"""FusedOp and ``apply_fusion`` (the JAX package's ``ops/fused.py``): a
producer op plus a chain of fused-on elementwise followers.

Reference: src/ops/fused.cu (FusedOp dispatches member ops' kernels
back-to-back in one task) + FFModel::apply_fusion (model.cc:1404-1475),
which merges producer/consumer ops sharing an identical ParallelConfig.

What the node buys is graph-level: the strategy table and the search see
one op a fused group. The port runs the members one after the other, as
the JAX package leaves their fusion to XLA, so a fused model computes
bitwise what the unfused one does.

Members are weightless, stateless, single-input, shape-preserving ops
whose sole consumer is the next member — the conservative subset of the
reference's fusion condition (model.cc:1424-1475). The group takes the
leader's name, so its weights and op state keep their keys; it adopts the
last member's outputs, so the intermediates leave the value map. A member
that draws (dropout) keeps its own generator: ``apply_fusion`` records
every op's index in the graph before the rewrite
(``FFModel._graph_index``), which seeds the generators, and the executor
hands the group its members' (``drawing_ops``).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops.base import InputOp, Op


class FusedOp(Op):
    op_type = OperatorType.OP_FUSED

    def __init__(self, leader: Op, members: List[Op]):
        super().__init__(leader.model, leader.name, leader.inputs)
        self.leader = leader
        self.members = list(members)
        self.stateful = leader.stateful
        self.needs_rng = leader.needs_rng or any(m.needs_rng
                                                  for m in members)
        self.outputs = self.members[-1].outputs

    def finalize(self):  # outputs adopted from members; nothing to infer
        raise RuntimeError("FusedOp is built by apply_fusion, not finalize()")

    def parts(self) -> List[Op]:
        """The leader, then the members, in graph order."""
        return [self.leader] + self.members

    @staticmethod
    def _gen(op: Op, gens):
        return (gens or {}).get(op.name)

    def _run_members(self, outs, training, gens):
        for m in self.members:
            if m.needs_rng:
                outs = m.forward({}, outs, training=training,
                                 gen=self._gen(m, gens))
            else:
                outs = m.forward({}, outs, training=training)
        return outs

    def forward(self, params, xs, *, training=False,
                gens: Optional[Dict[str, torch.Generator]] = None):
        """``gens``: the generators by op name (the executor's); each part
        that draws takes its own."""
        lead = self.leader
        if lead.needs_rng:
            outs = lead.forward(params, xs, training=training,
                                gen=self._gen(lead, gens))
        else:
            outs = lead.forward(params, xs, training=training)
        return self._run_members(outs, training, gens)

    def forward_stateful(self, params, state, xs, *, training=False,
                         gens: Optional[Dict[str, torch.Generator]] = None):
        outs, new_state = self.leader.forward_stateful(
            params, state, xs, training=training)
        return self._run_members(outs, training, gens), new_state

    def init_state(self, device=None):
        return self.leader.init_state(device)

    def weights(self):
        return self.leader.weights()

    # parallelization: the group is the leader, for the strategy table
    def weight_partition(self, axis_map):
        return self.leader.weight_partition(axis_map)

    def partitionable_output_dims(self):
        dims = set(self.leader.partitionable_output_dims())
        for m in self.members:
            dims &= set(m.partitionable_output_dims())
        return sorted(dims)

    def input_axis_map(self, axis_map, input_idx):
        return self.leader.input_axis_map(axis_map, input_idx)

    @property
    def _contracted_output_dims(self):
        return self.leader._contracted_output_dims

    def __repr__(self):
        chain = "+".join(type(m).__name__ for m in self.members)
        return f"FusedOp({self.leader!r}+{chain})"


def _fusable_follower(op: Op, producer_out, consumers: Dict[int, int]) -> bool:
    """``op`` can be folded onto the group ending in ``producer_out``."""
    return (len(op.inputs) == 1
            and op.inputs[0] is producer_out
            and not op.weight_specs()
            and not op.stateful
            and len(op.outputs) == 1
            and op.outputs[0].dims == op.inputs[0].dims
            and consumers.get(id(producer_out), 0) == 1)


def apply_fusion(model, protected=()) -> int:
    """Rewrite ``model.ops``, folding fusable elementwise chains into
    FusedOp nodes in one left-to-right scan (the JAX ``apply_fusion``).
    Returns the number of ops eliminated.

    ``protected``: tensors that must stay visible (the final tensor, the
    aux losses) — a group never swallows one as an intermediate. An op of
    several outputs leads no group: the group adopts its last member's
    outputs only, so the leader's others (a MoE's aux loss, a split's
    other parts) would leave the value map — the JAX function fuses such
    a leader, and its walk then misses them.

    Strategy compatibility (the reference's identical-ParallelConfig
    check, JAX ``fused.py:134-172``): a follower with a strategy entry of
    its own that differs from the leader's is not folded; a folded
    follower's entry is dropped from ``FFConfig.strategies``."""
    if model._graph_index is None:
        model._graph_index = {op.name: i for i, op in enumerate(model.ops)}
    strategies = model.config.strategies
    protected_ids = {id(t) for t in protected}
    consumers: Dict[int, int] = {}
    for op in model.ops:
        for t in op.inputs:
            consumers[id(t)] = consumers.get(id(t), 0) + 1

    new_ops: List[Op] = []
    i, eliminated = 0, 0
    ops = list(model.ops)
    while i < len(ops):
        op = ops[i]
        if isinstance(op, InputOp) or len(op.outputs) > 1:
            new_ops.append(op)
            i += 1
            continue
        members: List[Op] = []
        j = i + 1
        lead_strat = strategies.get(op.name)
        while j < len(ops):
            tail_out = (members[-1] if members else op).outputs[0]
            cand_strat = strategies.get(ops[j].name)
            if (id(tail_out) not in protected_ids
                    and _fusable_follower(ops[j], tail_out, consumers)
                    and (cand_strat is None or cand_strat == lead_strat)):
                members.append(ops[j])
                j += 1
            else:
                break
        if members:
            new_ops.append(FusedOp(op, members))
            for m in members:
                strategies.pop(m.name, None)
            eliminated += len(members)
            i = j
        else:
            new_ops.append(op)
            i += 1
    model.ops = new_ops
    return eliminated
