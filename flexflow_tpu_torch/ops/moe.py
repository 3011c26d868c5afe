"""Mixture-of-Experts op (the JAX package's ``ops/moe.py``), one device.

GShard-style capacity-based top-k routing with the JAX package's two
dispatch lowerings, selected by ``FFModel.moe(dispatch=...)``:

  * dense: the (N, E, C) one-hot dispatch and combine einsums; k rounds,
    each taking every token's best remaining expert (``argmax``: the
    lowest index on a tie, as ``jnp.argmax``), ranked in token order;
  * sort: the top-k assignments flattened round-major (all round-0 picks
    first, in token order), ordered by expert with a stable sort, so the
    capacity drops are the dense path's; O(N * k) routing state.

"auto" takes the sort path unless the mesh has an "expert" axis of more
than one rank that divides the experts (the JAX rule), which on one
device is never. Both share the router (logits in the input's dtype,
softmax in f32) and agree when capacity does not bind. The second output
is the load-balancing aux loss (Shazeer et al.), a 0-d f32 tensor the
executor adds to the training loss.

Expert parallelism (an EXPERT strategy axis, or a mesh axis named
"expert"): ``weight_partition`` shards ``w_in`` / ``w_out`` on the expert
dim, and the dense dispatch runs as GShard's all-to-alls
(``_forward_expert_parallel``). Every rank routes every token (the
capacity slots are the global batch's, as JAX's one program computes
them), then owns 1/R of the token rows (R the mesh's ranks): it
dispatches its rows' slots for every expert, ``parallel.all_to_all``
carries each expert rank its experts' slots (summed over the sources:
one token a slot, so the sum is exact), the rank runs its experts, and a
second all-to-all carries each row's combined outputs (f32 partials) back
to the rank that owns it. Gradients of the replicated values (the input,
the router, the routing) are partial sums over the ranks; the aux loss,
computed alike everywhere, sends 1/R of its gradient from each.

Where the JAX sort path scatter-adds (``.at[].add``), the port keeps the
result a pure function of its inputs, run to run: every kept assignment
owns a distinct buffer slot, so the dispatch is a plain index write (the
dropped ones all land in one trash row past the buffer's end, sliced
away), and the combine gathers each round's expert output
(``index_select``, whose backward adds once into each kept slot) and sums
the k rounds in round order. ``torch.topk`` promises no order on ties, so the
top-k is a stable descending sort (the lowest index first, as
``jax.lax.top_k``). Nothing here reads a value back to the host, so a
captured training step (``executor.StepReplay``) holds the routing. The
expert products are ``torch.bmm`` (cuBLAS on the card).
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.ffconst import DataType, OperatorType
from flexflow_tpu_torch.ops.base import Op, WeightSpec


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """f32 one-hot of int ``idx`` over ``n`` classes (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def expert_ffn(expert_in: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    """(E, C, D) -> gelu(x @ w_in) @ w_out, (E, C, D); the tanh GELU, as
    ``jax.nn.gelu``."""
    h = F.gelu(torch.bmm(expert_in, w_in), approximate="tanh")
    return torch.bmm(h, w_out)


class MoE(Op):
    op_type = OperatorType.OP_MOE

    def __init__(self, model, name, inputs, num_experts: int, hidden_dim: int,
                 k: int = 2, capacity_factor: float = 1.25,
                 aux_weight: float = 1e-2, dispatch: str = "auto"):
        super().__init__(model, name, inputs)
        self.num_experts = num_experts
        self.hidden_dim = hidden_dim
        self.k = min(k, num_experts)
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        if dispatch not in ("auto", "dense", "sort"):
            raise ValueError(
                f"dispatch must be auto|dense|sort, got {dispatch!r}")
        self.dispatch = dispatch
        self.dim = inputs[0].dims[-1]
        ntokens = 1
        for s in inputs[0].dims[:-1]:
            ntokens *= s
        self.capacity = max(
            1, int(capacity_factor * ntokens * self.k / num_experts))
        self.finalize()

    def output_shapes(self):
        return ([self.inputs[0].dims, ()],
                [self.inputs[0].dtype, DataType.DT_FLOAT])

    def weights(self) -> List[WeightSpec]:
        E, D, F_ = self.num_experts, self.dim, self.hidden_dim
        return [
            WeightSpec("router", (D, E), init="glorot", fan=(D, E)),
            WeightSpec("w_in", (E, D, F_), init="glorot", fan=(D, F_)),
            WeightSpec("w_out", (E, F_, D), init="glorot", fan=(F_, D)),
        ]

    def _use_sort_dispatch(self) -> bool:
        if self.dispatch != "auto":
            return self.dispatch == "sort"
        # dense pays off only when the experts shard over an "expert" axis
        # (its all-to-alls); the same condition as weight_partition's
        shape = self.model.mesh_shape or {}
        return not (shape.get("expert", 1) > 1
                    and self.num_experts % shape["expert"] == 0)

    def forward(self, params, xs, *, training=False, capacity=None):
        """[y, aux]. ``capacity`` overrides the build-time capacity: the
        serving walk (runtime/generation.py) passes the slab's token count
        N — a token never picks an expert twice, so no assignment drops
        and no row's output depends on another's."""
        x = xs[0]
        C = capacity if capacity is not None else self.capacity
        edim = self._expert_dim(params)
        if edim is not None and not self._use_sort_dispatch():
            return self._forward_expert_parallel(params, x, C, edim)
        t = x.reshape(-1, self.dim)                          # (N, D)
        logits = t @ params["router"]                        # (N, E)
        gates = torch.softmax(logits.float(), dim=-1)
        if self._use_sort_dispatch():
            y, aux = self._forward_sort(params, t, gates, C)
        else:
            y, aux = self._forward_dense(params, t, gates, C)
        return [y.reshape(x.shape), aux]

    @staticmethod
    def _expert_dim(params):
        """The one mesh dim ``w_in``'s experts are split over (a DTensor's
        Shard(0)), else None."""
        from flexflow_tpu_torch import parallel

        w = params["w_in"]
        if not parallel.is_dtensor(w):
            return None
        dims = [i for i, p in enumerate(w.placements) if p.is_shard(0)]
        return dims[0] if len(dims) == 1 else None

    def _aux(self, gates, ce):
        """E * sum(mean gate * mean assignment), weighted."""
        E = self.num_experts
        return self.aux_weight * E * torch.sum(gates.mean(dim=0)
                                               * (ce / self.k))

    def _forward_dense(self, params, t, gates, C):
        combine, ce = self._dense_routing(gates, C)
        dispatch = (combine > 0).to(t.dtype)
        expert_in = torch.einsum("nec,nd->ecd", dispatch, t)
        expert_out = expert_ffn(expert_in, params["w_in"], params["w_out"])
        y = torch.einsum("nec,ecd->nd", combine.to(t.dtype), expert_out)
        return y, self._aux(gates, ce)

    def _forward_expert_parallel(self, params, x, C, edim):
        """The dense dispatch with the experts split over mesh dim
        ``edim`` (see the module's docstring): [y, aux] as DTensors, y
        replicated."""
        from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                              Shard)

        from flexflow_tpu_torch import parallel

        mesh = x.device_mesh
        nd = mesh.ndim
        axis = parallel.mesh_axis(mesh, mesh.mesh_dim_names[edim])
        n, E, D = axis.size, self.num_experts, self.dim
        el = E // n
        part = [Partial()] * nd
        rep = [Replicate()] * nd
        t = x.redistribute(mesh, rep).to_local(
            grad_placements=part).reshape(-1, D)
        router = params["router"].redistribute(mesh, rep).to_local(
            grad_placements=part)
        w_in, w_out = (params[k].to_local(grad_placements=[
            p if p.is_shard() else Partial() for p in params[k].placements])
            for k in ("w_in", "w_out"))
        gates = torch.softmax((t @ router).float(), dim=-1)
        combine, ce = self._dense_routing(gates, C)
        # every rank routes every token; each owns r rows of the padded
        # batch, in DTensor's order of [Shard(0)] * nd
        N, R = t.shape[0], mesh.size()
        r = -(-N // R)
        pad = r * R - N
        if pad:
            t = torch.cat([t, t.new_zeros((pad, D))])
            combine = torch.cat([combine, combine.new_zeros(
                (pad,) + combine.shape[1:])])
        coord = mesh.get_coordinate()
        sizes = [mesh.size(i) for i in range(nd)]
        index = sum(c * math.prod(sizes[i + 1:]) for i, c in enumerate(coord))
        stride = math.prod(sizes[edim + 1:])
        me = coord[edim]

        def rows(j):
            lo = (index + (j - me) * stride) * r
            return slice(lo, lo + r)

        # tokens to their experts' ranks: this rank's rows' slots of every
        # expert, each rank's experts received from every source
        mine = rows(me)
        send = torch.einsum("nec,nd->ecd",
                            (combine[mine] > 0).to(t.dtype), t[mine])
        expert_in = parallel.all_to_all(send, axis, 0, 0).reshape(
            n, el, C, D).sum(0)
        out = expert_ffn(expert_in, w_in, w_out).float()
        # and back: each group rank's rows combined from this rank's
        # experts (f32 partials), summed where the rows live
        local_e = slice(me * el, (me + 1) * el)
        parts = torch.cat([torch.einsum("nec,ecd->nd",
                                        combine[rows(j), local_e], out)
                           for j in range(n)])
        y = parallel.all_to_all(parts, axis, 0, 0).reshape(n, r, D).sum(0)
        y = DTensor.from_local(y.to(t.dtype), mesh, [Shard(0)] * nd,
                               run_check=False, shape=(r * R, D),
                               stride=(D, 1)).redistribute(mesh, rep)
        y = y[:N].reshape(x.shape)
        # the aux loss, computed alike on every rank, sends 1/R of its
        # gradient from each (its value unchanged)
        aux = self._aux(gates, ce)
        aux = aux.detach() + (aux - aux.detach()) / R
        return [y, DTensor.from_local(aux, mesh, rep, run_check=False)]

    def _dense_routing(self, gates, C):
        """GShard's top-k routing with capacity: (combine (N, E, C) f32 —
        each kept assignment's renormalized gate at its expert slot —,
        the fraction of tokens each expert got, summed over rounds)."""
        N = gates.shape[0]
        E = self.num_experts
        dev = gates.device
        combine = torch.zeros((N, E, C), dtype=torch.float32, device=dev)
        remaining = gates
        ce = torch.zeros((E,), dtype=torch.float32, device=dev)
        # carried across rounds: round r's assignments take the slots after
        # round r-1's (C slots an expert in all)
        slots_used = torch.zeros((E,), dtype=torch.float32, device=dev)
        for _ in range(self.k):
            onehot = _one_hot(torch.argmax(remaining, dim=-1), E)
            ce = ce + onehot.mean(dim=0)
            pos = (torch.cumsum(onehot, dim=0) - 1.0) * onehot
            pos_in_e = (pos.sum(-1) + (onehot * slots_used).sum(-1)).int()
            fits = (pos_in_e < C).float()
            keep = fits * (onehot * remaining).amax(dim=-1)
            slot = _one_hot(torch.clamp(pos_in_e, 0, C - 1), C)
            combine = combine + (keep[:, None, None] * onehot[:, :, None]
                                 * slot[:, None, :])
            slots_used = slots_used + (onehot * fits[:, None]).sum(0)
            remaining = remaining * (1.0 - onehot)
        # renormalize the kept gates over each token's selected experts
        denom = combine.sum(dim=(1, 2), keepdim=True)
        combine = torch.where(denom > 0, combine / denom.clamp_min(1e-9),
                              combine)
        return combine, ce

    def _forward_sort(self, params, t, gates, C):
        N, D = t.shape
        E, k = self.num_experts, self.k
        dev = t.device
        # top-k with the lowest index first among equal gates
        topk_idx = torch.sort(gates, dim=-1, descending=True,
                              stable=True).indices[:, :k]       # (N, k)
        topk_gates = torch.gather(gates, 1, topk_idx)
        flat_e = topk_idx.t().reshape(-1)                        # round-major
        order = torch.argsort(flat_e, stable=True)
        sorted_e = flat_e[order]
        counts = torch.zeros((E,), dtype=torch.int64, device=dev).index_add_(
            0, flat_e, torch.ones_like(flat_e))
        starts = torch.cumsum(counts, 0) - counts
        rank_sorted = torch.arange(k * N, device=dev) - starts[sorted_e]
        # each assignment's rank within its expert, back in round-major
        # order (a permutation: distinct indices)
        rank = torch.empty_like(rank_sorted)
        rank[order] = rank_sorted
        kept = rank < C
        trash = E * C
        dest = torch.where(kept, flat_e * C + rank,
                           torch.full_like(rank, trash)).reshape(k, N)
        gate = topk_gates.t() * kept.reshape(k, N).float()      # (k, N)
        gate = gate / torch.clamp_min(gate.sum(dim=0), 1e-9)
        # dispatch: a plain write; the dropped assignments share the trash
        # row, which is cut off
        buf = torch.zeros((trash + 1, D), dtype=t.dtype, device=dev)
        buf = buf.index_put((dest.reshape(-1),), t.repeat(k, 1))
        expert_out = expert_ffn(buf[:trash].reshape(E, C, D),
                                params["w_in"], params["w_out"])
        expert_out = expert_out.reshape(trash, D)
        out = torch.cat([expert_out, expert_out.new_zeros((1, D))])
        # combine: each round's output gathered, the k rounds summed. The
        # gather's backward adds each kept assignment's gradient into its
        # own slot (index_select's index_add_: one add a kept slot, so
        # deterministic; only the trash row, which is dropped, takes
        # several)
        y = (out.index_select(0, dest.reshape(-1)).reshape(k, N, D)
             * gate[..., None].to(t.dtype)).sum(dim=0)
        return y, self._aux(gates, counts.float() / N)

    def partitionable_output_dims(self):
        return list(range(self.outputs[0].num_dims - 1))

    def expert_parallel_size(self):
        return self.num_experts

    def weight_partition(self, axis_map):
        """EXPERT axes shard the expert dim of w_in / w_out; without one a
        mesh axis literally named 'expert' that divides the experts does
        (the JAX convention)."""
        from flexflow_tpu_torch.parallel.pconfig import EXPERT

        eaxes = [ax for ax, d in (axis_map or {}).items() if d == EXPERT]
        shape = self.model.mesh_shape or {}
        if not eaxes and shape.get("expert", 1) > 1 \
                and self.num_experts % shape["expert"] == 0:
            eaxes = ["expert"]
        e = None if not eaxes else (eaxes[0] if len(eaxes) == 1
                                    else tuple(eaxes))
        return {"router": (None, None), "w_in": (e, None, None),
                "w_out": (e, None, None)}

    def input_axis_map(self, axis_map, input_idx):
        # sentinels never reach the input: it arrives replicated over them
        ndims = self.inputs[input_idx].num_dims
        return {ax: (d if d is not None and 0 <= d < ndims - 1 else None)
                for ax, d in (axis_map or {}).items()}
