"""The port's strategy layer against the JAX package's, with no process
spawned: strategy files, axis-map resolution, FSDP, every op's weight
partition, the errors, and the fusion rule under a strategy table.

* Strategy files round-trip across the packages: a table the JAX package
  writes loads in the port with equal degrees, device ids and axis maps,
  and back (the cases of ``tests/test_strategy_schema.py``: the @axismap
  sentinels CONTRACT / STAGE / EXPERT, an explicitly replicated entry, a
  host (CPU) entry, a reference-written degrees-only GPU file). The file's
  int 0 is the accelerator pool: JAX names it "TPU", the port "GPU".
* ``resolve_axis_map``, ``_with_fsdp`` and ``weight_partition`` of every
  op with weights equal JAX's, its PartitionSpecs read as tuples, over a
  table of (op, axis map, mesh) — GQA's replicated k/v and the indivisible
  fallbacks included; ``to_placements`` equals ``to_partition_spec``.
* The same errors as JAX for an axis absent from the mesh, a bad
  ``fsdp_axis`` and an axis map outside the op's rank.
* ``apply_fusion``'s groups and strategy table equal JAX's under a table
  with a conflicting follower.
"""

import types

import numpy as np
import pytest

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.ops.fused import apply_fusion as j_apply_fusion
from flexflow_tpu.parallel import mesh as jmesh
from flexflow_tpu.parallel import pconfig as jpc
from flexflow_tpu.parallel import strategy as jstrat
from flexflow_tpu.runtime import executor as jexec
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.ops.fused import apply_fusion
from flexflow_tpu_torch.parallel import pconfig as tpc
from flexflow_tpu_torch.parallel import strategy as tstrat
from flexflow_tpu_torch.runtime import executor as texec

MESH = {"data": 4, "model": 2}


def _tables():
    """Strategy tables of both packages' constructors (same records)."""
    def build(m):
        return {
            "col": m.ParallelConfig.from_axis_map(2, MESH,
                                                  {"data": 0, "model": 1}),
            "row": m.ParallelConfig.from_axis_map(
                2, MESH, {"data": 0, "model": m.CONTRACT}),
            "rep": m.ParallelConfig.replicated(3),
            "unused": m.ParallelConfig(axis_map={"data": 0, "model": None},
                                       dims=(4, 1),
                                       device_ids=tuple(range(4))),
            "stage": m.ParallelConfig.from_axis_map(
                3, {"data": 2, "pipe": 2}, {"data": 0, "pipe": m.STAGE}),
            "expert": m.ParallelConfig.from_axis_map(
                3, {"data": 2, "expert": 4},
                {"data": 0, "expert": m.EXPERT}),
            "host": m.ParallelConfig.host(2),
            "dp": m.ParallelConfig.data_parallel(4, 8),
        }
    return build(jpc), build(tpc)


def _same(a, b):
    assert a.dims == b.dims and a.device_ids == b.device_ids
    assert a.axis_map == b.axis_map
    pool = {"TPU": 0, "GPU": 0, "CPU": 1}
    assert pool[a.device_type] == pool[b.device_type]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_strategy_files_cross_load(tmp_path, writer):
    jt, tt = _tables()
    for name in jt:
        _same(jt[name], tt[name])
    p = str(tmp_path / "s.ff")
    if writer == "jax":
        jstrat.save_strategies_to_file(p, jt)
    else:
        tstrat.save_strategies_to_file(p, tt)
    loaded_j = jstrat.load_strategies_from_file(p)
    loaded_t = tstrat.load_strategies_from_file(p)
    assert set(loaded_j) == set(loaded_t) == set(jt)
    for name in jt:
        _same(loaded_t[name], loaded_j[name])
        if name != "expert":
            _same(loaded_t[name], jt[name])
        assert loaded_t[name].device_type == (
            "CPU" if name == "host" else "GPU")
        assert loaded_j[name].device_type == (
            "CPU" if name == "host" else "TPU")
    # both packages rewrite an EXPERT entry's ids alike (the schema has
    # one id a shard; JAX logs the rewrite)
    assert loaded_t["expert"].device_ids == (0, 1)
    assert loaded_t["rep"].axis_map == {}  # never degraded to None
    # each package rewrites the other's file byte for byte
    q = str(tmp_path / "again.ff")
    (tstrat if writer == "jax" else jstrat).save_strategies_to_file(
        q, loaded_t if writer == "jax" else loaded_j)
    assert open(p).read() == open(q).read()


def test_reference_written_gpu_file_loads_in_both(tmp_path):
    p = tmp_path / "ref.ff"
    p.write_text("1\ndense1\n0\n2\n2\t4\n8\n0\t1\t2\t3\t4\t5\t6\t7\n")
    j = jstrat.load_strategies_from_file(str(p))["dense1"]
    t = tstrat.load_strategies_from_file(str(p))["dense1"]
    _same(j, t)
    assert t.dims == (4, 2) and t.axis_map is None
    assert t.device_type == "GPU" and j.device_type == "TPU"


def test_strict_save_raises_alike(tmp_path):
    bad = {"mm_bad": dict(dims=(4, 1), device_ids=(0, 1, 2),
                          axis_map={"data": 0})}
    for m, s, name in ((jpc, jstrat, "j.ff"), (tpc, tstrat, "t.ff")):
        with pytest.raises(ValueError, match="mm_bad"):
            s.save_strategies_to_file(
                str(tmp_path / name),
                {k: m.ParallelConfig(**v) for k, v in bad.items()},
                strict=True)
        assert not (tmp_path / name).exists()


# ------------------------------------------------------ axis maps, FSDP

RESOLVE_CASES = [
    # (degrees, axis map, mesh, ndims)
    ((2, 1), None, {"data": 2, "model": 2}, 2),
    ((2, 2), None, {"data": 2, "model": 2}, 2),
    ((1, 4), None, {"data": 2, "model": 2}, 2),
    ((4, 1), None, {"data": 2, "model": 2}, 2),
    ((2, 1, 2), None, {"data": 2, "model": 2}, 2),      # trailing CONTRACT
    ((8, 1, 1), None, {"pipe": 2, "data": 2, "model": 2}, 3),
    ((2, 1, 1), {"data": 0, "model": -2}, {"data": 2, "model": 2}, 3),
    ((), {"data": 0, "model": 2}, {"data": 2, "model": 4}, 3),
    ((4, 1, 2), {"data": 0, "model": 2}, {"data": 2, "model": 2}, 3),
]


@pytest.mark.parametrize("dims,am,mesh,nd", RESOLVE_CASES)
def test_resolve_axis_map_equals_jax(dims, am, mesh, nd):
    j = jexec.resolve_axis_map(jpc.ParallelConfig(dims=dims, axis_map=am),
                               mesh, nd)
    t = texec.resolve_axis_map(tpc.ParallelConfig(dims=dims, axis_map=am),
                               mesh, nd)
    assert t == j


@pytest.mark.parametrize("dims,mesh", [((3, 1), {"data": 2, "model": 2}),
                                       ((2, 3), {"data": 2, "model": 2})])
def test_inexpressible_degrees_raise_alike(dims, mesh):
    msgs = []
    for m, ex in ((jpc, jexec), (tpc, texec)):
        with pytest.raises(ValueError) as e:
            ex.resolve_axis_map(m.ParallelConfig(dims=dims), mesh, 2)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("am,nd", [({"seq": 0}, 2), ({"data": 3}, 3),
                                   ({"data": 0, "model": 5}, 2)])
def test_bad_axis_maps_raise_alike(am, nd):
    """An axis absent from the mesh; a dim outside the op's rank (the
    rank check)."""
    msgs = []
    for m, ex in ((jpc, jexec), (tpc, texec)):
        with pytest.raises(ValueError) as e:
            ex.resolve_axis_map(m.ParallelConfig(axis_map=am),
                                {"data": 2, "model": 2}, nd)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def _spec(ps, rank):
    entries = tuple(ps)
    return entries + (None,) * (rank - len(entries))


FSDP_CASES = [
    ((None, None), (64, 32), "data", 2),
    ((None, "model"), (64, 32), "data", 4),
    (("model", None), (64, 32), "data", 2),
    ((None, None), (6, 10), "data", 4),          # nothing divisible
    ((None, "data"), (64, 32), "data", 2),       # axis already spent
    ((None, None, None), (16, 4, 8), "data", 1),  # one device
    ((None, ("data", "model")), (8, 8), "model", 2),
    ((None,), (48,), "data", 8),
]


@pytest.mark.parametrize("spec,shape,axis,size", FSDP_CASES)
def test_with_fsdp_equals_jax(spec, shape, axis, size):
    from jax.sharding import PartitionSpec as P

    j = jexec._with_fsdp(P(*spec), shape, axis, size)
    t = texec._with_fsdp(spec, shape, axis, size)
    assert _spec(t, len(shape)) == _spec(j, len(shape))


@pytest.mark.parametrize("am", [{"data": 0}, {"data": 0, "model": 1},
                                {"data": None, "model": 2},
                                {"data": 0, "model": -2}, {}])
def test_to_placements_equals_partition_spec(am):
    from torch.distributed.tensor import Replicate, Shard

    names = ["data", "model"]
    ps = jpc.ParallelConfig(axis_map=am).to_partition_spec(3, names)
    pl = tpc.ParallelConfig(axis_map=am).to_placements(names, 3)
    want = []
    for n in names:
        d = next((i for i, e in enumerate(ps)
                  if e == n or (isinstance(e, tuple) and n in e)), None)
        want.append(Shard(d) if d is not None else Replicate())
    assert pl == want


# ------------------------------------------------------- weight partitions

def _graph(pkg, mesh, kind):
    """A one-op graph (plus its input) of ``kind`` in either package."""
    jax_side = pkg == "jax"
    if jax_side:
        ff = JModel(JConfig(batch_size=8, mesh_shape=dict(mesh)))
        ff.mesh = jmesh.make_mesh(dict(mesh))
    else:
        ff = FFModel(FFConfig(batch_size=8, mesh_shape=dict(mesh)),
                     device="cpu")
    if kind in ("conv", "conv_nobias", "bn"):
        x = ff.create_tensor([8, 4, 6, 6], name="x")
    elif kind == "emb":
        from flexflow_tpu.ffconst import DataType as JDT
        from flexflow_tpu_torch.ffconst import DataType as TDT
        x = ff.create_tensor([8, 5], (JDT if jax_side else TDT).DT_INT32,
                             name="x")
    else:
        x = ff.create_tensor([8, 6, 16], name="x")
    if kind == "dense":
        ff.dense(x, 24, name="op")
    elif kind == "dense_nobias":
        ff.dense(x, 24, use_bias=False, name="op")
    elif kind == "emb":
        ff.embedding(x, 40, 16, name="op")
    elif kind == "mha":
        ff.multihead_attention(x, x, x, 16, 4, name="op")
    elif kind.startswith("gqa"):
        kvh = int(kind[3:])
        ff.multihead_attention(x, x, x, 16, 8, num_kv_heads=kvh, name="op")
    elif kind == "ln":
        ff.layer_norm(x, name="op")
    elif kind == "addln":
        ff.add_layer_norm(x, x, name="op")
    elif kind == "rms":
        ff.rms_norm(x, name="op")
    elif kind == "conv":
        ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, name="op")
    elif kind == "conv_nobias":
        ff.conv2d(x, 8, 3, 3, 1, 1, 1, 1, use_bias=False, name="op")
    elif kind == "bn":
        ff.batch_norm(x, name="op")
    elif kind == "moe":
        ff.moe(x, 4, 32, k=2, name="op")
    elif kind == "lstm":
        ff.lstm(x, 12, name="op")
    elif kind == "stack":
        ff.transformer_pipeline_stack(x, 4, 4, name="op")
    return ff, ff.get_op_by_name("op")


PARTITION_CASES = [
    ("dense", {"data": 0}, MESH),
    ("dense", {"data": 0, "model": 2}, MESH),
    ("dense", {"data": 0, "model": -2}, MESH),
    ("dense", {"data": 2, "model": -2}, MESH),
    ("dense_nobias", {"model": -2}, MESH),
    ("emb", {"data": 0, "model": 2}, MESH),
    ("mha", {"data": 0, "model": 2}, MESH),
    ("mha", {"data": 0}, MESH),
    ("gqa2", {"data": 0, "model": 2}, MESH),            # 2 kv heads / 2
    ("gqa2", {"data": 0, "model": 2}, {"data": 2, "model": 4}),  # kv rep.
    ("gqa4", {"model": 2, "data": 2}, {"data": 2, "model": 4}),
    ("ln", {"data": 0, "model": 1}, MESH),
    ("addln", {"data": 0}, MESH),
    ("rms", {"data": 0}, MESH),
    ("conv", {"data": 0, "model": 1}, MESH),
    ("conv", {"data": 0, "model": -2}, MESH),
    ("conv_nobias", {"model": 1}, MESH),
    ("bn", {"data": 0, "model": 1}, MESH),
    ("moe", {"data": 0, "expert": -4}, {"data": 2, "expert": 4}),
    ("moe", {"data": 0}, {"data": 2, "expert": 4}),
    ("moe", {"data": 0}, {"data": 2, "expert": 3}),      # 4 experts / 3
    ("lstm", {"data": 0}, MESH),
    ("stack", {"data": 0, "pipe": -3}, {"data": 2, "pipe": 2}),
    ("stack", {"data": 0}, {"data": 2, "pipe": 2}),
    ("stack", {"data": 0}, {"data": 2, "pipe": 3}),      # 4 layers / 3
]


@pytest.mark.parametrize("kind,am,mesh", PARTITION_CASES)
def test_weight_partition_equals_jax(kind, am, mesh):
    _, jop = _graph("jax", mesh, kind)
    _, top = _graph("port", mesh, kind)
    jw = jop.weight_partition(am)
    tw = top.weight_partition(am)
    shapes = {w.name: w.shape for w in top.weight_specs()}
    assert set(jw) == set(tw) == set(shapes)
    for name in tw:
        assert _spec(tw[name], len(shapes[name])) == \
            _spec(jw[name], len(shapes[name])), name
    # the other hooks the strategy layer reads
    assert top.partitionable_output_dims() == \
        jop.partitionable_output_dims()
    assert top.single_axis_dims() == jop.single_axis_dims()
    assert top.contract_size() == jop.contract_size()
    assert top.expert_parallel_size() == jop.expert_parallel_size()
    assert top.pipeline_stages() == jop.pipeline_stages()
    assert top.output_axis_map(am) == jop.output_axis_map(am)
    for i in range(len(top.inputs)):
        assert top.input_axis_map(am, i) == jop.input_axis_map(am, i)
        assert top.contract_input_dim(i) == jop.contract_input_dim(i)


@pytest.mark.parametrize("kind,am,mesh", [
    ("mha", {"data": 0, "model": 2}, MESH),
    ("gqa2", {"data": 0, "model": 2}, {"data": 2, "model": 4}),
    ("dense", {"data": 0, "model": -2}, MESH),
    ("conv", {"data": 0, "model": 1}, {"data": 2, "model": 3}),  # 8 / 3
])
def test_weight_placements_with_fsdp_equal_jax(kind, am, mesh):
    """The stored layout: JAX's ``param_shardings`` specs (FSDP over
    "data") as placements, indivisible dims unsharded as JAX's
    ``shard_entries`` leaves them."""
    from jax.sharding import PartitionSpec as P

    _, jop = _graph("jax", mesh, kind)
    _, top = _graph("port", mesh, kind)
    fake = types.SimpleNamespace(
        mesh_dim_names=tuple(a for a in jmesh.AXIS_ORDER if a in mesh),
        mesh=np.zeros([mesh[a] for a in jmesh.AXIS_ORDER if a in mesh]))
    for w in top.weight_specs():
        jspec = jexec._with_fsdp(jop.weight_partition(am)[w.name], w.shape,
                                 "data", mesh["data"])
        tspec = texec._with_fsdp(top.weight_partition(am)[w.name], w.shape,
                                 "data", mesh["data"])
        assert _spec(tspec, len(w.shape)) == _spec(jspec, len(w.shape))
        got = texec.spec_placements(tspec, fake, w.shape)
        want = texec.spec_placements(_spec(P(*jspec), len(w.shape)), fake,
                                     w.shape)
        assert got == want


def test_shard_entries_equals_jax():
    from flexflow_tpu.parallel import shard_entries as j_entries
    from flexflow_tpu_torch.parallel import shard_entries as t_entries

    mesh = jmesh.make_mesh({"data": 2, "model": 4})
    for am, shape in (({"data": 0, "model": 2}, (8, 6, 8, 4)),
                      ({"data": 0, "model": 2}, (8, 6, 6, 4)),
                      ({"data": 0, "model": 0}, (8, 6, 6, 4)),
                      ({"data": 1}, (8, 6, 6, 4)), ({}, (2, 2))):
        j = j_entries(mesh, am, shape, range(len(shape)))
        t = t_entries({"data": 2, "model": 4}, am, shape, range(len(shape)))
        for d in range(len(shape)):
            je = j[d]
            je = () if je is None else (je if isinstance(je, tuple)
                                        else (je,))
            assert t[d] == je, (am, shape, d)


# ------------------------------------------------------------- errors

def test_fsdp_axis_outside_the_mesh_raises_alike():
    from flexflow_tpu import SGDOptimizer as JSGD
    from flexflow_tpu_torch import SGDOptimizer

    jff = JModel(JConfig(batch_size=8, mesh_shape={"data": 1},
                         fsdp_axis="fsdp"))
    jff.dense(jff.create_tensor([8, 16], name="x"), 4, name="op")
    with pytest.raises(ValueError, match="is not a mesh axis") as je:
        jff.compile(JSGD(lr=0.1))
    tff = FFModel(FFConfig(batch_size=8, mesh_shape={"data": 1},
                           fsdp_axis="fsdp"), device="cpu")
    tff.dense(tff.create_tensor([8, 16], name="x"), 4, name="op")
    try:
        with pytest.raises(ValueError, match="is not a mesh axis") as te:
            tff.compile(SGDOptimizer(lr=0.1))
    finally:
        _leave_group()
    assert str(te.value) == str(je.value)


def _leave_group():
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def test_config_fields_and_refusals():
    from flexflow_tpu_torch.config import ROADMAP_PARALLEL, ROADMAP_SEARCH

    j, t = JConfig(mesh_shape={"data": 2}), FFConfig(mesh_shape={"data": 2})
    for f in ("num_devices", "mesh_shape", "ici_mesh_shape",
              "dcn_mesh_shape", "fsdp_axis", "strategies",
              "import_strategy_file", "export_strategy_file", "sp_mode",
              "overlap_grad_sync", "search_budget", "search_alpha",
              "measure_search_costs", "cost_db_path", "strategy_lint"):
        assert getattr(t, f) == getattr(j, f), f
    # unset: the JAX config fills {"data": n}; the port keeps None (the
    # single-device path) and counts the world's ranks
    assert FFConfig().mesh_shape is None and FFConfig().num_devices == 1
    # sp_mode is ported (ring / Ulysses attention): both lowerings build
    assert FFConfig(sp_mode="ulysses").sp_mode == "ulysses"
    # overlap_grad_sync is ported (ZeRO-1, tests/test_torch_zero1.py)
    assert FFConfig(overlap_grad_sync=True).overlap_grad_sync is True
    assert JConfig(overlap_grad_sync=True).overlap_grad_sync is True
    for kw, where in ((dict(search_budget=10), "item 10"),
                      (dict(measure_search_costs="measure"), "item 10"),
                      (dict(cost_db_path="x.db"), "item 10"),
                      (dict(strategy_lint="strict"), "item 10")):
        with pytest.raises(NotImplementedError, match=where):
            FFConfig(**kw)
    assert "item 9" in ROADMAP_PARALLEL and "item 10" in ROADMAP_SEARCH
    with pytest.raises(ValueError, match="strategy_lint"):
        FFConfig(strategy_lint="loud")
    with pytest.raises(ValueError, match="dcn_mesh_shape"):
        FFConfig(mesh_shape={"data": 2}, dcn_mesh_shape={"model": 2})


def test_sequence_stage_and_expert_strategies_refused():
    """None of these strategies is refused any more: a sharded sequence
    dim (ring / Ulysses attention), a STAGE axis (the stack's GPipe
    schedule) and an EXPERT axis (the MoE's all-to-all dispatch,
    tests/test_torch_expert_parallel.py) resolve to the same axis map as
    in JAX; the EXPERT axis shards the experts of w_in / w_out and "auto"
    takes the dense dispatch, as JAX's op does."""
    for kind, am, mesh in (
            ("mha", {"data": 0, "seq": 1}, {"data": 1, "seq": 2}),
            ("moe", {"expert": -4}, {"expert": 2}),
            ("stack", {"pipe": -3}, {"pipe": 2})):
        _, op = _graph("port", mesh, kind)
        jff, jop = _graph("jax", mesh, kind)
        nd = op.outputs[0].num_dims
        got = texec.resolve_axis_map(
            tpc.ParallelConfig.from_axis_map(nd, mesh, am), mesh, nd)
        want = jexec.resolve_axis_map(
            jpc.ParallelConfig.from_axis_map(nd, mesh, am), mesh, nd)
        assert got == want
        if kind == "moe":
            assert op.weight_partition(got)["w_in"] == ("expert", None, None)
            assert not op._use_sort_dispatch()
            assert not jop._use_sort_dispatch()


# --------------------------------------------------------------- fusion

def _chain(pkg):
    jax_side = pkg == "jax"
    mesh = {"data": 2, "model": 2}
    if jax_side:
        ff = JModel(JConfig(batch_size=8, mesh_shape=mesh))
        m = jpc
    else:
        ff = FFModel(FFConfig(batch_size=8, mesh_shape=mesh), device="cpu")
        m = tpc
    s = ff.config.strategies
    x = ff.create_tensor([8, 32], name="x")
    t = ff.dense(x, 64, name="fc1")
    t = ff.relu(t, name="act1")         # same entry as fc1: folds
    t = ff.sigmoid(t, name="act2")      # no entry: folds
    t = ff.dense(t, 64, name="fc2")
    t = ff.relu(t, name="act3")         # its own, other entry: blocks
    t = ff.tanh(t, name="act4")
    t = ff.dense(t, 10, name="fc3")
    t = ff.relu(t, name="act5")
    s["fc1"] = m.ParallelConfig.from_axis_map(2, mesh, {"data": 0,
                                                        "model": 1})
    s["act1"] = m.ParallelConfig.from_axis_map(2, mesh, {"data": 0,
                                                         "model": 1})
    s["fc2"] = m.ParallelConfig.from_axis_map(2, mesh, {"data": 0})
    s["act3"] = m.ParallelConfig.from_axis_map(2, mesh, {"data": None})
    s["act4"] = m.ParallelConfig.from_axis_map(2, mesh, {"data": None})
    return ff, t


def test_fusion_groups_equal_jax_under_strategies():
    groups = {}
    for pkg, fuse in (("jax", j_apply_fusion), ("port", apply_fusion)):
        ff, out = _chain(pkg)
        n = fuse(ff, protected=[out])
        groups[pkg] = (n, [(op.name, [m.name for m in getattr(
            op, "members", [])]) for op in ff.ops],
            sorted(ff.config.strategies))
    assert groups["port"] == groups["jax"]
    assert groups["port"][1][1] == ("fc1", ["act1", "act2"])
    assert ("act3", ["act4"]) in groups["port"][1]


def test_fused_op_delegates_partition_to_its_leader():
    ff, out = _chain("port")
    apply_fusion(ff, protected=[out])
    fused = ff.get_op_by_name("fc1")
    am = {"data": 0, "model": 1}
    assert fused.weight_partition(am) == fused.leader.weight_partition(am)
    assert fused.input_axis_map(am, 0) == \
        fused.leader.input_axis_map(am, 0)
    assert fused.partitionable_output_dims() == [0, 1]


# ------------------------------------------------ a world of one, in-process

@pytest.fixture
def world_of_one():
    """The strategy path in this process (``make_mesh`` makes a gloo group
    of one rank), the group left at the end."""
    yield
    _leave_group()


def test_kernel_wrappers_refuse_dtensors_on_the_cpu(world_of_one):
    import torch
    from torch.distributed.tensor import Replicate, distribute_tensor

    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.ops import kernels

    mesh = parallel.make_mesh({"data": 1}, "cpu")
    q = distribute_tensor(torch.randn(1, 8, 2, 32), mesh, [Replicate()])
    with pytest.raises(TypeError, match="local_shard"):
        kernels.flash_attention_fwd(q, q, q, False, 0.2)
    with pytest.raises(TypeError, match="local_shard"):
        kernels.flash_attention(q, q, q, False, 0.2)
    x = distribute_tensor(torch.randn(4, 32), mesh, [Replicate()])
    with pytest.raises(TypeError, match="local_shard"):
        kernels.fused_add_layernorm(x, x, x[0], x[0])
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        parallel.make_mesh({"data": 2, "model": 2}, "cpu")


@pytest.mark.parametrize("fsdp", ["", "data"])
def test_world_of_one_strategy_path_equals_single_device(world_of_one, fsdp,
                                                         tmp_path):
    """A mesh of one device runs the whole strategy path — DTensor
    weights, outputs redistributed, the kernels' plain versions on local
    shards, the Megatron table exported and imported — and gives the
    single-device path's losses and weights within 1e-6 (f32)."""
    import torch

    from flexflow_tpu_torch import (LossType, MetricsType, SGDOptimizer,
                                    parallel)
    from flexflow_tpu_torch.models import build_encoder_classifier

    torch.manual_seed(0)
    mesh = {"data": 1, "model": 1}
    path = str(tmp_path / "megatron.ff")
    table = FFConfig().strategies
    for i in range(2):
        for op in (f"attn_{i}", f"ffn1_{i}"):
            table[op] = tpc.ParallelConfig.from_axis_map(
                3, mesh, {"data": 0, "model": 2})
        table[f"ffn2_{i}"] = tpc.ParallelConfig.from_axis_map(
            3, mesh, {"data": 0, "model": tpc.CONTRACT})
    tstrat.save_strategies_to_file(path, table)
    rs = np.random.RandomState(1)
    batches = [{"input": rs.randn(4, 8, 32).astype(np.float32),
                "label": rs.randint(0, 8, (4, 1)).astype(np.int32)}
               for _ in range(3)]
    out = {}
    for kind, kw in (("single", {}),
                     ("mesh", dict(mesh_shape=mesh, fsdp_axis=fsdp,
                                   import_strategy_file=path))):
        ff = FFModel(FFConfig(batch_size=4, seed=2, use_fused_ln=True, **kw),
                     device="cpu")
        build_encoder_classifier(ff, 4, 8, 32, 2, 4, num_classes=8)
        ff.compile(SGDOptimizer(lr=0.1, momentum=0.9),
                   LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.METRICS_ACCURACY])
        parallel.reset_local_calls()
        losses = [float(ff._run_train_step(b)[0]) for b in batches]
        out[kind] = (ff, losses, dict(parallel.LOCAL_SHARD_CALLS))
    (sf, sl, _), (mf, ml, calls) = out["single"], out["mesh"]
    assert mf.mesh is not None and set(mf.config.strategies) == set(table)
    assert parallel.is_dtensor(mf.params["ffn2_0"]["kernel"])
    np.testing.assert_allclose(ml, sl, rtol=1e-6, atol=1e-6)
    for op, ws in sf.params.items():
        for k in ws:
            np.testing.assert_allclose(mf.get_weights(op, k),
                                       sf.get_weights(op, k), rtol=1e-6,
                                       atol=1e-6)
    assert calls == {"flash_attention": 6, "fused_add_layernorm": 12,
                     "fused_update": 3}


def test_shard_generator_draws_a_shard_its_own_mask():
    """Each rank draws a split op's mask from its shard's generator: the
    first shard from the op's own (a mesh of one draws what one process
    draws), another shard from one seeded by its coordinates (its own
    rows' mask), and ranks holding one shard (replicas over another mesh
    dim) the same."""
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from flexflow_tpu_torch.parallel import shard_generator

    class Mesh:
        def __init__(self, coord):
            self.coord = coord

        def get_coordinate(self):
            return list(self.coord)

    gen = torch.Generator().manual_seed(123)
    rows = [Shard(0), Replicate()]      # rows over "data", replicas over
    first = shard_generator(gen, Mesh((0, 1)), rows)
    assert first is gen
    a = shard_generator(gen, Mesh((1, 0)), rows)
    b = shard_generator(gen, Mesh((1, 1)), rows)
    assert a is b and a is not gen
    assert shard_generator(gen, Mesh((1, 0)), [Replicate(), Replicate()]) \
        is gen
    other = torch.Generator().manual_seed(123)
    assert shard_generator(other, Mesh((1, 0)), rows) is not a
    draws = [torch.rand(4096, generator=g) < 0.5 for g in (gen, a)]
    assert (draws[0] != draws[1]).float().mean().item() > 0.4
    assert shard_generator(None, Mesh((1, 0)), rows) is None


def test_world_of_one_dropout_equals_single_device(world_of_one):
    """Dropout on the strategy path (each rank masking its shard) on a mesh
    of one draws the single-device path's masks: the losses of three
    training steps equal bitwise."""
    import torch

    from flexflow_tpu_torch import (ActiMode, LossType, MetricsType,
                                    SGDOptimizer)

    rs = np.random.RandomState(3)
    batches = [{"x": rs.randn(8, 16).astype(np.float32),
                "label": rs.randint(0, 4, (8, 1)).astype(np.int32)}
               for _ in range(3)]
    out = {}
    for kind, kw in (("single", {}), ("mesh", dict(mesh_shape={"data": 1}))):
        torch.manual_seed(0)
        ff = FFModel(FFConfig(batch_size=8, seed=4, **kw), device="cpu")
        t = ff.dense(ff.create_tensor([8, 16], name="x"), 32,
                     ActiMode.AC_MODE_RELU, name="fc1")
        t = ff.dropout(t, 0.5, name="drop")
        ff.dense(t, 4, name="head")
        ff.compile(SGDOptimizer(lr=0.1),
                   LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                   [MetricsType.METRICS_ACCURACY])
        out[kind] = [float(ff._run_train_step(b)[0]) for b in batches]
    assert out["mesh"] == out["single"]
