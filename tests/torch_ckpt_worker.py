"""A rank of ``tests/test_torch_mesh_checkpoint.py``: checkpoints from every
rank, restores onto another mesh and the elastic resume, started through
the port's launcher (``python -m flexflow_tpu_torch.launcher
tests/torch_ckpt_worker.py --device cpu --num-processes N --process-id R
--coordinator HOST:PORT -- DIR STAGE``). ``DIR`` holds the weights
(``llama.npz``, ``mlp.npz``: ``op.weight`` keys) and the data
(``data.npz``); STAGE "save4" is the 4-rank half of the elastic scenario,
"main" the 2-rank rest. Records go to ``DIR/<scenario>.<rank>.npz``.
"""

import os
import sys

import numpy as np
import torch

LLAMA = dict(seq_len=8, hidden=64, layers=2, heads=4, kv_heads=2,
             vocab_size=97)
LR = 0.1
MOMENTUM = 0.9


def set_weights(ff, weights):
    for key in weights.files:
        op, w = key.split(".", 1)
        ff.set_weights(op, w, weights[key])


def llama(mesh, weights, tp=False, ckpt=""):
    """The restore flow's llama (JAX's ``test_checkpoint_restore_then_
    generate`` at hidden 64) under ``mesh`` — FSDP over "data", and with
    ``tp`` the head table over "model" —, momentum SGD."""
    from flexflow_tpu_torch import (FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer)
    from flexflow_tpu_torch.models import llama_lm
    from flexflow_tpu_torch.parallel import ParallelConfig

    cfg = FFConfig(batch_size=4, mesh_shape=mesh, checkpoint_dir=ckpt,
                   fsdp_axis="data" if mesh else "")
    if tp:
        for i in range(LLAMA["layers"]):
            for op in ("attn", "ffn_gate", "ffn_up"):
                cfg.strategies[f"{op}_{i}"] = ParallelConfig.from_axis_map(
                    3, mesh, {"data": 0, "model": 2})
    ff = FFModel(cfg, device="cpu")
    _, logits = llama_lm(ff, 4, **LLAMA)
    ff.compile(SGDOptimizer(lr=LR, momentum=MOMENTUM),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY], final_tensor=logits)
    if weights is not None:
        set_weights(ff, weights)
    return ff


def mlp(ckpt, mesh, policy="resume_resharded", min_devices=1, weights=None,
        data=None):
    """JAX's ``tests/test_elastic.py`` ``_build``: dense 8 -> 16 (ReLU) ->
    4, global batch 16, SGD lr 0.1, 64 rows."""
    from flexflow_tpu_torch import (ActiMode, FFConfig, FFModel, LossType,
                                    MetricsType, SGDOptimizer,
                                    SingleDataLoader)

    ff = FFModel(FFConfig(batch_size=16, epochs=1, seed=3,
                          checkpoint_dir=ckpt, mesh_shape=dict(mesh),
                          on_topology_change=policy,
                          elastic_min_devices=min_devices), device="cpu")
    x = ff.create_tensor([16, 8], name="x")
    t = ff.dense(x, 16, ActiMode.AC_MODE_RELU, name="fc1")
    ff.dense(t, 4, name="out")
    ff.compile(SGDOptimizer(lr=0.1),
               LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
               [MetricsType.METRICS_ACCURACY])
    if weights is not None:
        set_weights(ff, weights)
    SingleDataLoader(ff, x, data["mx"])
    SingleDataLoader(ff, ff.label_tensor, data["my"])
    return ff


def state(ff, prefix=""):
    """Every state tensor by its payload name, whole."""
    from flexflow_tpu_torch import parallel
    from flexflow_tpu_torch.runtime.checkpoint import state_tensors

    return {prefix + k: parallel.full_tensor(v).detach().numpy().copy()
            for k, v in state_tensors(ff).items()}


def restore_flow(d, data, out):
    """Train 3 steps on {"data": 2} (FSDP), save from every rank, generate;
    an async save of the same state; then a fresh model on {"data": 1,
    "model": 2} restores it and generates."""
    from flexflow_tpu_torch.runtime.checkpoint import (restore_checkpoint,
                                                       save_checkpoint,
                                                       wait_pending_saves)

    w = np.load(os.path.join(d, "llama.npz"))
    ff = llama({"data": 2}, w)
    batch = {"input": data["tokens"], "label": data["labels"]}
    out["losses"] = np.asarray(
        [float(ff._run_train_step(batch)[0]) for _ in range(3)])
    out.update(state(ff, "saved/"))
    save_checkpoint(ff, os.path.join(d, "ckpt"), step=3)
    save_checkpoint(ff, os.path.join(d, "ckpt_async"), step=3,
                    async_save=True)
    wait_pending_saves(os.path.join(d, "ckpt_async"))
    out["tokens"] = ff.generate(data["prompt"], 5)
    out["sharded/fc_fsdp"] = np.asarray(
        ff.params["ffn_gate_0"]["kernel"]._local_tensor.shape)
    del ff
    ff2 = llama({"data": 1, "model": 2}, None, tp=True)
    out["restored_step"] = np.int64(
        restore_checkpoint(ff2, os.path.join(d, "ckpt"), step=3))
    out.update(state(ff2, "restored/"))
    out["tp_tokens"] = ff2.generate(data["prompt"], 5)
    out["sharded/wq_tp"] = np.asarray(
        ff2.params["attn_0"]["wq"]._local_tensor.shape)


def elastic_save4(d, data, out):
    """JAX's ``test_resume_resharded_onto_fewer_devices``, first half: 4
    supervised steps on {"data": 4}."""
    from flexflow_tpu_torch.runtime.resilience import TrainSupervisor

    w = np.load(os.path.join(d, "mlp.npz"))
    ff = mlp(os.path.join(d, "elastic"), {"data": 4}, weights=w, data=data)
    sup = TrainSupervisor(ff, os.path.join(d, "elastic"))
    out["status"] = np.asarray(sup.run(4))
    out["losses"] = np.asarray(sup.losses)
    out.update(state(ff, "saved/"))


def elastic_resume2(d, data, out):
    """The second half on {"data": 2}: "abort" and elastic_min_devices
    refuse; "resume_resharded" doubles grad_accum_steps, restores bitwise
    and trains on to step 16."""
    from flexflow_tpu_torch.runtime import resilience
    from flexflow_tpu_torch.runtime.elastic import TopologyChangedError
    from flexflow_tpu_torch.runtime.resilience import TrainSupervisor

    ckpt = os.path.join(d, "elastic")
    for kw, key in ((dict(policy="abort"), "abort"),
                    (dict(min_devices=4), "min_devices")):
        try:
            mlp(ckpt, {"data": 2}, data=data, **kw)
            out[f"refused/{key}"] = np.asarray("")
        except TopologyChangedError as e:
            out[f"refused/{key}"] = np.asarray(str(e))
    resilience.reset_counters()
    ff = mlp(ckpt, {"data": 2}, data=data)
    dec = ff._elastic
    out["decision"] = np.asarray([dec.changed, dec.saved_grad_accum,
                                  dec.grad_accum,
                                  ff.config.grad_accum_steps,
                                  dec.saved_mesh["data"],
                                  dec.new_mesh["data"]])
    sup = TrainSupervisor(ff, ckpt)
    out["resumed"] = np.int64(sup.resume())
    out["elastic_resumes"] = np.int64(resilience.COUNTERS["elastic_resumes"])
    out.update(state(ff, "restored/"))
    out["status"] = np.asarray(sup.run(16))
    out["losses"] = np.asarray(sup.losses)


def main():
    import torch.distributed as dist

    torch.set_num_threads(1)
    d, stage = sys.argv[1], sys.argv[2]
    data = np.load(os.path.join(d, "data.npz"))
    rank = dist.get_rank()
    todo = ({"save4": [("elastic4", elastic_save4)],
             "main": [("restore", restore_flow),
                      ("elastic2", elastic_resume2)]}[stage])
    for name, fn in todo:
        out = {}
        fn(d, data, out)
        np.savez(os.path.join(d, f"{name}.{rank}.npz"), **out)
        dist.barrier()
    print(f"TORCH-CKPT rank={rank} ok", flush=True)


if __name__ == "__main__":
    main()
