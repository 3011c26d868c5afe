"""BERT-base's first SGD steps on one repeated batch, the PyTorch port
beside the JAX package, from the same numpy weights drawn at both
packages' own init law (glorot-uniform kernels and embeddings with fan
(shape[0], shape[-1]) unless the weight names its fan, zero biases, unit
scales), on the CPU. It witnesses the lr that chip_smoke.py phase 9 trains
BERT-base at: a loss that does not fall at some lr is the model's own
dynamics when the reference shows the same losses, and a fault of the port
when it does not.

Under pytest: at a small width (hidden 64, 2 layers, 2 heads) in f32, the
two packages' losses over four steps agree at lr 1e-2 and 1e-3 (1e-5).
As a script, at BERT-base's published widths (google-research/bert
uncased_L-12_H-768_A-12: hidden 768, 12 layers, 12 heads, vocab 30522) at
sequence 512, batch 8, in f32 (~13 GiB of host memory and ~2.5 minutes
an lr):

    python3 tests/test_torch_bert_witness.py [--lr 1e-2 1e-3 3e-4 1e-4]

prints, for each lr, the loss before each of 5 steps in both packages and
their largest difference.
"""

import argparse
import os
import sys
import time

import numpy as np
import pytest

SMALL = dict(seq=32, hidden=64, layers=2, heads=2, vocab=97, batch=2)
FULL = dict(seq=512, hidden=768, layers=12, heads=12, vocab=30522, batch=8)
CLASSES = 2


def _init_params(seed):
    """``GraphExecutor.init_params`` of the JAX package drawing numpy
    weights at its own law (one jit per weight would take minutes at
    BERT-base's 200 leaves)."""
    import jax

    def init_params(self, rng_key):
        rs = np.random.RandomState(seed)
        shardings = self.param_shardings()
        params = {}
        for op in self.model.ops:
            ws = {}
            for spec in op.weight_specs():
                if (op.name, spec.name) in self.model._tied:
                    continue
                shape = tuple(spec.shape)
                if spec.init == "glorot":
                    fan_in, fan_out = spec.fan or (shape[0], shape[-1])
                    lim = np.sqrt(6.0 / (fan_in + fan_out))
                    a = rs.uniform(-lim, lim, shape)
                elif spec.init in ("zero", "one"):
                    a = np.full(shape, float(spec.init == "one"))
                else:
                    raise ValueError(f"{op.name}.{spec.name}: init "
                                     f"{spec.init} is not BERT-base's")
                ws[spec.name] = jax.device_put(
                    a.astype(np.float32), shardings[op.name][spec.name])
            if ws:
                params[op.name] = ws
        return params
    return init_params


def _batch(shape, seed=0):
    rs = np.random.RandomState(seed)
    b, s = shape["batch"], shape["seq"]
    return {"input": rs.randint(0, shape["vocab"], (b, s)).astype(np.int32),
            "positions": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
            "label": rs.randint(0, CLASSES, (b, 1)).astype(np.int32)}


def witness_losses(lr, shape, steps=4, seed=0):
    """(JAX's losses, the port's losses): the loss before each of
    ``steps`` SGD steps at ``lr`` on one repeated batch, both packages
    from the same numpy weights."""
    import torch

    import flexflow_tpu as J
    from flexflow_tpu.models import bert as j_bert
    from flexflow_tpu.runtime import executor as jex
    import flexflow_tpu_torch as T
    from flexflow_tpu_torch.convert import params_from_jax
    from flexflow_tpu_torch.models import bert as t_bert

    b = shape["batch"]
    args = (b, shape["seq"], shape["hidden"], shape["layers"],
            shape["heads"], shape["vocab"], CLASSES)
    batch = _batch(shape)
    mp = pytest.MonkeyPatch()
    mp.setattr(jex.GraphExecutor, "init_params", _init_params(seed))
    try:
        jff = J.FFModel(J.FFConfig(batch_size=b, mesh_shape={"data": 1}))
        _, _, out = j_bert.bert_base(jff, *args)
        jff.compile(J.SGDOptimizer(lr=lr),
                    J.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                    [J.MetricsType.METRICS_ACCURACY], final_tensor=out)
    finally:
        mp.undo()
    weights = {op: {k: np.asarray(v) for k, v in ws.items()}
               for op, ws in jff.params.items()}
    jlosses = [float(jff._run_train_step(batch)[0]) for _ in range(steps)]
    del jff

    tff = T.FFModel(T.FFConfig(batch_size=b), device="cpu")
    _, _, out = t_bert.bert_base(tff, *args)
    tff.compile(T.SGDOptimizer(lr=lr),
                T.LossType.LOSS_SPARSE_CATEGORICAL_CROSSENTROPY,
                [T.MetricsType.METRICS_ACCURACY], final_tensor=out)
    tff.params = params_from_jax(weights, "cpu", torch.float32, model=tff)
    tff.opt_state = tff.optimizer.init_state(tff.params)
    tlosses = [float(tff._run_train_step(batch)[0]) for _ in range(steps)]
    return jlosses, tlosses


@pytest.mark.parametrize("lr", [1e-2, 1e-3])
def test_bert_losses_over_sgd_steps_match_jax(lr):
    jlosses, tlosses = witness_losses(lr, SMALL)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-5)
    assert all(np.isfinite(jlosses))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", type=float, nargs="+",
                    default=[1e-2, 1e-3, 3e-4, 1e-4])
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for lr in args.lr:
        t0 = time.perf_counter()
        jl, tl = witness_losses(lr, FULL, steps=5)
        diff = max(abs(t - j) for j, t in zip(jl, tl))
        print(f"bert_base {FULL} f32 SGD lr {lr}: JAX "
              f"{[round(v, 4) for v in jl]}, port "
              f"{[round(v, 4) for v in tl]}, largest difference "
              f"{diff:.3g} ({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main()
