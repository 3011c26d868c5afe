"""FFConfig: the subset of the JAX package's configuration that the serving
and training slices read.

Field names, defaults and validation follow the JAX package's
``config.py``, so a config written for one package means the same in the
other. Knobs that select features of later slices are kept (a user who
sets them must not be silently served or trained something else): the
serving engine and the training ``compile`` reject each non-default value
with ``NotImplementedError`` naming the ROADMAP item that ports it
(``not_ported``) — ``host_kv_pages > 0`` (the prefix cache's host tier)
and ``checkpoint_dir`` among them.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

#: where the features of later slices are queued
ROADMAP_SERVING = "ROADMAP.md queue 1, item 5 (serving features)"
ROADMAP_RUNTIME = "ROADMAP.md queue 1, item 11 (the runtime plane)"


def not_ported(feature: str, hint: str = "",
               where: str = ROADMAP_SERVING) -> NotImplementedError:
    """The error for a knob whose feature a later slice ports."""
    msg = f"{feature} is not ported to flexflow_tpu_torch yet ({where})"
    return NotImplementedError(msg + (f"; {hint}" if hint else ""))


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    epochs: int = 1
    seed: int = 0
    # "bfloat16" runs every op in bf16 (the serving default on the card);
    # "float32" is what the CPU parity tests use. Serving stores its
    # weights in this dtype.
    compute_dtype: str = "float32"

    # ---- training (model.py compile/fit, runtime/executor.py) ----
    # storage dtype of the trained weights (and the optimizer's state);
    # the update's arithmetic is f32 either way
    master_dtype: str = "float32"
    # residual add + LayerNorm as one fused op (models/transformer.py) —
    # the fused_add_layernorm kernel on the card
    use_fused_ln: bool = False
    # False sends the dense attention path to its einsum (or, past 4096
    # positions, blockwise) torch route instead of the flash kernels, as
    # in the JAX package
    use_flash_attention: bool = True
    # one update a dtype bucket (runtime/optimizer.py FusedUpdate): the
    # fused_update kernel on the card, bitwise the per-leaf update
    fused_optimizer: bool = False
    # multi-step training (FFModel.train_scanned): fit() runs up to this
    # many steps a dispatch — on the card one step captured as a CUDA
    # graph and replayed. 0 = one dispatch a step
    scan_steps: int = 0
    # gradient accumulation: each global batch splits into this many equal
    # microbatches, their gradients summed (f32 for bf16 weights) and ONE
    # update made. 1 = off
    grad_accum_steps: int = 1
    # divergence guard (runtime/executor.py guarded_train_step):
    #   "none"    — guard off
    #   "skip"    — a non-finite step leaves weights and optimizer state
    #               untouched
    #   "backoff" — skip, and halve the loss scale on a non-finite step;
    #               double it after loss_scale_growth_interval clean steps
    on_nonfinite: str = "none"
    loss_scale: float = 1.0  # initial loss scale ("backoff" mode)
    loss_scale_growth_interval: int = 200
    # fold each op's chain of weightless elementwise followers into one
    # FusedOp at compile (ops/fused.py apply_fusion); the math is unchanged
    perform_fusion: bool = False
    # later-slice knob, kept with the JAX default (see module docstring)
    checkpoint_dir: str = ""

    # ---- serving (runtime/serving.py) ----
    # decode slots: the engine's batch; the host scheduler admits and
    # retires one request per slot
    serve_slots: int = 4
    # paged KV pool of (kv_pages, kv_page_size, KVH, Dh) pages shared by
    # every slot through per-slot page tables; kv_pages = 0 derives
    # 1 (scratch page 0) + serve_slots * ceil(max_seq_len / kv_page_size)
    kv_page_size: int = 128
    kv_pages: int = 0
    # prompt-length admission buckets (ascending); None = powers of two
    # from 8
    decode_buckets: Optional[List[int]] = None
    # the radix prefix cache (HBM tier): prompts sharing page-aligned
    # prefixes mount the cached pages read-only and prefill their tail
    serve_prefix_cache: bool = True
    # KV-pool storage: native (the compute dtype), bf16, or int8 / fp8 with
    # one f32 scale per (page, kv head); weight-only quantization of the
    # served weights: native, int8 or fp8 (per-output-channel scales)
    kv_cache_dtype: str = "native"
    serve_weight_dtype: str = "native"
    # later-slice knobs, kept with the JAX defaults (see module docstring):
    # the prefix cache's host-memory tier, and the attention route
    host_kv_pages: int = 0
    paged_attention_impl: str = "auto"

    def __post_init__(self):
        for field in ("compute_dtype", "master_dtype"):
            if getattr(self, field) not in ("float32", "bfloat16"):
                raise ValueError(
                    f"{field}={getattr(self, field)!r}: must be 'float32' "
                    f"or 'bfloat16'")
        if self.epochs < 1 or self.grad_accum_steps < 1 \
                or self.scan_steps < 0:
            raise ValueError(
                f"epochs={self.epochs} (>= 1), grad_accum_steps="
                f"{self.grad_accum_steps} (>= 1), scan_steps="
                f"{self.scan_steps} (>= 0)")
        if self.batch_size % self.grad_accum_steps:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"grad_accum_steps {self.grad_accum_steps}")
        if self.on_nonfinite not in ("none", "skip", "backoff"):
            raise ValueError(
                f"on_nonfinite={self.on_nonfinite!r}: must be 'none', "
                f"'skip' or 'backoff'")
        if self.loss_scale <= 0:
            # 0 would make the guard divide by zero and classify every
            # step non-finite
            raise ValueError(f"loss_scale={self.loss_scale}: must be > 0")
        if self.loss_scale_growth_interval < 1:
            raise ValueError(
                f"loss_scale_growth_interval="
                f"{self.loss_scale_growth_interval}: must be >= 1")
        if self.serve_slots < 1 or self.kv_page_size < 1 \
                or self.kv_pages < 0:
            raise ValueError(
                f"serve_slots={self.serve_slots} (>= 1), "
                f"kv_page_size={self.kv_page_size} (>= 1), "
                f"kv_pages={self.kv_pages} (>= 0, 0 = derive)")
        if self.host_kv_pages < 0:
            raise ValueError(
                f"host_kv_pages={self.host_kv_pages}: must be >= 0 "
                f"(0 = no host tier)")
        if self.kv_page_size & (self.kv_page_size - 1):
            raise ValueError(
                f"kv_page_size={self.kv_page_size}: must be a power of two")
        if self.paged_attention_impl not in ("auto", "pallas", "einsum"):
            raise ValueError(
                f"paged_attention_impl={self.paged_attention_impl!r}: "
                f"must be 'auto', 'pallas' or 'einsum'")
        if self.kv_cache_dtype not in ("native", "bf16", "int8", "fp8"):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r}: must be "
                f"'native', 'bf16', 'int8' or 'fp8' (exact spelling — a "
                f"typo here would silently serve the wrong KV precision)")
        if self.serve_weight_dtype not in ("native", "int8", "fp8"):
            raise ValueError(
                f"serve_weight_dtype={self.serve_weight_dtype!r}: must "
                f"be 'native', 'int8' or 'fp8'")
        if self.decode_buckets is not None:
            bs = [int(b) for b in self.decode_buckets]
            if not bs or any(b < 1 for b in bs) or sorted(set(bs)) != bs:
                raise ValueError(
                    f"decode_buckets={self.decode_buckets!r}: must be a "
                    f"strictly ascending list of positive ints")


def check_training_ported(cfg: FFConfig) -> None:
    """Raise for a training knob set to a feature no slice has ported."""
    if cfg.checkpoint_dir:
        raise not_ported("checkpointing and auto-resume (checkpoint_dir)",
                         where=ROADMAP_RUNTIME)
