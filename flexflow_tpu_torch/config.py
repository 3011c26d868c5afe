"""FFConfig: the subset of the JAX package's configuration that the serving
slice reads.

Field names, defaults and validation follow the JAX package's
``config.py``, so a config written for one package means the same in the
other. Knobs that select features of later slices are kept (a user who
sets them must not be silently served something else): the serving engine
rejects each non-default value with ``NotImplementedError`` naming the
ROADMAP item that ports it (``not_ported``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

#: where the serving features of later slices are queued
ROADMAP_SERVING = "ROADMAP.md queue 1, item 5 (serving features)"


def not_ported(feature: str, hint: str = "") -> NotImplementedError:
    """The error for a knob whose feature a later slice ports."""
    msg = f"{feature} is not ported to flexflow_tpu_torch yet ({ROADMAP_SERVING})"
    return NotImplementedError(msg + (f"; {hint}" if hint else ""))


@dataclasses.dataclass
class FFConfig:
    batch_size: int = 64
    seed: int = 0
    # "bfloat16" stores the weights and runs every op in bf16 (the serving
    # default on the card); "float32" is what the CPU parity tests use
    compute_dtype: str = "float32"

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
    # later-slice knobs, kept with the JAX defaults (see module docstring)
    serve_prefix_cache: bool = True
    kv_cache_dtype: str = "native"
    serve_weight_dtype: str = "native"
    paged_attention_impl: str = "auto"

    def __post_init__(self):
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"compute_dtype={self.compute_dtype!r}: must be 'float32' "
                f"or 'bfloat16'")
        if self.serve_slots < 1 or self.kv_page_size < 1 \
                or self.kv_pages < 0:
            raise ValueError(
                f"serve_slots={self.serve_slots} (>= 1), "
                f"kv_page_size={self.kv_page_size} (>= 1), "
                f"kv_pages={self.kv_pages} (>= 0, 0 = derive)")
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
                f"'native', 'bf16', 'int8' or 'fp8'")
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
