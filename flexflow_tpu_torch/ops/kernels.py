"""The serving slice's hand-written Hopper kernels, their plain PyTorch
versions, and the build that compiles them (the counterpart of the JAX
package's ``ops/pallas_kernels.py``).

Three CUDA C++ kernels under ``flexflow_tpu_torch/csrc/`` replace the
three Pallas kernels the serving path runs:

  ============================  =========================================
  wrapper                       replaces (flexflow_tpu/ops/pallas_kernels.py)
  ============================  =========================================
  ``flash_attention_fwd``       ``flash_attention_fwd_pallas`` :180
  ``paged_attention_fwd``       ``paged_attention_fwd_pallas`` :689
  ``paged_prefill_write``       ``paged_prefill_write_pallas`` :779
  ============================  =========================================

The library is built at first use with ``nvcc`` (one process per source,
all started together, then one link) into ``build/`` at the root of the
checkout, keyed by a hash of the sources and flags, and loaded with
``ctypes``. Each wrapper takes its plain version when its tensors lie on
the CPU — and only then: on a CUDA tensor it launches its kernel or
raises. Each wrapper counts its launches in a plain integer attribute,
``wrapper.launches``, so a run can show that its main path went through
the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.nn.functional as F

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("flash_attention.cu", "paged_attention.cu", "paged_prefill_write.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: where the library is built: ``build/`` beside the package (listed in
#: .gitignore), one directory per source hash
BUILD_ROOT = _PKG.parent / "build" / "flexflow_tpu_torch_kernels"

# kernel dtype codes (csrc/common.cuh ffk::DType)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# head dims the kernels are instantiated for (csrc launch_d switches)
HEAD_DIMS = (32, 64, 128)


# ---------------------------------------------------------------- build


def _find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built at first use on a "
            "machine with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def _source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build_kernels() -> Path:
    """Compile the kernels into one shared library and return its path;
    a library built from the same sources and flags is reused. Sources
    compile in parallel (one ``nvcc -c`` each), then one link. The
    compiler's ``-Xptxas -v`` report (registers, shared memory, spills)
    is kept beside the library as ``build.log``."""
    out_dir = BUILD_ROOT / _source_digest()
    lib = out_dir / "libffkernels.so"
    if lib.exists():
        return lib
    nvcc = _find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix="tmp-"))
    try:
        procs = []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            procs.append((name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log = []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", str(tmp / lib.name), *[str(o) for _, o, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (tmp / "build.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "build.log", out_dir / "build.log")
        os.replace(tmp / lib.name, lib)  # atomic: concurrent builders agree
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


class _Library:
    """The loaded kernel library, built and bound once per process."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.path: Optional[Path] = None

    def get(self):
        with self._lock:
            if self._lib is None:
                self.path = build_kernels()
                lib = ctypes.CDLL(str(self.path))
                p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
                lib.ff_flash_attention_fwd.argtypes = [
                    p, p, p, p, i, i, i, i, i, i, i, f, i, p]
                lib.ff_paged_attention_fwd.argtypes = [
                    p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p]
                lib.ff_paged_prefill_write.argtypes = [
                    p, p, p, p, p, i, i, i, i, i, p]
                for fn in (lib.ff_flash_attention_fwd,
                           lib.ff_paged_attention_fwd,
                           lib.ff_paged_prefill_write):
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = _Library()


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, *tensors: torch.Tensor):
    """Every tensor on one CUDA device and contiguous; raise otherwise."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(
                f"{name}: all tensors must lie on one CUDA device (got "
                f"{[str(x.device) for x in tensors]})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


# ------------------------------------------------------- flash attention


def flash_attention_plain(q, k, v, causal: bool, scale: float):
    """Plain version of ``flash_attention_fwd``: the einsum-softmax branch
    of the JAX dense path (flexflow_tpu/ops/attention.py:795-806), with
    GQA's kv heads repeated to the query heads first (``_broadcast_kv``).
    Scores and softmax in f32; probabilities enter the P.V product in the
    value dtype."""
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshk->bqhk", probs, v)


def flash_attention_fwd(q, k, v, causal: bool, scale: float):
    """Attention forward on q (B, Sq, H, D), k/v (B, Sk, KVH, D) ->
    (B, Sq, H, D) in q's dtype; causal masking aligned bottom-right.

    Replaces ``flash_attention_fwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:180) with ``csrc/flash_attention.cu``: one block per
    (batch*head, 64-row q tile) streams 32-row K/V tiles with an f32
    online softmax and skips the tiles past the causal diagonal. Bound on
    the H100: bytes (q, k, v, o once each) at the serving prefill shape.
    """
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, scale)
    name = "flash_attention_fwd"
    _require_cuda(name, q, k, v)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share a dtype in "
                         f"{list(_DTYPE_CODES)}")
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h % kvh:
        raise ValueError(f"{name}: head dim {d} (supported {HEAD_DIMS}) or "
                         f"heads {h} not a multiple of kv heads {kvh}")
    if causal and sq > sk:
        raise ValueError(f"{name}: causal attention needs sq <= sk "
                         f"(got {sq} > {sk})")
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _check(lib.ff_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, sq, sk, h, kvh, d, float(scale),
            int(bool(causal)), _stream(q)), name)
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0


# ------------------------------------------------------- paged attention


def grouped_cache_attention(qh, ck, cv, live, scale: float):
    """q (B, C, H, D) against cached k/v (B, L, KVH, D) with a ``live``
    mask broadcastable to (B, KVH, G, C, L) — the JAX package's
    ``MultiHeadAttention._grouped_cache_attention`` (attention.py:333):
    consecutive query heads share a kv head, f32 scores and softmax."""
    b, c, h, d = qh.shape
    kvh = ck.shape[2]
    qg = qh.reshape(b, c, kvh, h // kvh, d)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(),
                          ck.to(qh.dtype).float()) * scale
    logits = torch.where(live, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(qh.dtype)
    ctx = torch.einsum("bkgqs,bskd->bqkgd", probs, cv.to(qh.dtype))
    return ctx.reshape(b, c, h, cv.shape[-1])


def paged_attention_plain(q, k_pages, v_pages, page_table, write_pos,
                          row_len, prompt_pad, scale: float):
    """Plain version of ``paged_attention_fwd``: the page-gather branch of
    the JAX ``_paged_attention_ctx`` (attention.py:638-651) — gather each
    slot's pages into a logical (B, L, KVH, D) cache, then the grouped
    einsum attention under the live rule."""
    b = q.shape[0]
    max_len = page_table.shape[1] * k_pages.shape[1]
    table = page_table.long()
    gk = k_pages[table].reshape(b, max_len, *k_pages.shape[2:])
    gv = v_pages[table].reshape(b, max_len, *v_pages.shape[2:])
    idx = torch.arange(max_len, device=q.device)
    live = (idx[None, None, :] < row_len[:, None, None]) \
        | ((idx[None, None, :] >= prompt_pad[:, None, None])
           & (idx[None, None, :] <= write_pos[:, :, None]))
    return grouped_cache_attention(q, gk, gv, live[:, None, None, :, :],
                                   scale)


def paged_attention_fwd(q, k_pages, v_pages, page_table, write_pos, row_len,
                        prompt_pad, scale: float):
    """Decode attention over the paged pool: q (B, S, H, D), k/v pools
    (P, page_size, KVH, D), page_table (B, pages_per_slot), write_pos
    (B, S), row_len / prompt_pad (B,) int32 -> (B, S, H, D) in q's dtype.

    Replaces ``paged_attention_fwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:689) with ``csrc/paged_attention.cu`` for native
    pools: one block per (slot, kv head) walks the slot's live positions
    through its page table in 32-position chunks; each chunk's K/V is
    staged once and shared by the whole query-head group. Bound on the
    H100: bytes (the live K/V).
    """
    ints = (page_table, write_pos, row_len, prompt_pad)
    if _on_cpu(q, k_pages, v_pages, *ints):
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     write_pos, row_len, prompt_pad, scale)
    name = "paged_attention_fwd"
    _require_cuda(name, q, k_pages, v_pages, *ints)
    b, s, h, d = q.shape
    n_pool, ps, kvh = k_pages.shape[:3]
    pps = page_table.shape[1]
    if q.dtype not in _DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise ValueError(f"{name}: q and the pools must share a dtype in "
                         f"{list(_DTYPE_CODES)} (quantized pools are not "
                         f"ported yet)")
    if k_pages.shape != (n_pool, ps, kvh, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS or h % kvh:
        raise ValueError(f"{name}: head dim {d} (supported {HEAD_DIMS}) or "
                         f"heads {h} not a multiple of kv heads {kvh}")
    if any(t.dtype != torch.int32 for t in ints) \
            or page_table.shape != (b, pps) or write_pos.shape != (b, s) \
            or row_len.shape != (b,) or prompt_pad.shape != (b,):
        raise ValueError(f"{name}: page_table (B, P), write_pos (B, S), "
                         f"row_len and prompt_pad (B,) must be int32")
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _check(lib.ff_paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            page_table.data_ptr(), write_pos.data_ptr(), row_len.data_ptr(),
            prompt_pad.data_ptr(), out.data_ptr(), _DTYPE_CODES[q.dtype],
            b, s, h, kvh, d, ps, pps, float(scale), _stream(q)), name)
    paged_attention_fwd.launches += 1
    return out


paged_attention_fwd.launches = 0


# --------------------------------------------------- paged prefill write


def paged_prefill_write_plain(pool_k, pool_v, kh, vh, pages):
    """Plain version of ``paged_prefill_write``: the scatter branch of the
    JAX ``paged_prefill_write`` (attention.py:493-517) — pad the slab to
    whole pages with zeros, reshape page-major, assign the listed pool
    pages (in place here)."""
    n_pages = pages.shape[0]
    ps = pool_k.shape[1]
    idx = pages.long()
    for pool, x in ((pool_k, kh), (pool_v, vh)):
        x = x[0]                                        # (S, KVH, D)
        pad = n_pages * ps - x.shape[0]
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        pool[idx] = x.reshape(n_pages, ps, *x.shape[1:]).to(pool.dtype)


def paged_prefill_write(pool_k, pool_v, kh, vh, pages):
    """Write a prefilled (1, S, KVH, D) k/v slab into pool pages ``pages``
    ((n,) int32, n = ceil(S / page_size)), IN PLACE; rows past S in the
    last page become zeros.

    Replaces ``paged_prefill_write_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:779) with ``csrc/paged_prefill_write.cu``: one block
    per (page, k-or-v) copies a page tile. The JAX kernel aliased the
    whole pool to its output; updating in place saves a pool copy per
    prefill. Bound on the H100: bytes (slab read, pages written).
    """
    tensors = (pool_k, pool_v, kh, vh, pages)
    if _on_cpu(*tensors):
        return paged_prefill_write_plain(pool_k, pool_v, kh, vh, pages)
    name = "paged_prefill_write"
    _require_cuda(name, *tensors)
    ps = pool_k.shape[1]
    s = kh.shape[1]
    n_pages = pages.shape[0]
    if kh.dtype != pool_k.dtype or vh.dtype != pool_v.dtype:
        raise ValueError(f"{name}: slab and pool dtypes differ (quantized "
                         f"pools are not ported yet)")
    if kh.shape[0] != 1 or kh.shape[2:] != pool_k.shape[2:] \
            or vh.shape[:2] != kh.shape[:2] \
            or vh.shape[2:] != pool_v.shape[2:] \
            or pool_v.shape[:2] != pool_k.shape[:2]:
        raise ValueError(f"{name}: slab {tuple(kh.shape)} / "
                         f"{tuple(vh.shape)} does not fit pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    if pages.dtype != torch.int32 or pages.dim() != 1 \
            or n_pages * ps < s or (n_pages - 1) * ps >= s:
        raise ValueError(f"{name}: pages must be (ceil(S / page_size),) "
                         f"int32 (S={s}, page_size={ps}, got "
                         f"{tuple(pages.shape)} {pages.dtype})")
    lib = LIBRARY.get()
    row = lambda t: t.shape[2] * t.shape[3] * t.element_size()  # noqa: E731
    with torch.cuda.device(pool_k.device):
        _check(lib.ff_paged_prefill_write(
            kh.data_ptr(), vh.data_ptr(), pool_k.data_ptr(),
            pool_v.data_ptr(), pages.data_ptr(), n_pages, s, ps,
            row(pool_k), row(pool_v), _stream(pool_k)), name)
    paged_prefill_write.launches += 1


paged_prefill_write.launches = 0


KERNELS = (flash_attention_fwd, paged_attention_fwd, paged_prefill_write)


def launch_counts() -> Dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
