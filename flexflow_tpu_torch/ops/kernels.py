"""The port's hand-written Hopper kernels, their plain PyTorch versions,
the autograd Functions around them, and the build that compiles them (the
counterpart of the JAX package's ``ops/pallas_kernels.py``).

Five CUDA C++ kernels under ``flexflow_tpu_torch/csrc/`` replace the
Pallas kernels the serving and training paths run:

  ==============================  =============================================
  wrapper                         replaces (flexflow_tpu/ops/pallas_kernels.py)
  ==============================  =============================================
  ``flash_attention_fwd``         ``flash_attention_fwd_pallas`` :180
  ``flash_attention_bwd``         ``flash_attention_bwd_pallas`` :335
  ``fused_add_layernorm_fwd``     ``fused_add_layernorm_fwd_pallas`` :461
  ``paged_attention_fwd``         ``paged_attention_fwd_pallas`` :689
  ``paged_prefill_write_layers``  ``paged_prefill_write_pallas`` :779
  ==============================  =============================================

The two flash wrappers choose their kernels by dtype: bf16 runs on the
tensor cores (``flash_attention_wgmma.cu``, ``flash_attention_bwd_wgmma.cu``:
wgmma products, tiles brought in by TMA; helpers in ``hopper.cuh``), f32 on
the CUDA cores (``flash_attention.cu``, ``flash_attention_bwd.cu``), which
keep f32's precision where TF32 wgmma would not.

The two paged kernels serve every KV pool of the serving engine: a native
pool (the compute dtype), a bf16 pool under f32 compute, and an int8 / fp8
pool with one f32 scale per (page, kv head) — attention applies each
page's k and v scales to its positions' scores and probabilities (the same
as dequantizing each value), the prefill write quantizes each page against
a fresh scale (the Pallas kernels' quantized bodies, :650-654 and
:843-852). Paged attention splits the slots' positions across blocks
(``paged_attention_plan``) and merges the splits in the same launch. The
prefill write takes every layer of a prefill in one launch
(``paged_prefill_write_layers``; ``paged_prefill_write`` is its one-layer
case), where the JAX package writes a layer a call.

``flash_attention_takes`` and ``fused_add_layernorm_takes`` state what the
flash and add + LayerNorm kernels take, from the checks their wrappers
make; the ops route the shapes they refuse to their own torch code, as the
JAX ops route them off their Pallas kernels.

A sixth kernel is the port's own, not a Pallas kernel's: ``fused_update``
(``csrc/fused_update.cu``) applies the optimizer's update to every weight
of one storage dtype in one launch, where the JAX package's ``FusedUpdate``
(flexflow_tpu/runtime/optimizer.py:40) leaves the job to XLA's fusion.
Both of the port's optimizers launch it on the card — ``FusedUpdate`` on
its flat state vectors, the per-leaf ``Optimizer`` on its per-leaf state
tensors; ``update_math`` is the formula it and the per-leaf torch update
(the CPU path) follow.

``flash_attention`` and ``fused_add_layernorm`` are the
``torch.autograd.Function`` counterparts of the JAX package's custom VJPs
(:538 and :502): the forward kernel saves its residuals, and the backward
is the flash backward kernel, or torch arithmetic for add + LayerNorm (as
the JAX package's backward there is plain JAX).

The library is built at first use with ``nvcc`` (one process per source,
all started together, then one link) into ``build/`` at the root of the
checkout, keyed by a hash of the sources and flags, and loaded with
``ctypes``. Each wrapper takes its plain version when its tensors lie on
the CPU — and only then: on a CUDA tensor it launches its kernel or
raises. Each wrapper counts its calls that launch in a plain integer
attribute, ``wrapper.launches``, so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import contextlib
import functools
import gc
import hashlib
import math
import os
import shutil
import subprocess
import tempfile
import threading
import weakref
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.parallel import is_dtensor

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = ("flash_attention.cu", "flash_attention_wide.cu",
           "flash_attention_wgmma.cu", "flash_attention_bwd.cu",
           "flash_attention_bwd_wide.cu", "flash_attention_bwd_wide_bf16.cu",
           "flash_attention_bwd_wgmma.cu",
           "fused_add_layernorm.cu", "paged_attention.cu",
           "paged_prefill_write.cu", "fused_update.cu")
HEADERS = ("common.cuh", "hopper.cuh", "flash_attention_simt.cuh",
           "flash_attention_bwd_simt.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")
#: where the library is built: ``build/`` beside the package (listed in
#: .gitignore), one directory per source hash
BUILD_ROOT = _PKG.parent / "build" / "flexflow_tpu_torch_kernels"

# kernel dtype codes (csrc/common.cuh ffk::DType); int8 and fp8 are
# quantized KV-pool storage only, the kernels compute in f32 or bf16
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
                torch.float8_e4m3fn: 3}
COMPUTE_DTYPES = (torch.float32, torch.bfloat16)
QUANT_DTYPES = (torch.int8, torch.float8_e4m3fn)
# head dims the flash kernels (1, 2) are instantiated for (csrc launch_d
# switches; bf16 at 80, 96 and 256 runs the CUDA-core kernels) and those the
# paged attention kernel (4) is
HEAD_DIMS = (32, 64, 80, 96, 128, 256)
PAGED_HEAD_DIMS = (32, 64, 128)


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
        log, failed = [], []
        for name, _, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {name}\n{out}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {name}:\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
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
                    p, p, p, p, p, i, i, i, i, i, i, i, f, i, p]
                lib.ff_flash_attention_bwd.argtypes = [
                    p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, f, i,
                    i, p]
                lib.ff_fused_add_layernorm_fwd.argtypes = [
                    p, p, p, p, p, p, p, p, i, i, i, f, p]
                lib.ff_paged_attention_fwd.argtypes = [
                    p, p, p, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i,
                    i, i, i, i, f, p]
                pp = ctypes.POINTER(ctypes.c_void_p)
                lib.ff_paged_prefill_write_layers.argtypes = [
                    pp, pp, pp, pp, pp, pp, i, p, i, i, i, i, i, i, i, i, i,
                    i, p]
                ll = ctypes.c_longlong
                ip = ctypes.POINTER(i)
                lib.ff_fused_update.argtypes = [
                    pp, pp, pp, pp, ctypes.POINTER(ll), ip, ip, ip, i, ll, i,
                    i, i, f, f, f, f, f, f, f, p, p, p, p]
                for fn in (lib.ff_flash_attention_fwd,
                           lib.ff_flash_attention_bwd,
                           lib.ff_fused_add_layernorm_fwd,
                           lib.ff_paged_attention_fwd,
                           lib.ff_paged_prefill_write_layers,
                           lib.ff_fused_update):
                    fn.restype = ctypes.c_int
                self._lib = lib
            return self._lib


LIBRARY = _Library()


_THREAD = threading.local()


@contextlib.contextmanager
def _on_device(device: torch.device):
    """torch's device guard, with the device's primary context made
    current on this thread. The library's CUDA runtime is linked
    statically, beside torch's: it launches into the context current on
    the calling thread, and a thread from which torch has launched nothing
    has none (a serving replica's driver thread, say), where the launch
    fails (cudaErrorInvalidValue). ``torch.cuda.set_device`` makes it
    current, once a thread and device."""
    with torch.cuda.device(device):
        idx = torch.cuda.current_device()
        bound = getattr(_THREAD, "bound", None)
        if bound is None:
            bound = _THREAD.bound = set()
        if idx not in bound:
            torch.cuda.set_device(idx)
            bound.add(idx)
        yield


def _check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name: str, *tensors: torch.Tensor):
    """Every tensor on one CUDA device and contiguous; raise otherwise.
    (``is_cuda`` and ``get_device`` rather than ``device``, which builds
    an object: the prefill write checks ~200 tensors a call.)"""
    idx = tensors[0].get_device()
    for t in tensors:
        if not t.is_cuda or t.get_device() != idx:
            raise ValueError(
                f"{name}: all tensors must lie on one CUDA device (got "
                f"{[str(x.device) for x in tensors]})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """Every tensor lies on the CPU (the plain version runs). A DTensor
    raises: a kernel takes local shards only (``parallel.local_shard``),
    and a DTensor on the CPU must never fall through to the plain
    version."""
    for t in tensors:
        if type(t) is not torch.Tensor and is_dtensor(t):
            raise TypeError(
                "a kernel wrapper was given a DTensor: run the kernel on "
                "local shards through flexflow_tpu_torch.parallel."
                "local_shard")
    return all(t.is_cpu for t in tensors)


# ------------------------------------------------------- flash attention


def _causal_mask(sq: int, sk: int, device) -> torch.Tensor:
    """(Sq, Sk) bool, True where query i may attend key j: j <= i + sk - sq
    (bottom-right alignment, the JAX ``_causal_mask`` rule)."""
    return torch.ones(sq, sk, dtype=torch.bool, device=device).tril(
        diagonal=sk - sq)


def flash_attention_plain(q, k, v, causal: bool, scale: float,
                          need_lse: bool = False):
    """Plain version of ``flash_attention_fwd``: the einsum-softmax branch
    of the JAX dense path (flexflow_tpu/ops/attention.py:795-806), with
    GQA's kv heads repeated to the query heads first (``_broadcast_kv``).
    Scores and softmax in f32; probabilities enter the P.V product in the
    value dtype. With ``need_lse`` also the logsumexp of the scaled, masked
    f32 logits, (B, H, Sq)."""
    h, kvh = q.shape[2], k.shape[2]
    if kvh != h:
        k = k.repeat_interleave(h // kvh, dim=2)
        v = v.repeat_interleave(h // kvh, dim=2)
    logits = torch.einsum("bqhk,bshk->bhqs", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(logits.shape[-2], logits.shape[-1], q.device)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhqs,bshk->bqhk", probs, v)
    if need_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _attention_refusal(q, k, v, causal: bool, *aligned) -> Optional[str]:
    """Why the flash kernels do not take q/k/v (None if they do): dtypes
    other than f32 / bf16 or not shared, k/v shapes that do not match q
    (unequal q and v head dims among them), head dims they are not built
    for, heads not a multiple of kv heads, causal attention with more
    queries than keys, or (bf16, read by TMA) a tensor of q, k, v and
    ``aligned`` not 16-byte aligned."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        return "q/k/v must be (B, S, H, D)"
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if q.dtype not in COMPUTE_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        return f"q/k/v must share a dtype in {list(COMPUTE_DTYPES)}"
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape:
        return (f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do not match "
                f"q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h % kvh:
        return (f"head dim {d} (supported {HEAD_DIMS}) or heads {h} not a "
                f"multiple of kv heads {kvh}")
    if causal and sq > sk:
        return f"causal attention needs sq <= sk (got {sq} > {sk})"
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 for t in (q, k, v) + aligned):
        return "bf16 tensors must be 16-byte aligned"
    return None


def _check_attention(name, q, k, v, causal: bool, *aligned):
    """Raise ``ValueError`` for q/k/v the flash kernels do not take."""
    why = _attention_refusal(q, k, v, causal, *aligned)
    if why is not None:
        raise ValueError(f"{name}: {why}")


def flash_attention_takes(q, k, v, causal: bool) -> bool:
    """Whether ``flash_attention_fwd`` (and, with kv heads equal to heads,
    ``flash_attention_bwd``) launches its kernel for these q/k/v rather
    than raise: the checks the wrappers make, from shapes, dtypes and
    alignment alone. The attention op routes the shapes it refuses to its
    own torch code, as the JAX op's ``_flash_ok`` routes them off its
    Pallas kernel."""
    return _attention_refusal(q, k, v, causal) is None


def flash_attention_fwd(q, k, v, causal: bool, scale: float,
                        need_lse: bool = False):
    """Attention forward on q (B, Sq, H, D), k/v (B, Sk, KVH, D) ->
    (B, Sq, H, D) in q's dtype; causal masking aligned bottom-right. With
    ``need_lse`` returns (out, lse), lse the (B, H, Sq) f32 logsumexp the
    backward needs.

    Replaces ``flash_attention_fwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:180). bf16 runs on the tensor cores
    (``csrc/flash_attention_wgmma.cu``): one block per (batch*head, 128-row
    q tile), a producer warp streaming 128-row K/V tiles by TMA, two
    warpgroups running Q K^T and P V as wgmma with the online softmax in
    registers between them. f32 runs on the CUDA cores
    (``csrc/flash_attention.cu``: 64-row q tiles, 32-row K/V tiles, f32
    products from shared memory). Both skip the tiles past the causal
    diagonal and write the lse from their final max and sum; the dtype
    alone chooses the kernel. Bound on the H100: bytes (q, k, v, o once
    each), by a small margin over the operations.
    """
    if _on_cpu(q, k, v):
        return flash_attention_plain(q, k, v, causal, scale, need_lse)
    name = "flash_attention_fwd"
    _require_cuda(name, q, k, v)
    _check_attention(name, q, k, v, causal)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    lse = (torch.empty(b, h, sq, dtype=torch.float32, device=q.device)
           if need_lse else None)
    with _on_device(q.device):
        _check(lib.ff_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None, _DTYPE_CODES[q.dtype], b,
            sq, sk, h, kvh, d, float(scale), int(bool(causal)), _stream(q)),
            name)
    _count(flash_attention_fwd)
    return (out, lse) if need_lse else out


flash_attention_fwd.launches = 0


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool,
                              scale: float, *, delta=None, dlse=None):
    """Plain version of ``flash_attention_bwd``: the FlashAttention-2
    arithmetic of the Pallas backward in einsums, f32 sums, with ds and p
    rounded to the input dtype before the products that consume them (as
    the Pallas kernels round them): p = exp(s - lse), dp = dO.V^T,
    delta = rowsum(dO * O) (or the caller's) - dlse, ds = p (dp - delta),
    dq = scale ds.K, dk = scale ds^T.Q, dv = p^T.dO."""
    f = torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(f), k.to(f)) * scale
    if causal:
        # the plain forward's mask value, so a row with no live key (causal
        # with sq > sk) gets the gradient of its uniform softmax
        s = torch.where(_causal_mask(s.shape[-2], s.shape[-1], q.device), s,
                        torch.finfo(f).min)
    p = torch.exp(s - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f), v.to(f))
    if delta is None:
        delta = (do.to(f) * o.to(f)).sum(-1).transpose(1, 2)  # (B, H, Sq)
    if dlse is not None:
        delta = delta - dlse
    ds = (p * (dp - delta[..., None])).to(q.dtype).to(f)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k.to(f)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.to(f)) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).to(f), do.to(f))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool, scale: float, *,
                        delta=None, dlse=None):
    """Attention backward: q, o, dO (B, Sq, H, D), k/v (B, Sk, H, D), lse
    (B, H, Sq) f32 from ``flash_attention_fwd`` -> (dq, dk, dv) in q's
    dtype. Kv heads must equal heads (the dense path broadcasts GQA's kv
    heads first); the reduction of dk/dv over a query group is not ported.
    ``delta`` ((B, H, Sq) f32, rowsum(dO * O) computed by the caller) skips
    the delta kernel; ``dlse`` ((B, H, Sq) f32, a cotangent of the lse) is
    folded in as ds = p (dp - delta + dlse) — the ``delta_precomputed`` and
    ``dlse`` arguments of the Pallas backward.

    Replaces ``flash_attention_bwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:335): a delta kernel (rowsum(dO * O), unless delta is
    given), then a dq kernel (one block per (batch*head, q tile) streaming
    K/V tiles) and a dk/dv kernel (one block per (batch*head, k tile)
    streaming q/dO tiles), each output written once, no atomics. bf16 runs
    them on the tensor cores (``csrc/flash_attention_bwd_wgmma.cu``: TMA
    rings, wgmma products, p and ds as register operands), f32 on the CUDA
    cores (``csrc/flash_attention_bwd.cu``); the dtype alone chooses. One
    call counts as one launch. Bound on the H100: operations.
    """
    name = "flash_attention_bwd"
    if k.shape[2] != q.shape[2]:
        raise ValueError(
            f"{name}: kv heads {k.shape[2]} != heads {q.shape[2]}: the "
            f"grouped-query backward is not ported (ROADMAP.md queue 2, "
            f"kernel 2); broadcast kv heads before attention")
    extra = tuple(t for t in (delta, dlse) if t is not None)
    for tag, t in (("delta", delta), ("dlse", dlse)):
        if t is not None and (t.shape != lse.shape
                              or t.dtype != torch.float32):
            raise ValueError(f"{name}: {tag} must be (B, H, Sq) f32 like lse "
                             f"{tuple(lse.shape)}, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if _on_cpu(q, k, v, o, lse, do, *extra):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal, scale,
                                         delta=delta, dlse=dlse)
    _require_cuda(name, q, k, v, o, lse, do, *extra)
    _check_attention(name, q, k, v, causal, do)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype:
        raise ValueError(f"{name}: o and dO must match q {tuple(q.shape)} "
                         f"{q.dtype}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"{name}: lse must be (B, H, Sq) f32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    lib = LIBRARY.get()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    compute = delta is None
    delta = torch.empty_like(lse) if compute else delta.contiguous()
    if dlse is not None:
        dlse = dlse.contiguous()
    with _on_device(q.device):
        _check(lib.ff_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(),
            dlse.data_ptr() if dlse is not None else None, dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _DTYPE_CODES[q.dtype], b, sq, sk,
            h, d, float(scale), int(bool(causal)), int(compute), _stream(q)),
            name)
    _count(flash_attention_bwd)
    return dq, dk, dv


flash_attention_bwd.launches = 0


class _FlashAttention(torch.autograd.Function):
    """The custom VJP of the JAX ``flash_attention`` (pallas_kernels.py:
    538-565): the forward keeps q, k, v, o and the lse; the backward is
    ``flash_attention_bwd``. Without a gradient to take the forward skips
    the lse, as the JAX primal does."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.causal, ctx.scale = causal, scale
        if not any(ctx.needs_input_grad[:3]):
            return flash_attention_fwd(q, k, v, causal, scale)
        o, lse = flash_attention_fwd(q, k, v, causal, scale, need_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal: bool = False,
                    scale: Optional[float] = None):
    """Differentiable flash attention on (B, S, H, D) q/k/v (kv heads ==
    heads for a gradient): ``flash_attention_fwd`` forward,
    ``flash_attention_bwd`` backward. ``scale`` defaults to 1/sqrt(D)."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, causal, s)


# ------------------------------------------------- fused add + layernorm


def fused_add_layernorm_plain(x, r, scale, bias, eps: float):
    """Plain version of ``fused_add_layernorm_fwd``: the f32-stats branch of
    the JAX ``AddLayerNorm`` (flexflow_tpu/ops/norm.py:189-197) with the
    kernel's stats: s = x + r in x's dtype; mean and the two-pass variance
    of s in f32; y in x's dtype. Returns (s, y, mean, rstd), stats (N,)."""
    s = x + r
    sf = s.float()
    mean = sf.mean(dim=-1)
    centered = sf - mean[:, None]
    rstd = torch.rsqrt((centered * centered).mean(dim=-1) + eps)
    y = centered * rstd[:, None] * scale.float() + bias.float()
    return s, y.to(s.dtype), mean, rstd


def _add_layernorm_refusal(x, r, scale, bias) -> Optional[str]:
    """Why the add + LayerNorm kernel does not take these (N, D) rows
    (None if it does): dtypes other than f32 / bf16 or not shared, shapes
    that do not match, a row width not a multiple of 8 or wider than the
    4096 16-byte vectors a block holds, a tensor not 16-byte aligned."""
    if x.dim() != 2:
        return f"x must be (N, D) rows, got {tuple(x.shape)}"
    d = x.shape[1]
    if x.dtype not in COMPUTE_DTYPES or any(
            t.dtype != x.dtype for t in (r, scale, bias)):
        return (f"x, r, scale and bias must share a dtype in "
                f"{list(COMPUTE_DTYPES)}")
    if r.shape != x.shape or scale.shape != (d,) or bias.shape != (d,):
        return (f"r {tuple(r.shape)} must match x {tuple(x.shape)}, "
                f"scale/bias must be ({d},)")
    if d % 8 or any(t.data_ptr() % 16 for t in (x, r, scale, bias)):
        return (f"the row width ({d}) must be a multiple of 8 and every "
                f"tensor 16-byte aligned")
    if d * x.element_size() > 4096 * 16:
        return (f"a row of {d} values exceeds the 4096 16-byte vectors one "
                f"block holds")
    return None


def fused_add_layernorm_takes(x, r, scale, bias) -> bool:
    """Whether ``fused_add_layernorm_fwd`` launches its kernel for these
    rows rather than raise: the wrapper's checks, from shapes, dtypes and
    alignment alone. ``AddLayerNorm`` sends the rows it refuses through its
    own torch code, as the JAX op's ``_fused_ok`` sends them off its
    Pallas kernel."""
    return _add_layernorm_refusal(x, r, scale, bias) is None


def fused_add_layernorm_fwd(x, r, scale, bias, eps: float,
                            need_stats: bool = True):
    """(N, D) rows: (s, y, mean, rstd) with s = x + r and y = LayerNorm(s)
    * scale + bias, both in x's dtype; mean and rstd (N,) f32, or None
    without ``need_stats``.

    Replaces ``fused_add_layernorm_fwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:461) with ``csrc/fused_add_layernorm.cu``: a
    persistent grid (as many blocks as the card holds at once) strides over
    the rows; each thread keeps its slices of scale and bias in registers
    for every row, loads the next row's x and r while the current row
    reduces, and keeps the rounded s in registers between the mean,
    variance and normalise passes, so x and r are read once and s and y
    written once (streaming stores). Bound on the H100: bytes.
    """
    if _on_cpu(x, r, scale, bias):
        s, y, mean, rstd = fused_add_layernorm_plain(x, r, scale, bias, eps)
        return (s, y, mean, rstd) if need_stats else (s, y, None, None)
    name = "fused_add_layernorm_fwd"
    _require_cuda(name, x, r, scale, bias)
    why = _add_layernorm_refusal(x, r, scale, bias)
    if why is not None:
        raise ValueError(f"{name}: {why}")
    n, d = x.shape
    lib = LIBRARY.get()
    s = torch.empty_like(x)
    y = torch.empty_like(x)
    mean = rstd = None
    if need_stats:
        mean = torch.empty(n, dtype=torch.float32, device=x.device)
        rstd = torch.empty_like(mean)
    with _on_device(x.device):
        _check(lib.ff_fused_add_layernorm_fwd(
            x.data_ptr(), r.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            s.data_ptr(), y.data_ptr(),
            mean.data_ptr() if need_stats else None,
            rstd.data_ptr() if need_stats else None,
            _DTYPE_CODES[x.dtype], n, d, float(eps), _stream(x)), name)
    _count(fused_add_layernorm_fwd)
    return s, y, mean, rstd


fused_add_layernorm_fwd.launches = 0


class _FusedAddLayerNorm(torch.autograd.Function):
    """The custom VJP of the JAX ``fused_add_layernorm`` (pallas_kernels.py:
    502-532): the forward kernel keeps s and its mean and rstd; the
    backward is ``_add_ln_bwd_rule`` (:517) in torch arithmetic, f32."""

    @staticmethod
    def forward(ctx, x, r, scale, bias, eps):
        need = any(ctx.needs_input_grad[:4])
        s, y, mean, rstd = fused_add_layernorm_fwd(x, r, scale, bias, eps,
                                                   need_stats=need)
        if need:
            ctx.save_for_backward(s, mean, rstd, scale)
        return s, y

    @staticmethod
    def backward(ctx, gs, gy):
        s, mean, rstd, scale = ctx.saved_tensors
        f = torch.float32
        gyf = gy.to(f)
        xhat = (s.to(f) - mean[:, None]) * rstd[:, None]
        dbias = gyf.sum(dim=0).to(scale.dtype)
        dscale = (gyf * xhat).sum(dim=0).to(scale.dtype)
        t = gyf * scale.to(f)
        dsn = (t - t.mean(dim=-1, keepdim=True)
               - xhat * (t * xhat).mean(dim=-1, keepdim=True)) * rstd[:, None]
        d = (dsn + gs.to(f)).to(s.dtype)
        # x and r get equal gradients; separate tensors, so accumulating
        # into one never writes through to the other
        return d, d.clone(), dscale, dbias, None


def fused_add_layernorm(x, r, scale, bias, eps: float = 1e-5):
    """Differentiable (x + r, LayerNorm(x + r) * scale + bias) on (N, D)
    rows: ``fused_add_layernorm_fwd`` forward, torch backward."""
    return _FusedAddLayerNorm.apply(x, r, scale, bias, eps)


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


def take_pages(pool, idx):
    """``pool[idx]`` along the page axis, through a byte view for one-byte
    (int8 / fp8) pools: advanced indexing of float8 tensors is not
    implemented on every device and version."""
    if pool.element_size() == 1:
        return pool.view(torch.uint8)[idx].view(pool.dtype)
    return pool[idx]


def put_pages(pool, idx, x):
    """``pool[idx] = x`` (x already in the pool's dtype), in place, through
    a byte view for one-byte pools."""
    if pool.element_size() == 1:
        pool.view(torch.uint8)[idx] = x.view(torch.uint8)
    else:
        pool[idx] = x


def paged_attention_plain(q, k_pages, v_pages, page_table, write_pos,
                          row_len, prompt_pad, scale: float, k_scales=None,
                          v_scales=None):
    """Plain version of ``paged_attention_fwd``: the page-gather branch of
    the JAX ``_paged_attention_ctx`` (attention.py:638-651) — gather each
    slot's pages into a logical (B, L, KVH, D) cache (dequantized against
    the pages' scales for a quantized pool, ``page_dequantize``), then the
    grouped einsum attention under the live rule, which casts the cache to
    q's dtype (the JAX einsum oracle's cast)."""
    from flexflow_tpu_torch.ops.attention import page_dequantize

    b = q.shape[0]
    max_len = page_table.shape[1] * k_pages.shape[1]
    table = page_table.long()
    gk = take_pages(k_pages, table)                 # (B, P, ps, KVH, D)
    gv = take_pages(v_pages, table)
    if k_scales is not None:
        gk = page_dequantize(gk, k_scales[table])
        gv = page_dequantize(gv, v_scales[table])
    gk = gk.reshape(b, max_len, *k_pages.shape[2:])
    gv = gv.reshape(b, max_len, *v_pages.shape[2:])
    idx = torch.arange(max_len, device=q.device)
    live = (idx[None, None, :] < row_len[:, None, None]) \
        | ((idx[None, None, :] >= prompt_pad[:, None, None])
           & (idx[None, None, :] <= write_pos[:, :, None]))
    return grouped_cache_attention(q, gk, gv, live[:, None, None, :, :],
                                   scale)


def _check_scales(name, pool_k, pool_v, k_scales, v_scales):
    """A quantized (int8 / fp8) pool comes with both (P, KVH) f32 scale
    planes, and only a quantized pool does; raise otherwise."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError(f"{name}: a quantized pool carries both k and v "
                         f"scales")
    quant = pool_k.dtype in QUANT_DTYPES
    if quant != (k_scales is not None):
        raise ValueError(
            f"{name}: scales go with an int8 / fp8 pool and only with one "
            f"(pool {pool_k.dtype}, scales "
            f"{'given' if k_scales is not None else 'missing'})")
    if quant:
        want = (pool_k.shape[0], pool_k.shape[2])
        for t in (k_scales, v_scales):
            if t.dtype != torch.float32 or tuple(t.shape) != want:
                raise ValueError(f"{name}: scales must be {want} f32, got "
                                 f"{tuple(t.shape)} {t.dtype}")
    if pool_v.dtype != pool_k.dtype:
        raise ValueError(f"{name}: k and v pools differ in dtype")


#: query rows a paged-attention block holds (csrc/paged_attention.cu kRows)
PAGED_ROWS = 16
#: the split count aims at this many blocks an SM (as many as fit at once:
#: the bf16 D = 128 kernel's tiles take 105 KB of shared memory)
PAGED_BLOCKS_PER_SM = 2
#: a split covers whole pages and at least this many positions
PAGED_MIN_SPLIT = 64
#: at most this many splits (csrc/paged_attention.cu kMaxSplits)
PAGED_MAX_SPLITS = 32


class PagedPlan(NamedTuple):
    """The paged-attention kernel's launch: ``grid`` (slot x kv head x row
    chunk, split), ``splits`` runs of ``split_pages`` pages each."""
    grid: Tuple[int, int]
    splits: int
    split_pages: int
    threads: int = 128

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


@functools.lru_cache(maxsize=256)
def paged_attention_plan(b: int, s: int, h: int, kvh: int, page_size: int,
                         pages_per_slot: int, sms: int,
                         decode_splits: bool = False) -> PagedPlan:
    """How ``paged_attention_fwd`` splits the slots' positions across
    blocks, from the shapes and the card's SM count alone (never from
    row_len or write_pos, which live on the device): enough whole-page
    splits that the grid holds about ``PAGED_BLOCKS_PER_SM`` blocks on
    each of the card's ``sms`` SMs, none shorter than ``PAGED_MIN_SPLIT``
    positions, at most ``PAGED_MAX_SPLITS`` of them. ``decode_splits``
    sizes the splits for one query position a slot whatever S, so each
    position of a speculative verify slab splits its keys as a decode step
    does and its attention is bitwise a decode step's
    (``attention.verify_as_decode``)."""
    row_chunks = -(-s * (h // kvh) // PAGED_ROWS)
    base = b * kvh * row_chunks
    sized_for = b * kvh * -(-(1 if decode_splits else s) * (h // kvh)
                            // PAGED_ROWS)
    want = max(1, -(-PAGED_BLOCKS_PER_SM * sms // sized_for))
    split_pages = min(pages_per_slot,
                      max(-(-pages_per_slot // want),
                          -(-PAGED_MIN_SPLIT // page_size),
                          -(-pages_per_slot // PAGED_MAX_SPLITS)))
    splits = -(-pages_per_slot // split_pages)
    return PagedPlan((base, splits), splits, split_pages)


_SM_COUNTS: Dict[int, int] = {}
# per (device, stream): the int32 tickets the split kernel's blocks take to
# find the last of each (slot, kv head, row chunk) — every launch leaves
# them zero, so one zeroed buffer serves every launch on its stream — and
# the f32 workspace of the splits' partials, which a launch uses only while
# it runs, so launches on one stream share it (the decode step is
# host-bound: no allocation a call)
_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count (cudaDevAttrMultiProcessorCount), cached."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNTS[idx]


def _tickets(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=device)
        _TICKETS[key] = t
    return t


def _workspace(device: torch.device, stream: int, n: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _WORKSPACE.get(key)
    if t is None or t.numel() < n:
        t = torch.empty(n, dtype=torch.float32, device=device)
        _WORKSPACE[key] = t
    return t


def stream_scratch(device: torch.device, stream: int) -> list:
    """The split-KV tickets and workspace cached for (``device``,
    ``stream``). A CUDA graph captured on that stream holds their
    addresses, so its owner keeps them alive: a later, larger launch on the
    stream replaces the cached buffers, and the old ones must not return
    to the allocator while the graph replays."""
    key = (device.index, stream)
    return [t for t in (_TICKETS.get(key), _WORKSPACE.get(key))
            if t is not None]


def tickets_clear() -> bool:
    """Every cached ticket buffer is all zero, as each launch must leave
    it (the next launch's merge relies on it)."""
    return all(not t.any() for t in _TICKETS.values())


def paged_attention_fwd(q, k_pages, v_pages, page_table, write_pos, row_len,
                        prompt_pad, scale: float, k_scales=None,
                        v_scales=None, decode_splits: bool = False):
    """Decode attention over the paged pool: q (B, S, H, D), k/v pools
    (P, page_size, KVH, D), page_table (B, pages_per_slot), write_pos
    (B, S), row_len / prompt_pad (B,) int32 -> (B, S, H, D) in q's dtype.
    The pool stores q's dtype, bf16 under f32 q (the mixed-width pool), or
    int8 / fp8 with (P, KVH) f32 ``k_scales`` / ``v_scales``, one per
    (pool page, kv head).

    Replaces ``paged_attention_fwd_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:689) with ``csrc/paged_attention.cu``, split-KV in
    one launch: the grid is (slot x kv head x row chunk of up to 16 query
    rows, split), the splits runs of whole pages chosen by
    ``paged_attention_plan`` from the shapes and the SM count; each block
    streams its split's live K/V tiles by ``cp.async`` and writes a
    partial that the last block of its (slot, kv head, row chunk) merges
    in split order (deterministic). bf16 queries (bf16, int8 and fp8
    pools) run Q K^T and P V on the tensor cores (``mma.sync``, the raw
    int8 / fp8 payload exact in bf16, each page's scales applied to its
    positions' scores and probabilities); f32 queries (f32 and mixed-width
    pools) on the CUDA cores in f32. The f32 workspace of the partials is
    one buffer per (device, stream), kept between calls.
    ``decode_splits``: split as a decode step does whatever S
    (``paged_attention_plan``). ``launches`` counts wrapper calls: one a
    call,
    whatever the grid. Bound on the H100: bytes (the live K/V).
    """
    ints = (page_table, write_pos, row_len, prompt_pad)
    scales = tuple(t for t in (k_scales, v_scales) if t is not None)
    if _on_cpu(q, k_pages, v_pages, *ints, *scales):
        return paged_attention_plain(q, k_pages, v_pages, page_table,
                                     write_pos, row_len, prompt_pad, scale,
                                     k_scales, v_scales)
    name = "paged_attention_fwd"
    _require_cuda(name, q, k_pages, v_pages, *ints, *scales)
    _check_scales(name, k_pages, v_pages, k_scales, v_scales)
    b, s, h, d = q.shape
    n_pool, ps, kvh = k_pages.shape[:3]
    pps = page_table.shape[1]
    pool = k_pages.dtype
    if q.dtype not in COMPUTE_DTYPES or not (
            pool == q.dtype or pool in QUANT_DTYPES
            or (pool == torch.bfloat16 and q.dtype == torch.float32)):
        raise ValueError(f"{name}: a {q.dtype} query takes a pool of its own "
                         f"dtype, int8 / fp8 with scales, or bf16 under f32 "
                         f"(got {pool})")
    if k_pages.shape != (n_pool, ps, kvh, d) or v_pages.shape != k_pages.shape:
        raise ValueError(f"{name}: pool shapes {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d not in PAGED_HEAD_DIMS or h % kvh:
        raise ValueError(f"{name}: head dim {d} (supported {PAGED_HEAD_DIMS})"
                         f" or heads {h} not a multiple of kv heads {kvh}")
    if any(t.dtype != torch.int32 for t in ints) \
            or page_table.shape != (b, pps) or write_pos.shape != (b, s) \
            or row_len.shape != (b,) or prompt_pad.shape != (b,):
        raise ValueError(f"{name}: page_table (B, P), write_pos (B, S), "
                         f"row_len and prompt_pad (B,) must be int32")
    if any(t.data_ptr() % 16 for t in (q, k_pages, v_pages)):
        raise ValueError(f"{name}: q and the pools must be 16-byte aligned")
    lib = LIBRARY.get()
    out = torch.empty_like(q)
    plan = paged_attention_plan(b, s, h, kvh, ps, pps, sm_count(q.device),
                                decode_splits)
    stream = _stream(q)
    ws_acc = ws_ml = tickets = None
    if plan.splits > 1:
        n_part = plan.blocks * PAGED_ROWS
        ws_acc = _workspace(q.device, stream, n_part * (d + 2)).data_ptr()
        ws_ml = ws_acc + 4 * n_part * d
        tickets = _tickets(q.device, stream, plan.grid[0]).data_ptr()
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    with _on_device(q.device):
        _check(lib.ff_paged_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            ptr(k_scales), ptr(v_scales), page_table.data_ptr(),
            write_pos.data_ptr(), row_len.data_ptr(), prompt_pad.data_ptr(),
            out.data_ptr(), ws_acc, ws_ml, tickets, _DTYPE_CODES[q.dtype],
            _DTYPE_CODES[pool], b, s, h, kvh, d, ps, pps, plan.split_pages,
            float(scale), stream), name)
    _count(paged_attention_fwd)
    return out


paged_attention_fwd.launches = 0


# --------------------------------------------------- paged prefill write


def paged_prefill_write_plain(pool_k, pool_v, kh, vh, pages, k_scale=None,
                              v_scale=None):
    """Plain version of ``paged_prefill_write``: the scatter branch of the
    JAX ``paged_prefill_write`` (attention.py:493-517) — pad the slab to
    whole pages with zeros, reshape page-major, assign the listed pool
    pages (in place here): a cast into a native pool, or, with scales, each
    page quantized against its own per-kv-head scale (``page_scale``,
    ``page_quantize``), payload and scale both written."""
    from flexflow_tpu_torch.ops.attention import (page_quantize, page_scale,
                                                  storage_qmax)

    n_pages = pages.shape[0]
    ps = pool_k.shape[1]
    idx = pages.long()
    for pool, sc, x in ((pool_k, k_scale, kh), (pool_v, v_scale, vh)):
        x = x[0]                                        # (S, KVH, D)
        pad = n_pages * ps - x.shape[0]
        if pad:
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
        x = x.reshape(n_pages, ps, *x.shape[1:])
        if sc is None:
            put_pages(pool, idx, x.to(pool.dtype))
            continue
        qmax = storage_qmax(pool.dtype)
        pf = x.float()
        scale = page_scale(pf, qmax)                    # (n_pages, KVH)
        put_pages(pool, idx, page_quantize(pf, scale, qmax, pool.dtype))
        sc[idx] = scale


def paged_prefill_write_layers_plain(pools_k, pools_v, khs, vhs, pages,
                                     k_scales=None, v_scales=None):
    """Plain version of ``paged_prefill_write_layers``: the plain write of
    each layer in turn."""
    for i in range(len(pools_k)):
        paged_prefill_write_plain(
            pools_k[i], pools_v[i], khs[i], vhs[i], pages,
            k_scales[i] if k_scales is not None else None,
            v_scales[i] if v_scales is not None else None)


#: layers one launch writes (csrc/paged_prefill_write.cu kMaxLayers: six
#: pointers a layer, 3 KB of the kernel's 4 KB of parameters); more layers
#: go in several launches
PREFILL_WRITE_MAX_LAYERS = 64
#: a quantizing CTA holds at most this many 16-value units of its tile in
#: registers (csrc kQThreads x kQUnits)
PREFILL_WRITE_CTA_UNITS = 1024


def prefill_write_cluster(page_size: int, d: int) -> int:
    """CTAs of a thread block cluster that a quantizing or casting write
    gives each tile (layer, listed page, kv head, k-or-v) of page_size x d
    values: the fewest of 1, 2, 4 and 8 whose registers hold it (1 up to
    16384 values: a 128-row page of D = 128). From the shapes alone.
    Splitting a tile that one CTA holds, to fill the card when a launch has
    few tiles, was slower on the H100 (``scripts/
    torch_prefill_write_cluster_sweep.py``, PERF.md). Raises for a tile
    that 8 CTAs cannot hold."""
    c = 1
    while -(-page_size // c) * (d // 16) > PREFILL_WRITE_CTA_UNITS:
        c *= 2
        if c > 8:
            raise ValueError(
                f"paged_prefill_write: a page of {page_size} x {d} values "
                f"exceeds what a cluster of 8 CTAs holds")
    return c


def paged_prefill_write(pool_k, pool_v, kh, vh, pages, k_scale=None,
                        v_scale=None):
    """Write a prefilled (1, S, KVH, D) k/v slab into pool pages ``pages``
    ((n,) int32, n = ceil(S / page_size)), IN PLACE; rows past S in the
    last page become zeros. A native pool takes the slab's dtype (a copy);
    a bf16 pool takes an f32 slab (a cast); an int8 / fp8 pool takes an f32
    or bf16 slab with its (P, KVH) f32 ``k_scale`` / ``v_scale`` planes,
    and each listed page gets a fresh per-kv-head scale (amax / qmax over
    the page) and its quantized payload. The one-layer case of
    ``paged_prefill_write_layers`` (the same kernel, one launch)."""
    paged_prefill_write_layers(
        [pool_k], [pool_v], [kh], [vh], pages,
        [k_scale] if k_scale is not None else None,
        [v_scale] if v_scale is not None else None)


def _check_prefill_layer(name, pool_k, pool_v, kh, vh, k_scale, v_scale,
                         pages):
    """One layer's pools, slabs and scales as the kernel takes them, with
    ``pages``; raise otherwise."""
    _check_scales(name, pool_k, pool_v, k_scale, v_scale)
    ps = pool_k.shape[1]
    s = kh.shape[1]
    n_pages = pages.shape[0]
    if kh.dim() != 4 or kh.shape[0] != 1 \
            or kh.shape[2:] != pool_k.shape[2:] \
            or vh.shape[:2] != kh.shape[:2] \
            or vh.shape[2:] != pool_v.shape[2:] \
            or pool_v.shape[:3] != pool_k.shape[:3]:
        raise ValueError(f"{name}: slab {tuple(kh.shape)} / "
                         f"{tuple(vh.shape)} does not fit pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)}")
    if pages.dtype != torch.int32 or pages.dim() != 1 \
            or n_pages * ps < s or (n_pages - 1) * ps >= s:
        raise ValueError(f"{name}: pages must be (ceil(S / page_size),) "
                         f"int32 (S={s}, page_size={ps}, got "
                         f"{tuple(pages.shape)} {pages.dtype})")
    if vh.dtype != kh.dtype:
        raise ValueError(f"{name}: k and v slabs differ in dtype")
    if kh.dtype == pool_k.dtype and k_scale is None:
        return  # the copy: any dtype, any row size
    cast = pool_k.dtype == torch.bfloat16 and kh.dtype == torch.float32
    if kh.dtype not in COMPUTE_DTYPES or not (
            cast or pool_k.dtype in QUANT_DTYPES):
        raise ValueError(f"{name}: a {kh.dtype} slab cannot be written into "
                         f"a {pool_k.dtype} pool (copy: same dtype; cast: "
                         f"f32 into bf16; quantize: f32 / bf16 into int8 / "
                         f"fp8 with scales)")
    if pool_v.shape != pool_k.shape or pool_k.shape[3] % 16 or any(
            t.data_ptr() % 16 for t in (kh, vh, pool_k, pool_v)):
        raise ValueError(f"{name}: a quantizing or casting write needs equal "
                         f"k/v head dims that are multiples of 16 and "
                         f"16-byte aligned tensors (pools "
                         f"{tuple(pool_k.shape)} / {tuple(pool_v.shape)})")


def paged_prefill_write_layers(pools_k, pools_v, khs, vhs, pages,
                               k_scales=None, v_scales=None):
    """``paged_prefill_write`` for every layer of a prefill at once: equal-
    length lists of each layer's k/v pools, (1, S, KVH, D) k/v slabs and,
    for int8 / fp8 pools, (P, KVH) f32 k/v scale planes, all written into
    the same listed pages, IN PLACE. Every layer shares S, the page size,
    KVH, D, the dtypes and ``pages``; the wrapper checks it and raises
    otherwise.

    Replaces ``paged_prefill_write_pallas`` (flexflow_tpu/ops/
    pallas_kernels.py:779), which the JAX package calls once a layer, with
    ``csrc/paged_prefill_write.cu``: one launch writes up to
    ``PREFILL_WRITE_MAX_LAYERS`` layers, their pointers passed by value in
    the kernel's parameters (more layers take one launch a chunk, each
    counted). A copy moves each (layer, k-or-v, page) in the widest unit
    the alignment allows, all loads in flight before the stores; a
    quantizing or casting write takes one pass a tile (layer, page, kv
    head, k-or-v): loads in flight, the amax reduced in registers, warps
    and (for a tile too large for one CTA, ``prefill_write_cluster``)
    distributed shared memory, the scale computed once and the payload
    stored from the registers. The JAX kernel aliased the whole pool (and
    scale planes) to its output; updating in place saves a pool copy per
    prefill. Bound on the H100: bytes (slabs read, pages written).
    """
    name = "paged_prefill_write"
    n = len(pools_k)
    if n == 0 or not (len(pools_v) == len(khs) == len(vhs) == n) or any(
            sc is not None and len(sc) != n for sc in (k_scales, v_scales)):
        raise ValueError(f"{name}: pools, slabs and scales must be equal-"
                         f"length lists of at least one layer")
    ks = list(k_scales) if k_scales is not None else [None] * n
    vs = list(v_scales) if v_scales is not None else [None] * n
    layers = list(zip(pools_k, pools_v, khs, vhs, ks, vs))
    flat = [t for layer in layers for t in layer if t is not None]
    if _on_cpu(pages, *flat):
        return paged_prefill_write_layers_plain(pools_k, pools_v, khs, vhs,
                                                pages, k_scales, v_scales)
    _require_cuda(name, pages, *flat)
    pk0, pv0, kh0, vh0 = layers[0][:4]
    _check_prefill_layer(name, *layers[0], pages)
    for i in range(1, n):
        if any((a is None) != (b is None) or (a is not None and (
                a.shape != b.shape or a.dtype != b.dtype))
               for a, b in zip(layers[i], layers[0])):
            raise ValueError(f"{name}: layer {i} differs from layer 0 in "
                             f"shape, dtype or scales; every layer of one "
                             f"call must match")
    ps, kvh, dk = pk0.shape[1:]
    dv = pv0.shape[3]
    s, n_pages = kh0.shape[1], pages.shape[0]
    copy = kh0.dtype == pk0.dtype and ks[0] is None
    if not copy and any(t.data_ptr() % 16 for layer in layers[1:]
                        for t in layer[:4]):
        raise ValueError(f"{name}: a quantizing or casting write needs "
                         f"16-byte aligned tensors")
    lib = LIBRARY.get()
    stream = _stream(pk0)
    cluster = 1 if copy else prefill_write_cluster(ps, dk)
    pool_code = -1 if copy else _DTYPE_CODES[pk0.dtype]
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(  # noqa: E731
        *(t.data_ptr() for t in ts))
    for lo in range(0, n, PREFILL_WRITE_MAX_LAYERS):
        hi = min(n, lo + PREFILL_WRITE_MAX_LAYERS)
        with _on_device(pk0.device):
            _check(lib.ff_paged_prefill_write_layers(
                ptrs(khs[lo:hi]), ptrs(vhs[lo:hi]), ptrs(pools_k[lo:hi]),
                ptrs(pools_v[lo:hi]),
                ptrs(ks[lo:hi]) if ks[0] is not None else None,
                ptrs(vs[lo:hi]) if vs[0] is not None else None, hi - lo,
                pages.data_ptr(), n_pages, s, ps, kvh, dk, dv,
                kh0.element_size(), _DTYPE_CODES.get(kh0.dtype, -1),
                pool_code, cluster, stream), name)
        _count(paged_prefill_write)


paged_prefill_write.launches = 0


# ---------------------------------------------------------- fused update


class UpdateRule(NamedTuple):
    """An optimizer's elementwise update: ``kind`` "sgd" (``momentum``,
    ``nesterov``) or "adam" (``beta1``, ``beta2``, ``epsilon``), both with
    ``weight_decay``."""

    kind: str
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    @property
    def n_moments(self) -> int:
        """State vectors a weight carries: Adam's m and v, SGD's v with
        momentum."""
        if self.kind == "adam":
            return 2
        return 1 if self.momentum > 0.0 else 0


def update_math(rule: UpdateRule, w, g, moments, lr):
    """One update in f32, the JAX package's formulas
    (flexflow_tpu/runtime/optimizer.py SGDOptimizer / AdamOptimizer
    ``upd``): w, g and ``moments`` f32 tensors, ``lr`` a 0-dim f32 tensor
    (Adam's bias-corrected alpha_t). Returns (w, moments) anew. Each
    operation is a torch operator of its own, in the formula's order, so
    every result rounds once (never a fused multiply-add) and
    ``fused_update``'s kernel can match it bit for bit. ``g + wd w`` is
    skipped when wd is 0."""
    if rule.weight_decay:
        g = g + rule.weight_decay * w
    if rule.kind == "adam":
        m, v = moments
        m = rule.beta1 * m + (1.0 - rule.beta1) * g
        v = rule.beta2 * v + (1.0 - rule.beta2) * g * g
        return w - lr * m / (torch.sqrt(v) + rule.epsilon), (m, v)
    if rule.momentum > 0.0:
        (v,) = moments
        v = rule.momentum * v + g
        step = g + rule.momentum * v if rule.nesterov else v
        return w - lr * step, (v,)
    return w - lr * g, ()


def _select(finite, new, old):
    return new if finite is None else torch.where(finite, new, old)


def _flat_state(m):
    """A state vector of the flat form, or the per-leaf form's tensors
    concatenated in leaf order."""
    if torch.is_tensor(m):
        return m
    return torch.cat([x.reshape(-1) for x in m])


def _put_state(m, new) -> None:
    """Write the flat f32 ``new`` into state ``m`` (either form)."""
    if torch.is_tensor(m):
        m.copy_(new)
        return
    off = 0
    for x in m:
        x.copy_(new[off:off + x.numel()].view(x.shape))
        off += x.numel()


def fused_update_plain(rule: UpdateRule, params, grads, moments, lr,
                       finite=None) -> None:
    """Plain version of ``fused_update``: concatenate the bucket's weights
    and gradients (a gradient in f32 where its dtype differs from its
    weight's, as the JAX package's ``_flatten_grads`` upcasts) and its
    state (either form), apply ``update_math`` to the flat f32 vectors,
    and write the result back into the weights and the state, in place.
    With ``finite`` (0-dim bool) false, everything keeps its old value."""
    w = torch.cat([p.reshape(-1) for p in params]).float()
    g = torch.cat([x.reshape(-1).float() for x in grads])
    ms = [_flat_state(m).float() for m in moments]
    nw, nms = update_math(rule, w, g, ms, lr)
    nw = _select(finite, nw, w)
    off = 0
    for p in params:
        p.copy_(nw[off:off + p.numel()].view(p.shape))
        off += p.numel()
    for m, new, old in zip(moments, nms, ms):
        _put_state(m, _select(finite, new, old))


#: leaves a launch (csrc/fused_update.cu kMaxLeaves): the leaf table rides
#: in the kernel's parameters (CUDA >= 12.1's 32764-byte limit); a bucket
#: of more leaves takes more launches
FUSED_UPDATE_MAX_LEAVES = 128
#: threads a block and 16-byte vectors a thread a chunk (csrc/
#: fused_update.cu kThreads, kUnroll): a chunk is 4096 bf16 or 2048 f32
#: elements of one leaf
FUSED_UPDATE_THREADS = 128
FUSED_UPDATE_UNROLL = 4
# leaf flags (csrc/fused_update.cu LeafFlag)
_GRAD_F32, _VECTOR = 1, 2


class UpdatePlan(NamedTuple):
    """How ``fused_update``'s kernel cuts one launch's leaves: ``head[i]``
    leading elements of leaf i are updated one by one before its body
    takes 16-byte vectors of ``width`` elements (``vector[i]``; a leaf
    whose pointers cannot all be aligned at one element goes one by one
    throughout); leaf i has ``chunk_end[i] - chunk_end[i - 1]`` chunks of
    up to ``chunk`` elements, none across two leaves."""

    numel: Tuple[int, ...]
    head: Tuple[int, ...]
    vector: Tuple[bool, ...]
    chunk_end: Tuple[int, ...]
    width: int
    chunk: int


def fused_update_plan(numels, pointers, elem_size: int) -> UpdatePlan:
    """The kernel's cut of one launch's leaves, from their sizes and
    addresses alone (no tensor touched). ``numels[i]``: leaf i's elements;
    ``pointers[i]``: (address, element size) of each of its arrays, the
    weight first (then its gradient and state); ``elem_size``: the
    weights' (4 f32, 2 bf16).

    A leaf's head is where its weight pointer reaches a 16-byte boundary;
    the leaf takes vectors iff every one of its pointers is aligned at
    that element (an array's element j lies at address + j * size, and a
    vector advances 16 bytes of the weight: 8 bf16 or 4 f32, one or two
    16-byte loads of an f32 gradient). Its chunks: the first holds the
    head and up to ``chunk`` elements after it, each next one ``chunk``
    elements, the last the rest (``fused_update_chunk_spans``)."""
    width = 16 // elem_size
    chunk = FUSED_UPDATE_THREADS * FUSED_UPDATE_UNROLL * width
    heads, vectors, ends, end = [], [], [], 0
    for n, ptrs in zip(numels, pointers):
        head = (-ptrs[0][0]) % 16 // elem_size
        vec = True
        for p, s in ptrs:
            if p % s or (p + head * s) % 16:
                vec, head = False, 0
                break
        if n == 0:
            count = 0
        elif vec:
            count = 1 if n <= head else -(-(n - head) // chunk)
        else:
            count = -(-n // chunk)
        end += count
        heads.append(head)
        vectors.append(vec)
        ends.append(end)
    return UpdatePlan(tuple(numels), tuple(heads), tuple(vectors),
                      tuple(ends), width, chunk)


def fused_update_chunk_spans(plan: UpdatePlan, leaf: int, k: int):
    """Chunk k of ``leaf`` as the kernel walks it: (s0, a, b, e), elements
    [s0, a) one by one, [a, b) in vectors, [b, e) one by one — the
    arithmetic of csrc/fused_update.cu's loop, for the host's tests."""
    n, head, c = plan.numel[leaf], plan.head[leaf], plan.chunk
    if plan.vector[leaf]:
        s0 = 0 if k == 0 else head + k * c
        a = min(head, n) if k == 0 else s0
        e = min(n, head + (k + 1) * c)
        return s0, a, a + (e - a) // plan.width * plan.width, e
    s0 = k * c
    return s0, s0, s0, min(n, s0 + c)


def fused_update_vector_elements(plan: UpdatePlan) -> Tuple[int, ...]:
    """Elements of each leaf that the vector path updates."""
    return tuple((n - h) // plan.width * plan.width if v and n > h else 0
                 for n, h, v in zip(plan.numel, plan.head, plan.vector))


def _per_leaf_form(moments) -> bool:
    return bool(moments) and not torch.is_tensor(moments[0])


def _state_pointers(numels, moments) -> list:
    """Per state vector, the address of each leaf's state: the per-leaf
    form's tensors, or the flat form's vector at each leaf's offset."""
    if _per_leaf_form(moments):
        return [[x.data_ptr() for x in m] for m in moments]
    out = []
    for m in moments:
        ptrs, addr, size = [], m.data_ptr(), m.element_size()
        for n in numels:
            ptrs.append(addr)
            addr += n * size
        out.append(ptrs)
    return out


class UpdateLaunch(NamedTuple):
    """One launch of ``fused_update``: its first leaf's index, its plan,
    and each of its leaves' weight, grad and state addresses."""

    lo: int
    plan: UpdatePlan
    w: list
    g: list
    state: list   # per state vector, one address a leaf


def fused_update_launches(params, grads, moments):
    """``fused_update``'s launches for these tensors, one per
    ``FUSED_UPDATE_MAX_LEAVES`` leaves, from addresses and sizes alone
    (CPU tensors too)."""
    numels = [p.numel() for p in params]
    state = _state_pointers(numels, moments)
    size = params[0].element_size()
    w = [p.data_ptr() for p in params]
    g = [x.data_ptr() for x in grads]
    gsize = [x.element_size() for x in grads]
    out = []
    for lo in range(0, len(params), FUSED_UPDATE_MAX_LEAVES):
        hi = min(lo + FUSED_UPDATE_MAX_LEAVES, len(params))
        sl = [s[lo:hi] for s in state]
        ptrs = [[(w[i], size), (g[i], gsize[i])]
                + [(s[i - lo], size) for s in sl] for i in range(lo, hi)]
        out.append(UpdateLaunch(
            lo, fused_update_plan(numels[lo:hi], ptrs, size), w[lo:hi],
            g[lo:hi], sl))
    return out


def _check_update(name, rule, params, grads, moments, lr, finite):
    """Raise ``ValueError`` for what ``fused_update`` does not take. State
    comes in one of two forms: flat, a ``(total,)`` vector a moment; or
    per leaf, a list a moment of one tensor of each weight's shape."""
    dt = params[0].dtype
    if dt not in COMPUTE_DTYPES:
        raise ValueError(f"{name}: weights must be one of "
                         f"{list(COMPUTE_DTYPES)}, got {dt}")
    if len(grads) != len(params) or len(moments) != rule.n_moments:
        raise ValueError(f"{name}: {len(params)} weights, {len(grads)} "
                         f"grads, {len(moments)} state vectors (want "
                         f"{rule.n_moments} for {rule.kind})")
    for i, (p, g) in enumerate(zip(params, grads)):
        if p.dtype != dt or g.shape != p.shape \
                or g.dtype not in (dt, torch.float32):
            raise ValueError(
                f"{name}: leaf {i}: weight {tuple(p.shape)} {p.dtype}, grad "
                f"{tuple(g.shape)} {g.dtype}: weights share one dtype, a "
                f"grad has its weight's shape and its dtype or f32")
    per_leaf = _per_leaf_form(moments)
    total = sum(p.numel() for p in params)
    for m in moments:
        if torch.is_tensor(m) == per_leaf:
            raise ValueError(f"{name}: state must be all flat vectors or all "
                             f"lists of per-leaf tensors")
        if not per_leaf:
            if m.dtype != dt or m.shape != (total,):
                raise ValueError(f"{name}: state vectors must be ({total},) "
                                 f"{dt}, got {tuple(m.shape)} {m.dtype}")
            continue
        if len(m) != len(params):
            raise ValueError(f"{name}: per-leaf state of {len(m)} tensors "
                             f"for {len(params)} weights")
        for i, (x, p) in enumerate(zip(m, params)):
            if x.dtype != dt or x.shape != p.shape:
                raise ValueError(
                    f"{name}: leaf {i}: per-leaf state {tuple(x.shape)} "
                    f"{x.dtype} must match its weight {tuple(p.shape)} {dt}")
    _check_update_scalars(name, lr, finite)


def _check_update_scalars(name, lr, finite):
    if lr.shape != () or lr.dtype != torch.float32:
        raise ValueError(f"{name}: lr must be a 0-dim f32 tensor")
    if finite is not None and (finite.shape != ()
                               or finite.dtype != torch.bool):
        raise ValueError(f"{name}: finite must be a 0-dim bool tensor")


def _state_tensors(moments) -> list:
    return [x for m in moments for x in ([m] if torch.is_tensor(m) else m)]


def _update_key(rule, params, grads, moments) -> tuple:
    """What a bucket's launches depend on: every tensor's address, shape
    and dtype, the state's form and the rule's state count."""
    def sig(t):
        return t.data_ptr(), t.shape, t.dtype

    return (rule.n_moments, tuple(map(sig, params)), tuple(map(sig, grads)),
            tuple(sig(m) if torch.is_tensor(m) else tuple(map(sig, m))
                  for m in moments))


def _update_args(rule, params, grads, moments) -> list:
    """Each launch's table arguments for ``ff_fused_update`` as ctypes
    arrays: (w, g, m, v, numel, flags, head, chunk_end, leaves, chunk)."""
    c_ptrs = lambda xs: (ctypes.c_void_p * len(xs))(*xs)  # noqa: E731
    c_ints = lambda xs: (ctypes.c_int * len(xs))(*xs)  # noqa: E731
    out = []
    for x in fused_update_launches(params, grads, moments):
        plan = x.plan
        if plan.chunk_end[-1] == 0:
            continue
        n = len(plan.numel)
        flags = [(_GRAD_F32 if grads[x.lo + i].dtype != params[0].dtype
                  else 0) | (_VECTOR if vec else 0)
                 for i, vec in enumerate(plan.vector)]
        out.append((c_ptrs(x.w), c_ptrs(x.g),
                    c_ptrs(x.state[0]) if rule.kind == "adam" else None,
                    c_ptrs(x.state[-1]) if x.state else None,
                    (ctypes.c_longlong * n)(*plan.numel), c_ints(flags),
                    c_ints(plan.head), c_ints(plan.chunk_end), n, plan.chunk))
    return out


#: ``fused_update``'s checked launch arguments by ``_update_key``: a
#: training loop updates the same tensors every step, so the leaf checks,
#: the plan and the ctypes tables are made once (a hit is always right: the
#: plan is a function of addresses, sizes and dtypes alone)
_UPDATE_ARGS: "collections.OrderedDict[tuple, list]" = \
    collections.OrderedDict()
_UPDATE_ARGS_SIZE = 16


def fused_update(rule: UpdateRule, params, grads, moments, lr,
                 finite=None, vector_count=None) -> None:
    """The optimizer update of one bucket of weights of one storage dtype
    (f32 or bf16), in place: ``params`` and ``grads`` lists of tensors
    (each grad of its weight's shape, in its dtype or f32), ``moments``
    the state (v, or Adam's m and v; weight dtype), either flat — one
    ``(total,)`` vector a moment, one element a weight element in the
    order of ``params`` (``FusedUpdate``) — or per leaf — a list a moment
    of one tensor of each weight's shape (the per-leaf ``Optimizer``);
    ``lr`` a 0-dim f32 tensor (the scheduled learning rate, or Adam's
    alpha_t), ``finite`` an optional 0-dim bool tensor: false writes
    nothing.

    The port's own kernel (``csrc/fused_update.cu``), the counterpart of
    the JAX package's ``FusedUpdate`` (flexflow_tpu/runtime/optimizer.py:40),
    which XLA fuses into one loop a bucket; not a Pallas kernel. One
    launch takes up to ``FUSED_UPDATE_MAX_LEAVES`` leaves through a table
    of pointers (weight, grad, state) in its parameters: no concatenation
    pass, and both state forms give the kernel the same per-leaf pointers.
    It moves 16-byte vectors wherever a leaf's pointers align
    (``fused_update_plan``), over leaf-aligned chunks on a persistent
    grid; each element's arithmetic is ``update_math``'s, rounded
    operation by operation, so the result is bitwise the per-leaf torch
    update's. Each launch counts one. Bound on the H100: bytes (6, 10 or
    14 B an element in bf16 for SGD, SGD with momentum, Adam).

    ``vector_count``, a measurement only: an int64 ``(1,)`` tensor on the
    card to which the launches add the elements their 16-byte path stored
    (the CPU's plain version has no such path and refuses it)."""
    name = "fused_update"
    extra = (lr,) + (() if finite is None else (finite,))
    state = _state_tensors(moments)
    if _on_cpu(*params, *grads, *state, *extra):
        if vector_count is not None:
            raise ValueError(f"{name}: vector_count counts the card "
                             f"kernel's vector path; the CPU has none")
        return fused_update_plain(rule, params, grads, moments, lr, finite)
    if vector_count is not None:
        extra += (vector_count,)
        if vector_count.shape != (1,) or vector_count.dtype != torch.int64:
            raise ValueError(f"{name}: vector_count must be a (1,) int64 "
                             f"tensor")
    _require_cuda(name, *params, *grads, *state, *extra)
    _check_update_scalars(name, lr, finite)
    key = _update_key(rule, params, grads, moments)
    args = _UPDATE_ARGS.get(key)
    if args is None:
        _check_update(name, rule, params, grads, moments, lr, finite)
        args = _UPDATE_ARGS[key] = _update_args(rule, params, grads, moments)
        if len(_UPDATE_ARGS) > _UPDATE_ARGS_SIZE:
            _UPDATE_ARGS.popitem(last=False)
    else:
        _UPDATE_ARGS.move_to_end(key)
    # csrc/fused_update.cu Kind: SGD, momentum, nesterov, Adam
    kind = (3 if rule.kind == "adam" else 0 if rule.n_moments == 0
            else 2 if rule.nesterov else 1)
    lib = LIBRARY.get()
    stream = _stream(params[0])
    with _on_device(params[0].device):
        for table in args:
            _check(lib.ff_fused_update(
                *table, _DTYPE_CODES[params[0].dtype], kind,
                int(bool(rule.weight_decay)), rule.weight_decay,
                rule.momentum, rule.beta1, 1.0 - rule.beta1, rule.beta2,
                1.0 - rule.beta2, rule.epsilon, lr.data_ptr(),
                None if finite is None else finite.data_ptr(),
                None if vector_count is None else vector_count.data_ptr(),
                stream), name)
            _count(fused_update)


fused_update.launches = 0


KERNELS = (flash_attention_fwd, flash_attention_bwd, fused_add_layernorm_fwd,
           paged_attention_fwd, paged_prefill_write, fused_update)


# Launch counting and capture are safe under threads: several serving
# engines, each driven from its own thread, launch eagerly and capture
# their own CUDA graphs on one card. The counters are updated under one
# lock. A launch into the stream being captured (from the capturing
# thread, or from autograd's worker thread running a captured backward)
# is tallied for that capture only: the capture launches nothing, and
# each replay adds the tally; a launch elsewhere counts as a launch.
_COUNT_LOCK = threading.Lock()
#: the tally of the capture under way (one at a time: the gate below)
_ACTIVE_TALLY: Optional[Dict[str, int]] = None


def _count(fn) -> None:
    """Count one launch of wrapper ``fn``: into the capture under way when
    the launch's stream (the calling thread's current one) captures, else
    into the process-wide counter."""
    tally = _ACTIVE_TALLY
    with _COUNT_LOCK:
        if tally is not None and torch.cuda.is_current_stream_capturing():
            tally[fn.__name__] += 1
        else:
            fn.launches += 1


def launch_counts() -> Dict[str, int]:
    with _COUNT_LOCK:
        return {fn.__name__: fn.launches for fn in KERNELS}


def reset_launch_counts() -> None:
    with _COUNT_LOCK:
        for fn in KERNELS:
            fn.launches = 0


class _CaptureGate:
    """One capture at a time, and no other thread's device work while it
    runs. Device work — an engine's tick, its prefill, slab export and
    import, a weight swap — runs in ``shared`` sections, any number at
    once; a capture runs ``exclusive``: it waits until no other thread is
    inside a shared section and holds new ones off until it ends. A
    thread inside its own shared section may capture (an engine captures
    its decode chunk mid-tick): its shared hold is set aside while it
    waits and taken back after, so two threads capturing at once cannot
    deadlock. A shared section must not wait on another engine's lock or
    on a capture: engine methods take their own lock first, then the
    section."""

    def __init__(self):
        self._cv = threading.Condition(threading.Lock())
        self._active: Dict[int, int] = {}   # thread -> shared depth
        self._capturing: Optional[int] = None

    @contextlib.contextmanager
    def shared(self):
        me = threading.get_ident()
        with self._cv:
            if me not in self._active:
                while self._capturing not in (None, me):
                    self._cv.wait()
            self._active[me] = self._active.get(me, 0) + 1
        try:
            yield
        finally:
            with self._cv:
                n = self._active.pop(me) - 1
                if n:
                    self._active[me] = n
                else:
                    self._cv.notify_all()

    @contextlib.contextmanager
    def exclusive(self):
        me = threading.get_ident()
        with self._cv:
            mine = self._active.pop(me, 0)
            self._cv.notify_all()
            while self._capturing is not None or self._active:
                self._cv.wait()
            self._capturing = me
        try:
            yield
        finally:
            with self._cv:
                self._capturing = None
                if mine:
                    self._active[me] = mine
                self._cv.notify_all()


# Several serving engines, each driven from its own thread, share one card
# and capture their own CUDA graphs. While a stream captures, another
# thread's device work — an allocation, a blocking copy, the first launch
# of a kernel (which loads it) — can fail or invalidate the capture, so a
# capture takes the gate exclusively and every engine's device work runs
# in a shared section (``device_section``). The capture itself runs in
# CUDA's "thread_local" mode, so work of threads outside the gate (the
# host tier's publisher waiting on its events) is not refused, and on a
# non-blocking stream that no other live owner holds (``private_stream``):
# the legacy default stream that eager work runs on creates no implicit
# dependency on it, and no one else's launch can land in the graph. The
# collector stays off across one capture (a collection then could free a
# dead engine's graph, and destroying a graph while a stream captures
# invalidates the capture).
_GATE = _CaptureGate()


def device_section():
    """The shared side of the capture gate: device work that must not run
    while another thread captures."""
    return _GATE.shared()


_STREAM_OWNERS: Dict[Tuple[int, int], "weakref.ref"] = {}
_NONBLOCKING: Dict[Tuple[int, int], bool] = {}


def _stream_nonblocking(stream) -> bool:
    """Whether ``stream`` was created non-blocking (the driver's
    ``cuStreamGetFlags``, CU_STREAM_NON_BLOCKING = 1), cached."""
    key = (stream.device.index, stream.cuda_stream)
    if key not in _NONBLOCKING:
        import ctypes

        libcuda = ctypes.CDLL("libcuda.so.1")
        flags = ctypes.c_uint(0)
        rc = libcuda.cuStreamGetFlags(ctypes.c_void_p(stream.cuda_stream),
                                      ctypes.byref(flags))
        if rc != 0:
            raise RuntimeError(f"cuStreamGetFlags failed ({rc})")
        _NONBLOCKING[key] = bool(flags.value & 1)
    return _NONBLOCKING[key]


def private_stream(device: torch.device,
                   owner=None) -> "torch.cuda.Stream":
    """A side stream for ``owner``'s programs that no other live owner
    holds. ``torch.cuda.Stream`` hands out a small pool of streams in turn,
    so a long-lived process could give two engines one stream; another
    engine's work on a stream that captures would land in the graph. The
    stream is held while ``owner`` lives (weakly referenced), or for the
    process's life without one."""
    with _COUNT_LOCK:
        for _ in range(64):     # the pool's streams, each at most twice
            s = torch.cuda.Stream(device)
            key = (s.device.index, s.cuda_stream)
            ref = _STREAM_OWNERS.get(key)
            if ref is None or ref() is None:
                _STREAM_OWNERS[key] = (weakref.ref(owner) if owner is not None
                                       else (lambda: True))
                return s
    raise RuntimeError("every pooled CUDA stream is held by a live "
                       "engine or program: release some first")


def capture(graph, stream, fn):
    """Capture ``fn()`` into the CUDA graph ``graph`` on ``stream``
    (``torch.cuda.graph``, "thread_local" mode, the gate held exclusively;
    see above); returns fn's outputs and the launches the capture
    recorded, which each replay adds (``add_launches``). ``stream`` must be
    non-blocking; a failed capture raises."""
    if not _stream_nonblocking(stream):
        raise RuntimeError("a program captures on a non-blocking stream "
                           "only (torch.cuda.Stream)")
    global _ACTIVE_TALLY
    with _GATE.exclusive():
        enabled = gc.isenabled()
        gc.disable()
        tally = {f.__name__: 0 for f in KERNELS}
        _ACTIVE_TALLY = tally
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode="thread_local"):
                outs = fn()
        finally:
            _ACTIVE_TALLY = None
            if enabled:
                gc.enable()
    return outs, dict(tally)


def add_launches(launches: Dict[str, int]) -> None:
    """Count a replay of a graph whose capture recorded ``launches``."""
    with _COUNT_LOCK:
        for fn in KERNELS:
            fn.launches += launches[fn.__name__]
