"""ctypes bridge to the native threaded dataloader (runtime/csrc/
dataloader.cc; the JAX package's ``runtime/native_loader.py``).

Groups the model's ``SingleDataLoader``s into ONE native loader so the
sample permutation stays consistent across input and label arrays (the
reference shares one ``SampleIdxs`` argmap across its loaders —
flexflow_dataloader.h:88-141). Worker threads gather shuffled batch slices
into a ring of prefetch slots, overlapping host-side batch assembly with
the device's step. The library is the port's own copy of the C++ source,
built at first use with g++ into ``build/`` beside the package (listed in
.gitignore).

``next_batch()`` returns numpy copies of a slot, as the JAX loader does;
``next_batch(out)`` copies each slot straight into the caller's buffers
(the pipeline's pinned ring on the card: one host copy, then a
non-blocking copy to the device) and releases the slot after the copy.
Where the library cannot be built or loaded, ``group_loader_for`` falls
back to Python slicing, as the JAX package does, but says so: a warning
and ``COUNTERS["fallbacks"]``.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.runtime import locks

log = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "csrc" / "dataloader.cc"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")
#: where the library is built: ``build/`` beside the package, one file per
#: source and flags hash
BUILD_DIR = (Path(__file__).resolve().parents[2] / "build"
             / "flexflow_tpu_torch_dataloader")
_lib = None
_lib_lock = locks.make_lock("native-loader")

#: batches the native loader served, and the fits that fell back to
#: Python slicing because the library would not build or load
COUNTERS: Dict[str, int] = {"batches": 0, "fallbacks": 0}


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes())
    return BUILD_DIR / f"libffdl-{h.hexdigest()[:16]}.so"


def load_lib():
    """Build (once per source hash) and load libffdl; None when it cannot
    be built or loaded. A failure is remembered, so ``fit`` does not run
    g++ again every call. The build writes a temporary file and renames
    it, so concurrent processes never load a half-written library."""
    global _lib
    with _lib_lock:
        if _lib is False:
            return None
        if _lib is not None:
            return _lib
        from flexflow_tpu_torch.runtime.resilience import retry

        path = lib_path()

        # a concurrent build can race this one (a just-renamed library,
        # transient fs errors): retry once; no g++ at all
        # (FileNotFoundError) is permanent
        @retry(attempts=2, base_delay=0.1,
               retryable=lambda e: isinstance(
                   e, (OSError, subprocess.CalledProcessError))
               and not isinstance(e, FileNotFoundError),
               name="native dataloader build")
        def _build_and_open():
            if not path.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = f"{path}.{os.getpid()}.tmp"
                subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)],
                               check=True, capture_output=True)
                os.rename(tmp, path)
            return ctypes.CDLL(str(path))

        try:
            lib = _build_and_open()
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native dataloader unavailable (%s: %s)",
                        type(e).__name__, e)
            _lib = False
            return None
        lib.ffdl_create.restype = ctypes.c_void_p
        lib.ffdl_create.argtypes = [
            ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64, ctypes.c_int, ctypes.c_int]
        lib.ffdl_num_batches.restype = ctypes.c_int64
        lib.ffdl_num_batches.argtypes = [ctypes.c_void_p]
        lib.ffdl_next.restype = ctypes.c_int
        lib.ffdl_next.argtypes = [ctypes.c_void_p]
        lib.ffdl_buffer.restype = ctypes.c_void_p
        lib.ffdl_buffer.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int]
        lib.ffdl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.ffdl_reset.argtypes = [ctypes.c_void_p]
        lib.ffdl_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class NativeBatchLoader:
    """One prefetching loader over N parallel (name, array) streams."""

    def __init__(self, arrays: Sequence[Tuple[str, np.ndarray]],
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 prefetch_slots: int = 3, num_threads: int = 2):
        lib = load_lib()
        if lib is None:
            raise RuntimeError("native dataloader unavailable (no g++?)")
        self._lib = lib
        self.names = [n for n, _ in arrays]
        # C-contiguous arrays kept alive for the loader's life: the C++
        # side reads them directly
        self.arrays = [np.ascontiguousarray(a) for _, a in arrays]
        ns = {a.shape[0] for a in self.arrays}
        if len(ns) != 1:
            raise ValueError(f"arrays disagree on num_samples: {ns}")
        self.num_samples = ns.pop()
        self.batch_size = batch_size
        self.sample_shapes = [a.shape[1:] for a in self.arrays]
        self.dtypes = [a.dtype for a in self.arrays]
        self._nbytes = [batch_size * int(np.prod(s, dtype=np.int64))
                        * d.itemsize
                        for s, d in zip(self.sample_shapes, self.dtypes)]
        n = len(self.arrays)
        ptrs = (ctypes.c_void_p * n)(
            *[a.ctypes.data_as(ctypes.c_void_p).value for a in self.arrays])
        sbytes = (ctypes.c_int64 * n)(
            *[int(np.prod(s, dtype=np.int64)) * d.itemsize
              for s, d in zip(self.sample_shapes, self.dtypes)])
        self._h = lib.ffdl_create(
            n, ptrs, sbytes, self.num_samples, batch_size,
            1 if shuffle else 0, seed, prefetch_slots, num_threads)
        if not self._h:
            raise RuntimeError("ffdl_create failed (batch_size > "
                               "num_samples?)")
        self.num_batches = int(lib.ffdl_num_batches(self._h))
        self._served = 0

    def batch_shapes(self) -> Dict[str, Tuple[Tuple[int, ...], np.dtype]]:
        """{name: (batch shape, numpy dtype)} of every stream."""
        return {n: ((self.batch_size,) + tuple(s), d) for n, s, d in
                zip(self.names, self.sample_shapes, self.dtypes)}

    def reset(self):
        self._lib.ffdl_reset(self._h)
        self._served = 0

    def next_batch(self, out: Optional[Dict[str, torch.Tensor]] = None):
        """The next prefetched batch, None at the end of the epoch. Without
        ``out``: {name: numpy copy}. With ``out`` ({name: contiguous host
        tensor of the batch's shape and dtype}): the slot is copied into
        those tensors, which are returned."""
        if self._h is None:
            raise RuntimeError("loader destroyed")
        slot = self._lib.ffdl_next(self._h)
        if slot < 0:
            return None
        res = {}
        try:
            for i, name in enumerate(self.names):
                ptr = self._lib.ffdl_buffer(self._h, slot, i)
                buf = (ctypes.c_char * self._nbytes[i]).from_address(ptr)
                shape = (self.batch_size,) + tuple(self.sample_shapes[i])
                if out is None:
                    res[name] = np.frombuffer(buf, dtype=self.dtypes[i]) \
                        .reshape(shape).copy()
                else:
                    dst = out[name]
                    # one copy, slot -> the caller's buffer (torch's copy
                    # runs without the GIL)
                    dst.view(-1).view(torch.uint8).copy_(
                        torch.frombuffer(buf, dtype=torch.uint8))
                    res[name] = dst
        finally:
            self._lib.ffdl_release(self._h, slot)
        self._served += 1
        COUNTERS["batches"] += 1
        return res

    def close(self):
        if self._h is not None:
            self._lib.ffdl_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:   # noqa: BLE001 — interpreter teardown
            pass


def group_loader_for(model) -> Optional[NativeBatchLoader]:
    """One NativeBatchLoader over the model's attached dataloaders; None
    when ``native_dataloader`` is off, the loaders disagree on batch size
    or sample count, or the library is unavailable (then with a warning
    and ``COUNTERS["fallbacks"]``: ``fit`` slices in Python)."""
    cfg = model.config
    if not cfg.native_dataloader or not model._dataloaders:
        return None
    sizes = {dl.batch_size for dl in model._dataloaders}
    ns = {dl.num_samples for dl in model._dataloaders}
    if len(sizes) != 1 or len(ns) != 1:
        return None
    try:
        return NativeBatchLoader(
            [(dl.name, dl.data[:dl.num_samples])
             for dl in model._dataloaders],
            batch_size=sizes.pop(), shuffle=cfg.dataloader_shuffle,
            seed=cfg.seed, prefetch_slots=cfg.dataloader_prefetch_slots,
            num_threads=cfg.dataloader_threads)
    except (RuntimeError, ValueError) as e:
        COUNTERS["fallbacks"] += 1
        log.warning("native_dataloader=True but the native loader is "
                    "unavailable (%s): fit slices the data in Python", e)
        return None
