"""Continuous-batching serving over a paged KV cache (the JAX package's
``runtime/serving.py`` ``ServingEngine``, its core).

  * ``serve_slots`` decode slots run as one (slots, 1) batch per decode
    step; the HOST scheduler admits queued prompts into free slots and
    retires rows on eos or length.
  * The KV cache is a POOL of ``(kv_pages, kv_page_size, KVH, Hd)`` pages
    with a per-slot page table. Pages are allocated at admission and freed
    at retirement; page 0 is a scratch page that inactive slots write.
  * Admission prefills the whole bucket-padded prompt (prompt lengths
    round up to powers of two, or to ``decode_buckets``) through the flash
    kernel into a contiguous per-request cache, then scatters that k/v
    into the slot's pages with the prefill-write kernel.
  * Decode runs ``decode_chunk`` steps per host round trip as a Python
    loop; each attention layer reads the pool through the paged-attention
    kernel. Tokens a slot computes past its own eos/length are truncated
    by the host, so outputs do not depend on the chunk.

Per-slot cache layout: logical positions ``[0, row_len)`` hold the true
prompt, ``[row_len, prompt_pad)`` masked bucket padding, and decode tokens
append from ``prompt_pad``; RoPE positions stay logical
(``row_len + emitted``).

Greedy decoding only. The features of later slices (prefix cache,
speculation, sampled streams, quantized KV or weights, LoRA, chunked
prefill) are refused with ``NotImplementedError`` rather than ignored.
"""

from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from flexflow_tpu_torch.config import not_ported
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops import sampling as sampling_ops
from flexflow_tpu_torch.runtime.generation import Generator


@dataclass
class Request:
    """One serving request and its lifecycle record."""

    rid: int
    prompt: np.ndarray              # (S,) int32, true (unpadded) prompt
    max_new_tokens: int
    state: str = "queued"           # queued | running | done | failed
    tokens: List[int] = field(default_factory=list)  # emitted tokens
    slot: int = -1
    bucket: int = 0
    pages: List[int] = field(default_factory=list)   # the slot's pages
    t_submit: float = 0.0
    ttft: float = 0.0               # submit -> first emitted token (s)
    t_done: float = 0.0
    error: str = ""

    @property
    def output(self) -> np.ndarray:
        """prompt + emitted tokens."""
        return np.concatenate(
            [self.prompt, np.asarray(self.tokens, np.int32)])


def _pow2_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _refuse_later_slices(cfg, prefix_cache, draft_model, speculate_k,
                         temperature, kv_cache_dtype, weight_dtype,
                         paged_attention_impl, adapter_pool_pages,
                         prefill_chunk):
    """Knobs of later slices: a non-default value raises, it is never
    silently served as the default."""
    if (prefix_cache if prefix_cache is not None
            else cfg.serve_prefix_cache):
        raise not_ported("the radix prefix cache",
                         "pass prefix_cache=False (or FFConfig("
                         "serve_prefix_cache=False))")
    if draft_model is not None or (speculate_k or 0) > 0:
        raise not_ported("speculative decoding (draft_model/speculate_k)")
    if temperature is not None and temperature > 0:
        raise not_ported("sampling with temperature > 0",
                         "greedy decoding (temperature 0) only")
    kv = kv_cache_dtype if kv_cache_dtype is not None else cfg.kv_cache_dtype
    if kv not in (None, "", "native"):
        raise not_ported(f"kv_cache_dtype={kv!r}",
                         "the pool stores the compute dtype ('native')")
    wd = weight_dtype if weight_dtype is not None else cfg.serve_weight_dtype
    if wd not in (None, "", "native"):
        raise not_ported(f"weight_dtype={wd!r}",
                         "weights are stored in the compute dtype ('native')")
    impl = paged_attention_impl or cfg.paged_attention_impl
    if impl != "auto":
        raise not_ported(f"paged_attention_impl={impl!r}",
                         "'auto' (the CUDA kernel on the card, its plain "
                         "version on the CPU) is the only route")
    if adapter_pool_pages:
        raise not_ported("LoRA adapter serving (adapter_pool_pages)")
    if prefill_chunk:
        raise not_ported("chunked prefill (prefill_chunk)",
                         "prompts prefill whole")


class ServingEngine:
    """Continuous-batching engine over a compiled FFModel decoder LM.

    Build once (after model.compile()); ``submit()`` requests and drive
    ``step()`` yourself, or hand ``run()`` a list of prompts. Knobs default
    to the model's FFConfig (serve_slots, kv_page_size, kv_pages,
    decode_buckets)."""

    def __init__(self, model, serve_slots: Optional[int] = None,
                 kv_page_size: Optional[int] = None,
                 kv_pages: Optional[int] = None,
                 decode_buckets: Optional[List[int]] = None,
                 max_seq_len: int = 1024,
                 temperature: Optional[float] = None,
                 eos_id: Optional[int] = None, pad_id: int = 0,
                 decode_chunk: int = 8,
                 prefix_cache: Optional[bool] = None,
                 draft_model=None, speculate_k: Optional[int] = None,
                 paged_attention_impl: Optional[str] = None,
                 kv_cache_dtype: Optional[str] = None,
                 weight_dtype: Optional[str] = None,
                 adapter_pool_pages: Optional[int] = None,
                 prefill_chunk: int = 0):
        cfg = model.config
        if model.params is None:
            raise ValueError("ServingEngine needs a compiled model "
                             "(FFModel.compile)")
        _refuse_later_slices(cfg, prefix_cache, draft_model, speculate_k,
                             temperature, kv_cache_dtype, weight_dtype,
                             paged_attention_impl, adapter_pool_pages,
                             prefill_chunk)
        self.model = model
        self.device = model.device
        self.slots = int(serve_slots or cfg.serve_slots)
        self.decode_chunk = max(1, int(decode_chunk))
        self.page_size = int(kv_page_size or cfg.kv_page_size)
        buckets = (decode_buckets if decode_buckets is not None
                   else cfg.decode_buckets)
        self.buckets = sorted(int(b) for b in buckets) if buckets else None
        self.max_seq_len = int(max_seq_len)
        if self.slots < 1 or self.page_size < 1 or self.max_seq_len < 2:
            raise ValueError(
                f"serve_slots={self.slots}, kv_page_size={self.page_size},"
                f" max_seq_len={self.max_seq_len}: all must be positive "
                f"(max_seq_len >= 2)")
        self.pages_per_slot = math.ceil(self.max_seq_len / self.page_size)
        # kv_pages = 0 derive: scratch page + one slot's worth per slot
        # (no prefix-cache slack: the prefix cache is a later slice)
        want_pages = 1 + self.slots * self.pages_per_slot
        self.num_pages = int(kv_pages or cfg.kv_pages or 0) or want_pages
        if self.num_pages < 1 + self.pages_per_slot:
            raise ValueError(
                f"kv_pages={self.num_pages} cannot hold even one "
                f"max_seq_len={self.max_seq_len} request "
                f"(needs {1 + self.pages_per_slot} incl. scratch page 0)")

        self.gen = Generator(model)
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._cdtype = self.gen._compute_dtype()
        self.pool = {
            op.name: op.init_paged_cache(self.num_pages, self.page_size,
                                         self._cdtype, self.device)
            for op in self.gen.attn_ops}
        self._free_pages = list(range(self.num_pages - 1, 0, -1))
        self._vocab = int(model._final_tensor.dims[-1])

        # per-slot scheduler state (host side, shipped to the device each
        # decode dispatch)
        n = self.slots
        self.page_tables = np.zeros((n, self.pages_per_slot), np.int32)
        self.row_len = np.zeros((n,), np.int32)
        self.prompt_pad = np.zeros((n,), np.int32)
        self.emitted = np.zeros((n,), np.int32)
        self.last_tok = np.zeros((n,), np.int32)
        self.active = np.zeros((n,), bool)
        self.slot_req: List[Optional[Request]] = [None] * n

        self._queue: List[Request] = []
        self._next_rid = 0
        self.decode_steps = 0
        self._decode_seconds = 0.0
        self._submitted = 0
        self._completed = 0
        self._failed = 0
        self._tokens_emitted = 0
        self._ttfts = collections.deque(maxlen=4096)
        # kernel launches are counted process-wide by the wrappers;
        # stats() reports them since this engine was built
        self._launch_base = kernels.launch_counts()

    # ---- scheduling ----------------------------------------------------------

    def _bucket(self, prompt_len: int) -> int:
        if self.buckets:
            for b in self.buckets:
                if b >= prompt_len:
                    return b
            raise ValueError(
                f"prompt length {prompt_len} exceeds the largest decode "
                f"bucket {self.buckets[-1]}")
        return _pow2_bucket(prompt_len)

    def submit(self, prompt, max_new_tokens: int,
               temperature: Optional[float] = None) -> Request:
        """Queue one request (greedy: ``temperature`` must be 0)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("empty prompt")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={max_new_tokens}: must be >= 1")
        if prompt.min() < 0 or prompt.max() >= self._vocab:
            raise ValueError(f"prompt token ids must lie in [0, "
                             f"{self._vocab})")
        bucket = self._bucket(prompt.size)
        if bucket + max_new_tokens > self.max_seq_len:
            raise ValueError(
                f"bucketed prompt ({bucket}) + max_new_tokens "
                f"({max_new_tokens}) exceeds max_seq_len {self.max_seq_len}")
        t, _, _ = sampling_ops.validate_sampling(
            temperature if temperature is not None else 0.0, 1.0, 0,
            "submit")
        if t > 0.0:
            raise not_ported("sampling with temperature > 0",
                             "greedy decoding (temperature 0) only")
        req = Request(rid=self._next_rid, prompt=prompt,
                      max_new_tokens=int(max_new_tokens), bucket=bucket,
                      t_submit=time.perf_counter())
        self._next_rid += 1
        self._submitted += 1
        self._queue.append(req)
        return req

    def pending(self) -> bool:
        return bool(self._queue) or bool(self.active.any())

    def _retire(self, slot: int, state: str, error: str = ""):
        req = self.slot_req[slot]
        req.state = state
        req.error = error
        req.t_done = time.perf_counter()
        if state == "done":
            self._completed += 1
        else:
            self._failed += 1
        if req.ttft:
            self._ttfts.append(req.ttft)
        self._free_pages.extend(req.pages)
        req.slot = -1
        self.slot_req[slot] = None
        self.active[slot] = False
        self.page_tables[slot, :] = 0   # scratch page: dead writes land there
        self.row_len[slot] = 0
        self.prompt_pad[slot] = 0
        self.emitted[slot] = 0

    def _record_token(self, slot: int, tok: int, ok: bool):
        """Append a sampled token to the slot's request and retire on
        non-finite logits, eos, or length — shared by prefill/decode."""
        req = self.slot_req[slot]
        if not ok:
            self._retire(slot, "failed", "non-finite logits")
            return
        req.tokens.append(int(tok))
        self._tokens_emitted += 1
        if not req.ttft:
            req.ttft = time.perf_counter() - req.t_submit
        self.emitted[slot] += 1
        self.last_tok[slot] = tok
        if (self.eos_id is not None and tok == self.eos_id) \
                or len(req.tokens) >= req.max_new_tokens:
            self._retire(slot, "done")

    # ---- device work ---------------------------------------------------------

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """A copy of host state on the device (never a view of it: the host
        arrays change while the tensors are in use)."""
        return torch.tensor(a, device=self.device)

    def _scatter_tail(self, gen, pool, caches, pages: torch.Tensor):
        """Write each attention op's contiguous prefill cache into the
        request's pool pages (the prefill-write kernel)."""
        for op in gen.attn_ops:
            op.paged_prefill_write(pool[op.name], caches[op.name]["k"],
                                   caches[op.name]["v"], pages)

    def _build_prefill(self, bucket: int, padded: np.ndarray, length: int,
                       pages: List[int]):
        """Whole-bucket prefill of one request: walk the graph over the
        padded prompt, take the first token from the logits at the prompt's
        last position, scatter the k/v into the request's pages. Returns
        (token, logits finite)."""
        gen = self.gen
        caches = {op.name: op.init_cache(1, bucket, self._cdtype, self.device)
                  for op in gen.attn_ops}
        logits, caches = gen._prefill(
            self.model.params, self._dev(padded),
            caches, self._dev(np.asarray([length], np.int32)))
        logits = logits[:, -1]                             # (1, V)
        ok = torch.isfinite(logits).all(dim=-1)
        tok = sampling_ops.sample_tokens(logits)
        self._scatter_tail(gen, self.pool, caches,
                           self._dev(np.asarray(pages, np.int32)))
        return int(tok[0]), bool(ok[0])

    def _admit(self):
        """Move queued requests into free slots: allocate the pages for
        bucket + max_new_tokens positions, prefill, seed the slot."""
        while self._queue:
            free = [i for i in range(self.slots)
                    if not self.active[i] and self.slot_req[i] is None]
            if not free:
                return
            slot = free[0]
            req = self._queue[0]
            n_total = math.ceil((req.bucket + req.max_new_tokens)
                                / self.page_size)
            if len(self._free_pages) < n_total:
                # wait for a retirement to free pages (FIFO admission;
                # submit() guarantees a request fits an empty pool)
                return
            self._queue.pop(0)
            req.pages = [self._free_pages.pop() for _ in range(n_total)]
            req.slot = slot
            req.state = "running"
            self.slot_req[slot] = req
            table = np.zeros((self.pages_per_slot,), np.int32)
            table[:n_total] = req.pages
            self.page_tables[slot] = table
            self.row_len[slot] = req.prompt.size
            self.prompt_pad[slot] = req.bucket
            self.emitted[slot] = 0
            n_prefill = math.ceil(req.bucket / self.page_size)
            padded = np.full((1, req.bucket), self.pad_id, np.int32)
            padded[0, :req.prompt.size] = req.prompt
            tok, ok = self._build_prefill(req.bucket, padded,
                                          req.prompt.size,
                                          req.pages[:n_prefill])
            self.active[slot] = True
            self._record_token(slot, tok, ok)

    def _slot_decode_state(self):
        """(write_pos, rope_pos, budget) for one decode dispatch. Inactive
        slots: state arrays are zeroed, so write_pos = -1 would index page
        -1 — clamp to 0 (the write lands in scratch page 0) and give them
        budget 1, clamping every later step there too. Budget is the last
        legal write position + 1 (bucket + the request's max_new_tokens)."""
        write_pos = np.maximum(self.prompt_pad + self.emitted - 1,
                               0).astype(np.int32)
        rope_pos = np.maximum(self.row_len + self.emitted - 1,
                              0).astype(np.int32)
        budget = np.ones((self.slots,), np.int32)
        for slot in range(self.slots):
            req = self.slot_req[slot]
            if req is not None and self.active[slot]:
                budget[slot] = req.bucket + req.max_new_tokens
        return write_pos, rope_pos, budget

    def _build_decode(self, n_steps: int):
        """``n_steps`` slot-decode steps from the current slot state.
        Past a slot's own budget (prompt_pad + its max_new_tokens) the
        write position and RoPE clamp to the final allocated position —
        those steps only produce tokens the host truncates, and the
        repeated overwrite stays inside the slot's own pages. Returns the
        (n_steps, slots) tokens and finiteness flags on the host."""
        write_pos, rope_pos, budget = self._slot_decode_state()
        dev = self._dev
        page_table = dev(self.page_tables)
        row_len, prompt_pad = dev(self.row_len), dev(self.prompt_pad)
        wp0, rp0 = dev(write_pos), dev(rope_pos)
        last_pos = dev(budget - 1)
        rope_cap = dev(budget - self.prompt_pad + self.row_len - 1)
        tok = dev(self.last_tok).long()
        toks, oks = [], []
        for i in range(n_steps):
            paged = {
                "page_table": page_table,
                "write_pos": torch.minimum(wp0 + i, last_pos),
                "rope_pos": torch.minimum(rp0 + i, rope_cap),
                "row_len": row_len, "prompt_pad": prompt_pad}
            logits, self.pool = self.gen._walk(self.model.params,
                                               tok[:, None], self.pool,
                                               paged=paged)
            logits = logits[:, 0]                          # (slots, V)
            oks.append(torch.isfinite(logits).all(dim=-1))
            tok = sampling_ops.sample_tokens(logits)
            toks.append(tok)
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(oks).cpu().numpy())

    def _decode_step(self):
        k = self.decode_chunk
        t0 = time.perf_counter()
        toks, oks = self._build_decode(k)     # ends in a device->host copy
        self._decode_seconds += time.perf_counter() - t0
        self.decode_steps += k
        for slot in range(self.slots):
            for t in range(k):
                if not self.active[slot]:
                    break  # retired mid-chunk: later tokens are truncated
                self._record_token(slot, int(toks[t, slot]),
                                   bool(oks[t, slot]))

    @torch.inference_mode()
    def step(self) -> bool:
        """One scheduler tick: admit what fits, then one decode chunk if
        any slot is live. Returns whether work remains."""
        self._admit()
        if self.active.any():
            self._decode_step()
        return self.pending()

    def run(self, prompts=None, max_new_tokens: int = 32) -> List[Request]:
        """Submit ``prompts`` (1-D int token arrays) and drive the
        scheduler until the engine is idle; returns this call's requests
        in submission order (with prompts=None: whatever was pending)."""
        if prompts is not None:
            batch = [self.submit(p, max_new_tokens) for p in prompts]
        else:
            batch = [r for r in self.slot_req if r is not None] \
                + list(self._queue)
        while self.step():
            pass
        return batch

    # ---- observability -------------------------------------------------------

    def stats(self) -> Dict:
        ttfts = sorted(self._ttfts)

        def pct(p):
            if not ttfts:
                return 0.0
            return ttfts[min(len(ttfts) - 1, int(p * len(ttfts)))]

        now = kernels.launch_counts()
        return {
            "requests": self._submitted,
            "completed": self._completed,
            "failed": self._failed,
            "tokens_generated": self._tokens_emitted,
            "decode_steps": self.decode_steps,
            # host time per decode step (each chunk ends in a device->host
            # copy of its tokens, so this includes the device work)
            "decode_step_ms": (1e3 * self._decode_seconds
                               / max(1, self.decode_steps)),
            "ttft_p50_ms": pct(0.50) * 1e3,
            "ttft_p99_ms": pct(0.99) * 1e3,
            "free_pages": len(self._free_pages),
            "kv_pages": self.num_pages,
            "kv_page_size": self.page_size,
            "serve_slots": self.slots,
            "kernel_launches": {k: now[k] - self._launch_base[k]
                                for k in now},
        }
