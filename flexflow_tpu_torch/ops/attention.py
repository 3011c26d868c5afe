"""MultiHeadAttention: the dense training path and the serving half (the
JAX package's ``ops/attention.py``).

Layouts are the JAX package's: weights ``wq`` (D, H, Hd), ``wk``/``wv``
(D, KVH, Hd), ``wo`` (H, Hd, D); activations (B, S, H, Hd); the paged pool
(pages, page_size, KVH, Hd). The places where the JAX package runs a
Pallas kernel call the wrappers of ``ops/kernels.py``:

  * ``forward`` -> ``flash_attention`` (the dense path; forward kernel
    with the lse, backward kernel under autograd),
  * ``prefill_forward`` -> ``flash_attention_fwd`` (the dense prompt pass),
  * ``paged_prefill_write`` -> ``paged_prefill_write`` (prompt k/v into
    the pool, quantized into an int8 / fp8 pool; the serving engine writes
    every layer's at once through ``paged_prefill_write_layers``),
  * ``_paged_attention_ctx`` -> ``paged_attention_fwd`` (decode, over any
    pool: native, bf16 under f32, int8 / fp8 with scales).

The dense paths choose their route from the shapes before they call a
wrapper, as the JAX op's ``_flash_ok`` does: a shape the flash kernels
take (``kernels.flash_attention_takes``) always goes to them; one they do
not take (a head dim they are not built for, unequal q and v head dims,
causal attention with more queries than keys), or any shape under
``use_flash_attention=False``, goes to the JAX package's fallback in torch
ops with autograd: the einsum branch, or past ``BLOCKWISE_SEQ_THRESHOLD``
positions with equal head dims the blockwise online-softmax scan
(``blockwise_attention``).

A prefix-cache hit prefills its tail with ``chunk_forward`` and scores its
last token with ``query_forward``: the grouped einsum attention, as in the
JAX package (no kernel there either). The pool is updated in place (the
JAX package returned new arrays); so are the contiguous prefill caches.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from flexflow_tpu_torch.ffconst import OperatorType
from flexflow_tpu_torch.ops import kernels
from flexflow_tpu_torch.ops.base import Op, WeightSpec
from flexflow_tpu_torch.ops.norm import dropout
from flexflow_tpu_torch.parallel import (head_layout, is_dtensor,
                                         keep_shards, local_shard,
                                         note_local_call, reduce_partial,
                                         rows_matmul, shard_generator)


# ---- quantized KV-page storage (the JAX package's attention.py:67-134) ---
#
# An int8 / fp8 pool stores the payload with one f32 scale per (page, kv
# head) beside it, so a page holds 2-4x more tokens per byte; the
# allocator, the copy-on-write rule and the radix trie are page-granular
# and never look inside a page. Dequantization happens where the data is
# consumed: inside the paged-attention kernel's staging, or after the
# gather of the plain version and of a prefix hit.


def kv_storage_dtype(kv_dtype) -> Tuple[Optional[torch.dtype],
                                         Optional[float]]:
    """An FFConfig.kv_cache_dtype value -> ``(storage dtype, qmax)``:
    ``(None, None)`` is native (the compute dtype), bf16 is a plain cast
    (no scales), int8 / fp8 are symmetric per-(page, kv head) scale
    quantization with ceiling ``qmax``. Raises on other values."""
    if kv_dtype in (None, "", "native"):
        return None, None
    if kv_dtype in ("bf16", "bfloat16"):
        return torch.bfloat16, None
    if kv_dtype in ("int8", "fp8"):
        dtype = torch.int8 if kv_dtype == "int8" else torch.float8_e4m3fn
        return dtype, storage_qmax(dtype)
    raise ValueError(
        f"kv_cache_dtype={kv_dtype!r}: must be 'native', 'bf16', "
        f"'int8' or 'fp8'")


def storage_qmax(dtype: torch.dtype) -> float:
    """The symmetric quantization ceiling of a storage dtype (127 for
    int8, 448 for fp8 e4m3fn)."""
    if dtype.is_floating_point:
        return float(torch.finfo(dtype).max)
    return float(torch.iinfo(dtype).max)


def _divide(x: torch.Tensor, qmax: float) -> torch.Tensor:
    """x / qmax as an IEEE division: torch's CUDA path multiplies by the
    reciprocal when the divisor is a python number, which is not bitwise
    the JAX division (nor the CUDA kernel's)."""
    return x / torch.full_like(x, qmax)


def page_scale(pf: torch.Tensor, qmax: float) -> torch.Tensor:
    """Per-(page, kv-head) scale of a (..., page_size, KVH, D) float slab:
    amax over the page's positions and head dim, over qmax."""
    return _divide(pf.float().abs().amax(dim=(-3, -1)), qmax)


def page_quantize(pf: torch.Tensor, scale: torch.Tensor, qmax: float,
                  dtype: torch.dtype) -> torch.Tensor:
    """Quantize (..., page_size, KVH, D) float against per-(page, head)
    ``scale`` (..., KVH): divide by max(scale, 1e-12), clip to +-qmax
    BEFORE the cast (an fp8 overflow cast gives nan, not saturation), round
    half to even for int8 (``torch.round``, as ``jnp.round``); fp8 rounds
    in the cast. Requantization at an unchanged scale is exact, which makes
    the append path's unconditional page requantization safe."""
    s = torch.clamp_min(scale, 1e-12)[..., None, :, None]
    q = torch.clamp(pf.float() / s, -qmax, qmax)
    if not dtype.is_floating_point:
        q = torch.round(q)
    return q.to(dtype)


def page_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(..., page_size, KVH, D) payload x (..., KVH) scales -> f32."""
    return q.float() * scale[..., None, :, None]


def rope_tables(theta: float, s: int, d: int,
                offset: Union[int, torch.Tensor], device: torch.device):
    """cos/sin of the rotary angles, (1 or B, S, 1, d/2) f32, from absolute
    positions ``offset + arange(S)``: a python int offsets every row, a
    (B,) tensor gives per-row offsets."""
    half = d // 2
    f32 = dict(dtype=torch.float32, device=device)
    freqs = theta ** (-torch.arange(0, half, **f32) / half)
    pos = torch.arange(s, **f32)
    if isinstance(offset, torch.Tensor):
        pos = offset.to(torch.float32)[..., None] + pos    # (B, S)
    else:
        pos = pos + float(offset)                          # (S,)
    ang = pos[..., None] * freqs                           # (..., S, half)
    if ang.dim() == 2:
        ang = ang[None]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def _apply_rope(x: torch.Tensor, theta: float,
                offset: Union[int, torch.Tensor] = 0,
                tables: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Rotary position embedding (rotate-half) on (B, S, H, Hd). Angles
    from absolute positions and the rotation itself are computed in f32
    whatever the compute dtype. ``offset`` shifts the positions: a python
    int applies to every row, a (B,) tensor gives per-row offsets.
    ``tables``: the ``rope_tables`` of these positions, where the caller
    already holds them."""
    half = x.shape[-1] // 2
    if tables is None:
        tables = rope_tables(theta, x.shape[1], x.shape[-1], offset,
                             x.device)
    cos, sin = tables
    x1 = x[..., :half].float()
    x2 = x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---- the dense route off the flash kernels (the JAX package's
# attention.py:771-806 and parallel/ring_attention.py:44-73, :333-387) -----

#: past this many queries or keys the torch route scans key blocks instead
#: of materialising the (Sq, Sk) scores (the JAX BLOCKWISE_SEQ_THRESHOLD)
BLOCKWISE_SEQ_THRESHOLD = 4096
#: the blockwise scan's mask value (the JAX ring_attention NEG_INF)
NEG_INF = -1e30


def einsum_attention(qh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                     causal: bool, scale: float, dropout_rate: float = 0.0,
                     gen: Optional[torch.Generator] = None) -> torch.Tensor:
    """The JAX dense path's einsum branch (attention.py:794-806) on
    (B, Sq, H, Dk) q, (B, Sk, H, Dk) k and (B, Sk, H, Dv) v: f32 logits, a
    bottom-right causal mask filled with the f32 minimum (not -inf, so a
    query row with no live key comes out uniform, as in JAX), softmax in
    f32, the probabilities cast to q's dtype for the product with v. With
    ``dropout_rate`` and ``gen`` the probabilities go through
    ``norm.dropout`` first (attention dropout in training)."""
    logits = torch.einsum("bqhk,bshk->bhqs", qh.float(), kh.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones(sq, sk, dtype=torch.bool,
                          device=qh.device).tril(diagonal=sk - sq)
        logits = torch.where(mask, logits, torch.finfo(torch.float32).min)
    probs = torch.softmax(logits, dim=-1).to(qh.dtype)
    probs = dropout(probs, dropout_rate, gen)
    return torch.einsum("bhqs,bshk->bqhk", probs, vh)


def _i64(v: int) -> int:
    """A python int wrapped to int64 (two's complement)."""
    return (v + (1 << 63)) % (1 << 64) - (1 << 63)


#: splitmix64's constants as signed int64 (torch has no uint64 arithmetic)
_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _srl(z: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 ``z`` by ``k`` (torch shifts signed
    values arithmetically)."""
    return (z >> k) & ((1 << (64 - k)) - 1)


def hashed_keep_mask(seed: torch.Tensor, shape, keep: float) -> torch.Tensor:
    """A Bernoulli(``keep``) bool mask of ``shape`` that is a pure function
    of ``seed`` (a 0-dim int64 tensor) and the element index: splitmix64
    of ``seed + index * golden``, its top 53 bits as a uniform in [0, 1).
    The blockwise route draws its dropout masks this way, so the
    backward's recomputation of a block (``torch.utils.checkpoint``)
    redraws the forward's mask; the JAX route folds the block index into
    its key for the same reason."""
    z = torch.arange(math.prod(shape), dtype=torch.int64,
                     device=seed.device).reshape(shape) * _GOLDEN + seed
    z = (z ^ _srl(z, 30)) * _MIX1
    z = (z ^ _srl(z, 27)) * _MIX2
    z = z ^ _srl(z, 31)
    return _srl(z, 11).to(torch.float64) * 2.0 ** -53 < keep


def _block_attend(q, k, v, m, l, o, scale: float, mask,
                  dropout_rate: float = 0.0, seed=None):
    """One online-softmax step over a key block (the JAX ``_block_attend``,
    ring_attention.py:44): q (B, Sq, H, D), k/v (B, Sk, H, D), running
    max m and sum l (B, H, Sq) and output o (B, Sq, H, D), all f32. With
    attention dropout the mask (``hashed_keep_mask`` of ``seed``) applies
    to the block's unnormalised probabilities feeding the value product
    while ``l`` sums the undropped ones, so the final o / l equals
    dropout(softmax) @ v, as in JAX."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv_in = p
    if seed is not None and dropout_rate > 0.0:
        keep = 1.0 - dropout_rate
        pv_in = torch.where(hashed_keep_mask(seed, p.shape, keep),
                            p / torch.full((), keep, dtype=p.dtype,
                                           device=p.device), 0.0)
    pv = torch.einsum("bhqk,bkhd->bqhd", pv_in.to(v.dtype).float(),
                      v.float())
    return m_new, l_new, o * alpha.transpose(1, 2)[..., None] + pv


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float, block_size: int,
                        dropout_rate: float = 0.0,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention as a scan over key blocks of ``block_size`` with an online
    softmax (the JAX ``blockwise_attention``, ring_attention.py:333): the
    working set is one (Sq, block) score tile, never the (Sq, Sk) one.
    Causal masking aligns bottom-right; a key length that ``block_size``
    does not divide is one block. f32 accumulation, output in q's dtype.
    Attention dropout (``dropout_rate`` > 0 with a 0-dim int64 ``seed``)
    masks block i with ``hashed_keep_mask(seed + i * golden, ...)``."""
    b, sq, h, _ = q.shape
    sk = k.shape[1]
    dev = q.device
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    o = torch.zeros((b, sq, h, v.shape[-1]), dtype=torch.float32,
                    device=dev)
    if sk <= block_size or sk % block_size:
        block_size = sk
    q_pos = torch.arange(sq, device=dev) + (sk - sq)
    for start in range(0, sk, block_size):
        mask = None
        if causal:
            k_pos = start + torch.arange(block_size, device=dev)
            mask = (q_pos[:, None] >= k_pos[None, :])[None, None]
        blk_seed = None
        if seed is not None:
            blk_seed = seed + _i64((start // block_size + 1) * _GOLDEN)
        m, l, o = _block_attend(q, k[:, start:start + block_size],
                                v[:, start:start + block_size], m, l, o,
                                scale, mask, dropout_rate, blk_seed)
    return (o / l.transpose(1, 2)[..., None]).to(q.dtype)


def resolve_paged_attention_impl(impl=None, config=None,
                                 device=None) -> str:
    """An ``auto | pallas | einsum`` request (the engine's override first,
    then FFConfig.paged_attention_impl) -> the decode attention route's
    name (the JAX ``resolve_paged_attention_impl``, attention.py:41-70).
    Both names reach ``kernels.paged_attention_fwd``: the CUDA kernel on
    the card, its plain version — the page gather and grouped einsum
    attention of the JAX einsum branch — on the CPU. ``auto`` is
    ``pallas``. ``einsum`` asks for the plain route, which the CPU runs
    and the card does not: on a CUDA ``device`` it raises."""
    if impl in (None, "", "auto"):
        impl = getattr(config, "paged_attention_impl", "auto") or "auto"
    if impl == "auto":
        return "pallas"
    if impl not in ("pallas", "einsum"):
        raise ValueError(
            f"paged_attention_impl={impl!r}: must be 'auto', 'pallas' "
            f"or 'einsum'")
    if impl == "einsum" and device is not None \
            and torch.device(device).type == "cuda":
        raise ValueError(
            "paged_attention_impl='einsum' is the CPU's route: on the card "
            "decode attention runs the paged-attention kernel "
            "(kernels.paged_attention_fwd, csrc/paged_attention.cu); use "
            "'auto' or 'pallas'")
    return impl


def verify_as_decode(x: torch.Tensor) -> bool:
    """Whether a speculative verify slab computes each position as a decode
    step does, bit for bit: on the card at 16-bit widths. There greedy
    speculation's tokens are the plain decode's only if slab position 0's
    logits are the decode step's, and two sums differ: cuBLAS sums the
    narrow k / v product of 4 rows in another order than of 4 x (K + 1)
    (measured at Llama-3-8B's 1024 kv columns), and kernel 4's splits
    sized for the slab merge in another order than a decode step's. So
    the verify projects k / v a position at a time and sizes kernel 4's
    splits for one position (``scripts/torch_verify_numerics.py`` times
    both). In f32, and on the CPU (no splits), the slab takes one product
    and its own splits."""
    return x.is_cuda and x.dtype in (torch.bfloat16, torch.float16)


def paged_slot(page_table: torch.Tensor, write_pos: torch.Tensor,
               page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pool rows the slots' tokens are written to: (page id, row in
    page), int64 of ``write_pos``'s shape, from the (B, pages_per_slot)
    page table and the (B,) decode or (B, S) verify write positions."""
    wp = write_pos.long()
    idx = wp // page_size
    page_ids = torch.gather(page_table.long(), 1,
                            idx if wp.dim() == 2 else idx[:, None])
    if wp.dim() == 1:
        page_ids = page_ids[:, 0]
    return page_ids, wp % page_size


#: the integer type of each element size: page payloads move as bits
_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def _raw_bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s storage viewed as integers of its element size."""
    return t.view(_BITS[t.element_size()])


def _head_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, D) x (D, H, Hd) -> (B, S, H, Hd): one matrix product (the
    einsum "bsd,dhk->bshk")."""
    y = rows_matmul(x, w.reshape(w.shape[0], -1))
    return y.view(*x.shape[:-1], w.shape[1], w.shape[2])


def _head_proj_by_position(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``_head_proj`` with each position's (B, D) rows a product of their
    own, a decode step's (``verify_as_decode``)."""
    return torch.cat([_head_proj(x[:, i:i + 1].contiguous(), w)
                      for i in range(x.shape[1])], dim=1)


def _WHOLE(ctx):
    """``_local_heads``'s ``back`` without a mesh: the context as it
    is."""
    return ctx


def _noted(back, kernel: str) -> None:
    """Count a kernel wrapper's call on a rank's heads
    (``LOCAL_SHARD_CALLS``): under a mesh only."""
    if back is not _WHOLE:
        note_local_call(kernel)


class MultiHeadAttention(Op):
    op_type = OperatorType.OP_MULTIHEAD_ATTENTION

    def __init__(self, model, name, inputs, embed_dim: int, num_heads: int,
                 kdim: int = 0, vdim: int = 0, dropout: float = 0.0,
                 bias: bool = True, add_bias_kv: bool = False,
                 add_zero_attn: bool = False, causal: bool = False,
                 num_kv_heads: int = 0, rope: bool = False,
                 rope_theta: float = 10000.0):
        super().__init__(model, name, inputs)
        if add_bias_kv or add_zero_attn:
            raise NotImplementedError(
                "add_bias_kv/add_zero_attn are not supported (the JAX "
                "package lacks them too)")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads:
            raise ValueError(f"num_heads {num_heads} must be a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
        self.rope = rope
        self.rope_theta = rope_theta
        self.kdim = kdim if kdim > 0 else embed_dim
        self.vdim = vdim if vdim > 0 else embed_dim
        # attention dropout: the identity at inference; in training it
        # takes the dense path off the flash kernels (_dense_attention);
        # only then does the op draw, and get a generator
        self.dropout = dropout
        self.needs_rng = dropout > 0
        self.bias = bias
        self.causal = causal
        if embed_dim % num_heads or self.kdim % num_heads \
                or self.vdim % num_heads:
            raise ValueError(f"{name}: embed/k/v dims must divide by the "
                             f"head count {num_heads}")
        self.qk_head_dim = self.kdim // num_heads
        self.v_head_dim = self.vdim // num_heads
        if rope and self.qk_head_dim % 2:
            raise ValueError(f"{name}: RoPE needs an even head dim")
        self.q_in = inputs[0].dims[-1]
        self.k_in = inputs[1].dims[-1]
        self.v_in = inputs[2].dims[-1]
        self.scale = 1.0 / math.sqrt(self.qk_head_dim)
        self.finalize()

    def output_shapes(self):
        q = self.inputs[0].dims
        return [tuple(q[:-1]) + (self.embed_dim,)], [self.inputs[0].dtype]

    def weights(self) -> List[WeightSpec]:
        kvh, h = self.num_kv_heads, self.num_heads
        ws = [
            WeightSpec("wq", (self.q_in, h, self.qk_head_dim),
                       fan=(self.q_in, self.kdim)),
            WeightSpec("wk", (self.k_in, kvh, self.qk_head_dim),
                       fan=(self.k_in, kvh * self.qk_head_dim)),
            WeightSpec("wv", (self.v_in, kvh, self.v_head_dim),
                       fan=(self.v_in, kvh * self.v_head_dim)),
            WeightSpec("wo", (h, self.v_head_dim, self.embed_dim),
                       fan=(self.vdim, self.embed_dim)),
        ]
        if self.bias:
            ws += [WeightSpec("bias_q", (h, self.qk_head_dim), init="zero"),
                   WeightSpec("bias_k", (kvh, self.qk_head_dim), init="zero"),
                   WeightSpec("bias_v", (kvh, self.v_head_dim), init="zero"),
                   WeightSpec("bias_o", (self.embed_dim,), init="zero")]
        return ws

    def _project_qkv(self, params, q, k, v, rope_offset=0, rope=None,
                     kv_by_position: bool = False, parts: str = "qkv"):
        """(B, S, D) x (D, H, Hd) -> (B, S, H, Hd) for q and (B, S, KVH, Hd)
        for k/v, bias and RoPE applied; k/v stay un-broadcast (the cache
        layout). ``rope``: the ``rope_tables`` of these positions, where
        the caller holds them (a graph walk derives them once for all its
        layers). ``kv_by_position``: k and v projected one position at a
        time, each a (B, D) product as a decode step's (a verify slab under
        ``verify_as_decode``). ``parts``: "q" or "kv" projects only those
        (the others come back None), where a caller needs no more."""
        qh = kh = vh = None
        if "q" in parts:
            qh = _head_proj(q, params["wq"])
            if self.bias:
                qh = qh + params["bias_q"]
        if "k" in parts:
            if kv_by_position and k.shape[1] > 1:
                kh = _head_proj_by_position(k, params["wk"])
                vh = _head_proj_by_position(v, params["wv"])
            else:
                kh = _head_proj(k, params["wk"])
                vh = _head_proj(v, params["wv"])
            if self.bias:
                kh = kh + params["bias_k"]
                vh = vh + params["bias_v"]
        if self.rope:
            x = q if qh is not None else k
            if rope is None:
                rope = rope_tables(self.rope_theta, x.shape[1],
                                   self.qk_head_dim, rope_offset, x.device)
            if qh is not None:
                qh = _apply_rope(qh, self.rope_theta, tables=rope)
            if kh is not None:
                kh = _apply_rope(kh, self.rope_theta, tables=rope)
        return qh, kh, vh

    def _broadcast_kv(self, kh, vh, heads: int = 0):
        """GQA: repeat each kv head over its query group (as
        ``repeat_interleave``), so the dense paths (and the flash
        backward) see plain multi-head shapes, as in the JAX package. It
        is built of views, which DTensor propagates on any placement.
        ``heads``: the query heads to reach (a rank's local heads on a
        serving pass; default all)."""
        heads = heads or self.num_heads
        if kh.shape[2] == heads:
            return kh, vh

        def expand(t):
            b, s, kvh, d = t.shape
            rep = heads // kvh
            return t.unsqueeze(3).expand(b, s, kvh, rep, d).reshape(
                b, s, kvh * rep, d)
        return expand(kh), expand(vh)

    def _out_proj(self, params, ctx):
        """(B, S, H, Hd) x (H, Hd, D) -> (B, S, D) (the einsum
        "bqhk,hkd->bqd")."""
        wo = params["wo"]
        out = rows_matmul(ctx.reshape(*ctx.shape[:2], -1),
                           wo.reshape(-1, wo.shape[-1]))
        if self.bias:
            # head-sharded: a partial sum a rank, reduced before the bias
            out = reduce_partial(out) + params["bias_o"]
        return out

    # ---- dense path (training, evaluation) --------------------------------

    def forward(self, params, xs, *, training=False, gen=None):
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2])
        kh, vh = self._broadcast_kv(kh, vh)
        attend = (self._sharded_attention if is_dtensor(qh)
                  else self._dense_attention)
        return [self._out_proj(params, attend(qh, kh, vh, training, gen))]

    def _sharded_attention(self, qh, kh, vh, training, gen=None):
        """The dense path on DTensor q / k / v (a strategy's run): each
        rank attends its local batch rows and heads — the kernels on
        local shards (``parallel.local_shard``), the JAX ``_flash_dense``
        under ``shard_map`` (attention.py:808-836). q keeps its shards of
        the batch and head dims; kv heads come broadcast to the query
        groups (``_broadcast_kv``), so kv left replicated (GQA with a head
        degree that does not divide the kv heads) gives each rank exactly
        the kv heads its query heads read. Attention dropout draws from
        the generator of this rank's shard (``parallel.shard_generator``)."""
        pl = keep_shards(qh.placements, (0, 2))
        use_dropout = training and self.dropout > 0.0 and gen is not None
        g = shard_generator(gen, qh.device_mesh, pl) if use_dropout else None
        return local_shard(
            lambda q, k, v: self._dense_attention(q, k, v, training, g),
            (qh, kh, vh), (pl, pl, pl),
            "flash_attention" if not use_dropout else "attention_fallback")

    def _flash_ok(self, qh, kh, vh) -> bool:
        """The flash kernels take these q/k/v and the config does not turn
        them off (``use_flash_attention``) — the JAX ``_flash_ok``
        (attention.py:737), with the port's kernels' own limits."""
        cfg = getattr(self.model, "config", None)
        if cfg is not None and not getattr(cfg, "use_flash_attention", True):
            return False
        return kernels.flash_attention_takes(qh, kh, vh, self.causal)

    def _fallback_attention(self, qh, kh, vh, gen=None):
        """The JAX dense path off its flash kernel (attention.py:771-806)
        on broadcast kv heads, in torch ops with autograd: past
        ``BLOCKWISE_SEQ_THRESHOLD`` positions with equal head dims the
        blockwise scan (key blocks of the first of 512 ... 8 that divides
        Sk), recomputed in the backward (``torch.utils.checkpoint``, as
        ``jax.checkpoint``); otherwise the einsum branch. With ``gen``
        (training) attention dropout at ``self.dropout``: the einsum
        branch draws its mask from ``gen``, the blockwise scan one int64
        seed from ``gen`` for its hashed block masks."""
        sq, sk = qh.shape[1], kh.shape[1]
        rate = self.dropout if gen is not None else 0.0
        if max(sq, sk) > BLOCKWISE_SEQ_THRESHOLD \
                and self.qk_head_dim == self.v_head_dim:
            block = next((b for b in (512, 256, 128, 64, 32, 16, 8)
                          if sk % b == 0), sk)
            seed = None
            if rate > 0.0:
                seed = torch.randint(-2 ** 63, 2 ** 63 - 1, (),
                                     dtype=torch.int64, device=qh.device,
                                     generator=gen)
            return torch.utils.checkpoint.checkpoint(
                blockwise_attention, qh, kh, vh, self.causal, self.scale,
                block, rate, seed, use_reentrant=False)
        return einsum_attention(qh, kh, vh, self.causal, self.scale, rate,
                                gen)

    def _dense_attention(self, qh, kh, vh, training, gen=None):
        """The flash autograd Function for the shapes its kernels take (on
        the CPU its plain versions); the JAX fallback in torch ops for the
        rest, for every shape under ``use_flash_attention=False``, and for
        attention dropout in training (a generator given and a rate above
        0: the mask applies to the probabilities, which the flash kernels
        never hold, as in JAX)."""
        use_dropout = training and self.dropout > 0.0 and gen is not None
        qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
        if not use_dropout and self._flash_ok(qh, kh, vh):
            return kernels.flash_attention(qh, kh, vh, self.causal,
                                           self.scale)
        return self._fallback_attention(qh, kh, vh,
                                        gen if use_dropout else None)

    # ---- parallelization (the JAX hooks, attention.py:888-925) ----------

    _contracted_output_dims = (2,)  # the hidden dim comes from wo

    def partitionable_output_dims(self):
        # batch, seq (ring attention, item 9), hidden (head split)
        return [0, 1, 2]

    def single_axis_dims(self):
        return [1]

    def weight_partition(self, axis_map):
        """Hidden-dim sharding splits heads (Megatron): the head dim of
        wq / wk / wv and wo's input side. GQA: when the head degree does
        not divide num_kv_heads, wk / wv (and their biases) stay
        replicated while wq / wo shard."""
        ax = self.axes_for_dim(axis_map, 2)
        if ax is None:
            return super().weight_partition(axis_map)
        kv_ax = ax
        shape = self.model.mesh_shape
        if self.num_kv_heads != self.num_heads and shape is not None:
            deg = 1
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                deg *= shape.get(a, 1)
            if self.num_kv_heads % deg != 0:
                kv_ax = None
        out = {"wq": (None, ax, None), "wk": (None, kv_ax, None),
               "wv": (None, kv_ax, None), "wo": (ax, None, None)}
        if self.bias:
            out.update(bias_q=(ax, None), bias_k=(kv_ax, None),
                       bias_v=(kv_ax, None), bias_o=(None,))
        return out

    # ---- a serving pass under a mesh (ROADMAP item 8, part 2) -------------

    def head_layout(self):
        """The heads this rank holds on a serving pass
        (``parallel.head_layout`` under the model's mesh and this op's
        axis map; every head without a mesh), made once a mesh."""
        mesh = getattr(self.model, "mesh", None)
        got = self.__dict__.get("_layout")
        if got is None or got[0] is not mesh:
            am = (self.model.executor.op_axis_map(self)
                  if mesh is not None else None)
            got = self._layout = (mesh, head_layout(self, mesh, am))
        return got[1]

    def _local_heads(self, qh, kh, vh):
        """A serving pass's projections as the plain tensors the kernels
        and the KV caches take. Under a mesh q / k / v are DTensors: q
        keeps this rank's heads (its head shards, the JAX ``shard_map``
        around a kernel), k / v the kv heads of its ``head_layout`` —
        their local shards, or, replicated, the heads its q heads read.
        Returns (q, k, v, back): ``back`` wraps the local context again as
        a head-sharded DTensor, so ``wo``'s row-parallel product reduces
        its partial sums; without a mesh, ``_WHOLE``. None entries pass as
        None."""
        lead = qh if qh is not None else kh
        if not is_dtensor(lead):
            return qh, kh, vh, _WHOLE
        from torch.distributed.tensor import DTensor

        lay = self.head_layout()
        mesh = lead.device_mesh

        def loc(t):
            pl = keep_shards(t.placements, (2,))
            if list(t.placements) != pl:
                t = t.redistribute(mesh, pl)
            return t.to_local(), pl

        q_pl = None
        if qh is not None:
            qh, q_pl = loc(qh)
            if qh.shape[2] != lay.q_heads:
                raise ValueError(
                    f"{self.name}: {qh.shape[2]} local q heads, its head "
                    f"layout holds {lay.q_heads} (q placements {q_pl})")
        if kh is not None:
            kh, vh = loc(kh)[0], loc(vh)[0]
            if lay.kv_select is not None:
                sel = torch.tensor(lay.kv_select, device=kh.device)
                kh, vh = kh.index_select(2, sel), vh.index_select(2, sel)

        def back(ctx):
            return DTensor.from_local(ctx, mesh, q_pl, run_check=False)

        return qh, kh, vh, back

    # ---- contiguous per-request cache (prefill) ---------------------------

    def init_cache(self, batch: int, max_len: int, dtype: torch.dtype,
                   device: torch.device):
        """Empty contiguous k / v caches of ``batch`` rows and ``max_len``
        positions over this rank's kv heads (``head_layout``)."""
        kvh = len(self.head_layout().kv_heads)
        return {
            "k": torch.zeros((batch, max_len, kvh, self.qk_head_dim),
                             dtype=dtype, device=device),
            "v": torch.zeros((batch, max_len, kvh, self.v_head_dim),
                             dtype=dtype, device=device),
        }

    def prefill_forward(self, params, xs, cache, rope=None):
        """Whole-prompt forward that also fills ``cache[:, :S]`` (in
        place). The prompt attends itself through the flash kernel, grouped
        kv heads un-broadcast, or, for a shape the kernel does not take,
        through the dense path's torch route on broadcast kv heads (the JAX
        ``prefill_forward``, attention.py:330). ``rope``: the
        ``rope_tables`` of positions 0..S-1, if the caller holds them."""
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope=rope)
        qh, kh, vh, back = self._local_heads(qh, kh, vh)
        s = qh.shape[1]
        cache["k"][:, :s] = kh
        cache["v"][:, :s] = vh
        qh, kh, vh = qh.contiguous(), kh.contiguous(), vh.contiguous()
        if self._flash_ok(qh, kh, vh):
            ctx = kernels.flash_attention_fwd(qh, kh, vh, self.causal,
                                              self.scale)
            _noted(back, "flash_attention_fwd")
        else:
            ctx = self._fallback_attention(
                qh, *self._broadcast_kv(kh, vh, qh.shape[2]))
        return self._out_proj(params, back(ctx)), cache

    def chunk_forward(self, params, xs, cache, start: int, rope=None):
        """Prefill a (B, C) slab of prompt positions [start, start + C):
        write its k/v into the contiguous ``cache`` (in place) and attend
        the prefix [0, start + C) under the causal rule (position j sees
        idx <= start + j) — the JAX ``chunk_forward`` (attention.py:352),
        the grouped einsum attention. A prefix-cache hit prefills its tail
        this way behind the gathered prefix. ``rope``: the
        ``rope_tables`` of positions start .. start + C - 1."""
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope_offset=start, rope=rope)
        qh, kh, vh, back = self._local_heads(qh, kh, vh)
        c = qh.shape[1]
        end = start + c
        cache["k"][:, start:end] = kh
        cache["v"][:, start:end] = vh
        dev = qh.device
        live = (torch.arange(end, device=dev)[None, :]
                <= (start + torch.arange(c, device=dev))[:, None])
        ctx = kernels.grouped_cache_attention(
            qh, cache["k"][:, :end], cache["v"][:, :end],
            live[None, None, None], self.scale)
        _noted(back, "grouped_cache_attention")
        return self._out_proj(params, back(ctx)), cache

    def query_forward(self, params, xs, cache, rope_pos, row_lengths,
                      rope=None):
        """Read-only cache query (the JAX ``query_forward``,
        attention.py:394): a (B, 1) slab holding each row's last prompt
        token, whose k/v the chunk passes already wrote — q at ``rope_pos``
        ((B,) positions) attends the row's live prefix idx < row_lengths.
        The cache is returned untouched."""
        qh, _, _ = self._project_qkv(params, xs[0], xs[1], xs[2],
                                     rope_offset=rope_pos, rope=rope,
                                     parts="q")
        qh, _, _, back = self._local_heads(qh, None, None)
        idx = torch.arange(cache["k"].shape[1], device=qh.device)
        live = idx[None, :] < row_lengths[:, None]
        ctx = kernels.grouped_cache_attention(
            qh, cache["k"], cache["v"], live[:, None, None, None, :],
            self.scale)
        _noted(back, "grouped_cache_attention")
        return self._out_proj(params, back(ctx)), cache

    def decode_forward(self, params, xs, cache, pos: torch.Tensor,
                       rope_pos: Optional[torch.Tensor] = None,
                       row_lengths: Optional[torch.Tensor] = None,
                       prompt_len: Optional[int] = None, rope=None):
        """One-token step of ``FFModel.generate`` (the JAX
        ``decode_forward``, attention.py:410): write the (B, 1) slab's k/v
        at slot ``pos`` of the static ``cache`` (in place) and attend the
        whole cache under the live mask ``idx <= pos``. ``pos`` is a 0-dim
        int64 device tensor, never a python int, so a CUDA graph captured
        over one step serves every step (the write is an ``index_copy_``,
        the mask a comparison on the card). Ragged right-padded prompts:
        ``row_lengths`` (B,) and the padded width ``prompt_len`` mask the
        pad slots, live = ``idx < row_lengths | (prompt_len <= idx <=
        pos)``, and ``rope_pos`` (B,) rotates each row at its logical
        position instead of ``pos``. The attention is the grouped einsum
        of the JAX package (no kernel there either). ``rope``: the
        ``rope_tables`` of these positions, where the caller holds them."""
        qh, kh, vh = self._project_qkv(
            params, xs[0], xs[1], xs[2],
            rope_offset=pos if rope_pos is None else rope_pos, rope=rope)
        qh, kh, vh, back = self._local_heads(qh, kh, vh)
        slot = pos.reshape(1)
        cache["k"].index_copy_(1, slot, kh.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, vh.to(cache["v"].dtype))
        idx = torch.arange(cache["k"].shape[1], device=qh.device)[None, :]
        if row_lengths is None:
            live = idx <= pos
        else:
            live = (idx < row_lengths[:, None]) \
                | ((idx >= prompt_len) & (idx <= pos))
        ctx = kernels.grouped_cache_attention(
            qh, cache["k"], cache["v"], live[:, None, None, None, :],
            self.scale)
        _noted(back, "grouped_cache_attention")
        return self._out_proj(params, back(ctx)), cache

    def encode_kv(self, params, enc):
        """Cross-attention's static k/v (the JAX ``encode_kv``,
        attention.py:376), projected once from the encoder states at the
        start of a seq2seq decode: every decoder pass reuses them. Only k
        and v are projected."""
        _, kh, vh = self._project_qkv(params, enc, enc, enc, parts="kv")
        return {"k": kh, "v": vh}

    def cross_forward_cached(self, params, xs, kv):
        """Cross-attention of a (B, C) decoder slab over the static
        encoder k/v of ``encode_kv`` (the JAX ``cross_forward_cached``,
        attention.py:385): non-causal, every query attends the whole
        source, through the grouped einsum attention. Only q is projected:
        k and v are ``kv``'s."""
        qh, _, _ = self._project_qkv(params, xs[0], xs[0], xs[0],
                                     parts="q")
        live = torch.ones((1, 1, 1, 1, kv["k"].shape[1]), dtype=torch.bool,
                          device=qh.device)
        ctx = kernels.grouped_cache_attention(qh, kv["k"], kv["v"], live,
                                              self.scale)
        return self._out_proj(params, ctx)

    # ---- paged KV pool (runtime/serving.py) --------------------------------

    def init_paged_cache(self, num_pages: int, page_size: int,
                         dtype: torch.dtype, device: torch.device,
                         kv_dtype: Optional[str] = None):
        """A pool of ``num_pages`` KV pages. Page 0 is the serving engine's
        scratch page. ``kv_dtype`` (FFConfig.kv_cache_dtype) picks the
        storage: None / 'native' stores ``dtype``, 'bf16' bfloat16, 'int8'
        / 'fp8' the quantized payload plus ``k_scale`` / ``v_scale``
        (num_pages, KVH) f32 planes riding the same page ids. Under a mesh
        the pool holds this rank's kv heads (``head_layout``), plain
        tensors: KVH is their count."""
        sdtype, qmax = kv_storage_dtype(kv_dtype)
        store = sdtype if sdtype is not None else dtype
        kvh = len(self.head_layout().kv_heads)
        pool = {
            "k": torch.zeros((num_pages, page_size, kvh, self.qk_head_dim),
                             dtype=store, device=device),
            "v": torch.zeros((num_pages, page_size, kvh, self.v_head_dim),
                             dtype=store, device=device),
        }
        if qmax is not None:
            for name in ("k_scale", "v_scale"):
                pool[name] = torch.zeros((num_pages, kvh),
                                         dtype=torch.float32, device=device)
        return pool

    def paged_prefill_write(self, cache, kh, vh, pages):
        """Scatter a slot's contiguous prefill k/v (1, L, KVH, Hd) into pool
        pages ``pages`` ((ceil(L / page_size),) int32), in place; the last
        page's tail past L is zeroed. A quantized pool gets each page's
        fresh per-(page, head) scale and its quantized payload (prefill
        only targets the request's own fresh pages)."""
        kernels.paged_prefill_write(cache["k"], cache["v"], kh, vh, pages,
                                    cache.get("k_scale"),
                                    cache.get("v_scale"))
        return cache

    def _paged_append(self, cache, kh, vh, page_ids, offs):
        """Write one token per slot at ``(page_ids[b], offs[b])``, in place
        (the JAX ``_paged_append``, attention.py:519-552). Native pools
        scatter the position. Quantized pools requantize the target page
        against a running-max scale: gather the page, dequantize at its
        scale, insert the token, grow the scale to cover it, requantize,
        scatter back — in torch ops, as the JAX package does it in XLA.
        Appends only land in a request's own private pages, so published
        prefix pages are never touched; inactive slots all target scratch
        page 0, whose contents are garbage by design."""
        if "k_scale" not in cache:
            cache["k"][page_ids, offs] = kh.to(cache["k"].dtype)
            cache["v"][page_ids, offs] = vh.to(cache["v"].dtype)
            return cache
        rows = torch.arange(page_ids.shape[0], device=page_ids.device)
        for name, x in (("k", kh), ("v", vh)):
            pool = cache[name]
            sc = cache[name + "_scale"]
            qmax = storage_qmax(pool.dtype)
            cur = sc[page_ids]                              # (B, KVH)
            pf = page_dequantize(kernels.take_pages(pool, page_ids), cur)
            pf[rows, offs] = x.float()
            amax = x.float().abs().amax(dim=-1)
            new = torch.maximum(cur, _divide(amax, qmax))
            kernels.put_pages(pool, page_ids,
                              page_quantize(pf, new, qmax, pool.dtype))
            sc[page_ids] = new
        return cache

    def gather_paged_kv(self, cache, pages):
        """Read ``pages`` ((n,) int) out of the pool as a full-width
        (1, n * page_size, KVH, Hd) k/v view, f32 from a quantized pool
        (dequantized against the pages' scales, so a prefix-cache borrower
        attends exactly the values the donor's decode sees)."""
        out = {}
        for name in ("k", "v"):
            x = kernels.take_pages(cache[name], pages)      # (n,ps,KVH,D)
            if name + "_scale" in cache:
                x = page_dequantize(x, cache[name + "_scale"][pages])
            out[name] = x.reshape(1, -1, *x.shape[2:])
        return out

    @staticmethod
    def export_page(cache, pages: torch.Tensor):
        """Pool pages ``pages`` ((n,) int64 on the pool's device) as the
        migration payload the host tier and the slab handoff move: each
        pool array's rows gathered verbatim (``index_select`` on the
        bits, which every storage dtype has), the quantized pools' per-
        (page, kv head) scales included, so a page imported back is
        bitwise the donor's. Device tensors; the caller copies them
        host-ward."""
        return {name: _raw_bits(cache[name]).index_select(0, pages)
                .view(cache[name].dtype)
                for name in ("k", "v", "k_scale", "v_scale")
                if name in cache}

    @staticmethod
    def import_page(cache, pages: torch.Tensor, payload) -> None:
        """Write exported payloads ((n, ...) per pool array, any device)
        into pool pages ``pages`` in place (``index_copy_``): the bytes
        land verbatim, never requantized, so export then import
        round-trips bitwise. Only fresh pages are ever targets (the
        copy-on-write rule)."""
        for name, x in payload.items():
            pool = cache[name]
            if x.dtype != pool.dtype or tuple(x.shape[1:]) \
                    != tuple(pool.shape[1:]):
                raise ValueError(
                    f"page payload {name} is {x.dtype}{tuple(x.shape[1:])} "
                    f"but the pool stores {pool.dtype}"
                    f"{tuple(pool.shape[1:])}")
            _raw_bits(pool).index_copy_(
                0, pages, _raw_bits(x.to(pool.device, non_blocking=True)))

    def _paged_attention_ctx(self, qh, cache, page_table, write_pos,
                             row_len, prompt_pad, decode_splits=False):
        """q (B, S, H, Hd) against the pool through the per-slot page
        tables; write_pos (B, S) per-position frontiers."""
        return kernels.paged_attention_fwd(
            qh.contiguous(), cache["k"], cache["v"], page_table, write_pos,
            row_len, prompt_pad, self.scale, k_scales=cache.get("k_scale"),
            v_scales=cache.get("v_scale"), decode_splits=decode_splits)

    def paged_decode_forward(self, params, xs, cache, page_table, write_pos,
                             rope_pos, row_len, prompt_pad, rope=None,
                             slot=None):
        """One continuous-batching decode step over the paged pool. xs[0]
        is (B_slots, 1, D); per-slot (B,) int32 ``write_pos`` (the logical
        cache position of this token), ``rope_pos`` (its logical sequence
        position), ``row_len`` (true prompt length) and ``prompt_pad``
        (bucket width). Live rule: j < row_len or prompt_pad <= j <=
        write_pos. Every layer of one step rotates the same positions and
        writes the same pool rows, so a graph walk passes them in, derived
        once: ``rope`` (``rope_tables`` at ``rope_pos``) and ``slot``
        (``paged_slot``)."""
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope_offset=rope_pos, rope=rope)
        qh, kh, vh, back = self._local_heads(qh, kh, vh)
        if slot is None:
            slot = paged_slot(page_table, write_pos, cache["k"].shape[1])
        cache = self._paged_append(cache, kh[:, 0], vh[:, 0], *slot)
        ctx = self._paged_attention_ctx(qh, cache, page_table,
                                        write_pos[:, None], row_len,
                                        prompt_pad)
        _noted(back, "paged_attention_fwd")
        return self._out_proj(params, back(ctx)), cache

    def paged_verify_forward(self, params, xs, cache, page_table, write_pos,
                             rope_pos0, row_len, prompt_pad, rope=None,
                             slot=None):
        """Speculative verify (the JAX ``paged_verify_forward``,
        attention.py:685-735): a (B, S) slab of candidate tokens (S = K
        draft proposals + 1) scored against the pool in one pass. Position
        i writes its k/v at ``write_pos[b, i]`` (the host clamps
        write_pos0 + i to the slot's budget, so positions at the budget
        repeat), rotates at ``rope_pos0[b] + i`` and attends at its own
        frontier through the same kernel as decode — the one kernel serves
        both shapes; under ``verify_as_decode`` each position's k / v and
        attention are a decode step's bits. On a quantized pool the S
        positions append SEQUENTIALLY through ``_paged_append`` (position
        i + 1 may land in the page position i just requantized; the
        running-max scale sees them in order), as JAX's do, so the pool
        after a verify is bitwise JAX's. A native pool takes one scatter;
        of positions repeated at the budget the last one's k/v is written
        (the others go to the scratch page 0), the order JAX's scatter
        writes them in."""
        as_decode = verify_as_decode(xs[0])
        qh, kh, vh = self._project_qkv(params, xs[0], xs[1], xs[2],
                                       rope_offset=rope_pos0, rope=rope,
                                       kv_by_position=as_decode)
        qh, kh, vh, back = self._local_heads(qh, kh, vh)
        if slot is None:
            slot = paged_slot(page_table, write_pos, cache["k"].shape[1])
        page_ids, offs = slot
        if "k_scale" in cache:
            for i in range(kh.shape[1]):
                cache = self._paged_append(cache, kh[:, i], vh[:, i],
                                           page_ids[:, i], offs[:, i])
        else:
            dup = torch.zeros_like(write_pos, dtype=torch.bool)
            dup[:, :-1] = write_pos[:, :-1] == write_pos[:, 1:]
            page_ids = torch.where(dup, torch.zeros_like(page_ids), page_ids)
            cache["k"][page_ids, offs] = kh.to(cache["k"].dtype)
            cache["v"][page_ids, offs] = vh.to(cache["v"].dtype)
        ctx = self._paged_attention_ctx(qh, cache, page_table, write_pos,
                                        row_len, prompt_pad,
                                        decode_splits=as_decode)
        _noted(back, "paged_attention_fwd")
        return self._out_proj(params, back(ctx)), cache
