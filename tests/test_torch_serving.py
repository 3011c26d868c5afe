"""The serving slice of the PyTorch port end to end, against the JAX
package.

The same small Llama (hidden 64, 2 layers, 4 heads over 2 kv heads, vocab
89, f32) is built in both packages; the JAX-initialised weights are carried
into the port with ``params_from_jax``. Both continuous-batching engines
serve the same mixed-length prompts: the greedy tokens must be identical
and the first-token logits within 1e-4 (the two frameworks sum in
different orders; f32 throughout). On the CPU the port's kernel wrappers
run their plain versions — the CUDA kernels themselves are checked on the
card (tests/test_torch_kernels.py, ``cuda`` marker, and chip_smoke.py).

Also pinned here: the port imports nothing of JAX or the JAX package, its
entry points refuse to run without a card unless asked for the CPU, the
host tier's and LoRA's knobs serve and are validated while the telemetry
identity of a later slice raises, and a default FFConfig (prefix cache on,
as in the JAX package) serves.
"""

import ast
import math
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import FFConfig as JConfig
from flexflow_tpu import FFModel as JModel
from flexflow_tpu.models.llama import llama_lm as j_llama_lm
from flexflow_tpu.runtime.generation import Generator as JGenerator
from flexflow_tpu_torch import FFConfig, FFModel
from flexflow_tpu_torch.convert import params_from_jax
from flexflow_tpu_torch.models import llama_lm
from flexflow_tpu_torch.runtime.generation import Generator

VOCAB = 89
ARCH = dict(seq_len=16, hidden=64, layers=2, heads=4, kv_heads=2,
            vocab_size=VOCAB)
ENGINE = dict(serve_slots=3, kv_page_size=4, max_seq_len=64,
              prefix_cache=False)
PROMPT_LENS = (3, 9, 17, 5, 30)
MAX_NEW = 8
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jff():
    model = JModel(JConfig(batch_size=2, mesh_shape={"data": 1}))
    _, logits = j_llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    return model


def _jax_params_np(jff):
    return {op: {w: np.asarray(a) for w, a in ws.items()}
            for op, ws in jff.params.items()}


@pytest.fixture(scope="module")
def tff(jff):
    model = FFModel(FFConfig(batch_size=2), device="cpu")
    _, logits = llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    model.params = params_from_jax(_jax_params_np(jff), "cpu", torch.float32,
                                   model=model)
    return model


@pytest.fixture(scope="module")
def prompts():
    rs = np.random.RandomState(7)
    return [rs.randint(0, VOCAB, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def test_greedy_tokens_match_jax_engine(jff, tff, prompts):
    """Five mixed-length prompts through three slots (so admission waits
    for retirements): the port's stream equals the JAX engine's."""
    j_reqs = jff.make_serving_engine(**ENGINE).run(prompts,
                                                   max_new_tokens=MAX_NEW)
    eng = tff.make_serving_engine(**ENGINE)
    t_reqs = eng.run(prompts, max_new_tokens=MAX_NEW)
    for jr, tr in zip(j_reqs, t_reqs):
        assert jr.state == tr.state == "done"
        assert tr.tokens == jr.tokens
    st = eng.stats()
    assert st["completed"] == len(prompts) and st["failed"] == 0
    assert st["tokens_generated"] == len(prompts) * MAX_NEW
    # every page is back on the free list (page 0 is the scratch page)
    assert st["free_pages"] == st["kv_pages"] - 1
    # on the CPU the wrappers took their plain versions: no launches
    assert set(st["kernel_launches"].values()) == {0}


@pytest.mark.parametrize("n", PROMPT_LENS)
def test_first_token_logits_match_jax(jff, tff, n, prompts):
    """The prefill's first-token logits (whole bucket-padded prompt, the
    last real position gathered) agree with JAX's within 1e-4."""
    prompt = prompts[PROMPT_LENS.index(n)]
    bucket = max(8, 1 << math.ceil(math.log2(n)))
    padded = np.zeros((1, bucket), np.int32)
    padded[0, :n] = prompt
    lengths = np.asarray([n], np.int32)
    jgen = JGenerator(jff)
    jcaches = {op.name: op.init_cache(1, bucket, jnp.float32)
               for op in jgen.attn_ops}
    jlogits, _ = jgen._prefill(jff.params, jff.bn_state, jnp.asarray(padded),
                               jcaches, jnp.asarray(lengths), 0)
    gen = Generator(tff)
    caches = {op.name: op.init_cache(1, bucket, torch.float32, tff.device)
              for op in gen.attn_ops}
    with torch.inference_mode():
        logits, _ = gen._prefill(tff.params, torch.as_tensor(padded), caches,
                                 torch.as_tensor(lengths))
    np.testing.assert_allclose(logits.numpy()[:, -1],
                               np.asarray(jlogits)[:, -1], **LOGIT_TOL)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, not chip_smoke.py and not the port's profile
    script imports jax or the JAX package (flexflow_tpu_torch itself is
    fine)."""
    files = sorted((REPO / "flexflow_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py"]
    files += sorted((REPO / "scripts").glob("torch_*.py"))
    names = {str(f.relative_to(REPO)) for f in files}
    # the training slice's modules, the zoo slice's, the MoE / recurrent
    # / pipelined / fusion slice's, the serving engine's (LoRA, the
    # fault-injection copy), generation's and the fleet's with its runtime
    # plane (router, locks, telemetry, flight recorder), the distribution
    # package (parallel/) and the launcher are among those scanned, and
    # the port's scripts
    assert {f"flexflow_tpu_torch/{m}.py" for m in (
        "runtime/executor", "runtime/optimizer", "runtime/loss",
        "runtime/metrics", "runtime/dataloader", "models/transformer",
        "ops/norm", "ops/kernels", "ops/conv", "ops/tensor_ops",
        "ops/elementwise", "ops/dense", "ops/attention", "models/cnn",
        "models/bert", "models/vit", "models/dlrm", "models/llama",
        "convert", "ffconst", "ops/moe", "ops/recurrent", "ops/pipelined",
        "ops/fused", "models/nmt", "ops/lora", "runtime/lora",
        "runtime/faultinject", "runtime/serving", "runtime/generation",
        "runtime/seq2seq_generation", "runtime/router", "runtime/locks",
        "runtime/telemetry", "runtime/flightrec", "runtime/manifest",
        "runtime/resilience", "runtime/checkpoint", "runtime/elastic",
        "runtime/deploy", "runtime/autoscale", "search/machine",
        "parallel/__init__", "parallel/pconfig", "parallel/strategy",
        "parallel/mesh", "parallel/ring_attention", "parallel/pipeline",
        "launcher")} \
        <= names
    assert "scripts/torch_serve_profile.py" in names
    assert "scripts/torch_sp_pp_smoke.py" in names
    bad = []
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "flexflow_tpu"):
                bad.append(f"{f.relative_to(REPO)}: {mod}")
    assert not bad, bad


def test_default_device_is_cuda():
    """Without a card the port refuses to run unless asked for the CPU."""
    if torch.cuda.is_available():
        FFModel(FFConfig())  # resolves to the card
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FFModel(FFConfig())


@pytest.mark.parametrize("knob", ["host_kv_pages", "adapter_pool_pages",
                                  "set_telemetry_identity"])
def test_later_slice_knobs_raise(tff, knob):
    """The host tier and LoRA adapters are ported: their knobs serve and
    are validated as in the JAX package (a negative size, a host tier
    without the prefix cache, a rank below 1). The fleet's telemetry
    identity is ported with the runtime plane: it relabels the engine's
    series and trace track; the SLOs over the training step and the
    checkpoint stall are accepted and validated as JAX's."""
    if knob == "set_telemetry_identity":
        eng = tff.make_serving_engine(**ENGINE)
        eng.set_telemetry_identity(0, "decode")
        assert eng._tm_labels == {"replica": "0", "role": "decode"}
        assert eng._tm_track == "replica0"
        req = eng.submit(np.arange(1, 6, dtype=np.int32), 2)
        assert req.trace_id == "0-r0"
        for knob in ("slo_step_time_p99_s", "slo_checkpoint_stall_s"):
            assert getattr(FFConfig(**{knob: 1.0}), knob) == 1.0
            with pytest.raises(ValueError, match=knob):
                FFConfig(**{knob: -1.0})
        return
    eng = tff.make_serving_engine(**dict(ENGINE, prefix_cache=True,
                                         **{knob: 4}))
    assert eng.stats()[knob] == 4
    with pytest.raises(ValueError, match=knob):
        tff.make_serving_engine(**dict(ENGINE, **{knob: -1}))
    if knob == "host_kv_pages":
        with pytest.raises(ValueError, match="radix prefix cache"):
            tff.make_serving_engine(**dict(ENGINE, host_kv_pages=4))
        with pytest.raises(ValueError, match="host_kv_pages"):
            FFConfig(host_kv_pages=-1)
    else:
        with pytest.raises(ValueError, match="serve_adapter_pool_pages"):
            FFConfig(serve_adapter_pool_pages=-1)
        with pytest.raises(ValueError, match="serve_lora_rank"):
            FFConfig(serve_lora_rank=0)


def test_config_prefix_cache_default_raises():
    """FFConfig's serve_prefix_cache defaults to True, as in the JAX
    package, and serves; the cache's host tier (FFConfig.host_kv_pages > 0)
    is inherited from the config and served, and refused without the
    prefix cache it lives under."""
    model = FFModel(FFConfig(batch_size=2, host_kv_pages=4), device="cpu")
    _, logits = llama_lm(model, 2, **ARCH)
    model.compile(final_tensor=logits)
    eng = model.make_serving_engine(serve_slots=2, kv_page_size=4,
                                    max_seq_len=32)
    st = eng.stats()
    assert st["prefix_cache"] and st["host_kv_pages"] == 4
    assert eng.run([np.arange(9) % VOCAB], max_new_tokens=2)[0].state \
        == "done"
    with pytest.raises(ValueError, match="host_kv_pages"):
        model.make_serving_engine(serve_slots=2, kv_page_size=4,
                                  max_seq_len=32, prefix_cache=False)


def test_config_default_serves(jff, tff, prompts):
    """A default FFConfig serves with the radix prefix cache on: the same
    greedy tokens as the JAX engine's default, and the same cache ledger
    (these prompts share no page-aligned prefix: no hit)."""
    kw = dict(serve_slots=2, kv_page_size=4, max_seq_len=64)
    j_eng = jff.make_serving_engine(paged_attention_impl="einsum", **kw)
    eng = tff.make_serving_engine(**kw)
    for jr, tr in zip(j_eng.run(prompts, max_new_tokens=4),
                      eng.run(prompts, max_new_tokens=4)):
        assert tr.state == "done" and tr.tokens == jr.tokens
    st, jst = eng.stats(), j_eng.stats()
    assert st["prefix_cache"] and st["kv_pages"] == jst["kv_pages"]
    for key in ("prefix_lookups", "prefix_hits", "kv_pages_cached",
                "free_pages", "prefix_refs_live"):
        assert st[key] == jst[key], key


def test_params_from_jax_rejects_mismatch(jff, tff):
    good = _jax_params_np(jff)
    bad = {op: dict(ws) for op, ws in good.items()}
    bad["lm_head"]["kernel"] = bad["lm_head"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="lm_head.kernel"):
        params_from_jax(bad, "cpu", torch.float32, model=tff)
    missing = {op: ws for op, ws in good.items() if op != "ln_f"}
    with pytest.raises(ValueError, match="missing op 'ln_f'"):
        params_from_jax(missing, "cpu", torch.float32, model=tff)


def test_submit_validates_prompt(tff):
    eng = tff.make_serving_engine(**ENGINE)
    with pytest.raises(ValueError, match="token ids"):
        eng.submit(np.asarray([1, VOCAB]), 4)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit(np.arange(40) % VOCAB, 40)


@pytest.mark.parametrize("impl", ["einsum", "pallas"])
def test_paged_attention_impl_matches_jax(jff, tff, prompts, impl):
    """``paged_attention_impl``: "pallas" names the paged-attention
    kernel, "einsum" the page gather and grouped einsum attention — the
    kernel's plain version, which is what the CPU runs for either name.
    The port's route against the JAX route of each name (the Pallas kernel
    in interpret mode): a decode / verify slab's attention within 1e-5,
    and the engine's greedy tokens identical."""
    from flexflow_tpu_torch.ops import kernels

    ja = next(op for op in jff.ops if type(op).__name__ ==
              "MultiHeadAttention")
    ta = next(op for op in tff.ops if type(op).__name__ ==
              "MultiHeadAttention")
    rs = np.random.RandomState(4)
    pool = {n: rs.randn(6, 4, 2, 16).astype(np.float32) for n in "kv"}
    table = np.asarray([[3, 1, 4], [5, 2, 0]], np.int32)
    for s in (1, 3):
        q = rs.randn(2, s, 4, 16).astype(np.float32)
        wp = np.minimum(np.asarray([8, 5])[:, None] + np.arange(s),
                        [[11], [6]]).astype(np.int32)
        rl, pad = np.asarray([3, 4], np.int32), np.asarray([8, 4], np.int32)
        want = np.asarray(ja._paged_attention_ctx(
            jnp.asarray(q), {n: jnp.asarray(a) for n, a in pool.items()},
            *(jnp.asarray(a) for a in (table, wp, rl, pad)), impl=impl))
        got = ta._paged_attention_ctx(
            torch.from_numpy(q), {n: torch.from_numpy(a)
                                  for n, a in pool.items()},
            *(torch.from_numpy(a) for a in (table, wp, rl, pad))).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    kw = dict(ENGINE, paged_attention_impl=impl)
    j_reqs = jff.make_serving_engine(**kw).run(prompts[:3], max_new_tokens=4)
    eng = tff.make_serving_engine(**kw)
    n0 = kernels.paged_attention_fwd.launches
    for jr, tr in zip(j_reqs, eng.run(prompts[:3], max_new_tokens=4)):
        assert tr.state == "done" and tr.tokens == jr.tokens
    assert kernels.paged_attention_fwd.launches == n0    # the CPU
    assert eng.stats()["paged_attention_impl"] == impl
    with pytest.raises(ValueError, match="paged_attention_impl"):
        tff.make_serving_engine(**dict(ENGINE, paged_attention_impl="xla"))


@pytest.mark.parametrize("impl", ["einsum", "pallas", "auto", None])
def test_einsum_route_refused_on_the_card(impl):
    """On a CUDA device decode attention is the paged-attention kernel:
    "einsum" (the plain route) raises, naming the kernel; the other names
    resolve to it. On the CPU every name is accepted."""
    from flexflow_tpu_torch.ops import attention

    if impl == "einsum":
        with pytest.raises(ValueError, match="paged_attention_fwd"):
            attention.resolve_paged_attention_impl(impl, None, "cuda")
    else:
        assert attention.resolve_paged_attention_impl(
            impl, None, torch.device("cuda", 0)) == "pallas"
    assert attention.resolve_paged_attention_impl(impl, None, "cpu") \
        == (impl if impl == "einsum" else "pallas")
