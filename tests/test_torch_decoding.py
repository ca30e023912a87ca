"""The port's decode scaffold and sampling (nexus_tpu_torch.models.decoding,
nexus_tpu_torch.ops.sampling, the llama decode entry points) against the
JAX package's, on the CPU in float32 with the same tiny Llama weights.

Logits of ``generic_forward_decode`` are held at rtol 1e-4, atol 1e-5 (the
training forward's tolerance: the same ops in another framework's
reduction order) over every cache layout — dense scalar and vector
lengths, paged through the gather path and the fused path, each native and
int8 — with ``n_valid`` feeds. Greedy tokens are compared exactly, after
asserting every choice's top-2 logit gap exceeds that tolerance, so a
near-tie cannot make the test flaky.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.models import decoding as jdec
from nexus_tpu.models import llama as jllama
from nexus_tpu.ops import sampling as jsampling
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import decoding as tdec
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.ops import sampling as tsampling

RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch at these
    tiny shapes gains nothing from threads, so keep it to one here rather
    than crowd out the other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(int8=False):
    jcfg = jllama.config("tiny", dtype=jnp.float32, kv_cache_quantized=int8)
    jparams = jllama.init(jax.random.PRNGKey(1), jcfg)
    tcfg = tllama.config("tiny", dtype="float32", kv_cache_quantized=int8)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return jcfg, jparams, tcfg, tparams


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _feeds(rng, b, widths, n_valids):
    return [(rng.integers(0, 256, (b, w)).astype(np.int32),
             None if nv is None else np.asarray(nv, np.int32)) for w, nv in zip(widths, n_valids)]


def _run(layout, int8, feeds):
    """The same feeds through both scaffolds → [(port logits, jax logits)]."""
    jcfg, jp, tcfg, tp = _models(int8)
    b = feeds[0][0].shape[0]
    if layout == "scalar":
        jc = jdec.init_kv_cache(2, 2, 16, jnp.float32, b, 32, quantized=int8)
        tc = tdec.init_kv_cache(2, 2, 16, torch.float32, b, 32, quantized=int8)
    elif layout == "vector":
        jc = jdec.init_kv_cache(2, 2, 16, jnp.float32, b, 32, quantized=int8)
        jc["length"] = jnp.asarray([0, 3, 5][:b], jnp.int32)
        tc = tdec.init_kv_cache(2, 2, 16, torch.float32, b, 32, quantized=int8)
        tc["length"] = torch.tensor([0, 3, 5][:b], dtype=torch.int32)
    else:  # paged: 11 blocks of 4 (the last one scratch), rows on permuted blocks
        jc = jdec.init_paged_kv_cache(2, 2, 16, jnp.float32, b, 11, 4, 5, quantized=int8)
        tc = tdec.init_paged_kv_cache(2, 2, 16, torch.float32, b, 11, 4, 5, quantized=int8)
        table = np.array([[3, 7, 1, 10, 10], [0, 9, 4, 2, 10], [6, 5, 8, 10, 10]][:b], np.int32)
        jc["block_table"] = jnp.asarray(table)
        tc["block_table"] = torch.from_numpy(table)
    out = []
    for tokens, nv in feeds:
        jin, tin = dict(jc), dict(tc)
        if nv is not None:
            jin["n_valid"], tin["n_valid"] = jnp.asarray(nv), torch.from_numpy(nv)
        if layout == "fused":
            m = jc["block_table"].shape[1]
            jin["shared_blocks"], tin["shared_blocks"] = jnp.asarray(0, jnp.int32), torch.tensor(0)
            jin["shared_table"] = jnp.full((m,), 10, jnp.int32)
            tin["shared_table"] = torch.full((m,), 10, dtype=torch.int32)
        jl, jc = jllama.forward_decode(jp, jcfg, jnp.asarray(tokens), jin)
        tl, tc = tllama.forward_decode(tp, tcfg, torch.from_numpy(tokens), tin)
        out.append((tl, jl, nv))
    return out


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layout", ["scalar", "vector", "paged", "fused"])
def test_forward_decode_logits_match_jax(layout, int8):
    rng = np.random.default_rng(3)
    if layout == "scalar":
        feeds = _feeds(rng, 2, (5, 1, 1, 3), (None,) * 4)
    else:  # per-row real-token counts; padding slots' logits are garbage
        b = 3
        feeds = _feeds(rng, b, (4, 4, 1, 2), ([4, 2, 1], [1, 4, 3], None, [2, 1, 2]))
    for tl, jl, nv in _run(layout, int8, feeds):
        if nv is None:
            _close(tl, jl)
        else:
            for r, n in enumerate(nv):
                _close(tl[r, :n], np.asarray(jl)[r, :n])


def test_chunked_prefill_equals_a_monolithic_prefill():
    _, _, cfg, params = _models()
    prompt = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (2, 23)).astype(np.int32))

    def fresh():
        return tdec.init_kv_cache(cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.dtype, 2, 40)

    whole, c1 = tdec._chunked_prefill(tllama.forward_decode, params, cfg, prompt, fresh())
    chunked, c2 = tdec._chunked_prefill(tllama.forward_decode, params, cfg, prompt, fresh(),
                                        chunk=5)
    torch.testing.assert_close(chunked, whole, rtol=1e-5, atol=1e-6)
    assert c1["length"] == c2["length"] == 23
    torch.testing.assert_close(c2["k"][:, :, :23], c1["k"][:, :, :23], rtol=1e-5, atol=1e-6)


def test_generate_greedy_tokens_equal_jax():
    jcfg, jp, tcfg, tp = _models()
    rng = np.random.default_rng(8)
    for p, n in ((3, 12), (17, 9), (40, 6)):
        prompt = rng.integers(0, 256, (2, p)).astype(np.int32)
        ref = np.asarray(jllama.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=n))
        got = tllama.generate(tp, tcfg, torch.from_numpy(prompt), n)
        assert got.tolist() == ref.tolist()
        # every choice is clear of a near-tie: each top-2 gap of the full
        # forward exceeds the logits' tolerance at that logit's size
        logits = tllama.forward(tp, tcfg, got[:, :-1])[:, p - 1:]
        top2 = logits.topk(2, dim=-1).values
        assert bool(((top2[..., 0] - top2[..., 1]) > RTOL * top2[..., 0].abs() + ATOL).all())


def test_generate_stop_token_freezes_rows_like_jax():
    jcfg, jp, tcfg, tp = _models()
    prompt = np.random.default_rng(9).integers(0, 256, (3, 6)).astype(np.int32)
    free = tllama.generate(tp, tcfg, torch.from_numpy(prompt), 10)
    stop = int(free[0, 9])  # row 0 emits it on its 4th new token
    ref = np.asarray(jllama.generate(jp, jcfg, jnp.asarray(prompt), max_new_tokens=10,
                                     stop_token_id=stop))
    got = tllama.generate(tp, tcfg, torch.from_numpy(prompt), 10, stop_token_id=stop)
    assert got.tolist() == ref.tolist()
    assert (got[0, 9:] == stop).all()


def test_generate_sampling_is_reproducible_from_its_generator():
    _, _, cfg, params = _models()
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 5)).astype(np.int32))

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return tllama.generate(params, cfg, prompt, 8, temperature=0.9, top_k=20, generator=g)

    assert torch.equal(run(3), run(3))
    assert not torch.equal(run(3), run(4))
    with pytest.raises(ValueError, match="Generator"):
        tllama.generate(params, cfg, prompt, 4, temperature=0.9)


def _jax_masked_logits(monkeypatch, logits, **kw):
    """The logits the JAX function hands to its categorical draw."""
    seen = {}

    def capture(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.zeros(lg.shape[:-1], jnp.int32)

    monkeypatch.setattr(jsampling.jax.random, "categorical", capture)
    jsampling.sample_logits(jnp.asarray(logits), key=jax.random.PRNGKey(0), **kw)
    return seen["logits"]


@pytest.mark.parametrize("kw", [dict(temperature=0.7), dict(temperature=1.3, top_k=5),
                                dict(temperature=0.9, top_p=0.6),
                                dict(temperature=1.0, top_k=7, top_p=0.8)])
def test_sampling_masks_match_jax(monkeypatch, kw):
    logits = np.random.default_rng(6).standard_normal((4, 32)).astype(np.float32) * 2
    ref = _jax_masked_logits(monkeypatch, logits, **kw)
    got = tsampling.masked_logits(torch.from_numpy(logits), kw["temperature"],
                                  kw.get("top_k", 0), kw.get("top_p", 1.0)).numpy()
    neg = np.finfo(np.float32).min
    assert ((got == neg) == (ref == neg)).all()
    np.testing.assert_allclose(got[got != neg], ref[ref != neg], rtol=1e-6)


def test_greedy_sampling_matches_jax_argmax():
    logits = np.random.default_rng(7).standard_normal((5, 64)).astype(np.float32)
    ref = np.asarray(jsampling.sample_logits(jnp.asarray(logits)))
    assert tsampling.sample_logits(torch.from_numpy(logits)).tolist() == ref.tolist()
    # and a sampled draw stays inside the top-k support
    g = torch.Generator().manual_seed(0)
    draw = tsampling.sample_logits(torch.from_numpy(logits), g, temperature=1.0, top_k=3)
    top3 = torch.from_numpy(logits).topk(3, dim=-1).indices
    assert all(int(d) in top3[i].tolist() for i, d in enumerate(draw))


def test_copy_kv_blocks_copies_every_plane_and_pads_onto_scratch():
    c = tdec.init_paged_kv_cache(2, 2, 4, torch.float32, 1, 6, 2, 3, quantized=True)
    for key in ("k", "v", "k_scale", "v_scale"):
        c[key].copy_(torch.randn(c[key].shape).to(c[key].dtype) if key.endswith("scale")
                     else torch.randint(-5, 5, c[key].shape, dtype=torch.int8))
    before = {k: c[k].clone() for k in ("k", "v", "k_scale", "v_scale")}
    tdec.copy_kv_blocks(c, torch.tensor([1, 2]), torch.tensor([3, 99]))
    for key, old in before.items():
        assert torch.equal(c[key][:, 3], old[:, 1])
        assert torch.equal(c[key][:, :3], old[:, :3]) and torch.equal(c[key][:, 4], old[:, 4])
