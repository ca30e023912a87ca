"""Head dim 256 (the flash kernels K1-K3 and the paged-decode kernel D1 at D
256, and a Llama-family model at that head dim) against the JAX package, on
the CPU in float32.

Inputs come from numpy seeds. The port's flash path runs its kernels' plain
versions here (CPU tensors), held against the JAX Pallas kernels in
interpret mode with 64x64 blocks, as tests/test_torch_ops.py holds them at
D 64: the output on rows that see a key to atol 2e-5, the q/k/v gradients
to atol 1e-4. D1's plain version is held against JAX's
``fused_paged_decode_attention`` with a Hydragen split and a window: float32
and int8 pools to rtol 1e-5 / atol 1e-6 (only the softmax's reduction order
differs), bf16 within 2e-2 of the reference's norm (both round q, K and V
to bf16 and the output at other points), as
tests/test_torch_decode_attention.py holds D 16 and 96.

The slice: a small Llama at head dim 256 (d_model 512, 2 query heads over
1 kv head, 2 layers, vocabulary 256, sequences of 128 so that the flash
rule is taken) with the weights carried over from JAX: a train step's loss,
grad norm and parameters against JAX's jitted step (rtol 1e-4, atol 1e-6,
as tests/test_torch_train.py), the forward logits (rtol 1e-4, atol 1e-5,
as tests/test_torch_llama.py), infer through both entry points from one
JAX-written npz step (the clock-free metrics equal, every row's greedy ids
equal to JAX's ``generate`` of the same prompt) and the serving engine's
greedy tokens and clock-free ledger against the JAX engine's, on native and
int8 pools.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.ops import attention as tattn
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import trainer as ttrainer

# the JAX package's ops/__init__ re-exports a function named ``attention``
jattn = importlib.import_module("nexus_tpu.ops.attention")

D = 256
# the slice's model: head dim 512 / 2 = 256, MQA
SMALL = dict(vocab_size=256, d_model=512, n_layers=2, n_heads=2, n_kv_heads=1, d_ff=512,
             max_seq_len=512)
SEQ = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch at these
    small shapes gains little from threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _valid_rows(sq, sk, causal, q_offset, window):
    """Rows that see at least one key (the JAX flash kernel's output is
    defined there only)."""
    if not causal:
        return np.ones(sq, bool)
    rows = np.arange(sq)[:, None] + q_offset
    cols = np.arange(sk)[None, :]
    vis = cols <= rows
    if window:
        vis &= cols > rows - window
    return vis.any(1)


# (hq, hkv, q_offset, window, sq, sk): causal MHA, GQA 8 -> 1, a window, a
# q_offset over longer keys
_FLASH_CASES = [
    (2, 2, 0, 0, 128, 128),
    (8, 1, 0, 0, 128, 128),
    (4, 2, 0, 48, 192, 192),
    (4, 1, 64, 0, 128, 192),
]


@pytest.mark.parametrize("hq,hkv,q_offset,window,sq,sk", _FLASH_CASES)
def test_flash_at_head_dim_256_matches_jax_pallas_interpret(hq, hkv, q_offset, window, sq, sk):
    rng = np.random.default_rng(hq * 10 + hkv + window)
    q = rng.standard_normal((1, sq, hq, D)).astype(np.float32)
    k = rng.standard_normal((1, sk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((1, sk, hkv, D)).astype(np.float32)
    valid = _valid_rows(sq, sk, True, q_offset, window)
    cot = rng.standard_normal((1, sq, hq, D)).astype(np.float32) * valid[None, :, None, None]

    def jflash(q, k, v):
        return jattn.flash_attention(q, k, v, causal=True, q_offset=q_offset, window=window,
                                     block_q=64, block_k=64, interpret=True)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out, vjp = jax.vjp(jflash, jq, jk, jv)
    ref_grads = vjp(jnp.asarray(cot))

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=True, q_offset=q_offset, window=window)
    (out * _t(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy()[:, valid], np.asarray(ref_out)[:, valid],
                               atol=2e-5)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def _paged_case(seed, t, pool, b=3, hq=8, hkv=1, bs=8, m=7, shared=2):
    """A pool of N blocks (the last one scratch), per-row depths, tables
    mapping each row's valid blocks onto distinct pool blocks (stale
    entries past them), the first ``shared`` common to every row."""
    rng = np.random.default_rng(seed)
    n = b * m + 2
    q = rng.standard_normal((b, t, hq, D)).astype(np.float32)
    if pool == "int8":
        k = rng.integers(-127, 128, (n, bs, hkv, D)).astype(np.int8)
        v = rng.integers(-127, 128, (n, bs, hkv, D)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (n, bs, hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (n, bs, hkv)).astype(np.float32)
    else:
        k = rng.standard_normal((n, bs, hkv, D)).astype(np.float32)
        v = rng.standard_normal((n, bs, hkv, D)).astype(np.float32)
        ks = vs = None
    start = rng.integers(shared * bs, m * bs - t + 1, size=b).astype(np.int32)
    start[0] = shared * bs  # a row no deeper than the shared run's end
    n_blocks = (-(-(start + t) // bs)).astype(np.int32)
    perm = rng.permutation(n - 1)  # never the scratch block
    table = np.full((b, m), n - 1, np.int32)
    used = shared
    for r in range(b):
        table[r, :shared] = perm[:shared]
        table[r, shared:n_blocks[r]] = perm[used:used + n_blocks[r] - shared]
        used += m - shared
        table[r, n_blocks[r]:] = perm[: m - n_blocks[r]]
    shared_table = np.full((m,), n - 1, np.int32)
    shared_table[:shared] = perm[:shared]
    if pool == "bfloat16":
        import ml_dtypes

        q, k, v = (x.astype(ml_dtypes.bfloat16) for x in (q, k, v))
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, start=start, n_blocks=n_blocks, table=table,
                shared_table=shared_table, shared=shared)


def _to_torch(x):
    if x is None:
        return None
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.astype(np.float32)).bfloat16()
    return torch.from_numpy(x)


@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("t", [1, 8])
def test_fused_decode_at_head_dim_256_matches_jax(pool, t):
    """D1's plain version: 8 query heads over 1 kv head, a Hydragen split
    over two shared blocks, a window, stale table tails."""
    c = _paged_case(7 * t + len(pool), t, pool)
    window = 13
    ref = jattn.fused_paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), jnp.asarray(c["table"]),
        jnp.asarray(c["start"]), window=window,
        k_scale=None if c["ks"] is None else jnp.asarray(c["ks"]),
        v_scale=None if c["vs"] is None else jnp.asarray(c["vs"]),
        n_blocks=jnp.asarray(c["n_blocks"]), shared_blocks=jnp.asarray(c["shared"], jnp.int32),
        shared_table=jnp.asarray(c["shared_table"]))
    got = tattn.fused_paged_decode_attention(
        _to_torch(c["q"]), _to_torch(c["k"]), _to_torch(c["v"]), torch.from_numpy(c["table"]),
        torch.from_numpy(c["start"]), window=window, k_scale=_to_torch(c["ks"]),
        v_scale=_to_torch(c["vs"]), n_blocks=torch.from_numpy(c["n_blocks"]),
        shared_blocks=torch.tensor(c["shared"], dtype=torch.int32),
        shared_table=torch.from_numpy(c["shared_table"]))
    assert got.shape == (3, t, 8, D)
    got, ref = got.float().numpy(), np.asarray(ref, np.float32)
    if pool == "bfloat16":
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_the_kernels_take_head_dim_256_in_bf16_and_still_refuse_float32():
    """The checks let a bf16 D-256 call through to the kernels (here their
    shape checks only: the CPU has no kernel) and still refuse float32,
    naming the restated items."""
    q = torch.zeros(1, 128, 8, D, dtype=torch.bfloat16)
    k = torch.zeros(1, 128, 1, D, dtype=torch.bfloat16)
    assert tattn._check_cuda(q, k, k, causal=True, window=0)[-1] == D
    assert tattn.tile_ok(q, k)
    with pytest.raises(NotImplementedError, match="item 2: K1-K3 for float32"):
        tattn._check_cuda(q.float(), k.float(), k.float(), causal=True, window=0)
    pool = torch.zeros(5, 32, 1, D, dtype=torch.bfloat16)
    table = torch.zeros(1, 4, dtype=torch.int32)
    tattn._check_decode(q[:, :1], pool, pool, table, None, None)
    with pytest.raises(NotImplementedError, match="item 3: D1 for float32"):
        tattn._check_decode(q[:, :1].float(), pool.float(), pool.float(), table, None, None)


def _models():
    jcfg = jllama.config("tiny", dtype=jnp.float32, attn_impl="flash", **SMALL)
    jparams = jllama.init(jax.random.PRNGKey(2), jcfg)
    tcfg = tllama.config("tiny", dtype="float32", attn_impl="flash", **SMALL)
    assert tcfg.head_dim == jcfg.head_dim == D
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def test_forward_logits_and_a_train_step_match_jax():
    """Both through their flash paths (JAX's Pallas kernels in interpret
    mode, the port's kernels' plain versions): the forward logits, then
    two steps of the jitted train step against the port's."""
    (jcfg, jparams), (tcfg, tparams) = _models()
    tokens = np.random.default_rng(0).integers(0, SMALL["vocab_size"],
                                               (2, SEQ + 1)).astype(np.int32)
    ref = np.asarray(jllama.forward(jparams, jcfg, jnp.asarray(tokens[:, :-1])))
    with torch.no_grad():
        got = tllama.forward(tparams, tcfg, torch.from_numpy(tokens[:, :-1]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)

    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
    jopt = jtrainer.build_optimizer(**kw)
    jstep = jtrainer.make_train_step(lambda p, b: jllama.loss_fn(p, jcfg, b), jopt,
                                     donate=False)
    jstate = jtrainer.init_train_state(lambda: jparams, jopt)
    topt = ttrainer.build_optimizer(**kw)
    tstep = ttrainer.make_train_step(lambda p, b: tllama.loss_fn(p, tcfg, b), topt)
    tstate = ttrainer.init_train_state(tparams, tllama.leaves(tparams), topt)
    batches = jdata.synthetic_lm_batches(2, SEQ, SMALL["vocab_size"], seed=4)
    for step in range(2):
        batch = next(batches)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(batch["tokens"]).long()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        want = jax.tree.map(np.asarray, jstate.params)
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(tstate.params[name].detach().numpy(), want[name],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name} step {step}")
        for name in tllama.LAYER_KEYS:
            np.testing.assert_allclose(tstate.params["layers"][name].detach().numpy(),
                                       want["layers"][name], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} step {step}")


def _clock_free(m):
    return {k: v for k, v in m.items()
            if not (str(k).endswith(("_s", "_seconds")) or "per_sec" in str(k)
                    or k in ("device", "device_kind"))}


def test_infer_through_the_entry_point_matches_jax(tmp_path):
    """One JAX-written npz step read by both entry points (``mode:
    infer``, 4 rows, a 16-token prompt, 8 new tokens): the clock-free
    metrics JAX reports equal, and every row's ids equal to JAX's
    ``generate`` of the port's prompt."""
    jcfg = jllama.config("tiny", dtype=jnp.float32, **SMALL)
    state = jtrainer.init_train_state(lambda: jllama.init(jax.random.PRNGKey(3), jcfg),
                                      jtrainer.build_optimizer(3e-3, warmup_steps=0,
                                                               total_steps=8))
    jck.make_checkpointer(str(tmp_path), fmt="npz").save(state, step=1, wait=True)
    spec = {"kind": "jax_xla", "mode": "infer",
            "model": {"family": "llama", "preset": "tiny",
                      "overrides": dict(SMALL, dtype="float32")},
            "train": {"batchSize": 4, "seqLen": 32, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(tmp_path), "format": "npz"},
            "infer": {"promptLength": 16, "maxNewTokens": 8, "iterations": 1}}
    got = run_template_runtime(spec, device="cpu")
    ref = jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1])
    keys = [k for k in ref if k in got]
    assert {"restored_step", "weights_loaded", "mode", "family"} <= set(keys)
    assert _clock_free({k: got[k] for k in keys}) == _clock_free({k: ref[k] for k in keys})
    assert got["output_shape"] == [4, 24] and got["last_logits_finite"]
    prompt = torch.randint(0, SMALL["vocab_size"], (4, 16), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(0))
    out = jllama.generate(state.params, jcfg, jnp.asarray(prompt.numpy()), 8)
    out = out[0] if isinstance(out, tuple) else out
    assert got["completion_ids_by_row"] == np.asarray(out)[:, 16:].tolist()


def _queue():
    rng = np.random.RandomState(29)
    common = rng.randint(0, 256, size=16).tolist()
    q = [(common + rng.randint(0, 256, size=p).tolist(), n) for p, n in ((8, 6), (5, 5), (12, 7))]
    q.append((list(q[0][0]), 4))  # 24 tokens = 3 full blocks: a copy-on-write hit
    return q


@pytest.mark.parametrize("pool", ["native", "int8"])
def test_serve_matches_the_jax_engine(pool):
    """The fused path with the prefix cache (D1's plain version through the
    Hydragen split): the same greedy tokens and clock-free ledger."""
    (jcfg, jparams), (tcfg, tparams) = _models()
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    kw = dict(batch_size=2, max_len=64, chunk=4, prefill_chunk=3, kv_block_size=8,
              prefix_cache=True, attention_path="fused", kv_pool_dtype=pool)
    q = _queue()
    jeng = jserving.ServingEngine(jllama.forward_decode, jparams, jcfg, **kw)
    jres, jmet = jeng.serve([jserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    teng = tserving.ServingEngine(tllama.forward_decode, tparams, tcfg, **kw)
    tres, tmet = teng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.status) == (b.new_tokens, b.status)
    common = [k for k in jmet if k in tmet and k not in ("wall_s", "tokens_per_sec")
              and not k.endswith("_s")]
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    assert tmet["prefix_hit_tokens"] > 0 and tmet["hydragen_waves"] >= 1
    assert tmet["committed_tokens"] == sum(n for _, n in q)
