"""The port's ops (nexus_tpu_torch.ops) against the JAX package's on the CPU.

Inputs are drawn with numpy from a seed and handed to both; everything runs
in float32. The port's flash path runs its kernels' plain versions here (CPU
tensors) and is held against the JAX Pallas kernels in interpret mode with
64x64 blocks, as tests/test_ops.py runs them. Tolerances are stated per test.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

# the JAX package's ops/__init__ re-exports a function named `attention`,
# which shadows the submodule as an attribute: take it from sys.modules
import nexus_tpu.ops.attention  # noqa: F401
from nexus_tpu.ops import losses as jlosses
from nexus_tpu.ops.norms import rms_norm as j_rms_norm
from nexus_tpu.ops.rope import apply_rope as j_apply_rope
from nexus_tpu.ops.rope import rope_cos_sin as j_rope_cos_sin
from nexus_tpu_torch.ops import attention as tattn
from nexus_tpu_torch.ops import losses as tlosses
from nexus_tpu_torch.ops.norms import rms_norm
from nexus_tpu_torch.ops.rope import apply_rope, rope_cos_sin

jattn = sys.modules["nexus_tpu.ops.attention"]


def _t(x):
    return torch.from_numpy(np.asarray(x, dtype=np.float32))


def _qkv(rng, b, sq, sk, hq, hkv, d):
    return (rng.standard_normal((b, sq, hq, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


def _valid_rows(sq, sk, causal, q_offset, window):
    """Rows that see at least one key: the only rows where the JAX flash
    kernel's output is defined (a fully masked row depends on its block)."""
    if not causal:
        return np.ones(sq, bool)
    rows = np.arange(sq)[:, None] + q_offset
    cols = np.arange(sk)[None, :]
    vis = cols <= rows
    if window:
        vis &= cols > rows - window
    return vis.any(1)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    ref = np.asarray(j_rms_norm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(rms_norm(_t(x), _t(w)).numpy(), ref, atol=1e-6)


@pytest.mark.parametrize("offset", [0, 37])
def test_rope_matches_jax(offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 4, 32)).astype(np.float32)
    jc, js = j_rope_cos_sin(24, 32, 500000.0, position_offset=offset)
    tc, ts = rope_cos_sin(24, 32, 500000.0, position_offset=offset)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    ref = np.asarray(j_apply_rope(jnp.asarray(x), jc, js))
    np.testing.assert_allclose(apply_rope(_t(x), tc, ts).numpy(), ref, atol=1e-6)


_XLA_CASES = [
    (causal, n_rep, off, w)
    for causal in (True, False)
    for n_rep in (1, 2, 4)
    for off in ((0, 64, -32) if causal else (0,))
    for w in ((0, 48) if causal else (0,))
]


@pytest.mark.parametrize("causal,n_rep,q_offset,window", _XLA_CASES)
def test_attention_xla_matches_jax(causal, n_rep, q_offset, window):
    """Dense reference vs dense reference, every row (both use the same
    finite mask value): atol 1e-5."""
    rng = np.random.default_rng(2)
    q, k, v = _qkv(rng, 2, 64, 96, 4, 4 // n_rep, 32)
    ref = jattn.attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_offset, window=window)
    got = tattn.attention_xla(_t(q), _t(k), _t(v), causal=causal,
                              q_offset=q_offset, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# (causal, n_rep, q_offset, window, sq, sk): GQA 1/2/4, both q_offset signs,
# a window, non-causal, and unequal q/k lengths
_FLASH_CASES = [
    (True, 1, 0, 0, 128, 128),
    (True, 2, 64, 0, 128, 192),
    (True, 4, -32, 0, 128, 128),
    (True, 1, 0, 48, 192, 192),
    (True, 2, 64, 48, 128, 192),
    (True, 4, -32, 48, 192, 128),
    (False, 2, 0, 0, 128, 192),
]


def _jax_flash(q, k, v, causal, q_offset, window):
    return jattn.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                 window=window, block_q=64, block_k=64,
                                 interpret=True)


@pytest.mark.parametrize("causal,n_rep,q_offset,window,sq,sk", _FLASH_CASES)
def test_flash_matches_jax_pallas_interpret(causal, n_rep, q_offset, window, sq, sk):
    """Forward on rows that see a key (atol 2e-5) and q/k/v gradients of
    sum(out * cot) with cot zero on the other rows (atol 1e-4); rows that
    see no key give 0 in the port."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 1, sq, sk, 4, 4 // n_rep, 64)
    valid = _valid_rows(sq, sk, causal, q_offset, window)
    cot = rng.standard_normal((1, sq, 4, 64)).astype(np.float32) * valid[None, :, None, None]

    def jloss(q, k, v):
        return jnp.sum(_jax_flash(q, k, v, causal, q_offset, window) * cot)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    ref_out = np.asarray(_jax_flash(jq, jk, jv, causal, q_offset, window))
    ref_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = tattn.flash_attention(tq, tk, tv, causal=causal, q_offset=q_offset, window=window)
    (out * _t(cot)).sum().backward()

    np.testing.assert_allclose(out.detach().numpy()[:, valid], ref_out[:, valid], atol=2e-5)
    assert np.all(out.detach().numpy()[:, ~valid] == 0)
    for got, ref in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


@pytest.mark.parametrize("causal,n_rep,q_offset,window,sq,sk",
                         [_FLASH_CASES[2], _FLASH_CASES[4], _FLASH_CASES[6]])
def test_flash_lse_value_and_cotangent_match_jax(causal, n_rep, q_offset, window, sq, sk):
    """flash_attention_lse: lse on rows that see a key (atol 2e-5), and the
    gradients of sum(out*cot) + sum(lse*cot_lse) (atol 1e-4)."""
    rng = np.random.default_rng(4)
    q, k, v = _qkv(rng, 1, sq, sk, 4, 4 // n_rep, 64)
    valid = _valid_rows(sq, sk, causal, q_offset, window)
    cot = rng.standard_normal((1, sq, 4, 64)).astype(np.float32) * valid[None, :, None, None]
    cot_lse = rng.standard_normal((1, sq, 4)).astype(np.float32) * valid[None, :, None]

    def jfn(q, k, v):
        return jattn.flash_attention_lse(q, k, v, causal=causal, q_offset=q_offset,
                                         window=window, block_q=64, block_k=64,
                                         interpret=True)

    def jloss(q, k, v):
        o, l = jfn(q, k, v)
        return jnp.sum(o * cot) + jnp.sum(jnp.where(valid[None, :, None], l, 0.0) * cot_lse)

    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, ref_lse = jfn(jq, jk, jv)
    ref_grads = jax.grad(jloss, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out, lse = tattn.flash_attention_lse(tq, tk, tv, causal=causal, q_offset=q_offset,
                                         window=window)
    assert lse.shape == (1, sq, 4)
    tv_lse = torch.where(torch.from_numpy(valid)[None, :, None], lse, torch.zeros_like(lse))
    ((out * _t(cot)).sum() + (tv_lse * _t(cot_lse)).sum()).backward()

    np.testing.assert_allclose(lse.detach().numpy()[:, valid],
                               np.asarray(ref_lse)[:, valid], atol=2e-5)
    assert np.all(np.isneginf(lse.detach().numpy()[:, ~valid]))
    for got, ref in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)


def test_attention_dispatch_uses_xla_on_cpu_and_rejects_unknown():
    rng = np.random.default_rng(5)
    q, k, v = (_t(x) for x in _qkv(rng, 1, 128, 128, 4, 2, 64))
    ref = tattn.attention_xla(q, k, v)
    torch.testing.assert_close(tattn.attention(q, k, v), ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(q, k, v, impl="ring")


@pytest.mark.parametrize("bad,match", [
    (dict(d=256), "head_dim.*ROADMAP"),
    (dict(sq=96), "multiples of 64"),
    (dict(dtype=torch.float32), "bfloat16.*ROADMAP"),
    (dict(window=16, causal=False), "window requires causal"),
    (dict(lse_dtype=torch.bfloat16), "lse/delta"),
    (dict(dout_sq=64), "dout"),
    (dict(k_contig=False), "contiguous"),
])
def test_kernel_wrapper_checks_reject_what_the_kernels_do_not_take(bad, match):
    """The shape/dtype/layout checks each wrapper runs before a CUDA launch."""
    d, sq = bad.get("d", 64), bad.get("sq", 128)
    dtype = bad.get("dtype", torch.bfloat16)
    q = torch.zeros(1, sq, 4, d, dtype=dtype)
    k = torch.zeros(1, 128, 2, d, dtype=dtype)
    if not bad.get("k_contig", True):
        k = torch.zeros(1, 2, 128, d, dtype=dtype).transpose(1, 2)
    dout = torch.zeros(1, bad.get("dout_sq", sq), 4, d, dtype=dtype)
    lse = torch.zeros(1, 4, sq, dtype=bad.get("lse_dtype", torch.float32))
    with pytest.raises((ValueError, TypeError, NotImplementedError), match=match):
        tattn._check_cuda(q, k, k, causal=bad.get("causal", True),
                          window=bad.get("window", 0), dout=dout, lse=lse, delta=lse)


@pytest.mark.parametrize("sq,sk,d,dtype,ok", [
    (128, 128, 128, torch.bfloat16, True),
    (256, 384, 64, torch.bfloat16, True),
    (128, 128, 256, torch.bfloat16, True),
    (128, 128, 128, torch.float32, True),
    (64, 64, 64, torch.bfloat16, False),
    (192, 128, 128, torch.bfloat16, False),
    (128, 128, 96, torch.bfloat16, False),
])
def test_tile_ok_is_the_jax_shape_rule(sq, sk, d, dtype, ok):
    """The flash path's rule of nexus_tpu/ops/attention.py::attention: S
    tiles by min(128, S), S >= 128, head dim 64/128/256, any dtype."""
    q = torch.zeros(1, sq, 4, d, dtype=dtype)
    k = torch.zeros(1, sk, 2, d, dtype=dtype)
    assert tattn.tile_ok(q, k) is ok


@pytest.mark.parametrize("tile", [64, 128])
def test_planted_kernel_faults_fail_the_chip_smoke_limits(tile):
    """chip_smoke.py's limits reject the faults a loop bound makes (a key
    tile skipped for the last query tile; the last query tile skipped for
    the dK/dV tiles), here at S 512 on the plain versions in bf16, for
    tiles of 64 rows and of 128 (the Hopper kernels' block)."""
    from chip_smoke import planted_faults

    g = torch.Generator().manual_seed(0)
    q, dout = (torch.randn(1, 512, 4, 64, generator=g).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.randn(1, 512, 2, 64, generator=g).to(torch.bfloat16) for _ in range(2))
    ratios = planted_faults(q, k, v, dout, torch.randn(1, 4, 512, generator=g), tile=tile)
    assert min(ratios.values()) > 1.0, ratios


def test_kernel_wrapper_checks_accept_what_the_kernels_take():
    q = torch.zeros(2, 256, 8, 128, dtype=torch.bfloat16)
    k = torch.zeros(2, 192, 2, 128, dtype=torch.bfloat16)
    lse = torch.zeros(2, 8, 256)
    dims = tattn._check_cuda(q, k, k, causal=True, window=48, dout=q, lse=lse, delta=lse)
    assert dims == (2, 256, 192, 8, 2, 128)


@pytest.mark.parametrize("chunk", [64, 100, 256])
def test_cross_entropy_dense_and_chunked_match_jax(chunk):
    """Value and gradients (hidden, lm_head) of the dense and the
    vocab-chunked loss; V = 250 is not divided by 64 or 100: atol 1e-5."""
    rng = np.random.default_rng(6)
    h = rng.standard_normal((2, 16, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 250)) * 0.2).astype(np.float32)
    tgt = rng.integers(0, 250, (2, 16)).astype(np.int32)
    jh, jw, jt = jnp.asarray(h), jnp.asarray(w), jnp.asarray(tgt)
    for jfn, tfn in (
        (jlosses.dense_softmax_xent, tlosses.dense_softmax_xent),
        (lambda a, b, c: jlosses.chunked_softmax_xent(a, b, c, chunk=chunk),
         lambda a, b, c: tlosses.chunked_softmax_xent(a, b, c, chunk=chunk)),
    ):
        ref, (gh, gw) = jax.value_and_grad(jfn, argnums=(0, 1))(jh, jw, jt)
        th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
        loss = tfn(th, tw, torch.from_numpy(tgt))
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(ref), atol=1e-5)
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(gh), atol=1e-5)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-5)
