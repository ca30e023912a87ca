"""The port's decode attention (nexus_tpu_torch.ops.attention) against the
JAX package's, on the CPU in float32: the dense ``decode_attention``, the
gather-then-attend ``paged_decode_attention``, and the plain version of
``fused_paged_decode_attention`` (what a CPU tensor runs; the paged-decode
kernel is held against it on the card).

Inputs come from numpy seeds: random permuted block tables, rows that share
leading blocks, scratch-padded and stale (pointing at live blocks) table
tails, ragged depths, n_rep 1/2/4, windows, int8 pools with f32 scales, and
T 1 and 8. Tolerance rtol 1e-5, atol 1e-6: the logits are the same dots
with the same scale and mask value, and only the softmax reduction order
differs between the two frameworks' kernels (float32 roundoff).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu_torch.ops import attention as tattn

# the JAX package's ops/__init__ re-exports a function named ``attention``
jattn = importlib.import_module("nexus_tpu.ops.attention")

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch at these
    tiny shapes gains nothing from threads, so keep it to one here rather
    than crowd out the other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _paged_case(seed, b=3, t=1, hq=4, hkv=2, d=16, bs=4, m=6, int8=False,
                stale=False, shared=0):
    """A pool of N blocks (the last one scratch), per-row depths, tables
    mapping each row's valid blocks onto distinct pool blocks, the first
    ``shared`` of them common to every row."""
    rng = np.random.default_rng(seed)
    n = b * m + 2
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (n, bs, hkv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (n, bs, hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (n, bs, hkv)).astype(np.float32)
    else:
        k = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
        v = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
        ks = vs = None
    # ragged depths; the feed of t tokens must fit the table
    start = rng.integers(shared * bs, m * bs - t + 1, size=b).astype(np.int32)
    if b > 1:
        start[0] = 0 if shared == 0 else shared * bs  # a shallow row
    n_blocks = -(-(start + t) // bs)
    perm = rng.permutation(n - 1)  # never the scratch block
    table = np.full((b, m), n - 1, np.int32)
    common = perm[:shared]
    used = shared
    for r in range(b):
        own = perm[used:used + m]
        used += m - shared
        table[r, :shared] = common
        table[r, shared:n_blocks[r]] = own[: n_blocks[r] - shared]
        if stale:  # entries past the row's blocks point at live blocks
            table[r, n_blocks[r]:] = perm[: m - n_blocks[r]]
    shared_table = np.full((m,), n - 1, np.int32)
    shared_table[:shared] = common
    return dict(q=q, k=k, v=v, ks=ks, vs=vs, start=start, n_blocks=n_blocks.astype(np.int32),
                table=table, shared_table=shared_table)


def _jax_fused(c, window=0, shared_blocks=None, n_blocks=True):
    opt = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    return jattn.fused_paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), jnp.asarray(c["table"]),
        jnp.asarray(c["start"]), window=window, k_scale=opt(c["ks"]), v_scale=opt(c["vs"]),
        n_blocks=jnp.asarray(c["n_blocks"]) if n_blocks else None,
        shared_blocks=None if shared_blocks is None else jnp.asarray(shared_blocks, jnp.int32),
        shared_table=None if shared_blocks is None else jnp.asarray(c["shared_table"]))


def _port_fused(c, window=0, shared_blocks=None, n_blocks=True):
    opt = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    return tattn.fused_paged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
        torch.from_numpy(c["table"]), torch.from_numpy(c["start"]), window=window,
        k_scale=opt(c["ks"]), v_scale=opt(c["vs"]),
        n_blocks=torch.from_numpy(c["n_blocks"]) if n_blocks else None,
        shared_blocks=None if shared_blocks is None else torch.tensor(shared_blocks, dtype=torch.int32),
        shared_table=None if shared_blocks is None else torch.from_numpy(c["shared_table"]))


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("t", [1, 8])
@pytest.mark.parametrize("window", [0, 6])
def test_fused_matches_jax(hq, hkv, t, window):
    c = _paged_case(hq * 10 + t + window, t=t, hq=hq, hkv=hkv, stale=True)
    _close(_port_fused(c, window), _jax_fused(c, window))


@pytest.mark.parametrize("t", [1, 8])
def test_fused_int8_pool_matches_jax(t):
    c = _paged_case(7 + t, t=t, int8=True)
    _close(_port_fused(c, 5), _jax_fused(c, 5))


def test_fused_default_n_blocks_matches_jax():
    c = _paged_case(11, t=2)
    _close(_port_fused(c, n_blocks=False), _jax_fused(c, n_blocks=False))


@pytest.mark.parametrize("int8", [False, True])
def test_hydragen_split_at_every_point_matches_the_unsplit_loop_and_jax(int8):
    """Rows share their first 3 blocks; every split length 0..hi (and one
    past, which clips) gives the unsplit loop's output."""
    c = _paged_case(5, b=4, t=1, shared=3, int8=int8, m=7)
    unsplit = _port_fused(c)
    hi = int(c["n_blocks"].max())
    for s in range(0, hi + 2):
        got = _port_fused(c, shared_blocks=min(s, 3))
        np.testing.assert_allclose(got.numpy(), unsplit.numpy(), rtol=RTOL, atol=ATOL)
        _close(got, _jax_fused(c, shared_blocks=min(s, 3)))


@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("int8", [False, True])
def test_gather_path_matches_jax(window, int8):
    c = _paged_case(3, t=3, int8=int8, stale=True)
    opt_t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    opt_j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    got = tattn.paged_decode_attention(
        torch.from_numpy(c["q"]), torch.from_numpy(c["k"]), torch.from_numpy(c["v"]),
        torch.from_numpy(c["table"]), torch.from_numpy(c["start"]), window=window,
        k_scale=opt_t(c["ks"]), v_scale=opt_t(c["vs"]))
    ref = jattn.paged_decode_attention(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), jnp.asarray(c["table"]),
        jnp.asarray(c["start"]), window=window, k_scale=opt_j(c["ks"]), v_scale=opt_j(c["vs"]))
    _close(got, ref)
    # the fused plain version computes the same function
    fused = _port_fused(c, window)
    np.testing.assert_allclose(fused.numpy(), got.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("start", [5, "vector"])
@pytest.mark.parametrize("window", [0, 4])
@pytest.mark.parametrize("int8", [False, True])
def test_dense_decode_attention_matches_jax(start, window, int8):
    rng = np.random.default_rng(17)
    b, t, hq, hkv, d, L = 2, 3, 4, 2, 16, 24
    q = rng.standard_normal((b, t, hq, d)).astype(np.float32)
    if int8:
        k = rng.integers(-127, 128, (b, L, hkv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (b, L, hkv, d)).astype(np.int8)
        ks = rng.uniform(0.001, 0.02, (b, L, hkv)).astype(np.float32)
        vs = rng.uniform(0.001, 0.02, (b, L, hkv)).astype(np.float32)
    else:
        k = rng.standard_normal((b, L, hkv, d)).astype(np.float32)
        v = rng.standard_normal((b, L, hkv, d)).astype(np.float32)
        ks = vs = None
    st = np.array([3, 17], np.int32) if start == "vector" else start
    opt_t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    opt_j = lambda x: None if x is None else jnp.asarray(x)  # noqa: E731
    got = tattn.decode_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 torch.as_tensor(st), window=window,
                                 k_scale=opt_t(ks), v_scale=opt_t(vs))
    ref = jattn.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(st),
                                 window=window, k_scale=opt_j(ks), v_scale=opt_j(vs))
    _close(got, ref)


def test_merge_and_finalize_match_jax():
    rng = np.random.default_rng(2)
    shape = (2, 2, 3, 4)
    parts = []
    for _ in range(2):
        m = rng.standard_normal(shape).astype(np.float32)
        m[0, 0, 0, 0] = tattn.DEFAULT_MASK_VALUE  # a row that saw nothing
        l = np.abs(rng.standard_normal(shape)).astype(np.float32)
        l[0, 0, 0, 0] = 0.0
        acc = rng.standard_normal(shape + (8,)).astype(np.float32)
        acc[0, 0, 0, 0] = 0.0
        parts.append((m, l, acc))
    t_parts = [tuple(torch.from_numpy(x) for x in p) for p in parts]
    j_parts = [tuple(jnp.asarray(x) for x in p) for p in parts]
    got = tattn.finalize_attention_partials(tattn.merge_attention_partials(*t_parts), torch.float32)
    ref = jattn.finalize_attention_partials(jattn.merge_attention_partials(*j_parts), jnp.float32)
    _close(got, ref)
    assert (got[0, 0, 0] == 0).all()  # l == 0 in both parts → exact zeros


def test_kernel_wrapper_takes_the_plain_path_only_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and counts nothing."""
    c = _paged_case(9)
    before = tattn.fused_paged_decode_attention.launches
    _port_fused(c)
    assert tattn.fused_paged_decode_attention.launches == before


def test_decode_splits_fill_the_card_and_stay_in_the_table():
    assert tattn.decode_splits(8, 8, 4, 256) == 9       # 64 (row, head) pairs
    assert tattn.decode_splits(8, 8, 64, 256) == 5      # two row groups
    assert tattn.decode_splits(1, 1, 1, 3) == 3         # never past the table
    assert tattn.decode_splits(64, 8, 4, 256) == 2
