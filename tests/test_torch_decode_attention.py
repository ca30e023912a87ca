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


@pytest.mark.parametrize("t", [17, 32, 64])
def test_decode_check_takes_any_feed_width(t):
    """The kernel takes every T a serve spec can ask for (prefillChunk, a
    verify window of numSpeculative + 1): its shape check passes, and the
    workspace keeps as many partials a row as at T 16."""
    q = torch.zeros(8, t, 32, 128, dtype=torch.bfloat16)
    pool = torch.zeros(9, 32, 8, 128, dtype=torch.bfloat16)
    table = torch.zeros(8, 4, dtype=torch.int32)
    tattn._check_decode(q, pool, pool, table, None, None)
    assert tattn.decode_max_partials(8, 32, t, 128) == tattn.decode_max_partials(8, 32, 16, 128)


def _cast(c, dtype):
    """The case with q and a native pool in ``dtype`` (an int8 pool keeps
    its int8 values and f32 scales)."""
    out = dict(c, q=c["q"].astype(dtype))
    if c["ks"] is None:
        out.update(k=c["k"].astype(dtype), v=c["v"].astype(dtype))
    return out


def _to_np(x):
    return x.float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


@pytest.mark.parametrize("d", [16, 96])
@pytest.mark.parametrize("pool", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n_rep", [1, 4])
@pytest.mark.parametrize("t", [1, 8, 17])
def test_fused_at_head_dims_16_and_96_matches_jax(d, pool, n_rep, t):
    """D1's plain version at the head dims the kernel now takes (the tiny
    presets' 16, GPT-NeoX-20B's 96), with the Hydragen split over two
    shared blocks and a window: float32 within RTOL/ATOL; bf16 within 2e-2
    of the reference's norm (both round q, K and V to bf16 and the output
    at other points)."""
    c = _paged_case(d + 10 * n_rep + t, b=3, t=t, hq=2 * n_rep, hkv=2, d=d, bs=8, m=7,
                    int8=pool == "int8", stale=True, shared=2)
    if pool == "bfloat16":
        import ml_dtypes

        c = _cast(c, ml_dtypes.bfloat16)
        got = tattn.fused_paged_decode_attention(
            torch.from_numpy(c["q"].astype(np.float32)).bfloat16(),
            torch.from_numpy(c["k"].astype(np.float32)).bfloat16(),
            torch.from_numpy(c["v"].astype(np.float32)).bfloat16(),
            torch.from_numpy(c["table"]), torch.from_numpy(c["start"]), window=9,
            n_blocks=torch.from_numpy(c["n_blocks"]), shared_blocks=torch.tensor(2),
            shared_table=torch.from_numpy(c["shared_table"]))
        ref = _jax_fused(c, 9, shared_blocks=2)
        assert got.dtype == torch.bfloat16 and got.shape == (3, t, 2 * n_rep, d)
        got, ref = _to_np(got), _to_np(ref)
        assert np.linalg.norm(got - ref) <= 2e-2 * np.linalg.norm(ref)
    else:
        _close(_port_fused(c, 9, shared_blocks=2), _jax_fused(c, 9, shared_blocks=2))


@pytest.mark.parametrize("d", tattn.DECODE_HEAD_DIMS)
def test_decode_check_takes_head_dims_16_64_96_and_128(d):
    q = torch.zeros(2, 1, 8, d, dtype=torch.bfloat16)
    pool = torch.zeros(5, 32, 2, d, dtype=torch.bfloat16)
    table = torch.zeros(2, 4, dtype=torch.int32)
    tattn._check_decode(q, pool, pool, table, None, None)
    tattn._check_decode(q, pool.to(torch.int8), pool.to(torch.int8), table,
                        torch.ones(5, 32, 2), torch.ones(5, 32, 2))


@pytest.mark.parametrize("d,q_dtype,pool_dtype", [
    (80, torch.bfloat16, torch.bfloat16), (256, torch.bfloat16, torch.bfloat16),
    (96, torch.float32, torch.float32), (16, torch.bfloat16, torch.float16)])
def test_decode_refusals_name_kernel_queue_item_3(d, q_dtype, pool_dtype):
    """What D1 does not take (another head dim, a non-bf16 query or pool)
    raises naming item 3 of ROADMAP's TPU-kernel queue, not the flash
    kernels' item 2."""
    q = torch.zeros(1, 1, 4, d, dtype=q_dtype)
    pool = torch.zeros(3, 8, 2, d, dtype=pool_dtype)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="'TPU kernels', item 3") as err:
        tattn._check_decode(q, pool, pool, table, None, None)
    assert "flash" not in str(err.value)


@pytest.mark.parametrize("d,dtype", [(16, torch.bfloat16), (96, torch.bfloat16),
                                     (128, torch.float32)])
def test_the_flash_check_still_refuses_16_96_and_float32_naming_item_2(d, dtype):
    """The flash kernels keep their head dims (64, 128) and bf16: 16 and 96
    (which the JAX rule sends to the dense path anyway) and float32 raise
    naming the flash kernels' item."""
    q = torch.zeros(1, 128, 4, d, dtype=dtype)
    k = torch.zeros(1, 128, 2, d, dtype=dtype)
    with pytest.raises(NotImplementedError, match="'TPU kernels', item 2: K1-K3 for float32 and head dim 256"):
        tattn._check_cuda(q, k, k, causal=True, window=0)
    assert tattn.KERNEL_HEAD_DIMS == (64, 128)
    assert not tattn.tile_ok(q, k) or d == 128


def test_kernel_wrapper_takes_the_plain_path_only_on_cpu_tensors():
    """On CPU tensors the wrapper is the plain version and counts nothing."""
    c = _paged_case(9)
    before = tattn.fused_paged_decode_attention.launches
    _port_fused(c)
    assert tattn.fused_paged_decode_attention.launches == before


# ------------------------------------------- the paged-decode kernel's work list
#
# ``decode_work_units`` is the Python twin of the list the kernel derives on
# the device; these hold it to the function it must compute: every visible
# slot of every query row read exactly once, the shared run once per kv head
# per 64 query rows, no unit for what no row sees, no partial past the
# workspace, and (emulated with the plain partials) the JAX output.


def _unit_case(seed, b, t, n_rep, hkv, bs, m, shared, window, ctas, pmax, dead_row=False):
    rng = np.random.default_rng(seed)
    start = rng.integers(0, m * bs - t + 1, size=b)
    if shared:
        start[0] = min(m * bs - t, shared * bs + int(rng.integers(0, bs)))
    if dead_row:
        start[-1] = -t  # a row whose queries sit before position 0: nothing visible
    n_blocks = np.clip(-(-(start + t) // bs), 1, m)
    split = shared if shared else None
    plan, units = tattn.decode_work_units(n_blocks, start, t, bs, window, split, m, n_rep, hkv,
                                          ctas, pmax)
    return dict(start=start, n_blocks=n_blocks, t=t, n_rep=n_rep, hkv=hkv, bs=bs, m=m,
                window=window, split=split, pmax=pmax, plan=plan, units=units)


def _visible_slots(c, r, local):
    """Slots holding a position that query row ``local`` of row r sees."""
    t = local % c["t"]
    qpos = int(c["start"][r]) + t
    nb = int(min(max(c["n_blocks"][r], 1), c["m"]))
    out = set()
    for s in range(nb):
        lo_pos, hi_pos = s * c["bs"], (s + 1) * c["bs"] - 1
        hi_vis = qpos
        lo_vis = qpos - c["window"] + 1 if c["window"] > 0 else 0
        if max(lo_pos, lo_vis) <= min(hi_pos, hi_vis):
            out.add(s)
    return out


def _unit_rows(c, u):
    """(row, local query row) pairs of unit u."""
    rows = c["plan"]["rows"]
    if u.b < 0:
        return [divmod(u.qr0 + i, rows) for i in range(u.nrows)]
    return [(u.b, u.qr0 + i) for i in range(u.nrows)]


UNIT_CASES = [
    # (seed, B, T, n_rep, Hkv, Bs, M, shared, window, ctas, pmax)
    (0, 8, 1, 4, 8, 32, 130, 8, 0, 264, 17),       # the serve shape's geometry
    (1, 8, 8, 4, 8, 32, 22, 8, 0, 264, 17),        # T 8: four 64-row shared groups
    (2, 16, 1, 4, 2, 32, 128, 0, 0, 264, 17),      # no split, uneven depths
    (3, 5, 8, 8, 4, 64, 20, 1, 0, 264, 5),         # two row groups a row, pmax 5
    (4, 3, 16, 2, 2, 8, 40, 3, 48, 132, 3),        # T 16, window, pmax 3
    (5, 64, 1, 4, 8, 32, 12, 4, 0, 264, 2),        # B 64, pmax 2: one own unit a row
    (6, 4, 3, 3, 1, 16, 9, 9, 0, 8, 17),           # the split covers the table; ragged rows
    (7, 6, 1, 1, 3, 48, 11, 2, 100, 1000, 17),     # Bs not a power of two, window
    # feeds past 16 tokens: 68, 128 and 256 query rows a (row, kv head)
    (8, 4, 17, 4, 2, 32, 30, 4, 0, 264, 17),       # T 17: a ragged third row group
    (9, 3, 32, 4, 2, 32, 24, 2, 64, 132, 9),       # T 32, window
    (10, 8, 64, 4, 8, 32, 40, 8, 0, 264, 17),      # T 64 at the serve geometry
]


@pytest.mark.parametrize("case", UNIT_CASES)
def test_decode_units_read_every_visible_slot_exactly_once(case):
    c = _unit_case(*case)
    for g in range(c["hkv"]):
        reads = {}
        for u in c["units"]:
            if u.g != g:
                continue
            for r, local in _unit_rows(c, u):
                for s in range(u.s0, u.s1):
                    reads[(r, local, s)] = reads.get((r, local, s), 0) + 1
        assert max(reads.values(), default=1) == 1  # no slot read twice for a query row
        for r in range(len(c["start"])):
            for local in range(c["plan"]["rows"]):
                missing = [s for s in _visible_slots(c, r, local) if (r, local, s) not in reads]
                assert missing == [], (g, r, local, missing)


@pytest.mark.parametrize("case", UNIT_CASES)
def test_decode_units_read_the_shared_run_once_per_kv_head_per_row_group(case):
    c = _unit_case(*case)
    rows_all = len(c["start"]) * c["plan"]["rows"]
    groups = -(-rows_all // tattn.DECODE_UNIT_ROWS)
    s_eff = c["plan"]["s_eff"]
    for g in range(c["hkv"]):
        shared = [u for u in c["units"] if u.g == g and u.b < 0]
        per_slot = {}
        for u in shared:
            assert u.s1 <= s_eff
            for s in range(u.s0, u.s1):
                per_slot[s] = per_slot.get(s, 0) + 1
        assert set(per_slot.values()) <= {groups}
        # no row's own unit reads a slot under the split
        assert all(u.s0 >= s_eff for u in c["units"] if u.g == g and u.b >= 0)
    if c["split"] and c["t"] * c["n_rep"] * len(c["start"]) <= tattn.DECODE_UNIT_ROWS:
        assert groups == 1  # T 1 at the serve shape: once per wave


@pytest.mark.parametrize("case", UNIT_CASES)
def test_decode_units_skip_rows_with_nothing_visible(case):
    c = _unit_case(*case, dead_row=True)
    dead = len(c["start"]) - 1
    assert not any(u.b == dead for u in c["units"])
    # its only arrivals are the shared units over its (masked) query rows
    rows = c["plan"]["rows"]
    per_group = tattn.DECODE_UNIT_ROWS
    groups = (dead * rows + rows - 1) // per_group - (dead * rows) // per_group + 1
    assert c["plan"]["arrivals"][dead] == c["plan"]["nsh"] * groups
    # every unit reads at least one slot
    assert all(u.s1 > u.s0 and u.nrows > 0 for u in c["units"])
    # and a batch that sees nothing at all gives an empty list
    _, none = tattn.decode_work_units([1, 1], [-1, -1], 1, 32, 0, 1, 4, 4, 2, 264, 17)
    assert none == []


@pytest.mark.parametrize("case", UNIT_CASES)
def test_decode_units_stay_in_the_workspace_and_count_their_arrivals(case):
    c = _unit_case(*case)
    plan, units = c["plan"], c["units"]
    for r in range(len(c["start"])):
        slots = {u.pslot for u in units if u.g == 0 and u.b == r}
        assert plan["nsh"] + len(slots) <= c["pmax"]
        assert slots == set(range(plan["nsh"], plan["nsh"] + len(slots)))
    assert all(0 <= u.pslot < c["pmax"] for u in units)
    # the arrivals that complete a (row, kv head) are the units touching it
    for g in range(c["hkv"]):
        for r, want in enumerate(plan["arrivals"]):
            got = sum(1 for u in units if u.g == g and r in {x for x, _ in _unit_rows(c, u)})
            assert got == want, (g, r)


def _emulate_units(c, q, k, v, table, shared_table, window, ks=None, vs=None):
    """The kernel's arithmetic, unit by unit, with the plain partials: each
    unit's (m, l, acc) over its slots, stored at its partial slot, then
    every query row's partials merged by log-sum-exp."""
    b, t = q.shape[:2]
    hkv, n_rep, rows = c["hkv"], c["n_rep"], c["plan"]["rows"]
    start = torch.as_tensor(c["start"])
    nbs = torch.as_tensor(c["n_blocks"]).long()
    parts = {}
    for u in c["units"]:
        tab = shared_table[None].expand(b, -1) if u.b < 0 else table
        m_, l_, a_ = tattn.paged_attention_partials(
            q, k, v, tab, start, u.s0, u.s1, nbs, window, k_scale=ks, v_scale=vs)
        for r, local in _unit_rows(c, u):
            key = (r, u.g, local // t, local % t)
            assert (key, u.pslot) not in parts
            parts[(key, u.pslot)] = (m_[r, u.g, local // t, local % t],
                                     l_[r, u.g, local // t, local % t],
                                     a_[r, u.g, local // t, local % t])
    out = torch.zeros(q.shape, dtype=torch.float32)
    for r in range(b):
        for g in range(hkv):
            for local in range(rows):
                key = (r, g, local // t, local % t)
                mine = [parts[(key, s)] for s in range(c["pmax"]) if (key, s) in parts]
                if not mine:
                    continue
                mm = torch.stack([x[0] for x in mine]).max()
                e = [torch.exp(x[0] - mm) for x in mine]
                ll = sum(x[1] * w for x, w in zip(mine, e))
                acc = sum(x[2] * w for x, w in zip(mine, e))
                out[r, local % t, g * n_rep + local // t] = acc / ll if ll != 0 else 0.0
    return out


@pytest.mark.parametrize("shared,window,int8", [(3, 0, False), (0, 40, False), (5, 0, True),
                                                (9, 20, False)])
def test_the_unit_list_computes_the_jax_function(shared, window, int8):
    """The work list, partials and merge the kernel runs give the JAX
    function's output (float32, emulated with the plain partials)."""
    c = _paged_case(21 + shared, b=4, t=2, hq=8, hkv=2, d=16, bs=32, m=9, int8=int8,
                    shared=min(shared, 8))
    split = shared if shared else None
    plan_c = dict(start=c["start"], n_blocks=c["n_blocks"], t=2, n_rep=4, hkv=2, bs=32, m=9,
                  window=window, pmax=4)
    plan_c["plan"], plan_c["units"] = tattn.decode_work_units(
        c["n_blocks"], c["start"], 2, 32, window, split, 9, 4, 2, 64, 4)
    tab = torch.from_numpy(c["table"])
    if split:  # slots under the split read the shared table
        tab = tab.clone()
        tab[:, :split] = torch.from_numpy(c["shared_table"])[:split]
    opt = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    got = _emulate_units(plan_c, torch.from_numpy(c["q"]), torch.from_numpy(c["k"]),
                         torch.from_numpy(c["v"]), tab, torch.from_numpy(c["shared_table"]),
                         window, opt(c["ks"]), opt(c["vs"]))
    ref = _jax_fused(c, window, shared_blocks=split)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
