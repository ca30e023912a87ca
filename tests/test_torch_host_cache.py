"""The host-RAM spill tier in the port (runtime/host_cache.py, the
allocator's spill and restore, ``gather_kv_block`` / ``write_kv_blocks``
and the engine's tier) against the JAX package's, on the CPU.

* The store: the same puts, takes and drops give the same bytes, keys,
  demotion flags and ``stats()``; the port keeps torch CPU tensors where
  JAX keeps numpy arrays, with the same byte count (numel × element size).
* int8 demotion: bit for bit JAX's ``quantize_kv_host`` (float32 and bf16
  inputs, zero vectors included), within max|x|/254 of the input.
* ``gather_kv_block`` / ``write_kv_blocks``: JAX's results on bf16 and int8
  planes; a padding id (out of range) writes no live block.
* The allocator with a host tier, driven by the same seeded operations as
  JAX's (admit with resident and spilled spans, grow, publish, release;
  spills and restores come from pool pressure): the same spills, restores,
  host evictions, free and parked lists, refcounts, tree keys, spilled set,
  store keys and bytes after every operation, and the same restored
  payloads; a host budget of ~1.5 blocks; the drain of a pending digest.
* The engine, tiny Llama in float32 with the same weights, a 4-block pool
  under two alternating prompt families: the port's tokens and clock-free
  ledger (every host-tier key) equal JAX's with the tier off, native and
  int8-demoting, on a float32 and an int8 pool, closed-loop and streamed;
  a second serve call restores what the first spilled; a cancel mid-decode
  leaves pool, tree and store coherent.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.models import decoding as jdec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import host_cache as jhc
from nexus_tpu.runtime import prefix_cache as jpc
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.runtime import traffic as jtraffic
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import decoding as tdec
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.runtime import host_cache as thc
from nexus_tpu_torch.runtime import prefix_cache as tpc
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime import traffic as ttraffic
from nexus_tpu_torch.testing import sanitizers as tsan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch gains nothing from
    threads at these shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_planes(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(
        _np(a[k]).dtype == _np(b[k]).dtype and np.array_equal(_np(a[k]), _np(b[k])) for k in a)


# ------------------------------------------------------------------ store

BLOCK = 4


def _planes(rng, scale=1.0):
    return {"k": (rng.randn(2, BLOCK, 1, 8) * scale).astype(np.float32),
            "v": (rng.randn(2, BLOCK, 1, 8) * scale).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_store_follows_the_jax_store(dtype):
    rng = np.random.RandomState(7)
    one = sum(a.nbytes for a in _planes(rng).values())
    stores = [jhc.HostBlockStore(3 * one, dtype=dtype), thc.HostBlockStore(3 * one, dtype=dtype)]
    live = []
    for step in range(60):
        op = rng.randint(3) if live else 0
        if op == 0:
            key = bytes([step])
            planes = _planes(rng, scale=float(rng.choice([0.0, 1.0, 30.0])))
            stores[0].put(key, planes)
            stores[1].put(key, {k: torch.from_numpy(v.copy()) for k, v in planes.items()})
            live.append(key)
        else:
            key = live.pop(rng.randint(len(live)))
            if op == 1:
                (jp, jd), (tp, td) = stores[0].take(key), stores[1].take(key)
                assert jd == td and _same_planes(jp, tp)
                assert all(isinstance(v, torch.Tensor) for v in tp.values())
            else:
                for s in stores:
                    s.drop(key)
        assert stores[1].keys() == stores[0].keys()
        assert stores[1].bytes == stores[0].bytes
        assert stores[1].over_budget() == stores[0].over_budget()
        assert stores[1].stats() == stores[0].stats()
        stores[1].audit()
    assert stores[1].stats()["puts"] > 20 and stores[1].stats()["bytes_peak"] > one


def test_store_refuses_what_the_jax_store_refuses():
    for store in (jhc, thc):
        with pytest.raises(ValueError):
            store.HostBlockStore(-1)
        with pytest.raises(ValueError):
            store.HostBlockStore(10, dtype="fp4")
    s = thc.HostBlockStore(10)
    s.put(b"a", {"k": torch.zeros(2), "v": torch.zeros(2)})
    with pytest.raises(ValueError, match="already spilled"):
        s.put(b"a", {"k": torch.zeros(2), "v": torch.zeros(2)})
    # an int8 payload (an int8 pool's block) passes an int8 store unchanged
    s8 = thc.HostBlockStore(1 << 20, dtype="int8")
    q = {"k": torch.ones(2, 3, dtype=torch.int8), "v": torch.ones(2, 3, dtype=torch.int8),
         "k_scale": torch.ones(2), "v_scale": torch.ones(2)}
    s8.put(b"q", q)
    planes, demoted = s8.take(b"q")
    assert not demoted and _same_planes(planes, q)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_demotion_is_bit_identical_to_jax(dtype):
    rng = np.random.RandomState(3)
    x = (rng.randn(3, 7, 2, 16) * rng.choice([0.01, 1.0, 100.0], size=(3, 7, 2, 1)))
    x = x.astype(np.float32)
    x[0, 0, 0] = 0.0  # a zero vector: scale 0, values 0
    x[1, 2, 1, :4] = [127.0, 63.5, -63.5, 0.5]  # half-way cases round to even
    if dtype == "bfloat16":
        jx = np.asarray(jnp.asarray(x, jnp.bfloat16))
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = x, torch.from_numpy(x)
    jq, js = jhc.quantize_kv_host(jx)
    tq, ts = thc.quantize_kv_host(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), jq) and np.array_equal(ts.numpy(), js)
    assert np.array_equal(thc.dequantize_kv_host(tq, ts).numpy(), jhc.dequantize_kv_host(jq, js))
    assert (tq[0, 0, 0] == 0).all() and ts[0, 0, 0] == 0
    ref = tx.float()
    err = (thc.dequantize_kv_host(tq, ts) - ref).abs()
    assert (err <= ref.abs().amax(dim=-1, keepdim=True) / 254.0 + 1e-6).all()


# ------------------------------------------------------ gather / write blocks


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_gather_and_write_kv_blocks_match_jax(quantized):
    rng = np.random.RandomState(11)
    L, N, Bs, H, D = 2, 6, 4, 2, 8  # N pool blocks, the last one scratch
    planes = {}
    if quantized:
        planes["k"] = rng.randint(-127, 128, size=(L, N, Bs, H, D)).astype(np.int8)
        planes["v"] = rng.randint(-127, 128, size=(L, N, Bs, H, D)).astype(np.int8)
        planes["k_scale"] = rng.rand(L, N, Bs, H).astype(np.float32)
        planes["v_scale"] = rng.rand(L, N, Bs, H).astype(np.float32)
    else:
        planes["k"] = rng.randn(L, N, Bs, H, D).astype(np.float32)
        planes["v"] = rng.randn(L, N, Bs, H, D).astype(np.float32)

    def jcast(k, v):
        return jnp.asarray(v, jnp.bfloat16) if not quantized and k in ("k", "v") else jnp.asarray(v)

    def tcast(k, v):
        t = torch.from_numpy(v.copy())
        return t.to(torch.bfloat16) if not quantized and k in ("k", "v") else t

    jcache = {k: jcast(k, v) for k, v in planes.items()}
    tcache = {k: tcast(k, v) for k, v in planes.items()}
    for blk in (0, 3, N - 1):
        jg, tg = jdec.gather_kv_block(jcache, jnp.int32(blk)), tdec.gather_kv_block(tcache, blk)
        assert set(jg) == set(tg)
        for k in jg:
            assert torch.equal(tg[k].float(), torch.from_numpy(np.asarray(jg[k]).astype(
                np.float32)))
            assert tg[k].data_ptr() != tcache[k].data_ptr()  # a copy, not a view
    # a wave of three uploads, two of them padding (out of range)
    dst = np.array([2, N + 1, 0, -1], dtype=np.int32)
    up = {k: rng.randn(L, 4, *v.shape[2:]).astype(np.float32) if v.dtype == np.float32
          else rng.randint(-127, 128, size=(L, 4) + v.shape[2:]).astype(np.int8)
          for k, v in planes.items()}
    jout = jdec.write_kv_blocks(jcache, jnp.asarray(dst), {k: jcast(k, v) for k, v in up.items()})
    before = {k: v.clone() for k, v in tcache.items()}
    tout = tdec.write_kv_blocks(tcache, torch.from_numpy(dst), {k: tcast(k, v)
                                                                for k, v in up.items()})
    for k in planes:
        assert tout[k] is tcache[k]  # in place
        got = tout[k][:, : N - 1].float().numpy()
        ref = np.asarray(jout[k]).astype(np.float32)[:, : N - 1]
        assert np.array_equal(got, ref), k
        # the live blocks the wave did not name keep their content
        assert torch.equal(tout[k][:, [1, 3, 4]], before[k][:, [1, 3, 4]])


# -------------------------------------------------------------- allocator


NUM_BLOCKS = 6  # tight: pool pressure spills and restores often


def _chains():
    chains = []
    for i in range(3):
        toks = [(7 * i + t) % 50 for t in range(5 * BLOCK)]
        chains.append((toks, jpc.chain_keys(toks, BLOCK)))
    return chains


class _Env:
    """One package's allocator, index and store, with a spill download
    whose payload derives from the digest (the same bytes in both)."""

    def __init__(self, pkg, serving, pc, budget, dtype):
        self.pkg = pkg
        self.store = pkg.HostBlockStore(budget, dtype=dtype)
        self.idx = pc.PrefixCacheIndex()
        self.alloc = serving.BlockAllocator(NUM_BLOCKS, BLOCK, prefix_index=self.idx,
                                            host_cache=self.store)
        torch_side = pkg is thc

        def spill_fn(blk, key):
            planes = _planes(np.random.RandomState(int.from_bytes(key[:4], "big") % (2**31 - 1)))
            return {k: torch.from_numpy(v) for k, v in planes.items()} if torch_side else planes

        self.alloc.spill_fn = spill_fn
        self.leases = []  # (lease, chain, published chain keys)

    def state(self):
        a, idx, st = self.alloc, self.idx, self.store
        return dict(spills=a.spills, restores=a.restores, host_evictions=a.host_evictions,
                    evictions=a.evictions, free=list(a._free), ref=list(a._ref),
                    reserved=a._reserved, parked=idx.parked_blocks(),
                    keys=sorted(idx.indexed_keys()), spilled=sorted(idx._spilled),
                    store_keys=st.keys(), store_bytes=st.bytes, store=st.stats(),
                    leases=[(lease.blocks, c, cov) for lease, c, cov in self.leases],
                    peak=a.peak_allocated)


def _step(env, chains, op):
    """One operation → what it returned: admit a chain (its resident and
    spilled spans, 1-4 private blocks), grow a lease to its reservation,
    release one, or publish a lease's chain blocks (under the engine's
    guard: only beneath a parent its own block holds)."""
    kind, x, y = op
    a, idx = env.alloc, env.idx
    if kind == 0:
        toks, keys = chains[x % len(chains)]
        shared, skeys, matched, cow = a.match_prefix(keys, len(toks) + 3)
        lease = a.admit(1 + y % 4, shared=shared, restore=skeys)
        if lease is None:
            return ("refused", matched)
        env.leases.append((lease, x % len(chains), len(shared) + len(skeys)))
        return ("admitted", matched, [(b, d, {k: _np(v) for k, v in p.items()})
                                      for b, p, d in lease.restored_payloads])
    if not env.leases:
        return ("noop",)
    i = x % len(env.leases)
    lease, c, cov = env.leases[i]
    if kind == 1:
        return ("grew", lease.grow_to(len(lease.shared) + lease.reservation))
    if kind == 2:
        env.leases.pop(i)
        lease.release()
        return ("released",)
    keys = chains[c][1]
    published = []
    for b in [b for b in lease._private if not idx.holds(b)]:
        if cov >= len(keys) or (cov and idx.holder(keys[cov - 1]) != lease.blocks[cov - 1]):
            break
        if not a.register_block(keys[cov], b, parent=keys[cov - 1] if cov else None):
            break
        published.append(cov)
        cov += 1
    env.leases[i] = (lease, c, cov)
    return ("published", published)


def _same_result(a, b):
    if a[0] != "admitted" or b[0] != "admitted":
        return a == b
    return a[:2] == b[:2] and len(a[2]) == len(b[2]) and all(
        ba == bb and da == db and _same_planes(pa, pb)
        for (ba, da, pa), (bb, db, pb) in zip(a[2], b[2]))


def _drive_both(ops, dtype, budget):
    chains = _chains()
    envs = [_Env(jhc, jserving, jpc, budget, dtype), _Env(thc, tserving, tpc, budget, dtype)]
    for op in ops:
        got = [_step(env, chains, op) for env in envs]
        assert _same_result(got[0], got[1]), (op, got)
        assert envs[1].state() == envs[0].state(), op
        envs[1].idx.audit()
        envs[1].store.audit()
    for env in envs:
        for lease, _, _ in env.leases:
            lease.release()
        env.leases = []
    assert envs[1].state() == envs[0].state()
    part = envs[1].alloc.pool_partition()
    assert part["allocated"] == part["reserved"] == 0
    assert set(envs[1].store.keys()) == set(envs[1].idx._spilled)
    return envs[1].alloc


def _ops(rng, n):
    return [(int(rng.randint(0, 4)), int(rng.randint(0, 32)), int(rng.randint(0, 32)))
            for _ in range(n)]


@pytest.mark.parametrize("dtype", ["native", "int8"])
def test_allocator_host_tier_follows_the_jax_allocator(dtype):
    rng = np.random.RandomState(20260803 + (dtype == "int8"))
    spills = restores = 0
    for _ in range(60):
        a = _drive_both(_ops(rng, int(rng.randint(20, 60))), dtype, budget=1 << 20)
        spills += a.spills
        restores += a.restores
    assert spills >= 10 and restores >= 3


def test_allocator_host_tier_follows_jax_under_a_tiny_host_budget():
    rng = np.random.RandomState(4242)
    one = sum(a.nbytes for a in _planes(rng).values())
    evictions = 0
    for _ in range(60):
        a = _drive_both(_ops(rng, int(rng.randint(20, 60))), "native", budget=one + one // 2)
        evictions += a.host_evictions
    assert evictions > 0


def test_admit_restore_survives_the_drain_of_a_pending_digest():
    """A spill inside admit()'s restore loop pushes the store over budget
    while a digest of the same admission still waits as a spilled leaf: the
    drain runs at the boundary, after every restore (JAX's order)."""
    rng = np.random.RandomState(11)
    one = sum(a.nbytes for a in _planes(rng).values())
    keys_a = tpc.chain_keys(list(range(BLOCK)), BLOCK)
    keys_b = tpc.chain_keys(list(range(50, 50 + BLOCK)), BLOCK)
    results = []
    for pkg, serving, pc in ((jhc, jserving, jpc), (thc, tserving, tpc)):
        store = pkg.HostBlockStore(one + one // 2)
        idx = pc.PrefixCacheIndex()
        alloc = serving.BlockAllocator(2, BLOCK, prefix_index=idx, host_cache=store)
        alloc.spill_fn = lambda blk, key, pkg=pkg: (
            {k: torch.from_numpy(v) for k, v in _planes(np.random.RandomState(blk)).items()}
            if pkg is thc else _planes(np.random.RandomState(blk)))
        la = alloc.admit(1)
        (a0,) = la.grow_to(1)
        alloc.register_block(keys_a[0], a0)
        la.release()
        lb = alloc.admit(2)
        b0, _ = lb.grow_to(2)
        alloc.register_block(keys_b[0], b0)
        lb.release()
        lease = alloc.admit(0, restore=[keys_a[0]])
        assert lease is not None and idx.holder(keys_a[0]) == lease.shared[0]
        assert not store.over_budget() and set(store.keys()) == set(idx._spilled)
        idx.audit()
        store.audit()
        results.append((alloc.spills, alloc.restores, alloc.host_evictions, lease.shared,
                        store.keys(), sorted(idx._spilled)))
        lease.release()
    assert results[0] == results[1]


def test_a_host_cache_needs_the_prefix_index():
    with pytest.raises(ValueError, match="prefix index"):
        tserving.BlockAllocator(4, BLOCK, host_cache=thc.HostBlockStore(1 << 20))


# ----------------------------------------------------------------- engine


def _models(int8_cfg=False):
    jcfg = jllama.config("tiny", dtype=jnp.float32, kv_cache_quantized=int8_cfg)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tllama.config("tiny", dtype="float32", kv_cache_quantized=int8_cfg)
    tparams = llama_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    for t in tllama.leaves(tparams):
        t.requires_grad_(False)
    return (jcfg, jparams), (tcfg, tparams)


def _pressure_queue(seed=5, groups=2, repeats=3):
    """Alternating warm prompt families through a pool too small to keep
    both resident: every re-admission finds its family spilled."""
    rng = np.random.RandomState(seed)
    fams = [rng.randint(0, 256, size=16).tolist() for _ in range(groups)]
    return [(g + rng.randint(0, 256, size=4).tolist(), 4) for _ in range(repeats) for g in fams]


ENGINE = dict(batch_size=1, max_len=64, chunk=4, prefill_chunk=4, kv_block_size=8,
              kv_num_blocks=4, prefix_cache=True)
# the wall clock's keys
CLOCKED = ("wall_s", "tokens_per_sec")
HOST_KEYS = ("host_cache_enabled", "spilled_blocks", "restored_blocks", "restore_hit_tokens",
             "restore_hit_requests", "host_cache_bytes", "host_cache_bytes_peak",
             "host_cache_dtype", "host_cache_evictions", "kv_spilled_blocks_final",
             "host_cache_entries_final")


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += float(s)


def _serve_both(q, mode="closed", calls=1, **kw):
    """The same queue through the JAX engine and the port's → per call
    (JAX results, JAX metrics, port results, port metrics)."""
    (jcfg, jparams), (tcfg, tparams) = _models()
    out = []
    engines = []
    for serving, traffic, fwd, params, cfg in (
            (jserving, jtraffic, jllama.forward_decode, jparams, jcfg),
            (tserving, ttraffic, tllama.forward_decode, tparams, tcfg)):
        clk = FakeClock()
        eng = serving.ServingEngine(fwd, params, cfg, clock=clk, **ENGINE, **kw)
        eng._sanitize = True  # the engine's in-loop audits, whatever the environment
        engines.append(eng)
        runs = []
        for _ in range(calls):
            reqs = [serving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q]
            if mode == "streamed":
                src = traffic.ListSource([(0.3 * i, r) for i, r in enumerate(reqs)],
                                         sleep=clk.sleep)
                runs.append(eng.serve([], source=src, heartbeat=lambda _: clk.sleep(0.1)))
            else:
                runs.append(eng.serve(reqs, heartbeat=lambda _: clk.sleep(0.1)))
        out.append(runs)
    return [(j[0], j[1], t[0], t[1]) for j, t in zip(*out)], engines[1]


def _assert_same(jres, jmet, tres, tmet):
    for a, b in zip(tres, jres):
        assert a.tokens == [int(x) for x in b.tokens]
        assert (a.new_tokens, a.status) == (b.new_tokens, b.status)
    common = [k for k in jmet if k in tmet and k not in CLOCKED]
    assert {k: tmet[k] for k in common} == {k: jmet[k] for k in common}
    return common


@pytest.mark.parametrize("pool,host,mode", [
    ("native", "off", "closed"), ("native", "native", "closed"), ("native", "int8", "closed"),
    ("int8", "native", "closed"), ("int8", "int8", "closed"),
    ("native", "native", "streamed"), ("native", "int8", "streamed"),
])
def test_engine_host_tier_matches_the_jax_engine(pool, host, mode):
    kw = dict(kv_pool_dtype=pool, admission_policy="fifo")
    if host != "off":
        kw.update(host_cache_bytes=1 << 20, host_cache_dtype=host)
    ((jres, jmet, tres, tmet),), eng = _serve_both(_pressure_queue(), mode=mode, **kw)
    common = _assert_same(jres, jmet, tres, tmet)
    tsan.audit_pool_partition(tmet)
    tsan.audit_prefix_tree(eng)
    tsan.audit_host_cache(eng)
    if host == "off":
        assert tmet["host_cache_enabled"] is False and tmet["prefix_evictions"] > 0
        return
    assert set(HOST_KEYS) <= set(common)
    assert tmet["spilled_blocks"] > 0 and tmet["restored_blocks"] > 0
    assert tmet["restore_hit_tokens"] > 0 and tmet["host_cache_dtype"] == host
    assert tmet["prefix_hit_tokens"] >= tmet["restore_hit_tokens"]
    if mode == "streamed":
        assert tmet["streamed_requests"] == len(_pressure_queue())
    # native payloads restore the same bytes: the tokens of the tier off
    if host == "native" and mode == "closed":
        ((_, _, off, _),), _ = _serve_both(_pressure_queue(), kv_pool_dtype=pool,
                                           admission_policy="fifo")
        assert [r.tokens for r in tres] == [r.tokens for r in off]


def test_engine_cache_aware_admission_ranks_spilled_hits_like_jax():
    runs, _ = _serve_both(_pressure_queue(seed=9, groups=3, repeats=2), host_cache_bytes=1 << 20)
    (jres, jmet, tres, tmet), = runs
    _assert_same(jres, jmet, tres, tmet)
    assert tmet["admission_policy"] == "cache-aware" and tmet["spilled_blocks"] > 0


def test_a_second_serve_restores_what_the_first_spilled():
    q = _pressure_queue(seed=13, groups=3, repeats=1)
    runs, eng = _serve_both(q, calls=2, host_cache_bytes=1 << 20, admission_policy="fifo")
    (_, _, first, m1), (jres, jmet, second, m2) = runs
    _assert_same(jres, jmet, second, m2)
    assert [r.tokens for r in first] == [r.tokens for r in second]
    assert m1["spilled_blocks"] > 0 and m1["kv_spilled_blocks_final"] > 0
    assert m2["restored_blocks"] > m1["restored_blocks"]  # the counters span the engine's life
    assert m2["prefix_hit_tokens_cross_call"] > 0 and m2["engine_serve_calls"] == 2
    eng.reset_cache()
    assert eng.last_host_store is not None and len(eng.last_host_store) == 0
    assert eng.last_prefix_index.spilled_count == 0


class _CancelAfter:
    """Cancels once the heartbeat has seen ``tokens`` committed tokens."""

    def __init__(self, tokens: int) -> None:
        self.tokens, self.fired = tokens, False

    def beat(self, committed: int) -> None:
        self.fired = self.fired or committed >= self.tokens

    def cancelled(self) -> bool:
        return self.fired


def test_cancel_mid_decode_leaves_the_tier_coherent():
    _, (cfg, params) = _models()
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, **ENGINE,
                                 admission_policy="fifo", host_cache_bytes=1 << 20)
    eng._sanitize = True
    q = _pressure_queue(seed=7, repeats=4)
    cancel = _CancelAfter(12)
    res, m = eng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q],
                       cancel=cancel, heartbeat=cancel.beat)
    assert m["interrupted"] is True and eng.last_drain
    assert m["spilled_blocks"] > 0 and m["restored_blocks"] > 0
    assert m["kv_allocated_blocks_final"] == m["kv_reserved_blocks_final"] == 0
    assert m["kv_free_blocks_final"] + m["kv_parked_blocks_final"] == m["kv_num_blocks"]
    assert m["kv_spilled_blocks_final"] == m["host_cache_entries_final"]
    tsan.audit_pool_partition(m)
    tsan.audit_prefix_tree(eng)
    tsan.audit_host_cache(eng)
    tsan.audit_committed_publication(eng, eng.last_requests, res)
    # the next call starts from the drained state (the warm-entry audit runs)
    res2, m2 = eng.serve([tserving.ServeRequest(prompt=p, max_new_tokens=n) for p, n in q])
    assert all(r.status == "ok" for r in res2) and m2["engine_serve_calls"] == 2


def test_the_host_tier_follows_the_prefix_cache():
    """Without the prefix cache (or paged layout) the tier is inert, as in
    JAX: no store is built and no host keys are reported."""
    _, (cfg, params) = _models()
    eng = tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                 kv_block_size=8, prefix_cache=False, host_cache_bytes=1 << 20)
    res, m = eng.serve([tserving.ServeRequest(prompt=[1, 2, 3], max_new_tokens=3)])
    assert res[0].new_tokens == 3 and eng.last_host_store is None
    assert "spilled_blocks" not in m
    for bad in (dict(host_cache_bytes=-1), dict(host_cache_dtype="fp4")):
        with pytest.raises(ValueError):
            tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1, max_len=64,
                                   **bad)
