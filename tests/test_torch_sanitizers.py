"""The port's ``NEXUS_SANITIZE`` audits (nexus_tpu_torch.testing.sanitizers
and the engine's in-loop checks), on the CPU.

``sanitizers_enabled`` parses the environment as JAX's does. Each audit
passes on a clean run of the engine (tiny Llama, float32, a 4-block pool
with a host tier, so that blocks spill and restore) and trips on a planted
fault: a leaked block, a resident entry below a spilled one, a store whose
bytes are off (or that holds a payload the tree does not know), a block
table whose unmapped tail was overwritten, an indexed block of text nobody
committed, and state dirtied between two calls. The engine reads the flag
once, at construction; ``install`` wraps the port's ``ServingEngine.serve``
with the post-serve audits and ``uninstall`` takes the wrap off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.models import llama as jllama
from nexus_tpu.testing import sanitizers as jsan
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models.decoding import gather_kv_block
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime.prefix_cache import chain_keys
from nexus_tpu_torch.testing import sanitizers as tsan


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes share a few cores; torch gains nothing from
    threads at these shapes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jparams = jllama.init(jax.random.PRNGKey(0), jcfg)
    cfg = tllama.config("tiny", dtype="float32")
    params = llama_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for t in tllama.leaves(params):
        t.requires_grad_(False)
    return cfg, params


def _queue(seed=5, groups=2, repeats=3):
    """Alternating prompt families through a pool too small for both: the
    host tier spills and restores."""
    rng = np.random.RandomState(seed)
    fams = [rng.randint(0, 256, size=16).tolist() for _ in range(groups)]
    return [tserving.ServeRequest(prompt=g + rng.randint(0, 256, size=4).tolist(),
                                  max_new_tokens=4) for _ in range(repeats) for g in fams]


def _engine(model, monkeypatch, armed=True, **kw):
    cfg, params = model
    if armed:
        monkeypatch.setenv(tsan.ENV_FLAG, "1")
    else:
        monkeypatch.delenv(tsan.ENV_FLAG, raising=False)
    return tserving.ServingEngine(
        tllama.forward_decode, params, cfg, batch_size=1, max_len=64, chunk=4, prefill_chunk=4,
        kv_block_size=8, kv_num_blocks=4, admission_policy="fifo", host_cache_bytes=1 << 20,
        **kw)


def _audit_all(eng, metrics, results):
    tsan.audit_pool_partition(metrics)
    tsan.audit_prefix_tree(eng)
    tsan.audit_host_cache(eng)
    tsan.audit_committed_publication(eng, eng.last_requests, results)
    tsan.audit_warm_boundary(eng)


@pytest.mark.parametrize("raw", ["", "0", "off", "OFF", " false ", "no", "No", "1", "yes",
                                 "true", " on ", "2", "x"])
def test_sanitizers_enabled_parses_the_env_like_jax(raw):
    env = {tsan.ENV_FLAG: raw}
    assert tsan.ENV_FLAG == jsan.ENV_FLAG
    assert tsan.sanitizers_enabled(env) == jsan.sanitizers_enabled(env)
    assert not tsan.sanitizers_enabled({})


def test_the_engine_reads_the_flag_at_construction(model, monkeypatch):
    eng = _engine(model, monkeypatch, armed=True)
    assert eng._sanitize is True
    monkeypatch.delenv(tsan.ENV_FLAG)
    assert eng._sanitize is True  # read once, not per call
    assert _engine(model, monkeypatch, armed=False)._sanitize is False
    monkeypatch.setenv(tsan.ENV_FLAG, "off")
    cfg, params = model
    assert tserving.ServingEngine(tllama.forward_decode, params, cfg, batch_size=1,
                                  max_len=64)._sanitize is False


def test_every_audit_passes_on_a_clean_armed_run(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    results, m = eng.serve(_queue())
    assert m["spilled_blocks"] > 0 and m["restored_blocks"] > 0
    _audit_all(eng, m, results)
    # a second call: the warm-entry audit runs and passes
    results, m = eng.serve(_queue(seed=6))
    assert m["engine_serve_calls"] == 2
    _audit_all(eng, m, results)


def test_pool_audit_trips_on_a_leaked_block(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    _, m = eng.serve(_queue())
    for forged, needle in ((dict(kv_allocated_blocks_final=1), "leaked lease"),
                           (dict(kv_reserved_blocks_final=1), "never refunded"),
                           (dict(kv_free_blocks_final=m["kv_free_blocks_final"] + 1), "fell out"),
                           (dict(host_cache_entries_final=m["host_cache_entries_final"] + 1),
                            "spilled tier leaked"),
                           (dict(kv_spilled_blocks_final=None), "spilled-tier ledger")):
        with pytest.raises(tsan.SanitizerError, match=needle):
            tsan.audit_pool_partition(dict(m, **forged))
    with pytest.raises(tsan.SanitizerError, match="missing"):
        tsan.audit_pool_partition({"kv_layout": "paged"})
    tsan.audit_pool_partition({"kv_layout": "dense"})  # no pool: nothing to check
    # a lease that never releases: the warm boundary sees the leak
    eng._alloc.admit(1).grow_to(1)
    with pytest.raises(tsan.SanitizerError, match="still allocated"):
        tsan.audit_warm_boundary(eng)


def test_tree_audit_trips_on_a_resident_entry_below_a_spilled_one(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    eng.serve(_queue())
    idx, store = eng.last_prefix_index, eng.last_host_store

    def spilled_pair():
        for key in idx._spilled:
            node, off = idx._by_key[key]
            for d in idx._descendant_entries(node, off):
                if d in idx._spilled:
                    return key, d
        return None

    # spill parked blocks leaf-first (as pool pressure would) until a
    # parent and its child are both spilled
    while spilled_pair() is None:
        blk, key = idx.spill_lru()
        store.put(key, gather_kv_block(eng._kv_cache, blk))
        eng._alloc._free.append(blk)
    pair = spilled_pair()
    tsan.audit_prefix_tree(eng)
    tsan.audit_host_cache(eng)
    # restore the child alone, as an allocator restoring out of chain
    # order would
    free = eng._alloc._free.pop()
    idx.restore(pair[1], free)
    store.take(pair[1])  # the store moves with the tree
    with pytest.raises(tsan.SanitizerError, match="resident descendant"):
        tsan.audit_prefix_tree(eng)
    # the next armed call refuses to build on it
    with pytest.raises(tsan.SanitizerError, match="warm-entry"):
        eng.serve(_queue(seed=6))


def test_host_cache_audit_trips_on_a_store_whose_bytes_are_off(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    eng.serve(_queue())
    store = eng.last_host_store
    tsan.audit_host_cache(eng)
    store._bytes += 1
    with pytest.raises(tsan.SanitizerError, match="byte accounting"):
        tsan.audit_host_cache(eng)
    store._bytes -= 1
    store.put(b"\x00" * 32, {"k": torch.zeros(2), "v": torch.zeros(2)})  # no tree marker
    with pytest.raises(tsan.SanitizerError, match="disagree on the spilled set"):
        tsan.audit_host_cache(eng)
    store.drop(b"\x00" * 32)
    tsan.audit_host_cache(eng)


def test_scratch_tail_audit_trips_on_an_overwritten_tail(model, monkeypatch):
    alloc = tserving.BlockAllocator(4, 8)
    table = np.full((2, 3), alloc.scratch_block, dtype=np.int32)
    table[0, 0] = 1
    alloc.audit_scratch_tails(table, [1, 0])
    table[1, 2] = 2
    with pytest.raises(AssertionError, match="row 1: unmapped tail entry points at block 2"):
        alloc.audit_scratch_tails(table, [1, 0])
    # in the loop: a table entry past a row's blocks overwritten mid-run
    eng = _engine(model, monkeypatch)

    def plant(_committed):
        eng._table_np[0, -1] = 0

    with pytest.raises(AssertionError, match="scratch-tail contract"):
        eng.serve(_queue(), heartbeat=plant)
    # unarmed, the same run goes through (the contract is not checked)
    quiet = _engine(model, monkeypatch, armed=False)
    quiet.serve(_queue(), heartbeat=lambda _: quiet._table_np.__setitem__((0, -1), 0))


def test_tree_audit_runs_after_every_admission_wave(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    calls = []

    def plant(_committed):
        calls.append(1)
        if len(calls) == 3:  # mid-run: a tree whose maps disagree
            idx = eng.last_prefix_index
            idx._by_key[b"\x01" * 32] = next(iter(idx._by_key.values()))

    with pytest.raises(AssertionError, match="accelerator map diverged"):
        eng.serve(_queue(), heartbeat=plant)


def test_publication_audit_trips_on_an_uncommitted_block(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    results, _ = eng.serve(_queue())
    tsan.audit_committed_publication(eng, eng.last_requests, results)
    stray = chain_keys(list(range(200, 208)), 8)[0]
    assert eng._alloc.register_block(stray, eng._alloc._free[-1])
    with pytest.raises(tsan.SanitizerError, match="match no request's committed text"):
        tsan.audit_committed_publication(eng, eng.last_requests, results)


def test_state_dirtied_between_calls_trips_the_warm_entry(model, monkeypatch):
    eng = _engine(model, monkeypatch)
    eng.serve(_queue())
    tsan.audit_warm_boundary(eng)
    eng._alloc.admit(1)  # a reservation nobody refunds
    with pytest.raises(tsan.SanitizerError, match="serve\\[warm-entry\\].*never refunded"):
        eng.serve(_queue(seed=6))
    eng.reset_cache()
    results, m = eng.serve(_queue(seed=6))  # a clean state serves again
    assert all(r.status == "ok" for r in results) and m["cache_resets"] == 1
    # a block fallen off the free list, held by nobody: it reads as allocated
    eng._alloc._free.pop()
    with pytest.raises(tsan.SanitizerError, match="still allocated at the call boundary"):
        tsan.audit_warm_boundary(eng)


def test_install_wraps_the_port_engine_with_the_post_serve_audits(model, monkeypatch):
    assert not getattr(tserving.ServingEngine, tsan._INSTALLED_FLAG, False)
    original = tserving.ServingEngine.serve
    assert tsan.install() and tsan.install()  # idempotent
    try:
        assert tserving.ServingEngine.serve is not original
        eng = _engine(model, monkeypatch)
        results, m = eng.serve(_queue())  # audits pass
        assert all(r.status == "ok" for r in results)
        # the wrap audits what the call returns: a leaky ledger trips it
        eng._alloc.admit(1).grow_to(1)
        monkeypatch.setattr(eng, "_sanitize", False)  # past the warm entry
        with pytest.raises(tsan.SanitizerError, match="sanitizer\\[pool\\]"):
            eng.serve(_queue(seed=6))
    finally:
        assert tsan.uninstall()
    assert tserving.ServingEngine.serve is original and not tsan.uninstall()
