"""The serving slice's host-side pieces against the JAX package's copies,
and the port's infer / serve entry points.

The block allocator, the radix prefix index, the admission policies, the
serve and infer spec blocks and the percentile estimator are pure Python
in both packages: the same operation sequences (numpy seeds) must give the
same answers, step by step. The entry points run ``mode: infer`` and
``mode: serve`` on the tiny Llama with ``device="cpu"`` and return the JAX
function's metric keys; every feature left out of the port raises
``NotImplementedError`` naming its ROADMAP item.
"""

import json

import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.runtime import prefix_cache as jpc
from nexus_tpu.runtime import scheduling as jsched
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.utils import telemetry as jtel
from nexus_tpu_torch.api import runtime_spec as tspec
from nexus_tpu_torch.runtime import prefix_cache as tpc
from nexus_tpu_torch.runtime import scheduling as tsched
from nexus_tpu_torch.runtime import serving as tserving
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.utils import telemetry as ttel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes on a few cores; torch at these
    tiny shapes gains nothing from threads, so keep it to one here rather
    than crowd out the other processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_block_allocator_follows_the_jax_allocator(seed):
    """Random admit / grow / release / register sequences: the same leases,
    blocks, refusals and pool partitions, and the invariants hold."""
    rng = np.random.default_rng(seed)
    allocs = [jserving.BlockAllocator(12, 4, prefix_index=jpc.PrefixCacheIndex()),
              tserving.BlockAllocator(12, 4, prefix_index=tpc.PrefixCacheIndex())]
    leases = [[], []]
    chains = [jpc.chain_keys(rng.integers(0, 50, 16).astype(np.int32), 4) for _ in range(3)]
    for step in range(60):
        op = rng.integers(0, 4)
        keys = chains[rng.integers(0, 3)]
        outs = []
        for a, ls in zip(allocs, leases):
            out = None
            if op == 0:  # admit with the longest cached prefix
                m = a.match_prefix(keys, 14)
                shared, cow = m[0], m[-1]
                lease = a.admit(3, shared=shared)
                if lease is not None:
                    ls.append((lease, keys))
                out = (list(shared), cow, lease is None)
            elif op == 1 and ls:  # grow and publish
                lease, k = ls[step % len(ls)]
                blks = lease.grow_to(len(lease.shared) + 3)
                for j, b in enumerate(blks[: len(k)]):
                    a.register_block(k[j], b, parent=k[j - 1] if j else None)
                out = list(blks)
            elif op == 2 and ls:  # release
                lease, _ = ls.pop(step % len(ls))
                lease.release()
            part = a.pool_partition()
            assert part["free"] + part["parked"] + part["allocated"] == part["total"]
            assert a.available_blocks >= 0
            outs.append((out, part, a.evictions, a.peak_allocated))
        assert outs[0] == outs[1], (step, op)
    for a, ls in zip(allocs, leases):
        for lease, _ in ls:
            lease.release()
        assert a.pool_partition()["allocated"] == a.reserved_blocks == 0
        a.index.audit()


def test_allocator_refuses_without_mutating_and_evicts_parked_blocks_leaf_first():
    a = tserving.BlockAllocator(4, 2, prefix_index=tpc.PrefixCacheIndex())
    keys = tpc.chain_keys(np.arange(8, dtype=np.int32), 2)
    lease = a.admit(4)
    blks = lease.grow_to(4)
    for j, b in enumerate(blks):
        a.register_block(keys[j], b, parent=keys[j - 1] if j else None)
    assert a.admit(1) is None and a.reserved_blocks == 0
    lease.release()
    assert a.cached_blocks == 4 and a.free_blocks == 0
    shared, spilled, matched, cow = a.match_prefix(keys, 8)
    assert shared == blks[:3] and spilled == [] and matched == 7 and cow == blks[3]
    other = a.admit(2)
    other.grow_to(2)  # takes parked blocks: leaves first
    assert a.evictions == 2 and a.index.match(keys) == blks[:2]
    a.index.audit()


@pytest.mark.parametrize("seed", [0, 1])
def test_prefix_index_follows_the_jax_index(seed):
    """Branching chains inserted, matched, parked leaf-first as released
    rows park them, and evicted LRU: the same answers from both copies, and
    both audits pass."""
    rng = np.random.default_rng(seed)
    idx = [jpc.PrefixCacheIndex(), tpc.PrefixCacheIndex()]
    root = rng.integers(0, 20, 8).astype(np.int32)
    prompts = [np.concatenate([root[: rng.integers(0, 3) * 4], rng.integers(0, 20, 12)])
               .astype(np.int32) for _ in range(5)]
    chains = [tpc.chain_keys(p, 4) for p in prompts]
    assert chains == [jpc.chain_keys(p, 4) for p in prompts]
    block_of = {}
    for keys in chains:
        for j, k in enumerate(keys):
            blk = block_of.setdefault(k, len(block_of))
            got = [ix.insert(k, blk, parent=keys[j - 1] if j else None) for ix in idx]
            assert got[0] == got[1]
    order = rng.permutation(len(chains))
    for step, c in enumerate(order):
        keys = chains[c]
        live = {k for c2 in order[step + 1:] for k in chains[c2]}  # still referenced
        res = []
        for ix in idx:
            for k in reversed(keys):  # a release parks leaf-first what nobody holds
                b = ix.holder(k)
                if b is not None and k not in live and b not in ix.parked_blocks():
                    ix.park(b)
            victim = ix.evict_lru() if step % 2 and ix.parked_count else None
            res.append((victim, sorted(ix.parked_blocks()), [ix.match(k) for k in chains]))
            ix.audit()
        assert res[0] == res[1], step
        assert sorted(idx[0].indexed_keys()) == sorted(idx[1].indexed_keys())


@pytest.mark.parametrize("name", ["fifo", "cache-aware"])
def test_admission_policies_order_like_the_jax_policies(name):
    rng = np.random.default_rng(4)
    jp = jsched.make_admission_policy(name, aging_waves=2)
    tp = tsched.make_admission_policy(name, aging_waves=2)
    assert tp.name == jp.name
    for _ in range(20):
        pending = list(rng.permutation(10)[: rng.integers(1, 10)])
        passed = {int(i): int(rng.integers(0, 4)) for i in pending}
        match = {int(i): int(rng.integers(0, 5)) * 8 for i in pending}
        assert tp.order(pending, passed, match.get) == jp.order(pending, passed, match.get)
    with pytest.raises(ValueError):
        tsched.make_admission_policy("lifo")


SERVE_DICTS = [
    {},
    {"numRequests": 32, "promptLengthMin": 320, "promptLengthMax": 512,
     "sharedPrefixLength": 256, "maxNewMin": 32, "maxNewMax": 128, "chunk": 8,
     "prefillChunk": 8, "kvBlockSize": 32, "attentionPath": "fused", "prefixCache": True},
    {"kvBlockSize": 0, "prefixCache": False, "chunk": 5, "temperature": 0.7,
     "maxQueueDepth": 9, "requestDeadlineSeconds": 2.5, "admissionPolicy": "fifo"},
    {"kvPoolDtype": "int8", "kvNumBlocks": 40, "kvBlockSize": 16, "promptLookupNgram": 3,
     "numSpeculative": 2, "replicas": 3, "arrival": "poisson", "hostCacheBytes": 1024},
]


@pytest.mark.parametrize("d", SERVE_DICTS)
def test_serve_spec_round_trips_and_sizes_the_pool_like_jax(d):
    t, j = tspec.ServeSpec.from_dict(d), jspec.ServeSpec.from_dict(d)
    assert t.to_dict() == j.to_dict()
    assert tspec.ServeSpec.from_dict(t.to_dict()) == t
    for rows in (1, 8):
        for max_seq in (512, 8192):
            assert t.kv_pool_blocks(rows, max_seq) == j.kv_pool_blocks(rows, max_seq)
            assert t.kv_request_cap(max_seq) == j.kv_request_cap(max_seq)
    assert t.serve_slack() == j.serve_slack()


def test_infer_spec_and_the_slack_formula_match_jax():
    for d in ({}, {"promptLength": 512, "maxNewTokens": 64, "iterations": 2, "temperature": 0.5,
                   "stopTokenId": 3, "promptTokenIds": [1, 2]}):
        assert tspec.InferSpec.from_dict(d).to_dict() == jspec.InferSpec.from_dict(d).to_dict()
    for args in ((8, 0, 4), (8, 3, 4), (5, 0, 2, True)):
        assert tspec.serve_dispatch_slack(*args) == jspec.serve_dispatch_slack(*args)


def test_validate_reports_what_the_jax_spec_reports():
    base = {"mode": "serve", "model": {"family": "llama", "preset": "tiny"}}
    assert tspec.JaxXlaRuntime.from_dict(base).validate() == []
    for serve, needle in (({"kvNumBlocks": 1}, "cannot hold"),
                          ({"attentionPath": "dense"}, "attentionPath"),
                          ({"kvPoolDtype": "fp8"}, "kvPoolDtype"),
                          ({"maxQueueDepth": 1}, "maxQueueDepth"),
                          ({"promptLengthMin": 9, "promptLengthMax": 4}, "prompt length")):
        errs = tspec.JaxXlaRuntime.from_dict(dict(base, serve=serve)).validate()
        jerrs = jspec.JaxXlaRuntime.from_dict(dict(base, serve=serve)).validate()
        assert errs and any(needle in e for e in errs), serve
        assert any(e.split(" (")[0][:40] in " ".join(jerrs) for e in errs), (errs, jerrs)


def test_percentile_matches_jax():
    rng = np.random.default_rng(1)
    for n in (1, 2, 7, 30):
        xs = list(rng.random(n))
        for q in (0.0, 0.5, 0.95, 1.0):
            assert ttel.percentile_nearest_rank(xs, q) == jtel.percentile_nearest_rank(xs, q)
    assert np.isnan(ttel.percentile_nearest_rank([], 0.5))


# ------------------------------------------------------------- entry points

_TINY = {"family": "llama", "preset": "tiny"}
INFER = {"mode": "infer", "model": _TINY, "train": {"batchSize": 2, "seed": 0},
         "infer": {"promptLength": 8, "maxNewTokens": 6, "iterations": 1}}
SERVE = {"mode": "serve", "model": _TINY, "train": {"batchSize": 2, "seed": 0},
         "serve": {"numRequests": 5, "promptLengthMin": 4, "promptLengthMax": 30,
                   "maxNewMin": 3, "maxNewMax": 10, "sharedPrefixLength": 16,
                   "kvBlockSize": 8}}


def _jax_metrics(spec):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(
        dict(spec, tpu={"accelerator": "v5e", "topology": "1x1"})))


@pytest.mark.parametrize("spec", [INFER, SERVE], ids=["infer", "serve"])
def test_entry_point_returns_the_jax_metric_keys(spec):
    got = run_template_runtime(spec, device="cpu")
    ref = _jax_metrics(spec)
    # the JAX keys the port has no feature for: none on these paths
    assert set(ref) - set(got) == set()
    assert got["mode"] == spec["mode"] and got["device"] == "cpu"
    if spec["mode"] == "serve":
        # the same synthetic queue (numpy stream from train.seed), the same
        # schedule: the clock-free ledger agrees with the JAX engine's
        for key in ("requests", "committed_tokens", "scheduled_step_slots", "decode_chunks",
                    "insert_dispatches", "prefill_steps", "prefix_hit_tokens",
                    "hydragen_waves", "kv_num_blocks", "kv_peak_allocated_blocks"):
            assert got[key] == ref[key], key
        assert got["budget_tokens"] == got["committed_tokens"]
        assert got["ok_requests"] == 5 and len(got["completion_ids"]) == 5
    else:
        assert got["output_shape"] == [2, 14] and got["last_logits_finite"]


# stands for a directory whose one step has Orbax's layout (no state.npz)
_ORBAX = "<orbax checkpoint directory>"


@pytest.mark.parametrize("block,item", [
    ({"serve": {"draft": dict(_TINY, overrides={"max_seq_len": 512}),
                "draftCheckpointDirectory": _ORBAX}}, "item 7"),
    ({"infer": {"draft": _TINY, "draftCheckpointDirectory": _ORBAX}}, "item 7"),
    ({"model": dict(_TINY, weights={"path": "w.safetensors"})}, "item 5"),
    ({"checkpoint": {"enabled": True, "directory": _ORBAX}}, "item 7"),
])
def test_unported_features_raise_naming_their_roadmap_item(block, item, tmp_path):
    """Params or a draft restored from an Orbax checkpoint (item 7) and
    pretrained weights (item 5) were refused and are ported now: each case
    pins that the refusal is gone, the spec reaching its reader, which
    finds no file at the path (no ``default/`` item in the Orbax step)."""
    orbax = tmp_path / "orbax"
    (orbax / "3").mkdir(parents=True)
    block = json.loads(json.dumps(block).replace(_ORBAX, str(orbax)))
    spec = dict(SERVE)
    if "infer" in block:
        spec = dict(INFER)
    for key, value in block.items():
        spec[key] = dict(spec.get(key, {}), **value) if key in ("serve", "infer") else value
    missing = "w.safetensors" if item == "item 5" else "has no default/ item"
    with pytest.raises(FileNotFoundError, match=missing):
        run_template_runtime(spec, device="cpu")


def test_serve_replicas_serve_through_the_fleet_drive():
    """serve.replicas > 1 (item 1e, once refused) serves the queue across
    the replicas behind the affinity router."""
    m = run_template_runtime(dict(SERVE, serve=dict(SERVE["serve"], replicas=2)), device="cpu")
    assert m["fleet_replicas"] == 2 and m["finished_requests"] == m["router_decisions"] == 5
    assert m["committed_tokens"] == m["budget_tokens"] > 0


def test_serve_trace_dump_raises(monkeypatch, tmp_path):
    """The span dump (item 1d) is ported: NEXUS_SERVE_TRACE no longer
    raises, it writes one valid timeline per request; an unwritable path
    is skipped with a warning (telemetry is best-effort), as in JAX."""
    import json

    from nexus_tpu_torch.obs import validate_trace

    path = tmp_path / "trace.json"
    monkeypatch.setenv("NEXUS_SERVE_TRACE", str(path))
    m = run_template_runtime(SERVE, device="cpu")
    dump = json.loads(path.read_text())
    assert m["traced"] is True and dump["requests"] == 5 and validate_trace(dump) == []
    monkeypatch.setenv("NEXUS_SERVE_TRACE", "/nonexistent/trace.json")
    assert run_template_runtime(SERVE, device="cpu")["traced"] is True


def test_literal_prompts_need_a_tokenizer_as_in_jax():
    with pytest.raises(ValueError, match="tokenizer"):
        run_template_runtime(dict(SERVE, serve=dict(SERVE["serve"], prompts=["hi"])),
                             device="cpu")
    with pytest.raises(ValueError, match="tokenizer"):
        run_template_runtime(dict(INFER, infer=dict(INFER["infer"], prompt="hi")), device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for spec in (INFER, SERVE):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run_template_runtime(spec)
