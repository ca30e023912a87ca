"""chip_smoke.py's parts that need no card: the paged-decode kernel's
bound, counted by hand on small shapes; the key-tail shapes, the decode
error gate, the serve phases' specs and their same-token count; the
tensor-parallel train phases' specs, gates and planted faults; the MoE
phases' specs, gates, planted faults and the dense dispatch's bytes.

The bound counts each input byte once: every row's visible slots past the
Hydragen split, and the visible slots under the split once for the whole
wave (each is one pool block, shared by every row), K and V of every kv
head, plus q and out.
"""

import pytest

import chip_smoke as cs

PER_POS_BF16 = 2 * 2 * 64 * 2  # K and V of 2 kv heads, D 64, bf16


def test_decode_bound_counts_the_shared_run_once_per_wave():
    # Bs 16, depths 40 / 100 / 10 → 3, 7, 1 blocks; split 2. Own slots past
    # the split: row 0 [2, 3), row 1 [2, 7), row 2 none; under the split,
    # slots 0 and 1 once: 1 + 5 + 2 = 8 slots of 16 positions.
    shape = dict(B=3, T=1, Hq=4, Hkv=2, D=64, Bs=16, depths=(40, 100, 10), shared=2,
                 split=2, window=0, int8=False, stale=False)
    assert cs.decode_read_slots(shape) == 8
    q_and_out = 2 * (2 * 3 * 1 * 4 * 64)
    assert cs.decode_bound_ms(shape) == pytest.approx(
        1e3 * (8 * 16 * PER_POS_BF16 + q_and_out) / cs.PEAK_HBM_BYTES, rel=1e-12)


def test_decode_bound_with_a_window_and_no_split():
    # T 4, window 20, Bs 16: row 0 (depth 100, start 96) sees positions
    # 77..99, slots 4..6; row 1 (depth 30, start 26) sees 7..29, slots 0..1
    shape = dict(B=2, T=4, Hq=4, Hkv=2, D=64, Bs=16, depths=(100, 30), shared=0,
                 split=None, window=20, int8=True, stale=False)
    assert cs.decode_read_slots(shape) == 3 + 2
    per_pos_int8 = 2 * 2 * (64 + 4)  # int8 rows and their f32 scales
    q_and_out = 2 * (2 * 2 * 4 * 4 * 64)
    assert cs.decode_bound_ms(shape) == pytest.approx(
        1e3 * (5 * 16 * per_pos_int8 + q_and_out) / cs.PEAK_HBM_BYTES, rel=1e-12)


@pytest.mark.parametrize("shape,slots,bound_ms", [
    (cs.DECODE_MAIN_SHAPE, 520, 0.02038),
    (dict(cs.DECODE_MAIN_SHAPE, T=8), 520, 0.02066),
    (cs.DECODE_SERVE_QUEUE_SHAPE, 64, 0.00254),
    (dict(cs.DECODE_SERVE_QUEUE_SHAPE, T=8), 64, 0.00282),
])
def test_decode_bound_at_the_timed_shapes(shape, slots, bound_ms):
    assert cs.decode_read_slots(shape) == slots
    assert cs.decode_bound_ms(shape) == pytest.approx(bound_ms, abs=5e-6)


def test_key_tail_shapes_end_mid_tile_under_both_masks():
    tails = {(s["Sq"], s["Sk"], s["causal"]) for s in cs.KEY_TAIL_SHAPES}
    assert tails == {(sq, sk, c) for sq, sk in ((128, 1), (128, 37), (128, 100), (256, 100))
                     for c in (True, False)}
    assert all(s["Sq"] % 64 == 0 and s["D"] in (64, 128) for s in cs.KEY_TAIL_SHAPES)


@pytest.mark.parametrize("floor,share", [(0.0, 0.1), (0.04, 0.14), (0.09, 0.19)])
def test_decode_exact_share_is_a_tenth_over_the_floor(floor, share):
    assert cs.decode_exact_share(floor) == pytest.approx(share)


@pytest.mark.parametrize("extra", [
    dict(num_requests=16, promptLookupNgram=2, numSpeculative=4),
    dict(num_requests=8, numSpeculative=4, draft=cs.DRAFT_REF),
    dict(num_requests=8, prefillChunk=32),
])
def test_the_new_serve_phases_are_valid_specs(extra):
    """serve-lookup, serve-draft and serve-prefill32 pass the port's
    validate(); the draft shares the target's vocabulary and context."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.models import llama

    spec = JaxXlaRuntime.from_dict(cs._serve_spec(**extra))
    assert spec.validate() == []
    if spec.serve.draft is not None:
        target = llama.config("8b")
        draft = llama.config(spec.serve.draft.preset, **spec.serve.draft.overrides)
        assert (draft.vocab_size, draft.max_seq_len) == (target.vocab_size, target.max_seq_len)
        assert draft.n_layers < target.n_layers


def test_same_tokens_counts_the_requests_that_agree(capsys):
    ref = {"completion_ids": [[1, 2, 3], [4, 5, 6], [7, 8, 9]]}
    run = {"completion_ids": [[1, 2, 3], [4, 0, 6]]}
    assert cs._same_tokens("x", ref, run) == "1/2"
    assert "first differing new token of the others: [1]" in capsys.readouterr().out


def _serve_metrics(**over):
    m = {"requests": 64, "ok_requests": 64, "finished_requests": 64, "committed_tokens": 4096,
         "budget_tokens": 4096, "kv_allocated_blocks_final": 0, "kv_reserved_blocks_final": 0,
         "kv_free_blocks_final": 10, "kv_parked_blocks_final": 54, "kv_num_blocks": 64,
         "host_cache_enabled": True, "spilled_blocks": 199, "restored_blocks": 38,
         "restore_hit_tokens": 1216, "kv_spilled_blocks_final": 161,
         "host_cache_entries_final": 161}
    m.update(over)
    return m


def test_the_serve_and_host_tier_gates_pass_a_good_run():
    m = _serve_metrics()
    cs.check_serve("x", m, {1: 10, 8: 5}, must_t=(8,))
    cs.check_host_tier("x", m)


@pytest.mark.parametrize("over,needle", [
    (dict(budget_tokens=0, committed_tokens=0), "budgets are 0"),
    (dict(committed_tokens=4095), "budgets are 4096"),
    (dict(ok_requests=63), "63 of 64 requests ok"),
    (dict(finished_requests=63), "requests ok"),
    (dict(kv_allocated_blocks_final=1), "the pool leaks"),
    (dict(kv_free_blocks_final=9), "the pool leaks"),
])
def test_the_serve_gates_fail_a_bad_run(over, needle):
    with pytest.raises(AssertionError, match=needle):
        cs.check_serve("x", _serve_metrics(**over), {1: 10})


def test_the_serve_gates_need_the_kernel_at_its_feed_widths():
    with pytest.raises(AssertionError, match="never launched at T"):
        cs.check_serve("x", _serve_metrics(), {1: 10}, must_t=(8,))
    with pytest.raises(AssertionError, match="never launched on the serve path"):
        cs.check_serve("x", _serve_metrics(), {1: 10}, missing=["fused_paged_decode_attention"])


@pytest.mark.parametrize("over,needle", [
    (dict(spilled_blocks=0), "spilled_blocks 0"),
    (dict(restored_blocks=0), "restored_blocks 0"),
    (dict(restore_hit_tokens=0), "restore_hit_tokens 0"),
    (dict(host_cache_entries_final=160), "160 host-store payloads"),
    (dict(host_cache_enabled=False), "the host tier is off"),
])
def test_the_host_tier_gates_fail_a_run_whose_tier_did_not_run(over, needle):
    with pytest.raises(AssertionError, match=needle):
        cs.check_host_tier("x", _serve_metrics(**over))


@pytest.mark.parametrize("name,host_cache_bytes", [
    ("serve-chat-host", cs.HOST_CACHE_BYTES), ("serve-host-int8", cs.HOST_CACHE_BYTES),
    ("serve-chat-host", 0),
], ids=["serve-chat-host", "serve-host-int8", "tier-off"])
def test_the_host_tier_phases_are_valid_specs(name, host_cache_bytes):
    """The chat trace's phases pass the port's validate(), and the trace's
    worst prompt fits the 8b context with room for its budget; the pool
    holds one worst-case request but not eight rows of them."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime.entrypoints import _synthetic_trace

    spec = JaxXlaRuntime.from_dict(cs.host_phase_spec(name, host_cache_bytes))
    assert spec.validate() == []
    sv = spec.serve
    assert sv.arrival == "poisson" and sv.trace_turns == 3 and sv.prefix_cache
    assert sv.host_cache_bytes == host_cache_bytes
    assert sv.host_cache_dtype == ("int8" if name == "serve-host-int8" else "native")
    num_requests = cs.HOST_PHASES[name][0]
    cfg = llama.config("8b")
    trace = _synthetic_trace(sv, spec.train, cfg)
    roots = {ev.session or i for i, ev in enumerate(trace.events)}
    assert len(roots) == num_requests
    worst = max(len(ev.prompt) for ev in trace.events)
    need = -(-(worst + 64 + sv.serve_slack() + 1) // sv.kv_block_size)
    assert need <= sv.kv_num_blocks < spec.train.batch_size * need


def test_the_kernel_line_still_lists_all_four_kernels():
    from nexus_tpu_torch.ops import attention as A

    names = [w.__name__ for w in A.KERNEL_WRAPPERS]
    assert names == ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                     "fused_paged_decode_attention"]
    assert set(cs.KERNEL_SOURCES) == set(cs.KERNEL_REPLACES) == set(names)
    assert [w.__name__ for w in A.SERVE_KERNELS] == ["fused_paged_decode_attention"]


@pytest.mark.parametrize("name", sorted(cs.HOST_PHASES))
@pytest.mark.parametrize("step_ms", [45.0, 130.0])
def test_the_host_tier_phases_restore_in_a_cpu_replay(name, step_ms):
    """The host phases' traffic, replayed through the port's engine on a
    stub model and a fake clock, spills and restores at the card's decode
    step (~45 ms at 8 rows) and at one three times slower: the gates of
    ``check_host_tier`` keep a margin on a slower card or host."""
    import torch

    from nexus_tpu_torch.tools.replay_serve import replay

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m = replay(cs.host_phase_spec(name), step_ms / 1e3)
    finally:
        torch.set_num_threads(n)
    assert m["ok_requests"] == m["requests"] == 2 * cs.HOST_PHASES[name][0]
    assert m["spilled_blocks"] > 0 and m["restored_blocks"] > 0
    assert m["restore_hit_tokens"] > 0 and m["kv_allocated_blocks_final"] == 0


# ------------------------------------------------- serve-fleet, serve-traced

def test_the_fleet_phase_is_a_valid_spec_that_spreads_over_the_replicas():
    """serve-fleet passes validate() with the shape of the repo's serve
    example (4 replicas, affinity at depth 2), its trace fits the 8b
    context, and the router puts its requests on at least two replicas."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.fleet import PrefixAffinityRouter
    from nexus_tpu_torch.ha import ServeFailoverPlanner
    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime.entrypoints import _synthetic_trace

    spec = JaxXlaRuntime.from_dict(cs._serve_spec(**cs.FLEET_SPEC_KEYS))
    assert spec.validate() == []
    sv = spec.serve
    assert (sv.replicas, sv.router_policy, sv.affinity_depth, sv.spill_candidates,
            sv.spill_threshold) == (4, "affinity", 2, 2, 4)
    assert sv.prefix_cache and sv.attention_path == "fused" and sv.kv_num_blocks == 0
    trace = _synthetic_trace(sv, spec.train, llama.config("8b"))
    reqs = trace.to_requests(arrivals=True)
    router = PrefixAffinityRouter([f"r{i}" for i in range(4)], block_size=sv.kv_block_size,
                                  affinity_depth=2, spill_candidates=2, spill_threshold=4)
    router.enable_pending_load()
    router.route_batch(ServeFailoverPlanner().fresh(reqs))
    assert len(router.ledger()["router_routed"]) >= 2


def _tiny_serve(tmp_path, **serve):
    """A tiny run of run_template_runtime on the CPU with NEXUS_SERVE_TRACE
    set → (metrics, the dump, the decision log or None)."""
    import torch

    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    spec = {"mode": "serve", "model": {"family": "llama", "preset": "tiny",
                                       "overrides": {"dtype": "float32"}},
            "train": {"batchSize": 2, "seed": 0},
            "serve": {"numRequests": 6, "promptLengthMin": 20, "promptLengthMax": 30,
                      "sharedPrefixLength": 16, "maxNewMin": 3, "maxNewMax": 5, "chunk": 4,
                      "kvBlockSize": 8, **serve}}
    path = str(tmp_path / "dump.json")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("NEXUS_SERVE_TRACE", path)
            mp.setenv("NEXUS_SERVE_REPLICA_ID", cs.TRACED_ENGINE)
            m = run_template_runtime(spec, device="cpu")
    finally:
        torch.set_num_threads(n)
    dump, fleet_log = cs._read_dumps(path)
    return m, dump, fleet_log


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    return _tiny_serve(tmp_path_factory.mktemp("fleet"), replicas=3, spillThreshold=1)


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    from nexus_tpu_torch.obs import render_prometheus
    from nexus_tpu_torch.utils import telemetry

    telemetry.with_statsd("nexus-tpu")
    m, dump, _ = _tiny_serve(tmp_path_factory.mktemp("traced"))
    return m, dump, render_prometheus()


def test_the_fleet_gates_pass_a_good_run(fleet_run):
    import copy

    m, journeys, fleet_log = copy.deepcopy(fleet_run)
    assert fleet_log is not None and m["fleet_replicas"] == 3
    cs.check_fleet("x", m, journeys, fleet_log)


def _leak(m, j, log):
    rid = next(r for r, v in m["fleet_per_replica"].items() if v["requests"])
    m["fleet_per_replica"][rid]["kv_allocated_blocks_final"] = 1


def _drift(m, j, log):
    j["journeys"][0]["legs"][0]["timeline"][0]["extra"] = 1


def _one_replica(m, j, log):
    for r in m["fleet_per_replica"].values():
        r["requests"] = 0
    m["fleet_per_replica"]["r0"]["requests"] = 6


def _log_drift(m, j, log):
    log["events"][0].pop("chosen")


@pytest.mark.parametrize("mutate,needle", [
    (_leak, "pool leaks"),
    (_drift, "journey dump or decision log is invalid"),
    (_log_drift, "journey dump or decision log is invalid"),
    (_one_replica, "served requests"),
    (lambda m, j, log: m.update(fleet_prefix_hit_tokens=0), "no prefix hits"),
    (lambda m, j, log: m.update(router_decisions=5), "the router counted"),
    (lambda m, j, log: j["journeys"].pop(), "journeys for"),
    (lambda m, j, log: m.update(committed_tokens=m["committed_tokens"] - 1), "budgets are"),
    (lambda m, j, log: m["fleet_per_replica"]["r0"].update(ok_requests=-1), "requests ok"),
], ids=["replica-leaks", "journey-drift", "log-drift", "one-replica", "no-hits", "router",
        "journeys", "budgets", "not-ok"])
def test_the_fleet_gates_fail_a_bad_run(fleet_run, mutate, needle):
    import copy

    m, journeys, fleet_log = copy.deepcopy(fleet_run)
    mutate(m, journeys, fleet_log)
    with pytest.raises(AssertionError, match=needle):
        cs.check_fleet("x", m, journeys, fleet_log)
    with pytest.raises(AssertionError, match="never launched"):
        cs.check_fleet("x", *copy.deepcopy(fleet_run),
                       missing=["fused_paged_decode_attention"])


def test_the_traced_gates_pass_a_good_run(traced_run):
    m, dump, text = traced_run
    assert m["serve_replica_id"] == cs.TRACED_ENGINE
    cs.check_traced("x", m, dump, text)


def _no_first_token(m, dump, text):
    tl = dump["spans"][0]["timeline"]
    tl[:] = [s for s in tl if s["kind"] != "first_token"]
    return text


@pytest.mark.parametrize("mutate,needle", [
    (_no_first_token, "does not run"),
    (lambda m, d, t: d["spans"][1]["timeline"].pop() and t, "terminal/drained"),
    (lambda m, d, t: m.update(live_gauge_publishes=0) or t, "live_gauge_publishes 0"),
    (lambda m, d, t: m.update(flight_recorder_events=0) or t, "flight_recorder_events 0"),
    (lambda m, d, t: t.replace(cs.TRACED_ENGINE, "other"), "Prometheus text has no"),
    (lambda m, d, t: d.update(requests=1) or t, "timelines for"),
], ids=["no-first-token", "no-terminal", "no-gauges", "no-flight", "untagged", "count"])
def test_the_traced_gates_fail_a_bad_run(traced_run, mutate, needle):
    import copy

    m, dump, text = copy.deepcopy(traced_run)
    text = mutate(m, dump, text)
    with pytest.raises(AssertionError, match=needle):
        cs.check_traced("x", m, dump, text)


# ------------------------------------------------------------ Mixtral phases


@pytest.mark.parametrize("make", [
    lambda: cs.mixtral_train_spec(),
    lambda: cs.mixtral_train_spec(steps=4, remat=True, remat_policy="dots_attn"),
    lambda: cs.mixtral_ckpt_spec("/ck", "/prof", steps=4),
    lambda: cs.mixtral_infer_spec(),
    lambda: cs.mixtral_serve_spec(),
], ids=["train", "remat", "ckpt", "infer", "serve"])
def test_the_mixtral_phases_are_valid_specs_at_published_widths(make):
    """Every Mixtral phase passes the port's validate() and runs preset
    8x7b at its published widths, cut in depth only (2, 1 or 16 layers)."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.models import mixtral

    spec = make()
    rt = JaxXlaRuntime.from_dict(spec)
    assert rt.validate() == []
    assert (rt.model.family, rt.model.preset) == ("mixtral", "8x7b")
    cfg = mixtral.config("8x7b", **rt.model.overrides)
    full = mixtral.config("8x7b")
    for width in ("vocab_size", "d_model", "n_heads", "n_kv_heads", "d_ff", "n_experts",
                  "n_experts_per_token"):
        assert getattr(cfg, width) == getattr(full, width), width
    assert cfg.n_layers in (1, 2, cs.MIXTRAL_SERVE_LAYERS)
    if rt.mode == "train":
        assert cfg.sliding_window == 4096 and "dispatch_impl" not in rt.model.overrides


def test_the_mixtral_serve_phase_weights_fit_under_the_peak_gate():
    from nexus_tpu_torch.models import mixtral

    cfg = mixtral.config("8x7b", n_layers=cs.MIXTRAL_SERVE_LAYERS)
    weights_gb = cfg.param_count() * 2 / 1e9
    assert 45 < weights_gb < cs.PEAK_GB - 5


def test_the_mixtral_train_gates():
    cs.check_mixtral_train("x", {"moe_dispatch": "scatter", "router_dropped_fraction": 0.08})
    cs.check_mixtral_train("x", {"moe_dispatch": "einsum", "router_dropped_fraction": 0.0},
                           "einsum")
    with pytest.raises(AssertionError, match="not 'einsum'"):
        cs.check_mixtral_train("x", {"moe_dispatch": "scatter", "router_dropped_fraction": 0.0},
                               "einsum")
    for bad, needle in (({"moe_dispatch": "einsum", "router_dropped_fraction": 0.1},
                         "moe_dispatch"),
                        ({"moe_dispatch": "scatter", "router_dropped_fraction": 1.0},
                         "outside"),
                        ({"moe_dispatch": "scatter", "router_dropped_fraction": None},
                         "outside")):
        with pytest.raises(AssertionError, match=needle):
            cs.check_mixtral_train("x", bad)


def _launches(fwd, n=8):
    return {"flash_fwd": fwd, "flash_bwd_dq": n, "flash_bwd_dkv": n,
            "fused_paged_decode_attention": 0}


def test_the_remat_gates_count_k1_once_under_dots_attn_and_twice_under_full():
    cs.check_remat("x", _launches(8), "dots_attn", layers=2, steps=4)
    cs.check_remat("x", _launches(16), "full", layers=2, steps=4)
    # planted: K1 counted twice under dots_attn (its outputs not kept)
    with pytest.raises(AssertionError, match="dots_attn"):
        cs.check_remat("x", _launches(16), "dots_attn", layers=2, steps=4)
    with pytest.raises(AssertionError, match="full"):
        cs.check_remat("x", _launches(8), "full", layers=2, steps=4)


def _ckpt_runs(**over):
    first = {"checkpoint_saved": True, "profile_dir": "/prof"}
    resumed = {"checkpoint_saved": True, "resumed_from_step": 4}
    resave = {"differing_members": []}
    args = dict(first=first, resumed=resumed, resave=resave,
                trace_text='{"name": "flash_fwd_kernel"}')
    for key, value in over.items():
        if key == "trace_text":
            args[key] = value
        else:
            block, field = key.split("__")
            args[block] = dict(args[block], **{field: value})
    return args


def test_the_checkpoint_gates_pass_a_good_run():
    cs.check_ckpt("x", **_ckpt_runs())


@pytest.mark.parametrize("over,needle", [
    (dict(resumed__resumed_from_step=2), "resumed_from_step 2"),
    (dict(resumed__resumed_from_step=0), "resumed_from_step 0"),
    (dict(trace_text=""), "does not name flash_fwd"),
    (dict(first__profile_dir=None), "never opened"),
    (dict(resave__differing_members=["leaf_3.npy"]), "leaf_3"),
    (dict(first__checkpoint_saved=False), "checkpoint_saved"),
], ids=["resumed-2", "not-resumed", "no-trace", "no-window", "resave-differs", "not-saved"])
def test_the_checkpoint_gates_fail_a_planted_fault(over, needle):
    with pytest.raises(AssertionError, match=needle):
        cs.check_ckpt("x", **_ckpt_runs(**over))


def test_the_peak_gate():
    cs.check_peak("x", 52.3)
    with pytest.raises(AssertionError, match="not under"):
        cs.check_peak("x", 61.0)


def test_the_resave_check_on_a_tiny_state(tmp_path):
    """The checkpoint phase's restore-and-save-again on the CPU at tiny
    size: a saved step re-saved through a fresh state has the same members
    byte for byte, and a changed file shows."""
    import zipfile

    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    spec = cs.mixtral_ckpt_spec(str(tmp_path / "ck"), str(tmp_path / "prof"), steps=4)
    spec["model"] = {"family": "mixtral", "preset": "tiny", "overrides": {"n_layers": 1}}
    spec["train"].update(seqLen=32, batchSize=2)
    m = run_template_runtime(spec, device="cpu")
    assert m["checkpoint_saved"] and m["profile_dir"]
    out = cs.resave_check(str(tmp_path / "ck"), 4, spec, str(tmp_path / "again"), device="cpu")
    assert out["differing_members"] == [] and out["state_bytes"] > 0
    again = tmp_path / "again" / "4" / "state.npz"
    with zipfile.ZipFile(again) as src, zipfile.ZipFile(tmp_path / "changed.npz", "w") as dst:
        for name in src.namelist():
            data = bytearray(src.read(name))
            if name == "leaf_2.npy":
                data[-1] ^= 1  # one bit of the last element
            dst.writestr(name, bytes(data))
    assert cs.differing_members(str(again), str(tmp_path / "changed.npz")) == ["leaf_2.npy"]


@pytest.mark.parametrize("window,tile", [(0, 64), (0, 128), (192, 64), (192, 128)])
def test_planted_faults_fail_the_limits_at_the_key_floor(window, tile):
    """The planted loop-bound faults (at key tile 0, or at the tile of the
    window's floor) each exceed the kernel check's limits; the function
    raises if any passes."""
    import torch

    g = torch.Generator().manual_seed(0)

    def rnd(*s):
        return torch.randn(*s, generator=g).to(torch.bfloat16)

    q, k, v, dout = rnd(1, 512, 4, 64), rnd(1, 512, 2, 64), rnd(1, 512, 2, 64), rnd(1, 512, 4, 64)
    ratios = cs.planted_faults(q, k, v, dout, torch.randn(1, 4, 512, generator=g), tile=tile,
                               window=window)
    assert set(ratios) == {"out", "lse", "dq", "dk", "dv"}
    assert min(ratios.values()) > 1.0


def test_the_mixtral_kernel_shapes_are_the_mixtral_train_phases():
    """The shapes phase_kernels checks K1-K3 at are the ones mixtral-train,
    mixtral-remat and mixtral-ckpt give them, and the Mixtral shape's bound
    counts the window's pairs: sum over rows of min(row + 1, window)."""
    from nexus_tpu_torch.models import mixtral

    for shape, spec in ((cs.MIXTRAL_SHAPE, cs.mixtral_train_spec()),
                        (cs.MIXTRAL_CKPT_SHAPE, cs.mixtral_ckpt_spec("ck", "prof", steps=4))):
        cfg = mixtral.config(spec["model"]["preset"], **spec["model"]["overrides"])
        assert (shape["B"], shape["Sq"], shape["Sk"]) == (
            spec["train"]["batchSize"], spec["train"]["seqLen"], spec["train"]["seqLen"])
        assert (shape["Hq"], shape["Hkv"], shape["D"]) == (
            cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        assert shape["causal"] and shape["q_offset"] == 0
        assert shape["window"] == cfg.sliding_window == 4096
    s, w = cs.MIXTRAL_SHAPE["Sq"], cs.MIXTRAL_WINDOW
    assert cs._visible_pairs(cs.MIXTRAL_SHAPE) == w * (w + 1) // 2 + (s - w) * w
    pairs = 32 * (w * (w + 1) // 2 + (s - w) * w)
    assert cs._bounds_ms(cs.MIXTRAL_SHAPE)["flash_fwd"] == (
        pytest.approx(1e3 * 4 * 128 * pairs / cs.PEAK_BF16_FLOPS, rel=1e-12), "operations")


# ------------------------------------------------------ GPT-NeoX and the MLP


@pytest.mark.parametrize("make,preset", [
    (cs.neox_train_spec, "1b"), (cs.neox_infer_spec, "20b"), (cs.neox_serve_spec, "20b"),
], ids=["train", "infer", "serve"])
def test_the_gptneox_phases_are_valid_specs_at_published_widths_and_depths(make, preset):
    """Every GPT-NeoX phase passes the port's validate() and runs its
    preset's widths: Pythia-1.4B trains whole, GPT-NeoX-20B infers and
    serves at NEOX_SERVE_LAYERS of its 44 layers (the script's time), no
    other override."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    rt = JaxXlaRuntime.from_dict(make())
    assert rt.validate() == []
    depth = {} if rt.mode == "train" else {"n_layers": cs.NEOX_SERVE_LAYERS}
    assert (rt.model.family, rt.model.preset, dict(rt.model.overrides)) == ("gptneox", preset,
                                                                            depth)
    if rt.mode == "serve":
        assert rt.serve.num_requests == 16 and rt.serve.attention_path == "fused"
        assert rt.serve.prefix_cache and rt.serve.kv_pool_dtype == "native"
    if rt.mode == "train":
        assert (rt.train.batch_size, rt.train.seq_len, rt.train.steps) == (4, 2048, 6)


def test_gptneox_20b_weights_and_pool_fit_under_the_peak_gate():
    """41.1 GB of bf16 weights (20.55 B parameters) and the serve phase's
    auto-sized pool (the queue's envelope with the shared preamble's blocks
    counted once, plus the scratch block) stay well under 60 GB."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.models import gptneox

    cfg = gptneox.config("20b")
    weights_gb = cfg.param_count() * 2 / 1e9
    assert weights_gb == pytest.approx(41.109, abs=1e-3)
    rt = JaxXlaRuntime.from_dict(cs.neox_serve_spec())
    blocks = rt.serve.kv_pool_blocks(rt.train.batch_size, cfg.max_seq_len) + 1
    block_bytes = cfg.n_layers * 2 * rt.serve.kv_block_size * cfg.n_kv_heads * cfg.head_dim * 2
    assert block_bytes == 44 * 2 * 32 * 64 * 96 * 2  # 1.08 MB a position, 34.6 MB a block
    pool_gb = blocks * block_bytes / 1e9
    assert blocks == 113 and 3 < pool_gb < 5.5
    assert weights_gb + pool_gb < cs.PEAK_GB - 10


@pytest.mark.parametrize("t,bound_ms", [(1, 0.0150831), (8, 0.0154939)])
def test_the_neox_decode_bound_is_counted_by_hand(t, bound_ms):
    """GPT-NeoX-20B's serve shape: depths 320..640 at Bs 32 hold 10, 12,
    13, 14, 15, 17, 19 and 20 blocks, 8 of them under the split: 56 own
    slots and 8 shared ones. A position is K and V of 64 heads of 96 in
    bf16 (24576 bytes); q and out are 2 x 8 rows x T x 64 x 96 x 2 bytes."""
    shape = dict(cs.NEOX_DECODE_SHAPE, T=t)
    assert (shape["Hq"], shape["Hkv"], shape["D"]) == (64, 64, 96)
    assert cs.decode_read_slots(shape) == 56 + 8
    nbytes = 64 * 32 * (2 * 64 * 96 * 2) + 2 * (2 * 8 * t * 64 * 96)
    assert cs.decode_bound_ms(shape) == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    assert cs.decode_bound_ms(shape) == pytest.approx(bound_ms, abs=5e-7)


def test_the_pythia_kernel_shape_is_the_train_phases_and_its_bounds():
    """K1-K3 at gptneox-train's shape (B 4, S 2048, 16 heads of 128, MHA,
    causal): 134 M visible pairs, bounds 4D / 6D / 8D FLOP a pair at the
    bf16 peak: 0.0695 / 0.1043 / 0.1390 ms."""
    from nexus_tpu_torch.models import gptneox

    spec = cs.neox_train_spec()
    cfg = gptneox.config(spec["model"]["preset"])
    s = cs.PYTHIA_SHAPE
    assert (s["B"], s["Sq"], s["Sk"]) == (spec["train"]["batchSize"], spec["train"]["seqLen"],
                                          spec["train"]["seqLen"])
    assert (s["Hq"], s["Hkv"], s["D"]) == (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    assert s["causal"] and s["window"] == 0 and s["q_offset"] == 0
    pairs = 4 * 16 * 2048 * 2049 // 2
    assert pairs == 134_283_264 and cs._visible_pairs(s) * 4 * 16 == pairs
    bounds = cs._bounds_ms(s)
    for name, per_pair, ms in (("flash_fwd", 4, 0.0695), ("flash_bwd_dq", 6, 0.1043),
                               ("flash_bwd_dkv", 8, 0.1390)):
        assert bounds[name] == (pytest.approx(1e3 * per_pair * 128 * pairs / 989e12, rel=1e-12),
                                "operations")
        assert bounds[name][0] == pytest.approx(ms, abs=5e-5)


def test_the_head_dim_decode_cases_cover_what_the_kernel_now_takes():
    """D 16 and D 96 each on bf16 and int8 pools, n_rep 1 and 4, T 1 to 17,
    stale tables, shared runs, windows and a block size that is not a power
    of two; all of them among the edge cases the decode phase checks."""
    cases = cs.DECODE_HEAD_DIM_SHAPES
    assert all(c in cs.DECODE_EDGE_SHAPES for c in cases)
    for d in (16, 96):
        mine = [c for c in cases if c["D"] == d]
        assert {c["int8"] for c in mine} == {False, True}
        assert {c["Hq"] // c["Hkv"] for c in mine} >= {1, 4}
        assert {1, 17} <= {c["T"] for c in mine}
        assert any(c["stale"] for c in mine) and any(c["split"] for c in mine)
        assert any(c["window"] for c in mine)
        assert any(c["Bs"] & (c["Bs"] - 1) for c in mine)  # not a power of two


def test_the_mlp_gate_passes_a_good_run_and_fails_a_bad_one():
    cs.check_mlp_train("x", {"loss_history": [1.0, 0.8], "final_loss": 0.3})
    with pytest.raises(AssertionError, match="not under half"):
        cs.check_mlp_train("x", {"loss_history": [1.0, 0.8], "final_loss": 0.6})


def test_the_mlp_phase_halves_its_loss_on_the_cpu():
    """mlp-train's spec, which names no family, run on the CPU (the same
    model and data in float32): it meets its gate there too."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    spec = cs.mlp_train_spec()
    assert "family" not in spec["model"]  # the spec's default family
    m = run_template_runtime(spec, device="cpu")
    assert m["family"] == "mlp" and m["preset"] == "small" and m["steps"] == 200
    cs.check_mlp_train("mlp-train", m)


def test_one_rounding_step_reads_more_of_the_limit_at_d16_than_the_exact_share():
    """At D 16 one bf16 step of a row's largest output element reads more
    of the per-vector limit than the tenth the exact-share gate allows
    over its floor; at D 128 it reads less than twice that. Rows of
    N(0, 1) / 4 elements (the scale of an attention output over random
    V); a row holding one element 0.5 reads its step, 2^-8, over its
    limit."""
    import torch

    g = torch.Generator().manual_seed(0)
    share = {d: cs.rounding_step_share((torch.randn(64, d, generator=g) / 4).bfloat16())
             for d in (16, 128)}
    assert share[16] > cs.DECODE_EXACT_SHARE and share[128] < 2 * cs.DECODE_EXACT_SHARE
    assert share[16] > 1.5 * share[128]
    row = torch.zeros(1, 16)
    row[0, 3] = 0.5
    assert cs.rounding_step_share(row) == pytest.approx(
        2 ** -8 / (cs.RTOL * 0.5 + cs.ATOL * 4), rel=1e-6)
    assert cs.DECODE_STEP_FLOOR_BELOW_D == 64
    assert {s["D"] for s in cs.DECODE_EDGE_SHAPES if s["D"] < 64} == {16}


# ------------------------------------------------ pretrained weights and text

TINY = {"family": "llama", "preset": "tiny",
        "overrides": {"dtype": "float32", "vocab_size": 640, "max_seq_len": 1024}}


def _tiny(spec: dict) -> dict:
    """A pretrained phase's spec at the tiny preset (the tokenizer's ids fit
    its vocabulary, the preamble prompts its context)."""
    return dict(spec, model={**TINY, **{k: v for k, v in spec["model"].items()
                                        if k == "weights"}})


@pytest.fixture(scope="module")
def tiny_export(tmp_path_factory):
    """Tiny Llama weights from the seed, exported as the phase exports the
    8b ones (four shards and an index), and the script's tokenizer."""
    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.runtime.entrypoints import _decode_params

    root = tmp_path_factory.mktemp("pretrained")
    cfg = llama.config("tiny", **TINY["overrides"])
    params = _decode_params(llama, cfg, torch.device("cpu"), seed=0)
    ckpt = str(root / "ckpt")
    nbytes = cs.export_sharded(params, "llama", cfg, ckpt)
    tok = cs.write_tokenizer_json(str(root / "ckpt" / "tokenizer.json"))
    return {"cfg": cfg, "params": params, "ckpt": ckpt, "tok": tok, "bytes": nbytes}


def test_the_pretrained_phase_specs_are_valid_at_8b_widths():
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    for spec in (cs.pretrained_infer_spec("/ck", "/ck/tokenizer.json"),
                 cs.pretrained_infer_spec(prompt_ids=[1, 2, 3]),
                 cs.pretrained_serve_spec("/ck", "/ck/tokenizer.json")):
        rt = JaxXlaRuntime.from_dict(spec)
        assert rt.validate() == []
        # the published widths, depth cut to PRETRAINED_LAYERS (the script's time)
        assert (rt.model.family, rt.model.preset, dict(rt.model.overrides)) == (
            "llama", "8b", {"n_layers": cs.PRETRAINED_LAYERS})
        assert rt.train.batch_size == 8
    serve = JaxXlaRuntime.from_dict(cs.pretrained_serve_spec("/ck", "/t")).serve
    assert len(serve.prompts) == 8 and serve.attention_path == "fused" and serve.prefix_cache
    assert sum(p.startswith(" ".join(cs.PRETRAINED_PREAMBLE)) for p in serve.prompts) == 4
    assert len(cs.PRETRAINED_PREAMBLE) == 200 and 35 <= len(cs.PRETRAINED_PROMPT.split()) <= 45


def test_the_tokenizer_writer_gives_a_file_both_engines_read_alike(tiny_export):
    import json

    from nexus_tpu_torch.utils.tokenizer import load_tokenizer

    with open(tiny_export["tok"]) as f:
        doc = json.load(f)
    vocab = doc["model"]["vocab"]
    assert len(doc["model"]["merges"]) == 300 and len(vocab) == 256 + 300
    assert sorted(vocab.values()) == list(range(len(vocab)))
    assert [t["id"] for t in doc["added_tokens"]] == [len(vocab), len(vocab) + 1]
    pure, rust = (load_tokenizer(tiny_export["tok"], engine=e) for e in ("pure", "rust"))
    for text in [cs.PRETRAINED_PROMPT] + cs.pretrained_prompts():
        ids = pure.encode(text)
        assert ids == rust.encode(text) and pure.decode(ids) == text
        assert max(ids) < 128256  # Llama-3-8B's vocabulary


def test_the_sharded_export_and_the_load_gate(tiny_export, tmp_path):
    """Four shards of about equal bytes and an index naming every tensor;
    the load gate passes on the export and fails on a flipped bit in one
    shard; a missing tensor fails the load."""
    import json
    import os
    import shutil

    from nexus_tpu_torch.runtime.weights import load_pretrained

    ckpt, cfg, params = tiny_export["ckpt"], tiny_export["cfg"], tiny_export["params"]
    with open(os.path.join(ckpt, "model.safetensors.index.json")) as f:
        index = json.load(f)
    shards = sorted(set(index["weight_map"].values()))
    assert shards == [f"model-0000{i}-of-00004.safetensors" for i in range(1, 5)]
    assert index["metadata"]["total_size"] == tiny_export["bytes"]
    cs.check_load("x", params, load_pretrained("llama", ckpt, cfg, device="cpu"))

    bad = str(tmp_path / "flipped")
    shutil.copytree(ckpt, bad)
    path = os.path.join(bad, shards[2])
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 3)
        byte = f.read(1)[0]
        f.seek(-1, 1)
        f.write(bytes([byte ^ 0x10]))
    with pytest.raises(AssertionError, match="differ from the exported"):
        cs.check_load("x", params, load_pretrained("llama", bad, cfg, device="cpu"))

    holed = str(tmp_path / "holed")
    shutil.copytree(ckpt, holed)
    victim = "model.layers.1.mlp.up_proj.weight"
    index["weight_map"].pop(victim)
    with open(os.path.join(holed, "model.safetensors.index.json"), "w") as f:
        json.dump(index, f)
    with pytest.raises(KeyError, match="up_proj"):
        load_pretrained("llama", holed, cfg, device="cpu")


def test_the_pretrained_infer_gate_on_the_cpu(tiny_export):
    """infer-pretrained's spec at the tiny preset: the gate holds on a good
    run, and fails on a run whose ids differ or whose weights were not
    loaded."""
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
    from nexus_tpu_torch.utils.tokenizer import load_tokenizer

    ids = load_tokenizer(tiny_export["tok"]).encode(cs.PRETRAINED_PROMPT)
    m = run_template_runtime(_tiny(cs.pretrained_infer_spec(tiny_export["ckpt"],
                                                            tiny_export["tok"])), device="cpu")
    ref = run_template_runtime(_tiny(cs.pretrained_infer_spec(prompt_ids=ids)), device="cpu")
    assert m["output_shape"] == [8, len(ids) + cs.PRETRAINED_NEW_TOKENS]
    cs.check_pretrained_infer("x", m, ref, len(ids))
    with pytest.raises(AssertionError, match="completion ids"):
        flipped = [t ^ 1 for t in ref["completion_ids"]]
        cs.check_pretrained_infer("x", m, dict(ref, completion_ids=flipped), len(ids))
    with pytest.raises(AssertionError, match="weights_loaded"):
        cs.check_pretrained_infer("x", dict(m, weights_loaded=False), ref, len(ids))
    with pytest.raises(AssertionError, match="prompt_tokens"):
        cs.check_pretrained_infer("x", m, ref, len(ids) + 1)


def test_the_pretrained_serve_gates_on_the_cpu(tiny_export):
    from nexus_tpu_torch.runtime.entrypoints import run_template_runtime

    m = run_template_runtime(_tiny(cs.pretrained_serve_spec(tiny_export["ckpt"],
                                                            tiny_export["tok"])), device="cpu")
    cs.check_serve("x", m, {1: 1})
    cs.check_pretrained_serve("x", m)
    assert m["prefix_hit_tokens"] > 0  # the shared preamble
    with pytest.raises(AssertionError, match="completions"):
        cs.check_pretrained_serve("x", dict(m, completions=m["completions"][:7]))


def test_the_pure_tokenizer_gate(tiny_export):
    """The pure engine equals the engine load_tokenizer picks on every
    prompt of the phases; a tokenizer that splits otherwise fails."""
    from nexus_tpu_torch.utils.tokenizer import load_tokenizer

    chosen, pure = load_tokenizer(tiny_export["tok"]), load_tokenizer(tiny_export["tok"], "pure")
    cs.check_pure_tokenizer("x", chosen, pure)

    class Off:
        def encode(self, text):
            return pure.encode(text)[1:]

    with pytest.raises(AssertionError, match="pure tokenizer"):
        cs.check_pure_tokenizer("x", chosen, Off())


# ------------------------------------------------------------ Orbax phases


def test_the_orbax_phase_specs_are_valid_at_8b_widths():
    """The Orbax phases' specs: Llama-3-8B widths at ORBAX_LAYERS layers, a
    checkpoint block that names no format (Orbax, the default), keep 1."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    for spec in (cs.orbax_train_spec("/ck", 4), cs.orbax_infer_spec("/ck")):
        rt = JaxXlaRuntime.from_dict(spec)
        assert not rt.validate()
        assert rt.model.preset == "8b" and rt.model.overrides == {"n_layers": cs.ORBAX_LAYERS}
        assert rt.checkpoint.enabled and rt.checkpoint.format == "orbax"
        assert "format" not in spec["checkpoint"]
    train = JaxXlaRuntime.from_dict(cs.orbax_train_spec("/ck", 4))
    assert (train.checkpoint.keep, train.checkpoint.interval_steps) == (1, 4)
    assert (train.train.batch_size, train.train.seq_len) == (2, 4096)


def _orbax_run(**over):
    m = {"steps_after_first": [4], "steps_on_disk": [6], "staging": [], "resumed_from_step": 4,
         "differing_leaves": [], "differing_params": [], "params_bytes_read": 30,
         "params_value_bytes": 30, "state_bytes_read": 90, "all_value_bytes": 90,
         "frames_checked": 2}
    m.update(over)
    return m


def test_the_llama_orbax_gates_pass_a_good_run():
    cs.check_llama_orbax("x", _orbax_run())


@pytest.mark.parametrize("over,needle", [
    (dict(steps_on_disk=[4, 6]), "keep 1"),
    (dict(steps_after_first=[2, 4]), "keep 1"),
    (dict(staging=["6.orbax-checkpoint-tmp-1"]), "staging"),
    (dict(resumed_from_step=0), "resumed_from_step 0"),
    (dict(differing_leaves=["opt_state.1.0.mu.embed"]), "mu.embed"),
    (dict(differing_params=["params.embed"]), "params.embed"),
    (dict(params_bytes_read=90), "params-only restore read 90"),
    (dict(state_bytes_read=80), "full restore 80"),
    (dict(frames_checked=1), "frames checked"),
], ids=["keep-6", "keep-4", "staging", "not-resumed", "moment-differs", "param-differs",
        "params-read-all", "state-read-part", "frames"])
def test_the_llama_orbax_gates_fail_a_planted_fault(over, needle):
    with pytest.raises(AssertionError, match=needle):
        cs.check_llama_orbax("x", _orbax_run(**over))


def test_the_store_and_leaf_checks_on_a_tiny_state(tmp_path):
    """check_store_frames and differing_state_leaves on a tiny Llama step
    saved by the port: clean, then with a bit flipped in the root node and
    in one moment."""
    import os

    import torch

    from nexus_tpu_torch.train.checkpoint import OrbaxCheckpointer

    spec = cs.orbax_train_spec(str(tmp_path), 2)
    spec["model"] = {"family": "llama", "preset": "tiny", "overrides": {}}
    _, _, state = cs.fresh_train_state(spec, device="cpu")
    for t in state.leaves + state.opt_state.mu + state.opt_state.nu:
        t.detach().normal_()
    OrbaxCheckpointer(str(tmp_path)).save(state)
    step = str(tmp_path / "0")
    assert cs.check_store_frames(step) == 2  # the manifest and one leaf node
    _, _, fresh = cs.fresh_train_state(spec, device="cpu")
    OrbaxCheckpointer(str(tmp_path)).restore(fresh)
    assert cs.differing_state_leaves(fresh, state) == []
    with torch.no_grad():
        fresh.opt_state.mu[0].view(-1)[0] += 1
    fresh.step = 3
    assert cs.differing_state_leaves(fresh, state) == ["opt_state.1.0.mu.embed", "step"]
    d = os.path.join(step, "default", "d")
    node = next(os.path.join(d, f) for f in os.listdir(d)
                if open(os.path.join(d, f), "rb").read(4) == b"\x0c\xdb\x20\xde")
    data = bytearray(open(node, "rb").read())
    data[20] ^= 1
    open(node, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="CRC32C"):
        cs.check_store_frames(step)


# ------------------------------------------------- the multi-rank phases


def test_the_long_context_spec_is_the_template_cut_to_one_card():
    """chip_smoke's copy of examples/train-gptneox-long-context.yaml keeps
    the template's model block and learning rate; only the cuts its
    comments name differ."""
    import os

    import yaml

    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    path = os.path.join(os.path.dirname(cs.__file__), "examples",
                        "train-gptneox-long-context.yaml")
    with open(path) as f:
        tpl = yaml.safe_load(f)["spec"]["runtime"]
    spec = cs.long_context_spec()
    assert spec["model"] == tpl["model"]
    assert spec["train"]["learningRate"] == tpl["train"]["learningRate"]
    assert spec["parallelism"] == {"sequence": 2} and spec["train"]["seqLen"] == 8192
    rt = JaxXlaRuntime.from_dict(spec)
    assert rt.model.overrides["attn_impl"] == "ring" and not rt.checkpoint.enabled
    small = cs.long_context_spec(n_layers=2, steps=5, parallelism={"fsdp": 2, "sequence": 2},
                                 batch=2)
    assert small["model"]["overrides"]["n_layers"] == 2 and cs.LONG_CONTEXT["model"] == tpl["model"]
    assert cs._model_config(cs.long_context_spec(n_layers=4)).param_count() == 407482368


@pytest.mark.parametrize("label,launches", [("pythia", [1, 2]), ("mixtral", [1, 2])])
def test_ring_ops_expected_launches(label, launches):
    shape = cs.RING_OPS_SHAPES[label]
    assert [cs.ring_expected_launches(shape, r) for r in range(cs.RING_RANKS)] == launches
    # over 4 ranks a window of one block keeps two steps: rank r > 0 sees one past block
    four = dict(shape, window=shape["S"] // 4)
    assert [cs.ring_expected_launches(four, r, n=4) for r in range(4)] == [1, 2, 2, 2]


def test_the_visiting_block_shapes_are_the_rings_second_step():
    for label, shape in cs.RING_OPS_SHAPES.items():
        visit = cs.RING_VISIT_SHAPES[label]
        s_local = shape["S"] // cs.RING_RANKS
        assert (visit["Sq"], visit["Sk"], visit["Hq"], visit["Hkv"], visit["D"]) == (
            s_local, s_local, shape["Hq"], shape["Hkv"], shape["D"])
        assert visit["causal"] == (shape["window"] > 0)
        assert visit["q_offset"] == (s_local if shape["window"] else 0)


def test_the_same_losses_gate():
    """Every step's loss and grad norm, each against its limit: a drift at
    a third of a limit passes, one at twice it fails, and so does a grad
    norm scaled by the ranks (gradients not divided by them)."""
    ref = {"steps": [(10.0, 4.0), (9.0, 3.0), (8.0, 2.0)]}
    dl, dg = cs.RING_LOSS_RTOL / 3, cs.RING_GRAD_NORM_RTOL / 3
    near = {"steps": [(10.0, 4.0), (9.0 * (1 + dl), 3.0 * (1 - dg)), (8.0, 2.0)]}
    worst = cs.check_same_losses("x", near, ref)
    assert worst["loss"] == pytest.approx(dl) and worst["grad_norm"] == pytest.approx(dg)
    far_loss = {"steps": [(10.0, 4.0), (9.0 * (1 + 2 * cs.RING_LOSS_RTOL), 3.0), (8.0, 2.0)]}
    with pytest.raises(AssertionError, match="loss differs by"):
        cs.check_same_losses("x", far_loss, ref)
    far_norm = {"steps": [(10.0, 4.0), (9.0, 3.0), (8.0, 2.0 * (1 + 2 * cs.RING_GRAD_NORM_RTOL))]}
    with pytest.raises(AssertionError, match="grad_norm differs by"):
        cs.check_same_losses("x", far_norm, ref)
    unscaled = {"steps": [(loss, 4 * norm) for loss, norm in ref["steps"]]}
    with pytest.raises(AssertionError, match="grad_norm differs by"):
        cs.check_same_losses("x", unscaled, ref)
    with pytest.raises(AssertionError, match="unlike length"):
        cs.check_same_losses("x", {"steps": [(10.0, 4.0)]}, ref)


def _rank_run(rank, hist=(5.0,), launches=1, peak=10.0):
    names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "fused_paged_decode_attention")
    return {"rank": rank, "loss_history": list(hist), "steps": [(h, 1.0) for h in hist],
            "tokens_per_sec": 1.0,
            "tokens_per_sec_per_chip": 0.5, "n_devices": 2, "peak_mem_gb": peak,
            "optimizer_state_bytes": 8, "launches": dict.fromkeys(names, launches),
            "resident_bytes": 12, "reckoned_bytes": {"params": 4, "moments": 8, "peak_floor": 20}}


@pytest.mark.parametrize("runs,needle", [
    ([_rank_run(0), _rank_run(1, hist=(5.5,))], "different losses"),
    ([_rank_run(0), _rank_run(1, launches=0)], "never launched"),
    ([_rank_run(0, hist=(float("nan"),)), _rank_run(1, hist=(float("nan"),))], "not finite"),
    ([_rank_run(0), _rank_run(1, peak=70.0)], "GB"),
])
def test_the_rank_run_gates_fail_a_planted_fault(runs, needle):
    assert cs.check_rank_runs("x", [_rank_run(0), _rank_run(1)])
    with pytest.raises(AssertionError, match=needle):
        cs.check_rank_runs("x", runs)


def test_fsdp_blocks_are_the_trainers_and_fingerprints_see_one_bit():
    """chip_smoke's blocks of a whole state are what each rank of the train
    entry point holds over {fsdp: 2, sequence: 2} (its init over
    ``param_shard``, the mesh built without a group), the moments cut
    alike, and its reckoned bytes are theirs; a fingerprint changes with one
    flipped bit or two swapped elements."""
    import torch

    from nexus_tpu_torch.models import llama
    from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from nexus_tpu_torch.parallel.sharding import param_shard
    from nexus_tpu_torch.train.trainer import build_optimizer, init_train_state

    spec = {"model": {"family": "llama", "preset": "tiny", "overrides": {"dtype": "bfloat16"}},
            "parallelism": {"fsdp": 2, "sequence": 2}}
    cfg = llama.config("tiny", dtype="bfloat16")
    whole = llama.init(torch.Generator().manual_seed(0), cfg, "cpu")
    state = init_train_state(whole, llama.leaves(whole), build_optimizer())
    for t in state.opt_state.mu + state.opt_state.nu:
        t.normal_()
    n = len(state.leaves)
    for rank in range(4):
        shard = param_shard(Mesh(MeshPlan(fsdp=2, sequence=2), rank))
        held = llama.leaves(llama.init(torch.Generator().manual_seed(0), cfg, "cpu",
                                       shard=shard))
        blocks = cs.rank_blocks(spec, 4, rank, state)
        assert len(blocks) == 3 * n
        for a, b in zip(blocks, held):
            assert torch.equal(a, b)
        for a, b in zip(blocks[n:], held + held):  # the moments cut as the parameters
            assert a.shape == b.shape
        assert cs.reckoned_bytes(spec, 4, rank)["params"] == sum(
            t.numel() * t.element_size() for t in held)
        assert any(a.shape != t.shape for a, t in zip(blocks, state.leaves))
    ts = [torch.randn(5, 3).to(torch.bfloat16), torch.randn(7), torch.randn(2, 2, 2)]
    base = cs.state_fingerprints(ts)
    flipped = ts[0].clone().view(torch.int16)
    flipped[2, 1] ^= 1
    assert cs.state_fingerprints([flipped.view(torch.bfloat16)] + ts[1:]) != base
    swapped = ts[1].clone()
    swapped[[0, 1]] = swapped[[1, 0]]
    assert cs.state_fingerprints([ts[0], swapped, ts[2]]) != base
    assert cs.state_fingerprints([t.clone() for t in ts]) == base


def test_recorded_steps_keep_every_steps_loss_and_grad_norm():
    """The ring phases compare every step, the untimed warmup ones too:
    the recorded losses end with the run's loss history, and the entry
    point is restored when the recording closes."""
    from nexus_tpu_torch.runtime import entrypoints as E

    make = E.make_train_step
    spec = {"kind": "jax_xla", "mode": "train", "model": {"family": "llama", "preset": "tiny"},
            "train": {"batchSize": 2, "seqLen": 32, "steps": 4, "learningRate": 3e-3}}
    with cs.recorded_steps() as steps:
        m = E.run_template_runtime(spec, device="cpu")
    assert E.make_train_step is make and steps.profile is None
    assert len(steps) == 4 and [loss for loss, _ in steps[2:]] == m["loss_history"]
    assert all(norm > 0 for _, norm in steps)


def test_the_profile_table_counts_kernel_rows_only():
    """An op's row repeats its kernels' device time: the kinds sum the
    kernel rows alone, split into collectives, flash and the rest."""
    import types

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def row(key, dev_us, device_type, cpu_us=0.0):
        return types.SimpleNamespace(key=key, self_device_time_total=dev_us, count=1,
                                     device_type=device_type, self_cpu_time_total=cpu_us)

    rows = [row("ncclDevKernel_SendRecv", 3e5, cuda), row("nccl:coalesced", 3e5, cpu),
            row("flash_fwd_kernel", 2e5, cuda), row("aten::mm", 1e5, cpu, cpu_us=5e4),
            row("nvjet_gemm", 1e5, cuda)]
    prof = types.SimpleNamespace(key_averages=lambda: rows)
    table = cs.profile_table(prof, 1.0)
    assert table["device_s_by_kind"] == pytest.approx({"collective": 0.3, "flash": 0.2,
                                                       "other": 0.1})
    assert [k for k, _, _ in table["top_device"]] == ["ncclDevKernel_SendRecv",
                                                      "flash_fwd_kernel", "nvjet_gemm"]
    assert table["top_host"][0][0] == "aten::mm"


def test_the_token_share_gate(monkeypatch):
    """The share counts each request's tokens up to its first difference;
    a run under it fails, and so does a planted run that reaches it."""
    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    one = {"completion_ids": [[1, 2, 3, 4], [5, 6, 7, 8]]}
    assert cs.token_share(one["completion_ids"], [[1, 2, 9, 4], [5, 6, 7, 8]]) == 6 / 8
    assert cs.token_share(one["completion_ids"], [[0, 2, 3, 4], [5, 6, 7, 8]]) == 4 / 8
    wrong = {"completion_ids": [[0] * 4, [0] * 4]}
    assert cs.check_tp_share("x", one, one, planted=wrong) == {"clean": 1.0, "planted": 0.0}
    with pytest.raises(AssertionError, match="token share"):
        cs.check_tp_share("x", one, wrong)
    with pytest.raises(AssertionError, match="planted kv-head block passes"):
        cs.check_tp_share("x", one, one, planted=one)


@pytest.mark.parametrize("name", ["llama", "gptneox"])
def test_the_paged_feed_is_the_dense_one_and_a_rolled_pool_fails_the_limit(name, monkeypatch):
    """The teacher-forced feed through a paged pool (feeds of 8, then of 1)
    gives the dense feed's logits at tiny widths in float32 on the CPU, and
    D1 reading the pool's kv heads rolled by one moves them past the logits
    limit, which the gate then reports; a clean feed past the limit, or a
    fault under it, fails."""
    import numpy as np
    import torch

    from nexus_tpu_torch.models.registry import get_family
    from nexus_tpu_torch.runtime.entrypoints import _decode_params

    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    family = get_family(name)
    cfg = family.config("tiny", dtype=torch.float32)
    params = _decode_params(family, cfg, torch.device("cpu"), 0)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (2, 24)))
    dense = cs._teacher_forced(family, params, cfg, tokens)
    paged = cs._teacher_forced(family, params, cfg, tokens, paged=True)
    torch.testing.assert_close(paged, dense, rtol=1e-5, atol=1e-5)
    with cs._planted("kv_head_block"):
        rolled = cs._teacher_forced(family, params, cfg, tokens, paged=True)

    def ranks(clean, fault):
        logits = {"paged/clean": clean, "paged/kv_head_block": fault}
        return [{"logits": {name: {"logits": logits, "checksum": {"paged/clean": 1.0}}}}]

    ratios = cs.check_tp_logits({name: {"paged": dense}}, ranks(paged, rolled))
    assert ratios[name]["paged/clean"] < 1e-3 < 1 < ratios[name]["paged/kv_head_block"]
    with pytest.raises(AssertionError, match="planted faults pass"):
        cs.check_tp_logits({name: {"paged": dense}}, ranks(paged, paged))
    with pytest.raises(AssertionError, match="over ranks"):
        cs.check_tp_logits({name: {"paged": dense}}, ranks(rolled, rolled))


def test_route_flips_splits_the_error_by_the_tokens_whose_routing_flips():
    """By hand: 2 layers, 1 row of 4 tokens, top 2; token 2's experts
    differ at layer 1. The error of each token is its largest logit
    difference over one rank's largest logit (10)."""
    import torch

    want = torch.zeros(1, 4, 3)
    want[0, 0, 0] = 10.0
    got = want.clone()
    got[0, :, 1] += torch.tensor([0.1, 0.2, 3.0, 0.5])
    ref = torch.tensor([[[0, 1], [2, 3], [0, 4], [1, 2]]] * 2)
    routes = ref.clone()
    routes[1, 2] = torch.tensor([0, 5])
    out = cs.route_flips(want, got, ref, routes)
    assert out["tokens"] == 4 and out["flipped_tokens"] == 1 and out["flips_by_layer"] == [0, 1]
    assert out["flipped"] == pytest.approx(0.3) and out["unflipped"] == pytest.approx(0.05)
    assert out["before_first_flip"] == pytest.approx(0.02)
    nothing = cs.route_flips(want, got, ref, ref)
    assert nothing["flipped_tokens"] == 0 and nothing["flipped"] == 0.0
    assert nothing["before_first_flip"] == nothing["unflipped"] == pytest.approx(0.3)


def test_an_moe_feed_records_its_routes_and_its_unflipped_tokens_are_gated(monkeypatch):
    """A tiny Mixtral's dense feed records one (B·T, k) route a layer (the
    patch put back after); check_tp_logits holds the tokens whose routing
    does not flip to TP_LOGIT_LIMIT, beside the whole feed's family limit."""
    import numpy as np
    import torch

    from nexus_tpu_torch.models import mixtral
    from nexus_tpu_torch.runtime.entrypoints import _decode_params

    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    cfg = mixtral.config("tiny", dtype=torch.float32)
    params = _decode_params(mixtral, cfg, torch.device("cpu"), 0)
    tokens = torch.as_tensor(np.random.RandomState(0).randint(0, cfg.vocab_size, (1, 12)))
    route = mixtral.top_k_routing
    ref = cs._feed(mixtral, params, cfg, tokens, "dense")
    assert mixtral.top_k_routing is route
    assert ref["dense/routes"].shape == (cfg.n_layers, 12, cfg.n_experts_per_token)
    assert "dense/routes" not in cs._feed(mixtral, params, cfg, tokens, "paged")
    logits = ref["dense"]
    scale = logits.abs().max()
    limit = cs.TP_LOGIT_LIMITS["mixtral"]
    fault = logits + 2 * limit * scale
    routes = ref["dense/routes"].clone()
    routes[0, 5] = routes[0, 5].flip(0) + 1  # token 5 flips at layer 0

    def ranks(clean, routes):
        return [{"logits": {"mixtral": {
            "logits": {"dense/clean": clean, "dense/no_wdown_reduce": fault},
            "routes": {"dense/routes": routes}, "checksum": {"dense/clean": 1.0}}}}]

    # an error past TP_LOGIT_LIMIT on the flipped token alone passes
    moved = logits.clone()
    moved[0, 5, 0] += 1.5 * cs.TP_LOGIT_LIMIT * scale
    out = cs.check_tp_logits({"mixtral": ref}, ranks(moved, routes))
    info = out["mixtral"]["dense/routes"]
    assert info["flipped_tokens"] == 1 and info["unflipped"] == 0.0
    assert info["flipped"] == pytest.approx(1.5 * cs.TP_LOGIT_LIMIT, rel=1e-4)
    # on a token that keeps its routing it fails
    with pytest.raises(AssertionError, match="routing does not flip"):
        cs.check_tp_logits({"mixtral": ref}, ranks(moved, ref["dense/routes"]))


# ------------------------------------------------ tensor-parallel training


def test_train_tp_is_the_fsdp_template_cut_in_depth_steps_and_batch():
    """TRAIN_TP keeps examples/train-llama8b-fsdp.yaml's model, widths,
    overrides and parallelism (re-planned by the ranks' count), cutting
    only what its comments list."""
    import yaml

    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.parallel.mesh import MeshPlan, plan_for_devices

    with open("examples/train-llama8b-fsdp.yaml") as f:
        rt = yaml.safe_load(f)["spec"]["runtime"]
    spec = cs.train_tp_spec()
    assert spec["model"]["family"] == rt["model"]["family"] and spec["model"]["preset"] == "8b"
    over = dict(spec["model"]["overrides"])
    assert over.pop("n_layers") == 2 and over == rt["model"]["overrides"]
    assert spec["parallelism"] == rt["parallelism"]
    plan = MeshPlan.from_parallelism(JaxXlaRuntime.from_dict(spec).parallelism)
    assert plan.total() == 64 and plan_for_devices(2).tensor == 2
    assert plan_for_devices(4).tensor == 4
    assert cs.train_tp_spec(2, planted="block_norm")["planted"] == "block_norm"
    neox = cs.tp_neox_spec("/x", 5)
    JaxXlaRuntime.from_dict(neox)
    assert neox["checkpoint"]["resume"] and neox["parallelism"] == {"fsdp": 2, "tensor": 2}
    assert "checkpoint" not in cs.tp_neox_spec("", 2)


def test_the_train_rank_shapes_are_the_ranks_heads():
    for label, (hq, hkv, ranks) in {"llama8b_tp2": (32, 8, 2), "llama8b_tp4": (32, 8, 4),
                                    "pythia_tp2": (16, 16, 2),
                                    "mixtral_tp2": (32, 8, 2)}.items():
        shape = cs.TP_TRAIN_SHAPES[label]
        assert (shape["Hq"], shape["Hkv"]) == (hq // ranks, hkv // ranks)


def _steps(*pairs):
    return {"steps": list(pairs)}


def test_the_train_tp_gates_pass_clean_runs_and_catch_faults(monkeypatch):
    monkeypatch.setattr(cs, "card_label", lambda: "no card")
    one = _steps((10.0, 2.0), (9.0, 3.0))
    clean = _steps((10.0 * (1 + cs.TP_TRAIN_LOSS_RTOL / 2), 2.0), (9.0, 3.0))
    fault = _steps((10.0, 2.0 * (1 + 3 * cs.TP_TRAIN_NORM_RTOL)))
    out = cs.check_train_tp("x", clean, one, {"f": fault})
    assert out["f"]["grad_norm"] == pytest.approx(3.0)
    with pytest.raises(AssertionError, match="over the ranks"):
        cs.check_train_tp("x", _steps((10.0, 2.0 * (1 + 2 * cs.TP_TRAIN_NORM_RTOL)),
                                      (9.0, 3.0)), one, {})
    with pytest.raises(AssertionError, match="planted f passes"):
        cs.check_train_tp("x", clean, one, {"f": clean})
    with pytest.raises(AssertionError, match="unlike length"):
        cs.step_differences(_steps(), one)


def test_the_planted_train_faults_patch_and_restore():
    import torch

    from nexus_tpu_torch.parallel import tensor as T
    from nexus_tpu_torch.train import trainer as Tr

    backward, norm = T._Copy.backward, Tr.sharded_norm
    with cs.planted_train_fault("no_copy_reduce"):
        g = torch.ones(2)
        assert T._Copy.backward(None, g)[0] is g
    with cs.planted_train_fault("block_norm"):
        assert float(Tr.sharded_norm([torch.full((4,), 2.0)], [True], None)) == 4.0
    assert T._Copy.backward is backward and Tr.sharded_norm is norm
    with pytest.raises(ValueError, match="unknown planted fault"):
        with cs.planted_train_fault("nope"):
            pass


# ------------------------------------------------------------ MoE over ranks


def _fanout_runtime():
    import yaml

    with open("examples/moe-mixtral-fanout.yaml") as f:
        docs = [d for d in yaml.safe_load_all(f) if d["kind"] == "NexusAlgorithmTemplate"]
    return docs[0]["spec"]["runtime"]


def test_the_moe_train_specs_are_the_fanout_template_cut():
    """MOE_TRAIN keeps examples/moe-mixtral-fanout.yaml's model, widths,
    overrides and parallelism (re-planned by the ranks' count), cutting
    only what its comments list; train-moe-ep runs it over {fsdp: 2,
    expert: 2} at 1 layer, 2 rows and MOE_EP_CF, resuming an Orbax step."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.parallel.mesh import plan_for_devices

    rt = _fanout_runtime()
    spec = cs.moe_train_spec()
    assert (spec["model"]["family"], spec["model"]["preset"]) == ("mixtral", "8x7b")
    over = dict(spec["model"]["overrides"])
    assert over.pop("n_layers") == 2  # dispatch_impl as the template leaves it: auto
    assert over == rt["model"]["overrides"] and spec["parallelism"] == rt["parallelism"]
    twin = cs.one_card_twin(spec)
    assert twin["model"]["overrides"] == dict(spec["model"]["overrides"], dispatch_impl="einsum")
    assert "dispatch_impl" not in spec["model"]["overrides"]  # the twin is a copy
    assert plan_for_devices(cs.MOE_RANKS).tensor == cs.MOE_RANKS
    JaxXlaRuntime.from_dict(spec)
    assert cs.moe_train_spec(1, planted="no_expert_copy")["planted"] == "no_expert_copy"
    ep = cs.moe_ep_spec("/x", 3)
    JaxXlaRuntime.from_dict(ep)
    assert ep["parallelism"] == cs.MOE_EP_PLAN and ep["train"]["batchSize"] == 2
    assert ep["model"]["overrides"]["n_layers"] == 1
    assert ep["model"]["overrides"]["capacity_factor"] == cs.MOE_EP_CF
    assert ep["checkpoint"]["resume"] and ep["checkpoint"]["format"] == "orbax"
    assert not cs.moe_ep_spec("", 1)["checkpoint"]["enabled"]
    assert cs.moe_ep_spec("", 1, plan={"expert": 4})["parallelism"] == {"expert": 4}


def test_the_dispatch_timing_shapes_are_the_train_phases_rank_shapes():
    """MOE_DISPATCH_SHAPES: each MoE train phase's tokens a rank, the rank's
    experts and d_ff, and the global capacity, from its spec and plan."""
    from nexus_tpu_torch.ops.moe import default_capacity

    # {tensor: 2}: every expert, half of d_ff; {fsdp: 2, expert: 2}: half
    # of the tokens and of the experts, all of d_ff
    for name, spec, world, experts, ff in (
            ("train-moe-tp", cs.moe_train_spec(), cs.MOE_RANKS, 8, 14336 // 2),
            ("train-moe-ep", cs.moe_ep_spec("", 1), 4, 4, 14336)):
        cfg = cs._model_config(spec)
        tokens = spec["train"]["batchSize"] * spec["train"]["seqLen"]
        cap = default_capacity(tokens, cfg.n_experts, cfg.n_experts_per_token,
                               cfg.capacity_factor)
        assert cs.MOE_DISPATCH_SHAPES[name] == (4096, experts, cap, ff)
        assert cs.moe_dense_bytes(spec, world) == 2 * 4 * 4096 * experts * cap


def test_the_dense_dispatch_bytes_are_counted_by_hand():
    # train-moe-tp re-planned to {tensor: 2}: 4096 tokens, 8 experts,
    # capacity int(4096 * 2 * 1.25 / 8) = 1280, two f32 tensors
    assert cs.moe_dense_bytes(cs.moe_train_spec(), 2) == 2 * 4 * 4096 * 8 * 1280
    # train-moe-ep over {fsdp: 2, expert: 2}: 4096 of 8192 tokens a rank, 4
    # experts, capacity int(8192 * 2 * 0.5 / 8) = 1024
    assert cs.moe_dense_bytes(cs.moe_ep_spec("", 1), 4) == 2 * 4 * 4096 * 4 * 1024


def test_the_moe_gates_hold_the_dropped_share_absolute(monkeypatch):
    monkeypatch.setattr(cs, "card_label", lambda: "no card")
    lim = cs.MOE_LIMITS
    one = _steps((10.0, 2.0, 1.5, 0.0), (9.0, 3.0, 1.4, 0.25))
    clean = _steps((10.0 * (1 + lim["loss"] / 2), 2.0, 1.5, lim["router_dropped_fraction"] / 2),
                   (9.0, 3.0, 1.4, 0.25))
    out = cs.check_train_tp("x", clean, one, {}, lim)
    assert out["clean"]["router_dropped_fraction"] == pytest.approx(
        lim["router_dropped_fraction"] / 2)
    aux_fault = _steps((10.0, 2.0, 1.5 * (1 + 4 * lim["aux"]), 0.0))
    assert cs.check_train_tp("x", clean, one, {"f": aux_fault}, lim)["f"]["aux"] == \
        pytest.approx(4.0)
    with pytest.raises(AssertionError, match="over the ranks"):
        cs.check_train_tp("x", _steps((10.0, 2.0, 1.5, 2 * lim["router_dropped_fraction"]),
                                      (9.0, 3.0, 1.4, 0.25)), one, {}, lim)
    with pytest.raises(AssertionError, match="planted f passes"):
        cs.check_train_tp("x", clean, one, {"f": clean}, lim)


def test_the_moe_planted_faults_patch_and_restore(monkeypatch):
    """Each fault patches what its comment says for the block, and puts it
    back: the norm given no copies, f skipped for the (T, d) tokens alone
    (not the (T, 2) combine weights nor a 3-d input), no token grid."""
    import torch

    from nexus_tpu_torch.models import mixtral as Mx
    from nexus_tpu_torch.parallel import tensor as T
    from nexus_tpu_torch.train import trainer as Tr

    calls = []
    monkeypatch.setattr(Tr, "sharded_norm", lambda blocks, copies, mesh: calls.append(copies))
    monkeypatch.setattr(T._Copy, "apply", lambda x, group: calls.append(tuple(x.shape)) or x)
    norm, copy, grid = Tr.sharded_norm, Mx.copy_to_tensor, Mx.token_grid
    with cs.planted_train_fault("whole_norm"):
        Tr.sharded_norm([], [1, 2], None)
    with cs.planted_train_fault("no_expert_copy"):
        for shape in ((3, 8), (3, 2), (1, 3, 8)):
            Mx.copy_to_tensor(torch.ones(shape), "group")
    with cs.planted_train_fault("per_rank_routing"):
        assert Mx.token_grid("any mesh") is None
    assert calls == [None, (3, 2), (1, 3, 8)]
    assert (Tr.sharded_norm, Mx.copy_to_tensor, Mx.token_grid) == (norm, copy, grid)


def test_recorded_steps_keep_the_moe_metrics():
    """Mixtral's steps carry (loss, grad norm, aux, dropped share), the
    MoE gates' four metrics."""
    from nexus_tpu_torch.runtime import entrypoints as E

    spec = {"kind": "jax_xla", "mode": "train", "model": {"family": "mixtral", "preset": "tiny"},
            "train": {"batchSize": 2, "seqLen": 32, "steps": 2, "learningRate": 3e-3}}
    with cs.recorded_steps() as steps:
        m = E.run_template_runtime(spec, device="cpu")
    assert len(steps) == 2 and all(len(step) == 4 for step in steps)
    assert steps[-1][0] == m["loss_history"][-1] and steps[-1][3] == m["router_dropped_fraction"]


def test_serve_moe_tp_serves_mixtral_serves_requests_over_two_ranks():
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    spec, one = cs.moe_serve_spec(), cs.mixtral_serve_spec()
    JaxXlaRuntime.from_dict(spec)
    assert spec["parallelism"] == {"tensor": cs.TP_RANKS} and "parallelism" not in one
    assert spec["serve"] == one["serve"] and spec["serve"]["numRequests"] == 8
    assert spec["model"]["overrides"] == {"n_layers": cs.MOE_SERVE_LAYERS,
                                          "dispatch_impl": cs.MOE_DISPATCH_OVER_RANKS}
    assert cs.moe_serve_spec(1)["parallelism"] == {"tensor": 1}
    assert cs.moe_serve_spec(1)["model"]["overrides"] == spec["model"]["overrides"]
    assert cs.moe_serve_spec(4, 32)["model"]["overrides"]["n_layers"] == 32
    assert cs.rank_heads(spec, cs.TP_RANKS) == (16, 4, 128)
    preset, over, feeds = cs.TP_LOGIT_CASES["mixtral"]
    assert preset == "8x7b" and over == {"n_layers": cs.MIXTRAL_SERVE_LAYERS}
    assert feeds == {"dense": ("clean", "no_wdown_reduce")}


# -------------------------- the rest of the batch and tensor axes (item 4b)


def _infer_template():
    import yaml

    with open("examples/infer-llama8b.yaml") as f:
        return yaml.safe_load(f)["spec"]["runtime"]


def test_the_batch_axes_specs_are_the_templates_cut():
    """infer-dp-tp is examples/infer-llama8b.yaml at its widths cut to
    BATCH_AXES_LAYERS over {data: 2, tensor: 2}; serve-fsdp-tp the serve
    queue at that depth over JAX's 16-chip plan at 4 ranks; train-ring-tp
    the long-context template over {sequence: 2, tensor: 2}; the MoE and MLP
    phases their templates over 4 ranks; each a valid runtime block."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.parallel.mesh import plan_for_devices

    rt = _infer_template()
    infer = cs.infer_dp_tp_spec()
    assert (infer["model"]["family"], infer["model"]["preset"]) == (
        rt["model"]["family"], rt["model"]["preset"])
    assert infer["model"]["overrides"] == {"n_layers": cs.BATCH_AXES_LAYERS}
    assert infer["infer"]["promptLength"] == rt["infer"]["promptLength"] == 128
    assert infer["parallelism"] == {"data": 2, "tensor": 2}
    assert cs.infer_dp_tp_spec({})["parallelism"] == {}
    # JAX's plan for 16 chips, {tensor: 8, fsdp: 2}, at 4 ranks
    plan = plan_for_devices(16)
    assert (plan.tensor, plan.fsdp) == (8, 2)
    serve = cs.serve_fsdp_tp_spec()
    assert serve["parallelism"] == {"fsdp": 2, "tensor": 2}
    assert serve["serve"]["numRequests"] == cs.SERVE_FSDP_TP_REQUESTS
    assert serve["model"]["overrides"] == {"n_layers": cs.BATCH_AXES_LAYERS}
    assert serve["serve"] == dict(cs._serve_spec()["serve"],
                                  numRequests=cs.SERVE_FSDP_TP_REQUESTS)
    ring = cs.ring_tp_spec()
    assert ring["parallelism"] == {"sequence": 2, "tensor": 2}
    assert ring["train"]["seqLen"] == 8192 and ring["model"]["overrides"]["n_layers"] == 2
    moe = cs.moe_ring_tp_spec()
    assert moe["parallelism"] == {"sequence": 2, "tensor": 2}
    assert moe["model"]["overrides"]["n_layers"] == 1
    assert moe["train"]["steps"] == cs.MOE_RING_TP_STEPS
    mlp = cs.mlp_tp_spec()
    assert mlp["model"] == {"family": "mlp", "preset": "small"}
    assert mlp["parallelism"] == {"fsdp": 2, "tensor": 2}
    assert mlp["train"]["steps"] == cs.MLP_TP_STEPS
    assert cs.mlp_tp_spec(1, planted="no_copy_reduce")["planted"] == "no_copy_reduce"
    for spec in (infer, serve, ring, moe, mlp):
        JaxXlaRuntime.from_dict(spec)
    assert cs.rank_heads(serve, 2) == (16, 4, 128)


def test_the_ring_visit_at_a_tensor_ranks_heads():
    shape = cs.TP_TRAIN_SHAPES["pythia_ring_visit_tp2"]
    assert shape == dict(cs.RING_VISIT_SHAPES["pythia"], Hq=8, Hkv=8)
    cfg = cs._model_config(cs.ring_tp_spec())
    assert cfg.n_heads // cs.RING_TP_PLAN["tensor"] == shape["Hq"]
    assert cs.ring_tp_spec()["train"]["seqLen"] // cs.RING_TP_PLAN["sequence"] == shape["Sq"]


def test_the_dp_logits_gate_passes_clean_rows_and_catches_faults(monkeypatch):
    import torch

    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    ref = torch.randn(8, 4, 16)
    swapped = torch.cat([ref[4:], ref[:4]])
    near = ref * (1 + cs.TP_LOGIT_LIMIT / 4)
    ranks = [{"logits": {"clean": near, "rows_reversed": swapped, "peer_rows": swapped},
              "checksum": 1.0, "rows": [0, 4]}, {"checksum": 1.0, "rows": [4, 8]}]
    out = cs.check_dp_logits(ref, ranks)
    assert out["clean"] < 1 and out["rows_reversed"] > 1 and out["peer_rows"] > 1
    with pytest.raises(AssertionError, match="faults pass the limit"):
        cs.check_dp_logits(ref, [dict(ranks[0], logits=dict(ranks[0]["logits"],
                                                             peer_rows=near)), ranks[1]])
    with pytest.raises(AssertionError, match="logits over ranks"):
        cs.check_dp_logits(ref, [dict(ranks[0], logits=dict(ranks[0]["logits"],
                                                             clean=swapped)), ranks[1]])
    with pytest.raises(AssertionError, match="differ"):
        cs.check_dp_logits(ref, [ranks[0], dict(ranks[1], checksum=2.0)])


def test_the_planted_row_faults_move_the_rows_and_restore():
    import torch

    from nexus_tpu_torch.parallel import sharding as S
    from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan

    decode, gather = S.decode_rows, S.gather_rows
    mesh = Mesh(MeshPlan(data=2, tensor=2), rank=0)
    assert (S.decode_rows(mesh, 8).start, S.decode_rows(mesh, 8).stop) == (0, 4)
    with cs.planted_rows("peer_rows"):
        rows = S.decode_rows(mesh, 8)
        assert (rows.start, rows.stop, rows.axes) == (4, 8, ("data",))
    x = torch.arange(8.0)[:, None]

    def fake_gather(t, m, rows):  # the two data ranks' blocks, in order
        return torch.cat([t, t + 4])

    S.gather_rows = fake_gather
    try:
        with cs.planted_rows("rows_reversed"):
            got = S.gather_rows(x[:4], mesh, decode(mesh, 8))
        assert got[:, 0].tolist() == [4, 5, 6, 7, 0, 1, 2, 3]
    finally:
        S.gather_rows = gather
    assert (S.decode_rows, S.gather_rows) == (decode, gather)
    with pytest.raises(ValueError, match="unknown planted fault"):
        with cs.planted_rows("nope"):
            pass


def test_the_batch_gates_fail_unlike_ranks(monkeypatch):
    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    b = cs.INFER_DP_TP["train"]["batchSize"]
    shape = [b, 128 + 64]
    ids = [[1, 2, 3]] * b
    run = {"completion_ids_by_row": ids, "last_logits_finite": True, "output_shape": shape,
           "peak_mem_gb": 1.0, "decode_tokens_per_sec": 1.0,
           "decode_tokens_per_sec_per_chip": 0.25, "iteration_seconds": [1.0]}
    one = dict(run, completion_ids_by_row=[[1, 2, 4]] * b)
    assert cs.check_batch_infer("x", [run, run], one) == {"token_share_vs_one_card": 2 / 3}
    with pytest.raises(AssertionError, match="different ids"):
        cs.check_batch_infer("x", [run, dict(run, completion_ids_by_row=[[0]] * b)], one)
    with pytest.raises(AssertionError, match="rank output"):
        cs.check_batch_infer("x", [dict(run, output_shape=[4, 192])], one)
    monkeypatch.setattr(cs, "check_tp_serve", lambda *a: None)
    serve = {"tokens_per_sec": 3.0, "committed_tokens": 9, "peak_mem_gb": 1.0,
             "phase_wall_s": 2.0, "spawn_wall_s": 5.0}
    cs.check_batch_serve("x", [serve, dict(serve, peak_mem_gb=2.0, phase_wall_s=1.0)], ())
    with pytest.raises(AssertionError, match=r"ledgers differ in \['committed_tokens'\]"):
        cs.check_batch_serve("x", [serve, dict(serve, committed_tokens=8)], ())
    cs.check_diverged("x", [{"audit": "lockstep audit (first admission)"}] * 2)
    with pytest.raises(AssertionError, match="did not fire"):
        cs.check_diverged("x", [{"audit": "lockstep audit (x)"}, {"audit": None}])


def test_the_world_ring_fault_rings_over_the_world_and_restores(monkeypatch):
    import torch.distributed as dist

    from nexus_tpu_torch.ops import ring_attention as R

    seen = []
    monkeypatch.setattr(R, "ring_attention",
                        lambda q, k, v, group, **kw: seen.append((group, kw)))
    ring = R.ring_attention
    with cs.planted_train_fault("world_ring"):
        R.ring_attention(1, 2, 3, "sequence group", causal=True)
    assert seen == [(dist.group.WORLD, {"causal": True})] and R.ring_attention is ring


# ------------------- infer and serve over the expert axis (item 4c, parts two, three)


def test_the_expert_axis_specs_are_mixtral_infer_and_serve_cut():
    """infer-moe-ep is mixtral-infer's spec at MOE_EP_LAYERS, prompt 128,
    over {data: 2, expert: 2}, the rows over data; serve-moe-ep is
    serve-moe-tp's over {expert: 2, tensor: 2}, D1 at 16 / 4 heads a rank;
    both pin the dispatch ``auto`` resolves over ranks."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
    from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from nexus_tpu_torch.parallel.sharding import decode_rows

    infer, mixtral_infer = cs.infer_moe_ep_spec(), cs.mixtral_infer_spec()
    assert infer["model"]["family"] == "mixtral" and infer["model"]["preset"] == "8x7b"
    assert infer["model"]["overrides"] == {"n_layers": cs.MOE_EP_LAYERS,
                                           "dispatch_impl": cs.MOE_DISPATCH_OVER_RANKS}
    assert infer["infer"] == dict(mixtral_infer["infer"], promptLength=128, iterations=1)
    assert infer["train"] == mixtral_infer["train"] and infer["infer"]["maxNewTokens"] == 64
    assert infer["parallelism"] == {"data": 2, "expert": 2}
    assert cs.infer_moe_ep_spec({})["parallelism"] == {}
    serve = cs.serve_moe_ep_spec()
    assert serve["parallelism"] == {"expert": 2, "tensor": 2}
    assert {k: v for k, v in serve.items() if k != "parallelism"} == {
        k: v for k, v in cs.moe_serve_spec().items() if k != "parallelism"}
    assert cs.rank_heads(serve, 2) == (16, 4, 128)
    for spec in (infer, serve):
        JaxXlaRuntime.from_dict(spec)
    rows = [decode_rows(Mesh(MeshPlan(**cs.MOE_EP_INFER_PLAN), r), 8) for r in range(4)]
    assert [(x.start, x.stop, x.axes) for x in rows] == [(0, 4, ("data",))] * 2 + [
        (4, 8, ("data",))] * 2
    assert cs.moe_ep_prompt(32000).shape == (8, 128)


@pytest.fixture(scope="module")
def tiny_moe_feeds():
    """A tiny Mixtral's ``moe_ep_feeds`` of 8 rows of 12 tokens (8 in the
    prefill, the last 4 one a feed): the whole batch's, each half of the
    rows fed alone (each rank routing its rows alone), and the whole batch
    replayed under each of those two routings."""
    import numpy as np
    import torch

    from nexus_tpu_torch.models import mixtral
    from nexus_tpu_torch.runtime.entrypoints import _decode_params

    steps = cs.MOE_EP_LOGIT_STEPS
    cs.MOE_EP_LOGIT_STEPS = 4
    try:
        cfg = mixtral.config("tiny", dtype=torch.float32)
        params = _decode_params(mixtral, cfg, torch.device("cpu"), 0)
        tokens = torch.as_tensor(np.random.RandomState(3).randint(0, cfg.vocab_size, (8, 12)))
        whole = cs.moe_ep_feeds(params, cfg, tokens)
        halves = [cs.moe_ep_feeds(params, cfg, tokens[r:r + 4]) for r in (0, 4)]
        alone = {part: {k: torch.cat([h[part][k] for h in halves]) for k in feeds}
                 for part, feeds in whole.items()}
        replayed = {name: cs.moe_ep_feeds(params, cfg, tokens, replay=feeds)
                    for name, feeds in (("whole", whole), ("alone", alone))}
    finally:
        cs.MOE_EP_LOGIT_STEPS = steps
    return cfg, whole, alone, replayed


def test_moe_ep_feeds_record_each_layer_of_each_held_position(tiny_moe_feeds):
    import numpy as np
    import torch

    from nexus_tpu_torch.models import mixtral
    from nexus_tpu_torch.models.decoding import cache_for

    cfg, whole, _, replayed = tiny_moe_feeds
    k = cfg.n_experts_per_token
    assert sorted(whole) == ["prefill", "steps"]
    for part in whole.values():
        assert part["logits"].shape == (8, 4, cfg.vocab_size)
        assert part["experts"].shape == part["valid"].shape == (8, 4 * cfg.n_layers, k)
        assert bool((part["experts"][..., 1:] > part["experts"][..., :1]).all())  # sorted
    assert whole["prefill"]["calls"].shape == (8, 8 * cfg.n_layers, k)
    assert len(cs.route_calls(whole, cfg.n_layers)) == cfg.n_layers * (1 + 4)
    # one card replaying its own routing gives its own logits, bit for bit
    for part in whole:
        assert torch.equal(replayed["whole"][part]["logits"], whole[part]["logits"])
    # the prefill's last position is the last row of the 8-token feed
    from nexus_tpu_torch.runtime.entrypoints import _decode_params
    params = _decode_params(mixtral, cfg, torch.device("cpu"), 0)
    tokens = torch.as_tensor(np.random.RandomState(3).randint(0, cfg.vocab_size, (8, 12)))
    logits, _ = mixtral.forward_decode(params, cfg, tokens[:, :8],
                                       cache_for(params, cfg, 8, 12, "cpu"))
    assert torch.equal(whole["prefill"]["logits"], logits[:, -4:].float())
    assert mixtral.top_k_routing.__module__ == "nexus_tpu_torch.ops.moe"
    assert mixtral.global_top_k_routing.__module__ == "nexus_tpu_torch.ops.moe"


def test_the_route_layouts_put_tokens_where_the_gates_read_them():
    """``_by_layer`` lays a feed-major (B, feeds · layers, k) record out as
    (layers, B · feeds, k) row-major over rows × feeds (``route_flips``);
    ``_by_feed`` as (layers, feeds · B, k), each feed's rows in order."""
    import torch

    b, feeds, layers = 2, 3, 2
    # entry (row, feed, layer) holds 100 row + 10 feed + layer
    x = torch.tensor([[[100 * r + 10 * f + l] for f in range(feeds) for l in range(layers)]
                      for r in range(b)])
    by_layer, by_feed = cs._by_layer(x, layers), cs._by_feed(x, layers)
    assert by_layer[1, :, 0].tolist() == [1, 11, 21, 101, 111, 121]
    assert by_feed[1, :, 0].tolist() == [1, 101, 11, 111, 21, 121]


def test_valid_mismatches_count_only_before_a_feeds_first_flip():
    import torch

    # one layer, two feeds of 3 rows: in feed 0 row 1 flips its experts
    ref = torch.tensor([[[0, 1], [1, 2], [2, 3], [0, 1], [1, 2], [2, 3]]])
    routes = ref.clone()
    routes[0, 1] = torch.tensor([0, 3])
    ref_valid = torch.ones(1, 6, 2)
    valid = ref_valid.clone()
    valid[0, 2, 0] = 0  # after feed 0's flip: a consequence, not counted
    assert cs.valid_mismatches(ref, routes, ref_valid, valid, 3) == 0
    valid[0, 0, 1] = 0  # before it
    valid[0, 4, 0] = 0  # feed 1 has no flip
    assert cs.valid_mismatches(ref, routes, ref_valid, valid, 3) == 2


def test_the_moe_ep_logits_gate_on_a_tiny_mixtral(monkeypatch, tiny_moe_feeds):
    """The one card's feeds pass; each rank's rows routed alone is caught
    (by the valid flags, by one card under its routing, or both), and so
    are logits off by twice the limit; a token whose routing parts passes
    far from one card's own logits while it is close to them under its
    routing; a valid flag moved before any flip, logits off under the
    ranks' routing, a fault that equals one card and unlike ranks fail."""
    import torch

    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    cfg, whole, alone, replayed = tiny_moe_feeds
    layers = cfg.n_layers
    limit = cs.TP_LOGIT_LIMITS["mixtral"]

    def moved(part, **kw):
        return dict(whole, **{part: dict(whole[part], **kw)})

    off = moved("prefill", logits=whole["prefill"]["logits"] * (1 + 2 * limit))

    def check(clean, rows_alone=alone, tensor_only=off, checksum=1.0, same=None):
        same = dict({"clean": whole, "rows_alone": replayed["alone"],
                     "moe_tensor_only": whole}, **(same or {}))
        ranks = [{"feeds": {"clean": clean, "rows_alone": rows_alone,
                            "moe_tensor_only": tensor_only}, "checksum": 1.0, "rows": [0, 4]},
                 {"checksum": checksum, "rows": [4, 8]}]
        return cs.check_moe_ep_logits(whole, same, ranks, layers)

    out = check(whole)
    assert out["clean"]["prefill"]["error"] == out["clean"]["steps"]["same_routes_error"] == 0.0
    assert out["clean"]["steps"]["valid_mismatches"] == 0
    assert out["rows_alone"]["caught_by"] and out["moe_tensor_only"]["caught_by"] == ["logits"]
    valid = whole["steps"]["valid"].clone()
    valid[0, 0, 0] = 1 - valid[0, 0, 0]
    with pytest.raises(AssertionError, match="over the ranks"):
        check(moved("steps", valid=valid))
    with pytest.raises(AssertionError, match="over the ranks"):  # off under the same routing
        check(off)
    # a token whose routing parts may read far from one card's own run,
    # and within the limit of one card's under the ranks' routing
    experts = whole["steps"]["experts"].clone()
    experts[0, 0] = experts[0, 0].flip(0) + 1
    far = whole["steps"]["logits"].clone()
    far[0, 0] *= 1 + 2 * limit
    parted = moved("steps", experts=experts, logits=far)
    out = check(parted, same={"clean": parted})
    assert out["clean"]["steps"]["flipped_tokens"] == 1
    assert out["clean"]["steps"]["unflipped"] == 0.0
    assert out["clean"]["steps"]["error"] > limit
    with pytest.raises(AssertionError, match="moe_tensor_only passes every gate"):
        check(whole, tensor_only=whole)
    with pytest.raises(AssertionError, match="differ"):
        check(whole, checksum=2.0)
    assert torch.equal(whole["steps"]["logits"], tiny_moe_feeds[1]["steps"]["logits"])


def test_replayed_routes_take_every_call_and_put_the_routing_back():
    import torch

    from nexus_tpu_torch.models import mixtral as Mx

    route = Mx.top_k_routing
    logits = torch.randn(6, 4, generator=torch.Generator().manual_seed(1))
    chosen = torch.tensor([[0, 1], [0, 1], [0, 1], [2, 3], [3, 2], [0, 1]])
    with cs.replayed_routes([chosen]):
        r = Mx.top_k_routing(logits, 2, 2, dense=False)
    assert Mx.top_k_routing is route
    assert r.expert_index.tolist() == chosen.tolist()
    assert r.valid.tolist() == [[1, 1], [1, 1], [0, 0], [1, 1], [1, 1], [0, 0]]
    probs = torch.softmax(logits, -1)
    picked = torch.gather(probs, 1, chosen)
    assert torch.allclose(r.weights, picked / picked.sum(-1, keepdim=True))
    with pytest.raises(AssertionError, match="1 replayed routes were never taken"):
        with cs.replayed_routes([chosen]):
            pass
    with cs.replayed_routes([]):
        assert Mx.top_k_routing is route


def test_the_planted_moe_route_faults_patch_and_restore(monkeypatch):
    from nexus_tpu_torch.models import mixtral as Mx
    from nexus_tpu_torch.parallel import mesh as M

    class FakeMesh:
        def group(self, *axes):
            return "group of " + "/".join(axes)

    rows, split = Mx.split_rows, Mx.moe_split
    monkeypatch.setattr(M, "_active", FakeMesh())
    monkeypatch.setattr(Mx, "split_rows", lambda: "rows")
    with cs.planted_moe_route("rows_alone"):
        assert Mx.split_rows() is None
    assert Mx.split_rows() == "rows"
    monkeypatch.setattr(Mx, "moe_split", lambda layers, cfg: (2, "expert and tensor"))
    with cs.planted_moe_route("moe_tensor_only"):
        assert Mx.moe_split({}, None) == (2, "group of tensor")
    assert Mx.moe_split({}, None) == (2, "expert and tensor")
    with pytest.raises(ValueError, match="unknown planted fault"):
        with cs.planted_moe_route("nope"):
            pass
    monkeypatch.undo()
    assert (Mx.split_rows, Mx.moe_split) == (rows, split)


def test_own_capacities_are_each_ranks_largest_kept_count():
    """moe-dispatch's C_local report: the rank of row block r and expert
    block e holds, for each of its experts, the valid selections of its
    rows; its C_local is the most of them (at least 1), under C_global."""
    import torch

    from nexus_tpu_torch.ops.moe import top_k_routing

    name, blocks, expert_blocks = cs.MOE_OWN_SHAPE
    t, local, cap = 64, 8 // expert_blocks, 24
    assert name == "train-moe-ep" and cs.MOE_DISPATCH_SHAPES[name][1] == local
    routing = top_k_routing(torch.randn(blocks * t, 8, generator=torch.Generator().manual_seed(4)),
                            2, cap, dense=False)
    got = cs.own_capacities(routing, t, local, cap)
    for r in range(blocks):
        idx = routing.expert_index[r * t:(r + 1) * t]
        valid = routing.valid[r * t:(r + 1) * t] > 0
        for e in range(expert_blocks):
            kept = [int(((idx == x) & valid).sum()) for x in range(e * local, (e + 1) * local)]
            assert got[f"rows {r}, experts {e}"] == max(max(kept), 1) <= cap
    assert min(got.values()) < cap  # the later row block keeps less than C_global


def test_the_batch_infer_gate_takes_the_expert_phases_spec(monkeypatch):
    monkeypatch.setattr(cs, "card_label", lambda: "cpu")
    spec = cs.infer_moe_ep_spec()
    run = {"completion_ids_by_row": [[1, 2]] * 8, "last_logits_finite": True,
           "output_shape": [8, 128 + 64], "peak_mem_gb": 1.0, "decode_tokens_per_sec": 1.0,
           "decode_tokens_per_sec_per_chip": 0.25, "iteration_seconds": [1.0]}
    assert cs.check_batch_infer("x", [run] * 4, run, spec) == {"token_share_vs_one_card": 1.0}
    with pytest.raises(AssertionError, match="rank output"):
        cs.check_batch_infer("x", [dict(run, output_shape=[8, 512 + 64])], run, spec)


# ------------- heads that do not tile the tensor axis (item 4b, part four)


def test_the_untiled_specs_are_pythia_160m_over_tensor_8():
    """The spawn of 8 runs Pythia-160M at its published widths over {tensor:
    8}, the plan 8 ranks keep (plan_for_devices gives it too), cut in depth,
    rows and requests only; every rank's span holds 2 of the 12 heads."""
    from nexus_tpu_torch.models import gptneox
    from nexus_tpu_torch.parallel.mesh import MeshPlan, plan_for_devices
    from nexus_tpu_torch.parallel.tensor import rank_heads

    assert plan_for_devices(cs.UNTILED_RANKS) == MeshPlan(**cs.UNTILED_PLAN)
    specs = {"train": cs.untiled_train_spec(), "infer": cs.UNTILED_INFER,
             "serve": cs.untiled_serve_spec()}
    for name, spec in specs.items():
        assert spec["model"]["family"] == "gptneox" and spec["model"]["preset"] == "160m"
        assert spec["model"]["overrides"] == {"n_layers": cs.UNTILED_LAYERS}
        assert cs.rank_plan(spec, cs.UNTILED_RANKS) == MeshPlan(tensor=8), name
        cfg = cs._model_config(spec)
        assert (cfg.d_model, cfg.n_heads, cfg.head_dim, cfg.d_ff, cfg.vocab_size) == (
            768, 12, 64, 3072, 50304)
        assert {k: getattr(cfg, k) for k in gptneox.PRESETS["160m"] if k != "n_layers"} == {
            k: v for k, v in gptneox.PRESETS["160m"].items() if k != "n_layers"}
        assert cfg.n_heads % 8 and (cfg.n_heads * cfg.head_dim) % 8 == 0
        assert cs.span_heads(spec, cs.UNTILED_RANKS) == (2, 2, 64)
        spans = [rank_heads(12, 12, 64, r, 8).q[:2] for r in range(8)]
        assert spans == [(0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (9, 10), (10, 11)]
    train = specs["train"]["train"]
    assert train["seqLen"] % 64 == 0 and train["seqLen"] >= 128  # K1-K3 run
    assert (train["batchSize"], train["steps"]) == (1, 3)
    assert (cs.UNTILED_INFER["infer"]["promptLength"],
            cs.UNTILED_INFER["infer"]["maxNewTokens"]) == (128, 32)
    assert specs["serve"]["serve"]["numRequests"] == 4
    assert specs["serve"]["serve"]["attentionPath"] == "fused"  # D1 at the span
    # untiled-gqa: the tiny Llama's q and kv columns both under a head
    gqa = cs._model_config(cs.GQA_SERVE)
    assert (gqa.n_heads, gqa.n_kv_heads) == (4, 2) and gqa.n_kv_heads * gqa.head_dim // 8 < 16
    assert cs.span_heads(cs.GQA_SERVE, cs.UNTILED_RANKS) == (1, 1, 16)


def test_the_untiled_kernel_shapes_are_the_spans():
    """K1-K3 and D1 run at the span shapes: Pythia-160M over 8 (2 / 2 heads
    of 64, untiled-train's row) and Llama-3-8B over 16 (2 q heads and the
    kv head they read, of 128, at train-tp's tp 4 row shape)."""
    from nexus_tpu_torch.parallel.tensor import rank_heads

    pythia, llama = (cs.UNTILED_TRAIN_SHAPES[k] for k in ("pythia160m_tp8", "llama8b_tp16"))
    h = rank_heads(12, 12, 64, 3, 8)
    assert (pythia["Hq"], pythia["Hkv"], pythia["D"]) == (h.q_heads, h.kv_heads, 64)
    assert (pythia["B"], pythia["Sq"]) == (1, cs.UNTILED_TRAIN["train"]["seqLen"])
    for r in range(16):
        h = rank_heads(32, 8, 128, r, 16)
        assert (llama["Hq"], llama["Hkv"], llama["D"]) == (h.q_heads, h.kv_heads, 128)
        assert h.kv_index is None  # the kernels' group rule holds
    tp4 = cs.TP_TRAIN_SHAPES["llama8b_tp4"]
    assert (llama["B"], llama["Sq"], llama["Sk"]) == (tp4["B"], tp4["Sq"], tp4["Sk"])
    for label, shape in cs.UNTILED_DECODE_SHAPES.items():
        train = cs.UNTILED_TRAIN_SHAPES[label]
        assert (shape["Hq"], shape["Hkv"], shape["D"]) == (train["Hq"], train["Hkv"], train["D"])
        assert shape["depths"] == cs.DECODE_SERVE_QUEUE_SHAPE["depths"]


def test_the_span_faults_patch_and_restore():
    import torch

    from nexus_tpu_torch.parallel import tensor as T

    own, backward = T.RankHeads.own, T._SpanGather.backward
    heads = T.rank_heads(12, 12, 4, 1, 8)  # columns 6..11: heads 1..2, offset 2
    out = torch.arange(2 * 4, dtype=torch.float32).view(1, 1, 2, 4)
    assert heads.own(out).flatten().tolist() == [2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    with cs.planted_span("span_offset"):
        assert heads.own(out).flatten().tolist() == [0.0, 1.0, 2.0, 3.0, 4.0, 5.0]
    with cs.planted_span("gather_grad_block"):
        assert T._SpanGather.backward is not backward
    assert T.RankHeads.own is own and T._SpanGather.backward is backward
    with pytest.raises(ValueError, match="unknown planted fault"):
        with cs.planted_span("nope"):
            pass


def test_the_span_norm_gate_passes_clean_runs_and_catches_faults(monkeypatch):
    monkeypatch.setattr(cs, "card_label", lambda: "no card")
    one = {"span_norms": [1.0, 2.0]}
    clean = {"span_norms": [1.0 * (1 + cs.TP_TRAIN_NORM_RTOL / 2), 2.0]}
    fault = {"span_norms": [1.0 * (1 + 4 * cs.TP_TRAIN_NORM_RTOL)]}
    out = cs.check_span_norms("x", clean, one, {"f": fault})
    assert out["f"] == pytest.approx(4.0)
    with pytest.raises(AssertionError, match="span gradient norms"):
        cs.check_span_norms("x", {"span_norms": [1.01, 2.0]}, one, {})
    with pytest.raises(AssertionError, match="pass the limit"):
        cs.check_span_norms("x", clean, one, {"f": clean})


def test_span_grad_norms_record_the_qkv_leaves_on_one_card():
    import torch

    from nexus_tpu_torch.train import trainer as Tr

    opt = Tr.build_optimizer(1e-3, warmup_steps=1, total_steps=2)
    leaves = [torch.zeros(3, requires_grad=True) for _ in range(4)]
    state = opt.init(leaves)
    grads = [torch.full((3,), float(i)) for i in range(4)]
    update = Tr.AdamW.update
    with cs.span_grad_norms() as seen:
        opt.update(leaves, grads, state)
    assert seen == [pytest.approx((3 * 1.0 + 3 * 4.0) ** 0.5)]  # leaves 1 and 2
    assert Tr.AdamW.update is update
