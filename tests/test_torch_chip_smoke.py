"""chip_smoke.py's parts that need no card: the paged-decode kernel's
bound, counted by hand on small shapes; the key-tail shapes, the decode
error gate, the serve phases' specs and their same-token count.

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
    assert 45 < weights_gb < cs.MIXTRAL_PEAK_GB - 5


def test_the_mixtral_train_gates():
    cs.check_mixtral_train("x", {"moe_dispatch": "scatter", "router_dropped_fraction": 0.08})
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
