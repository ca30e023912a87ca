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
    assert 45 < weights_gb < cs.PEAK_GB - 5


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


# ------------------------------------------------------ GPT-NeoX and the MLP


@pytest.mark.parametrize("make,preset", [
    (cs.neox_train_spec, "1b"), (cs.neox_infer_spec, "20b"), (cs.neox_serve_spec, "20b"),
], ids=["train", "infer", "serve"])
def test_the_gptneox_phases_are_valid_specs_at_published_widths_and_depths(make, preset):
    """Every GPT-NeoX phase passes the port's validate() and runs its
    preset whole: Pythia-1.4B trains, GPT-NeoX-20B infers and serves, no
    override of width or depth."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    rt = JaxXlaRuntime.from_dict(make())
    assert rt.validate() == []
    assert (rt.model.family, rt.model.preset, dict(rt.model.overrides)) == ("gptneox", preset, {})
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
        assert (rt.model.family, rt.model.preset, dict(rt.model.overrides)) == ("llama", "8b", {})
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
    """The Orbax phases' specs: Llama-3-8B widths at 2 layers, a checkpoint
    block that names no format (Orbax, the default), keep 1."""
    from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime

    for spec in (cs.orbax_train_spec("/ck", 4), cs.orbax_infer_spec("/ck")):
        rt = JaxXlaRuntime.from_dict(spec)
        assert not rt.validate()
        assert rt.model.preset == "8b" and rt.model.overrides == {"n_layers": 2}
        assert rt.checkpoint.enabled and rt.checkpoint.format == "orbax"
        assert "format" not in spec["checkpoint"]
    train = JaxXlaRuntime.from_dict(cs.orbax_train_spec("/ck", 4))
    assert (train.checkpoint.keep, train.checkpoint.interval_steps) == (1, 2)
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
            "optimizer_state_bytes": 8, "launches": dict.fromkeys(names, launches)}


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
    """chip_smoke's block slicing equals train/trainer.py::FsdpShards' (a
    mesh of fsdp 2 built without a group: local() needs none), and a
    fingerprint changes with one flipped bit or two swapped elements."""
    import torch

    from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
    from nexus_tpu_torch.train.trainer import FsdpShards

    ts = [torch.randn(5, 3).to(torch.bfloat16), torch.randn(7), torch.randn(2, 2, 2)]
    for index in range(2):
        shards = FsdpShards.__new__(FsdpShards)
        shards.n, shards.index = 2, index
        for a, b in zip(cs.fsdp_blocks(ts, 2, index), shards.local(ts)):
            assert torch.equal(a, b)
    assert Mesh(MeshPlan(fsdp=2, sequence=2), 3).index("fsdp") == 3 // 2
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
