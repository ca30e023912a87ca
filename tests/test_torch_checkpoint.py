"""The port's npz checkpointer (nexus_tpu_torch.train.checkpoint), its train
loop's checkpoint and profiler windows, and the entry points' resume and
restore paths, against the JAX package's NpzCheckpointer and entry point on
the CPU.

Either package reads the other's files: the leaf order is JAX's flatten
order of TrainState(params, opt_state, step), derived here from files JAX
saved (their meta.json counts and every member's shape and values), not
assumed. Tolerances: a state restored from a file equals the file exactly
(f32 and bf16 bit patterns); one train step after a resume f32 rtol 1e-5,
atol 1e-7 (loss rtol 1e-5), as the train tests hold one step; a port-saved
file's members byte for byte JAX's.
"""

import json
import logging
import os
import shutil
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.interop import llama_params_from_jax, mixtral_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models.params import tree_items
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import checkpoint as tck
from nexus_tpu_torch.train import trainer as ttrainer

FAMILIES = {"llama": (jllama, tllama, llama_params_from_jax),
            "mixtral": (jmix, tmix, mixtral_params_from_jax)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(family, dtype="float32", warmup=0):
    """The same state in both packages: JAX's init and optimizer state,
    and the port's from the same params (fresh moments, step 0)."""
    jfam, tfam, conv = FAMILIES[family]
    jcfg = jfam.config("tiny", dtype=getattr(jnp, dtype))
    jopt = jtrainer.build_optimizer(3e-3, warmup_steps=warmup, total_steps=8)
    jstate = jtrainer.init_train_state(lambda: jfam.init(jax.random.PRNGKey(0), jcfg), jopt)
    tcfg = tfam.config("tiny", dtype=dtype)
    params = conv(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    topt = ttrainer.build_optimizer(3e-3, warmup_steps=warmup, total_steps=8)
    tstate = ttrainer.init_train_state(params, tfam.leaves(params), topt)
    return jstate, tstate, (jcfg, tcfg, topt)


def _members(path):
    with zipfile.ZipFile(path) as z:
        return {name: z.read(name) for name in z.namelist()}


def _as_f32(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("family,warmup", [("llama", 0), ("mixtral", 0), ("mixtral", 2)])
def test_the_leaf_order_is_the_one_of_a_file_jax_saved(tmp_path, family, warmup):
    """JAX saves its state; meta.json's counts are the port's, and the port
    restores every member into the leaf at its position: params by sorted
    keys, Adam's count, mu, nu, the schedule's count (with warmup), step."""
    jstate, tstate, _ = _states(family, warmup=warmup)
    # give every moment its own values, so a swapped mu/nu or param order shows
    jstate = jtrainer.TrainState(
        jstate.params,
        jax.tree.map(lambda x: x + np.float32(0.25) if x.dtype == jnp.float32 else x + 3,
                     jstate.opt_state),
        jnp.asarray(5, jnp.int32))
    jck.NpzCheckpointer(str(tmp_path)).save(jstate, step=5)
    with open(tmp_path / "5" / "meta.json") as f:
        meta = json.load(f)
    assert meta["leaves"] == len(tck.state_leaves(tstate))
    assert meta["param_leaves"] == len(FAMILIES[family][1].leaves(tstate.params))
    tck.NpzCheckpointer(str(tmp_path)).restore(tstate)
    ref = jax.tree_util.tree_leaves(jstate)
    got = tck.state_leaves(tstate)
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(_as_f32(g), np.asarray(r, np.float32), err_msg=f"leaf {i}")
    assert tstate.step == 5 and tstate.opt_state.count == 3
    assert tstate.opt_state.schedule_count == (3 if warmup else None)


def _train_batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (2, 33)).astype(np.int32)


@pytest.mark.parametrize("family", ["llama", "mixtral"])
def test_jax_restores_what_the_port_saved(tmp_path, family):
    jstate, tstate, (jcfg, tcfg, topt) = _states(family, warmup=2)
    tfam = FAMILIES[family][1]
    step = ttrainer.make_train_step(lambda p, b: tfam.loss_fn(p, tcfg, b), topt)
    for seed in (0, 1):
        tstate, _ = step(tstate, {"tokens": torch.from_numpy(_train_batch(tcfg, seed))})
    tck.NpzCheckpointer(str(tmp_path)).save(tstate)
    assert tck.latest_step(str(tmp_path)) == 2
    restored = jck.NpzCheckpointer(str(tmp_path)).restore(jstate)
    ref = jax.tree_util.tree_leaves(restored)
    got = tck.state_leaves(tstate)
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(np.asarray(r, np.float32), _as_f32(g), err_msg=f"leaf {i}")
    params = jck.NpzCheckpointer(str(tmp_path)).restore_params(jstate.params)
    for r, g in zip(jax.tree_util.tree_leaves(params), got):
        np.testing.assert_array_equal(np.asarray(r), _as_f32(g))


def test_a_jax_saved_bf16_state_loads_bit_exactly_and_saves_byte_for_byte(tmp_path):
    """JAX writes bf16 leaves as '<V2' (raw bits); the port reads them bit
    for bit, and writes its own bf16 leaves the same way: the members of a
    port-saved copy are JAX's bytes."""
    jstate, tstate, _ = _states("mixtral", dtype="bfloat16")
    jstate = jtrainer.TrainState(jstate.params, jstate.opt_state, jnp.asarray(1, jnp.int32))
    jck.NpzCheckpointer(str(tmp_path / "jax")).save(jstate)
    params = tmix.empty_params(tmix.config("tiny", dtype="bfloat16"), "cpu")
    tck.NpzCheckpointer(str(tmp_path / "jax")).restore_params(params)
    for (path, got), ref in zip(tree_items(params), jax.tree_util.tree_leaves(jstate.params)):
        ref = np.asarray(ref)
        if got.dtype == torch.bfloat16:
            assert ref.dtype.itemsize == 2
            np.testing.assert_array_equal(got.view(torch.int16).numpy(), ref.view(np.int16),
                                          err_msg=path)
        else:  # the router, f32
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=path)
    tck.NpzCheckpointer(str(tmp_path / "jax")).restore(tstate)
    tck.NpzCheckpointer(str(tmp_path / "port")).save(tstate)
    for archive in ("state.npz", "params.npz"):
        ref = _members(tmp_path / "jax" / "1" / archive)
        got = _members(tmp_path / "port" / "1" / archive)
        assert got.keys() == ref.keys()
        for name in ref:
            assert got[name] == ref[name], f"{archive}/{name}"


def test_keep_prunes_the_oldest_steps_and_staging_is_never_a_step(tmp_path, monkeypatch):
    _, tstate, _ = _states("llama")
    ck = tck.NpzCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        tstate.step = s
        ck.save(tstate)
    assert ck.all_steps() == [3, 4] == jck.all_steps(str(tmp_path))
    assert ck.save(tstate) == 4  # already durable: left as it is
    os.makedirs(tmp_path / ".tmp-9-123")  # a save interrupted mid-write
    os.makedirs(tmp_path / "7.orbax-checkpoint-tmp-1")
    assert tck.latest_step(str(tmp_path)) == 4 == jck.latest_step(str(tmp_path))

    def broken(path, leaves):
        with open(path, "w") as f:
            f.write("partial")
        raise OSError("disk full")

    monkeypatch.setattr(tck, "_write_npz", broken)
    tstate.step = 5
    with pytest.raises(OSError, match="disk full"):
        ck.save(tstate)
    assert ck.all_steps() == [3, 4]
    assert not [e for e in os.listdir(tmp_path) if e.startswith(".tmp-5-")]


def test_restore_refuses_another_structure(tmp_path):
    _, tstate, _ = _states("llama")
    tck.NpzCheckpointer(str(tmp_path)).save(tstate)
    _, other, _ = _states("mixtral")
    with pytest.raises(ValueError, match="structure drift"):
        tck.NpzCheckpointer(str(tmp_path)).restore(other)
    with pytest.raises(FileNotFoundError):
        tck.NpzCheckpointer(str(tmp_path / "empty")).restore(tstate)


@pytest.mark.parametrize("what", ["state", "params"])
def test_a_restore_holds_one_leaf_on_the_host_at_a_time(tmp_path, monkeypatch, what):
    """Each leaf read from the archive is copied into its target and let go
    before the next is read, as the JAX package converts leaf by leaf
    inside its np.load: the host's peak is one leaf, not the file."""
    import weakref

    _, tstate, _ = _states("mixtral")
    tck.NpzCheckpointer(str(tmp_path)).save(tstate)
    _, fresh, _ = _states("mixtral")
    for t in fresh.opt_state.mu:
        t.zero_()
    held, live = [], []
    copy = tck._copy_into

    def watching(target, arr, name):
        live.append(sum(r() is not None for r in held))
        held.append(weakref.ref(arr))
        copy(target, arr, name)

    monkeypatch.setattr(tck, "_copy_into", watching)
    ck = tck.NpzCheckpointer(str(tmp_path))
    if what == "state":
        ck.restore(fresh)
        assert len(live) == sum(torch.is_tensor(x) for x in tck.state_leaves(fresh))
    else:
        ck.restore_params(fresh.params)
        assert len(live) == len(tmix.leaves(fresh.params))
    assert max(live) == 0  # no earlier leaf alive when the next is read
    for got, ref in zip(tck.state_leaves(fresh), tck.state_leaves(tstate)):
        if torch.is_tensor(ref):
            assert torch.equal(got, ref)


def test_formats_orbax_raises_naming_its_item_and_auto_sniffs(tmp_path):
    """The format dispatch (the name predates the Orbax port, when orbax
    raised): the default and ``orbax`` give an OrbaxCheckpointer, ``auto``
    sniffs each format as JAX's does, an unknown format raises."""
    assert isinstance(tck.make_checkpointer(str(tmp_path / "a")), tck.OrbaxCheckpointer)
    assert isinstance(tck.make_checkpointer(str(tmp_path / "a"), fmt="orbax"),
                      tck.OrbaxCheckpointer)
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        tck.make_checkpointer(str(tmp_path / "a"), fmt="zarr")
    (tmp_path / "orbax" / "3").mkdir(parents=True)
    assert tck.detect_format(str(tmp_path / "orbax")) == "orbax" == jck.detect_format(
        str(tmp_path / "orbax"))
    assert isinstance(tck.make_checkpointer(str(tmp_path / "orbax"), fmt="auto"),
                      tck.OrbaxCheckpointer)
    _, tstate, _ = _states("llama")
    tck.NpzCheckpointer(str(tmp_path / "npz")).save(tstate)
    assert tck.detect_format(str(tmp_path / "npz")) == "npz" == jck.detect_format(
        str(tmp_path / "npz"))
    assert isinstance(tck.make_checkpointer(str(tmp_path / "npz"), fmt="auto"),
                      tck.NpzCheckpointer)


# ------------------------------------------------------------- entry points


def _spec(family, ck_dir, steps, warmup=0, **extra):
    spec = {"kind": "jax_xla", "mode": "train",
            "model": {"family": family, "preset": "tiny", "overrides": {"dtype": "float32"}},
            "train": {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                      "warmupSteps": warmup, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(ck_dir), "format": "npz",
                           "intervalSteps": 100, "keep": 3}}
    spec.update(extra)
    return spec


def _jax_run(spec, **kw):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1], **kw)


@pytest.mark.parametrize("family,warmup", [("llama", 0), ("mixtral", 2)])
def test_the_port_resumes_a_jax_checkpoint_and_its_next_step_equals_jax(tmp_path, family,
                                                                         warmup):
    """JAX trains 2 steps and saves; both packages resume that step and take
    step 3 on the same batch; the step-3 files agree leaf by leaf."""
    _jax_run(_spec(family, tmp_path / "jax", 2, warmup))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = _jax_run(_spec(family, tmp_path / "jax", 3, warmup))
    got = run_template_runtime(_spec(family, tmp_path / "port", 3, warmup), device="cpu")
    assert got["resumed_from_step"] == ref["resumed_from_step"] == 2
    assert got["checkpoint_saved"] and ref["checkpoint_saved"]
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
    with np.load(tmp_path / "jax" / "3" / "state.npz") as zr, \
            np.load(tmp_path / "port" / "3" / "state.npz") as zg:
        assert zr.files == zg.files
        for name in zr.files:
            np.testing.assert_allclose(zg[name], zr[name], rtol=1e-5, atol=1e-7, err_msg=name)


def test_interval_saves_heartbeats_and_restore_step(tmp_path):
    """Interval saves every 2 timed steps, keep 3; a resume pinned to an
    older step (restore_step) reports global heartbeat steps."""
    m = run_template_runtime(_spec("llama", tmp_path, 6, **{"checkpoint": {
        "enabled": True, "directory": str(tmp_path), "format": "npz", "intervalSteps": 2,
        "keep": 3}}), device="cpu")
    assert m["checkpoint_saved"] and tck.all_steps(str(tmp_path)) == [4, 6]
    seen = []
    m = run_template_runtime(_spec("llama", tmp_path, 8), device="cpu", heartbeat=seen.append,
                             restore_step=4)
    assert m["resumed_from_step"] == 4 and m["steps"] == 4
    assert seen == [7, 8]  # after 2 warmup steps: global steps 4 + 3, 4 + 4


def test_a_hard_cancel_skips_the_final_save(tmp_path):
    class Hard:
        hard = True

        def cancelled(self):
            return True

    m = run_template_runtime(_spec("llama", tmp_path, 4), device="cpu", cancel=Hard())
    assert m["interrupted"] and not m["checkpoint_saved"]
    assert tck.latest_step(str(tmp_path)) is None


def test_infer_serve_and_a_draft_restore_from_a_port_checkpoint(tmp_path, caplog):
    run_template_runtime(_spec("llama", tmp_path / "ck", 2), device="cpu")
    tiny = {"family": "llama", "preset": "tiny", "overrides": {"dtype": "float32"}}
    infer = _spec("llama", tmp_path / "ck", 2, mode="infer", infer={
        "promptLength": 8, "maxNewTokens": 6, "iterations": 1, "numSpeculative": 2,
        "draft": tiny, "draftCheckpointDirectory": str(tmp_path / "ck")})
    m = run_template_runtime(infer, device="cpu")
    assert m["weights_loaded"] and m["restored_step"] == 2 and m["draft_weights_loaded"]
    # a draft trained as the target itself accepts every proposal
    assert m["acceptance_rate"] == 1.0
    serve = _spec("llama", tmp_path / "ck", 2, mode="serve", serve={
        "numRequests": 3, "promptLengthMin": 4, "promptLengthMax": 16, "maxNewMin": 2,
        "maxNewMax": 5, "kvBlockSize": 8})
    m = run_template_runtime(serve, device="cpu")
    assert m["weights_loaded"] and m["restored_step"] == 2 and m["ok_requests"] == 3
    infer["infer"]["draftCheckpointDirectory"] = str(tmp_path / "nothing")
    with caplog.at_level(logging.WARNING, logger="nexus_tpu_torch.runtime"):
        m = run_template_runtime(infer, device="cpu")
    assert not m["draft_weights_loaded"] and "RANDOM weights" in caplog.text
    empty = _spec("llama", tmp_path / "empty", 2, mode="serve", serve=serve["serve"])
    m = run_template_runtime(empty, device="cpu")
    assert not m["weights_loaded"] and m["restored_step"] == -1


# --------------------------------------------------------------- profiler


def test_the_profiler_window_writes_a_trace(tmp_path):
    spec = _spec("llama", tmp_path / "ck", 5, profile={
        "enabled": True, "directory": str(tmp_path / "prof"), "startStep": 1, "numSteps": 1})
    spec["checkpoint"]["enabled"] = False
    m = run_template_runtime(spec, device="cpu")
    assert m["profile_dir"] == str(tmp_path / "prof")
    (trace,) = os.listdir(tmp_path / "prof")
    with open(tmp_path / "prof" / trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert trace == "train_steps_4-4.pt.trace.json"  # timed step 1 = global step 4


def test_the_profiler_warns_when_its_window_never_opens(tmp_path, caplog):
    spec = _spec("llama", tmp_path / "ck", 4, profile={
        "enabled": True, "directory": str(tmp_path / "prof"), "startStep": 5, "numSteps": 1})
    spec["checkpoint"]["enabled"] = False
    with caplog.at_level(logging.WARNING, logger="nexus_tpu_torch.runtime"):
        m = run_template_runtime(spec, device="cpu")
    assert "profile_dir" not in m and "capture window never opened" in caplog.text
    assert not os.path.exists(tmp_path / "prof")


def test_the_spec_blocks_validate_like_jax():
    from nexus_tpu_torch.api import runtime_spec as tspec

    for block in ({"profile": {"enabled": True}}, {"profile": {"enabled": True,
                                                               "directory": "/p",
                                                               "numSteps": 0}},
                  {"checkpoint": {"format": "zarr"}}):
        spec = dict(_spec("llama", "/ck", 2), **block)
        got = tspec.JaxXlaRuntime.from_dict(spec).validate()
        ref = jspec.JaxXlaRuntime.from_dict(spec).validate()
        assert got and set(got) <= set(ref)
