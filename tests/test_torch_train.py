"""The port's training path (nexus_tpu_torch.train, .runtime) against the
JAX package's on the CPU, in float32.

Tolerances: optimizer steps atol 1e-6; full train steps of the tiny Llama
rtol 1e-4 (atol 1e-6 for entries near 0).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from nexus_tpu.api.runtime_spec import JaxXlaRuntime as JaxRuntime
from nexus_tpu.models import llama as jllama
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime as PortRuntime
from nexus_tpu_torch.interop import llama_params_from_jax
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import data as tdata
from nexus_tpu_torch.train import trainer as ttrainer


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_matches_optax_clip_then_adamw(warmup):
    """5 steps on the same gradients; step 3's gradients are scaled up so
    clip_by_global_norm fires (asserted)."""
    rng = np.random.default_rng(0)
    shapes = [(8, 16), (16,), (4, 4, 4)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    kw = dict(learning_rate=1e-2, warmup_steps=warmup, total_steps=5, weight_decay=0.1)
    jopt = jtrainer.build_optimizer(**kw)
    topt = ttrainer.build_optimizer(**kw)
    jp = [jnp.asarray(p) for p in params]
    jstate = jopt.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = topt.init(tp)
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) * (0.05 if step != 3 else 10.0)
                 for s in shapes]
        norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads))
        assert (norm > 1.0) == (step == 3)
        upd, jstate = jopt.update([jnp.asarray(g) for g in grads], jstate, jp)
        jp = optax.apply_updates(jp, upd)
        got_norm = topt.update(tp, [torch.from_numpy(g) for g in grads], tstate)
        np.testing.assert_allclose(got_norm.item(), norm, rtol=1e-6)
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f"step {step}")


def test_warmup_cosine_schedule_matches_optax():
    ref = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    got = ttrainer.warmup_cosine_schedule(3e-4, 10, 50)
    for count in (0, 1, 5, 10, 11, 30, 50, 70):
        np.testing.assert_allclose(got(count), float(ref(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_three_train_steps_match_jax(grad_accum):
    """Tiny Llama, the same params and batches through the JAX package's
    jitted make_train_step and the port's; params compared after each step."""
    jcfg = jllama.config("tiny", dtype=jnp.float32, attn_impl="xla")
    jparams = jllama.init(jax.random.PRNGKey(1), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    tcfg = tllama.config("tiny", dtype="float32", attn_impl="xla")
    tparams = llama_params_from_jax(np_params, tcfg, "cpu")

    kw = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
    jopt = jtrainer.build_optimizer(**kw)
    jstep = jtrainer.make_train_step(
        lambda p, b: jllama.loss_fn(p, jcfg, b), jopt, grad_accum=grad_accum, donate=False)
    jstate = jtrainer.init_train_state(lambda: jparams, jopt)
    topt = ttrainer.build_optimizer(**kw)
    tstep = ttrainer.make_train_step(
        lambda p, b: tllama.loss_fn(p, tcfg, b), topt, grad_accum=grad_accum)
    tstate = ttrainer.init_train_state(tparams, tllama.leaves(tparams), topt)

    batches = jdata.synthetic_lm_batches(4, 64, jcfg.vocab_size, seed=3)
    for step in range(3):
        batch = next(batches)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(batch["tokens"])})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(batch["tokens"]).long()})
        np.testing.assert_allclose(tm["loss"].item(), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]), rtol=1e-4)
        ref = jax.tree.map(np.asarray, jstate.params)
        for name in ("embed", "final_norm", "lm_head"):
            np.testing.assert_allclose(tstate.params[name].detach().numpy(), ref[name],
                                       rtol=1e-4, atol=1e-6, err_msg=f"{name} step {step}")
        for name in tllama.LAYER_KEYS:
            np.testing.assert_allclose(tstate.params["layers"][name].detach().numpy(),
                                       ref["layers"][name], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{name} step {step}")
    assert tstate.step == 3


@pytest.mark.parametrize("seed", [0, 7])
def test_synthetic_batches_identical_to_jax(seed):
    a = jdata.synthetic_lm_batches(3, 50, 256, seed=seed)
    b = tdata.synthetic_lm_batches(3, 50, 256, seed=seed)
    for _ in range(4):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_token_file_batches_identical_to_jax(tmp_path):
    path = str(tmp_path / "corpus.int32")
    jdata.write_token_file(path, np.arange(5000) % 300)
    a = jdata.token_file_batches(path, 4, 32, seed=2, vocab_size=300)
    b = tdata.corpus_batches(path, 4, 32, seed=2, vocab_size=300)
    for _ in range(3):
        assert np.array_equal(next(a)["tokens"], next(b)["tokens"])


def test_prefetcher_yields_the_stream_and_reraises_its_error():
    def source():
        for i in range(3):
            yield {"tokens": np.full((2, 17), i, np.int32)}
        raise OSError("corpus went away")

    pf = tdata.Prefetcher(source(), "cpu", depth=2)
    got = [next(pf)["tokens"] for _ in range(3)]
    for i, t in enumerate(got):
        assert t.dtype == torch.int64 and torch.equal(t, torch.full((2, 17), i))
    with pytest.raises(OSError, match="corpus went away"):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_close_stops_an_endless_stream():
    pf = tdata.Prefetcher(tdata.synthetic_lm_batches(2, 16, 64), "cpu", depth=1)
    next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def _example_runtimes():
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")
    for path in sorted(glob.glob(os.path.join(root, "*.yaml"))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                rt = (doc or {}).get("spec", {}).get("runtime")
                if rt:
                    yield os.path.basename(path), rt


@pytest.mark.parametrize("name,rt", list(_example_runtimes()), ids=lambda x: x if isinstance(x, str) else "")
def test_spec_copy_reads_what_the_jax_spec_reads(name, rt):
    """Every example template's runtime block: the port's copy of the spec
    gives the same values as the JAX package's for each field it keeps."""
    ref, got = JaxRuntime.from_dict(rt), PortRuntime.from_dict(rt)
    assert got.mode == ref.mode
    for block in ("model", "parallelism", "train", "data", "checkpoint", "profile"):
        g, r = getattr(got, block), getattr(ref, block)
        for f in g.__dataclass_fields__:
            assert getattr(g, f) == getattr(r, f), f"{name}: {block}.{f}"
    assert got.parallelism.total() == ref.parallelism.total()


def _tiny_spec(**over):
    spec = {
        "kind": "jax_xla", "mode": "train",
        "model": {"family": "llama", "preset": "tiny"},
        "train": {"batchSize": 2, "seqLen": 64, "steps": 4, "learningRate": 3e-3},
    }
    for key, val in over.items():
        spec[key] = {**spec.get(key, {}), **val} if isinstance(val, dict) else val
    return spec


_JAX_TRAIN_METRIC_KEYS = {
    "mode", "family", "preset", "steps", "final_loss", "loss_history",
    "steps_per_sec", "tokens_per_sec", "n_devices", "resumed_from_step",
    "interrupted", "checkpoint_saved", "param_count", "tokens_per_sec_per_chip",
    "model_flops_per_token", "mfu",
}


def test_run_template_runtime_returns_the_train_metrics():
    m = run_template_runtime(_tiny_spec(parallelism={"fsdp": 4}), device="cpu")
    assert _JAX_TRAIN_METRIC_KEYS <= m.keys()
    assert m["steps"] == 4 and m["n_devices"] == 1
    assert len(m["loss_history"]) == 2  # 2 untimed warmup steps
    assert np.isfinite(m["final_loss"]) and m["tokens_per_sec"] > 0
    assert m["mfu"] is None  # no device peak for a CPU
    assert m["param_count"] == jllama.config("tiny").param_count()


def test_run_template_runtime_cancel_and_heartbeat():
    seen = []

    class Cancel:
        def cancelled(self):
            return len(seen) >= 3

    m = run_template_runtime(_tiny_spec(train={"steps": 8}), device="cpu",
                             cancel=Cancel(), heartbeat=seen.append)
    # as in the JAX trainer, the hook runs at the timed steps' boundaries
    # (after the 2 warmup steps) and cancel is checked before each one
    assert m["interrupted"] and m["steps"] == 5 and seen == [3, 4, 5]


@pytest.mark.parametrize("device", [None, "cuda"])
def test_entry_point_raises_without_cuda_unless_cpu_is_asked(monkeypatch, device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_template_runtime(_tiny_spec(), device=device)


@pytest.mark.parametrize("over,exc,match", [
    (dict(checkpoint={"enabled": True, "directory": "/x"}), NotImplementedError, "checkpoint"),
    (dict(mode="serve"), NotImplementedError, "serving slice"),
    (dict(mode="infer"), NotImplementedError, "serving slice"),
    (dict(model={"overrides": {"remat": True, "remat_policy": "dots"}}), ValueError, "dots"),
    (dict(model={"family": "mixtral"}), NotImplementedError, "not ported"),
])
def test_unported_paths_raise(over, exc, match):
    with pytest.raises(exc, match=match):
        run_template_runtime(_tiny_spec(**over), device="cpu")
