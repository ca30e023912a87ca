"""The port's MLP family (nexus_tpu_torch.models.mlp), its synthetic data and
its list-valued parameter pytree, against the JAX package's on the CPU.

float32 throughout: forward, loss and gradients rtol 1e-5 (atol 1e-6, the
GPT-NeoX and Mixtral tests' limits: outputs near 0 carry f32 noise);
the synthetic batches byte for byte; the leaf order and checkpoint members
exactly; the train entry point's loss over its timed steps rtol 1e-5 from
the same JAX-saved weights.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import mlp as jmlp
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime
from nexus_tpu_torch.interop import mlp_params_from_jax
from nexus_tpu_torch.models import mlp as tmlp
from nexus_tpu_torch.models.params import tree_items
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import checkpoint as tck
from nexus_tpu_torch.train import data as tdata
from nexus_tpu_torch.train import trainer as ttrainer


def _models(preset):
    jcfg = jmlp.config(preset)
    jparams = jmlp.init(jax.random.PRNGKey(0), jcfg)
    tcfg = tmlp.config(preset)
    tparams = mlp_params_from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    return (jcfg, jparams), (tcfg, tparams)


def _batch(cfg, seed=0, b=32):
    return next(jdata.synthetic_mlp_batches(b, cfg.in_dim, cfg.out_dim, seed=seed))


@pytest.mark.parametrize("preset", ["tiny", "small"])
def test_forward_loss_and_gradients_match_jax(preset):
    (jcfg, jp), (tcfg, tp) = _models(preset)
    batch = _batch(jcfg)
    ref_out = np.asarray(jmlp.forward(jp, jcfg, jnp.asarray(batch["x"])))
    (ref_loss, ref_m), jgrads = jax.value_and_grad(
        lambda p: jmlp.loss_fn(p, jcfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jp)
    tb = tdata.to_device(batch, torch.device("cpu"))
    out = tmlp.forward(tp, tcfg, tb["x"])
    loss, m = tmlp.loss_fn(tp, tcfg, tb)
    grads = torch.autograd.grad(loss, tmlp.leaves(tp))
    assert out.dtype == torch.float32 and tcfg.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(m) == set(ref_m) == {"loss"}
    ref_leaves = jax.tree_util.tree_leaves(jgrads)
    assert len(grads) == len(ref_leaves)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-6,
                                   err_msg=f"leaf {i}")


def test_synthetic_batches_are_byte_identical_to_jax():
    ref = jdata.synthetic_mlp_batches(8, 16, 4, seed=3)
    got = tdata.synthetic_mlp_batches(8, 16, 4, seed=3)
    for _ in range(3):
        a, b = next(got), next(ref)
        assert a.keys() == b.keys() == {"x", "y"}
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == b[k].tobytes(), k
    # y comes out float64 in both (a float32 array over numpy's float64
    # sqrt); on the way to the device float batches become float32, as JAX
    # puts them without x64, and token batches int64
    dev = tdata.to_device({"y": a["y"], "tokens": np.zeros((2, 3), np.int32)},
                          torch.device("cpu"))
    assert a["y"].dtype == np.float64
    assert dev["y"].dtype == torch.float32 and dev["tokens"].dtype == torch.int64


def test_the_leaf_order_is_jax_flatten_order_of_the_list_pytree():
    (_, jp), (_, tp) = _models("small")
    paths, ref = zip(*jax.tree_util.tree_flatten_with_path(jp)[0])
    got = list(tree_items(tp))
    assert [p for p, _ in got] == ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                                            for k in path) for path in paths]
    assert [p for p, _ in got][:4] == ["layers/0/b", "layers/0/w", "layers/1/b", "layers/1/w"]
    for (_, t), r in zip(got, ref):
        np.testing.assert_array_equal(t.detach().numpy(), np.asarray(r))
    assert [id(t) for _, t in got] == [id(t) for t in tmlp.leaves(tp)]


def _states():
    jcfg = jmlp.config("small")
    jopt = jtrainer.build_optimizer(3e-3, warmup_steps=2, total_steps=8)
    jstate = jtrainer.init_train_state(lambda: jmlp.init(jax.random.PRNGKey(0), jcfg), jopt)
    tcfg = tmlp.config("small")
    params = mlp_params_from_jax(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    topt = ttrainer.build_optimizer(3e-3, warmup_steps=2, total_steps=8)
    return jstate, ttrainer.init_train_state(params, tmlp.leaves(params), topt), (tcfg, topt)


def _as_f32(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def test_npz_checkpoints_round_trip_both_ways(tmp_path):
    """The port saves two steps, JAX restores every leaf; JAX saves that
    state again, the port restores it into a fresh state and saves it: the
    members equal JAX's byte for byte."""
    import zipfile

    jstate, tstate, (tcfg, topt) = _states()
    step = ttrainer.make_train_step(lambda p, b: tmlp.loss_fn(p, tcfg, b), topt)
    for seed in (0, 1):
        tstate, _ = step(tstate, {k: torch.from_numpy(v) for k, v in _batch(tcfg, seed).items()})
    tck.NpzCheckpointer(str(tmp_path / "port")).save(tstate)
    restored = jck.NpzCheckpointer(str(tmp_path / "port")).restore(jstate)
    ref = jax.tree_util.tree_leaves(restored)
    got = tck.state_leaves(tstate)
    assert len(got) == len(ref) and int(restored.step) == 2
    for i, (g, r) in enumerate(zip(got, ref)):
        np.testing.assert_array_equal(np.asarray(r, np.float32), _as_f32(g), err_msg=f"leaf {i}")
    jck.NpzCheckpointer(str(tmp_path / "jax")).save(restored, step=2)
    _, fresh, _ = _states()
    tck.NpzCheckpointer(str(tmp_path / "jax")).restore(fresh)
    tck.NpzCheckpointer(str(tmp_path / "again")).save(fresh)
    with zipfile.ZipFile(tmp_path / "jax" / "2" / "state.npz") as a, \
            zipfile.ZipFile(tmp_path / "again" / "2" / "state.npz") as b:
        assert sorted(a.namelist()) == sorted(b.namelist())
        for name in a.namelist():
            assert a.read(name) == b.read(name), name


# ------------------------------------------------------------- entry points


def _spec(**over):
    spec = {"kind": "jax_xla", "mode": "train", "model": {"family": "mlp", "preset": "tiny"},
            "train": {"batchSize": 16, "steps": 12, "learningRate": 1e-2, "seed": 0}}
    spec.update(over)
    return spec


def _jax_run(spec):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1])


def test_train_entry_matches_the_jax_entry(tmp_path):
    """Both entry points resume the same JAX-saved weights (step 2) and
    train on the same synthetic batches: the same loss history, a falling
    loss, and the JAX entry's metric keys (the port adds its device's)."""
    ck = {"enabled": True, "format": "npz", "intervalSteps": 100, "keep": 2}
    _jax_run(_spec(train=dict(_spec()["train"], steps=2),
                   checkpoint=dict(ck, directory=str(tmp_path / "jax"))))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = _jax_run(_spec(checkpoint=dict(ck, directory=str(tmp_path / "jax"))))
    got = run_template_runtime(_spec(checkpoint=dict(ck, directory=str(tmp_path / "port"))),
                               device="cpu")
    assert set(got) - {"device", "device_kind"} == set(ref)
    assert got["resumed_from_step"] == ref["resumed_from_step"] == 2
    assert got["tokens_per_sec"] == ref["tokens_per_sec"] == 0
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
    assert got["loss_history"][-1] < got["loss_history"][0]


def test_a_spec_that_names_no_family_trains():
    """The spec's default family is mlp (preset tiny)."""
    runtime = JaxXlaRuntime.from_dict({"kind": "jax_xla", "mode": "train",
                                       "train": {"steps": 6, "learningRate": 1e-2}})
    assert runtime.model.family == "mlp" and get_family("mlp") is tmlp
    m = run_template_runtime(runtime, device="cpu")
    assert m["family"] == "mlp" and m["steps"] == 6 and np.isfinite(m["final_loss"])
    assert "param_count" not in m and "mfu" not in m  # as the JAX entry: no LM metrics


@pytest.mark.parametrize("mode", ["infer", "serve"])
def test_infer_and_serve_raise_for_mlp(mode):
    with pytest.raises(ValueError, match="mlp"):
        run_template_runtime(_spec(mode=mode), device="cpu")
    with pytest.raises(ValueError, match="mlp"):
        _jax_run(_spec(mode=mode))


def test_config_presets_init_and_interop():
    """The JAX presets; the init's scales (weights std 1/sqrt(fan_in)
    within 10%, biases zeros); a tree of another config is refused."""
    for name, preset in jmlp.PRESETS.items():
        assert tmlp.PRESETS[name] == preset
    assert tmlp.config("tiny", dtype="bfloat16").dtype == torch.bfloat16
    tp = tmlp.init(torch.Generator().manual_seed(0), tmlp.config("small"), "cpu")
    assert len(tp["layers"]) == 3
    for layer in tp["layers"]:
        assert layer["b"].abs().sum() == 0 and layer["w"].requires_grad
        np.testing.assert_allclose(layer["w"].detach().std().item(), layer["w"].shape[0] ** -0.5,
                                   rtol=0.1)
    (_, jp), _ = _models("tiny")
    with pytest.raises(ValueError, match="layers"):
        mlp_params_from_jax(jax.tree.map(np.asarray, jp), tmlp.config("small"), "cpu")
