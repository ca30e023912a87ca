"""The port's Orbax checkpoint format (nexus_tpu_torch.train.orbax_format,
OrbaxCheckpointer in nexus_tpu_torch.train.checkpoint) against the JAX
package's Checkpointer (Orbax, OCDBT, zarr v2, zstd level 1) on the CPU.

Either package reads the other's steps bit for bit. The tree paths the port
writes are derived here from a ``_METADATA`` JAX wrote for each family,
with and without a warmup schedule (whose state adds a leaf), not assumed.
Orbax is imported once in this file (its import costs ~30 s cold); the
JAX-written steps are made once per module.

Tolerances: restores are exact (bf16 and f32 bit patterns, the counts); one
train step after a resume f32 rtol 1e-5, atol 1e-7 (loss rtol 1e-5), as the
npz resume test holds it.
"""

import glob
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.models import mlp as jmlp
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.api.runtime_spec import JaxXlaRuntime as PortRuntime
from nexus_tpu_torch.interop import (gptneox_params_from_jax, llama_params_from_jax,
                                     mixtral_params_from_jax, mlp_params_from_jax)
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models import mlp as tmlp
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.train import checkpoint as tck
from nexus_tpu_torch.train import orbax_format as tob
from nexus_tpu_torch.train import trainer as ttrainer
from nexus_tpu_torch.testing.dist import spawn
from nexus_tpu_torch.utils import ocdbt

import torch_dist_workers as workers

ts = pytest.importorskip("tensorstore")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "orbax_llama_tiny")
FAMILIES = {"llama": (jllama, tllama, llama_params_from_jax),
            "mixtral": (jmix, tmix, mixtral_params_from_jax),
            "gptneox": (jneox, tneox, gptneox_params_from_jax),
            "mlp": (jmlp, tmlp, mlp_params_from_jax)}
CASES = [(f, w) for f in FAMILIES for w in (0, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states(family, warmup):
    """The same state in both packages at the family's tiny preset and its
    dtype: JAX's with every moment and count given values of its own
    (numpy seed 0) and step 5, and the port's with the same params and
    fresh moments."""
    jfam, tfam, conv = FAMILIES[family]
    jcfg = jfam.config("tiny")
    jopt = jtrainer.build_optimizer(3e-3, warmup_steps=warmup, total_steps=8)
    jstate = jtrainer.init_train_state(lambda: jfam.init(jax.random.PRNGKey(0), jcfg), jopt)
    rng = np.random.default_rng(0)
    leaves, treedef = jax.tree_util.tree_flatten(jstate.opt_state)
    leaves = [jnp.asarray(rng.standard_normal(x.shape), x.dtype) if jnp.issubdtype(x.dtype, jnp.floating)
              else jnp.asarray(3, x.dtype) for x in leaves]
    jstate = jtrainer.TrainState(jstate.params, jax.tree_util.tree_unflatten(treedef, leaves),
                                 jnp.asarray(5, jnp.int32))
    dtype = str(np.dtype(jcfg.dtype)) if family != "mlp" else None
    tcfg = tfam.config("tiny", **({"dtype": dtype} if dtype else {}))
    params = conv(jax.tree.map(np.asarray, jstate.params), tcfg, "cpu")
    topt = ttrainer.build_optimizer(3e-3, warmup_steps=warmup, total_steps=8)
    tstate = ttrainer.init_train_state(params, tfam.leaves(params), topt)
    return jstate, tstate, tcfg


def _fresh(family, warmup, tcfg):
    tfam = FAMILIES[family][1]
    params = tfam.empty_params(tcfg, "cpu")
    topt = ttrainer.build_optimizer(3e-3, warmup_steps=warmup, total_steps=8)
    return ttrainer.init_train_state(params, tfam.leaves(params), topt)


def _bits(x):
    """A leaf's raw values: bf16 as its 16-bit patterns, ints as int32."""
    if torch.is_tensor(x):
        x = x.detach().contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return a.view(np.int16)
    return a.astype(np.int32) if a.dtype.kind in "iu" else a


def _port_arrays(state):
    return [(leaf.name, leaf.value) for leaf in tob.state_leaves(state) if leaf.value is not None]


@pytest.fixture(scope="module")
def jax_steps(tmp_path_factory):
    """A JAX-written Orbax step (step 5) for each family, with and without
    warmup."""
    out = {}
    for family, warmup in CASES:
        jstate, _, tcfg = _states(family, warmup)
        d = str(tmp_path_factory.mktemp(f"jax-{family}-{warmup}"))
        ck = jck.Checkpointer(d)
        ck.save(jstate, wait=True)
        ck.close()
        out[family, warmup] = (d, jstate, tcfg)
    return out


@pytest.mark.parametrize("family,warmup", CASES)
def test_the_tree_paths_are_the_ones_jax_writes(jax_steps, family, warmup):
    """Every entry of the port's tree, in order: the path, each key's type,
    the value's type and shape, as JAX's _METADATA lists them."""
    d, _, _ = jax_steps[family, warmup]
    _, tstate, _ = _states(family, warmup)
    with open(os.path.join(d, "5", "default", "_METADATA")) as f:
        ref = json.load(f)["tree_metadata"]
    got = {}
    for leaf in tob.state_leaves(tstate):
        value = ({"value_type": "None", "skip_deserialize": True} if leaf.value is None else
                 {"value_type": "jax.Array", "skip_deserialize": False,
                  "write_shape": list(leaf.shape)})
        got[str(leaf.keys)] = {"key_metadata": [{"key": k, "key_type": t}
                                                for k, t in zip(leaf.keys, leaf.key_types)],
                               "value_metadata": value}
    assert list(got) == list(ref)
    assert got == ref


@pytest.mark.parametrize("family,warmup", CASES)
def test_the_port_restores_a_jax_step_bit_for_bit(jax_steps, family, warmup):
    d, jstate, tcfg = jax_steps[family, warmup]
    state = _fresh(family, warmup, tcfg)
    ck = tck.make_checkpointer(d, fmt="auto")
    assert isinstance(ck, tck.OrbaxCheckpointer)
    ck.restore(state)
    ref = jax.tree_util.tree_leaves(jstate)
    got = [v for _, v in _port_arrays(state)]
    assert len(got) == len(ref)
    for (name, g), r in zip(_port_arrays(state), ref):
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=name)
    assert state.step == 5 and state.opt_state.count == 3
    assert state.opt_state.schedule_count == (3 if warmup else None)
    # params only: the params.* values alone are read
    params = FAMILIES[family][1].empty_params(tcfg, "cpu")
    ck.restore_params(params)
    for g, r in zip(tob.param_leaves(params), jax.tree_util.tree_leaves(jstate.params)):
        np.testing.assert_array_equal(_bits(g.value), _bits(r), err_msg=g.name)
    with ocdbt.Reader(os.path.join(d, "5", "default")) as store:
        sizes = {k: (v.length if isinstance(v, ocdbt.Ref) else len(v))
                 for k, v in store.entries().items()}
    assert ck.last_bytes_read == sum(n for k, n in sizes.items() if k.startswith(b"params."))
    ck.restore(state)
    assert ck.last_bytes_read == sum(sizes.values())


@pytest.mark.parametrize("family", list(FAMILIES))
def test_jax_reads_a_port_step_bit_for_bit(tmp_path, jax_steps, family):
    """The port saves its state (moments of their own values, warmup 2);
    JAX's Checkpointer restores it, params only, and reads its metadata;
    the .zarray of every array is JAX's byte for byte."""
    jstate, tstate, _ = _states(family, 2)
    rng = np.random.default_rng(1)
    for t in tstate.opt_state.mu + tstate.opt_state.nu:
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape))))
    tstate.opt_state.count, tstate.opt_state.schedule_count, tstate.step = 4, 4, 7
    ck = tck.make_checkpointer(str(tmp_path))
    assert ck.save(tstate) == 7 and ck.latest_step() == 7
    jck_ = jck.Checkpointer(str(tmp_path))
    restored = jck_.restore(jstate)
    got = jax.tree_util.tree_leaves(restored)
    for (name, t), r in zip(_port_arrays(tstate), got):
        np.testing.assert_array_equal(_bits(r), _bits(t), err_msg=name)
    params = jck_.restore_params(jstate.params)
    for leaf, r in zip(tob.param_leaves(tstate.params), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(_bits(r), _bits(leaf.value), err_msg=leaf.name)
    meta = jck_._mgr.item_metadata(7)
    meta = getattr(meta, "tree", meta)


    def part(k):
        return str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))

    shapes = {".".join(part(k) for k in path): (tuple(m.shape), np.dtype(m.dtype))
              for path, m in jax.tree_util.tree_flatten_with_path(meta)[0]}
    assert shapes == {name: (tuple(np.shape(_bits(t))), np.dtype(r.dtype))
                      for (name, t), r in zip(_port_arrays(tstate), got)}
    jck_.close()
    jax_dir = jax_steps[family, 2][0]
    with ocdbt.Reader(os.path.join(jax_dir, "5", "default")) as ref, \
            ocdbt.Reader(os.path.join(str(tmp_path), "7", "default")) as port:
        zarrays = [k for k in ref.keys() if k.endswith(b"/.zarray")]
        assert zarrays == [k for k in port.keys() if k.endswith(b"/.zarray")]
        for k in zarrays:
            assert port.read(k) == ref.read(k), k


def test_the_port_restores_a_step_jax_wrote_from_a_sharded_mesh(tmp_path):
    """Arrays sharded over 4 devices along their first dim are written one
    chunk a shard (``0.0`` … ``3.0``); the port reads each chunk into its
    slice, bit for bit."""
    jstate, _, tcfg = _states("llama", 2)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("x",))
    P = jax.sharding.PartitionSpec

    def put(x):
        spec = P("x") if x.ndim and x.shape[0] % 4 == 0 else P()
        return jax.device_put(x, jax.sharding.NamedSharding(mesh, spec))

    jstate = jax.tree.map(put, jstate)
    ck = jck.Checkpointer(str(tmp_path))
    ck.save(jstate, wait=True)
    ck.close()
    with ocdbt.Reader(os.path.join(str(tmp_path), "5", "default")) as store:
        chunks = [k for k in store.keys() if k.startswith(b"params.embed/") and b".z" not in k]
    assert chunks == [b"params.embed/0.0", b"params.embed/1.0", b"params.embed/2.0",
                      b"params.embed/3.0"]
    state = _fresh("llama", 2, tcfg)
    tck.OrbaxCheckpointer(str(tmp_path)).restore(state)
    for (name, g), r in zip(_port_arrays(state), jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(_bits(g), _bits(np.asarray(r)), err_msg=name)


def test_the_fixture_restores_equal_to_its_npz_twin():
    """The committed JAX-written step (tiny Llama, bf16, warmup 2, one train
    step): its Orbax and npz copies restore to the same state, bit for bit."""
    tcfg = tllama.config("tiny", dtype="bfloat16")
    orbax_state, npz_state = _fresh("llama", 2, tcfg), _fresh("llama", 2, tcfg)
    tck.make_checkpointer(os.path.join(FIXTURE, "orbax"), fmt="auto").restore(orbax_state)
    tck.make_checkpointer(os.path.join(FIXTURE, "npz"), fmt="auto").restore(npz_state)
    for (name, a), (_, b) in zip(_port_arrays(orbax_state), _port_arrays(npz_state)):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert orbax_state.step == npz_state.step == 1
    assert orbax_state.opt_state.schedule_count == npz_state.opt_state.schedule_count == 1
    params = tllama.empty_params(tcfg, "cpu")
    tck.OrbaxCheckpointer(os.path.join(FIXTURE, "orbax")).restore_params(params)
    for leaf, ref in zip(tob.param_leaves(params), tob.param_leaves(npz_state.params)):
        np.testing.assert_array_equal(_bits(leaf.value), _bits(ref.value), err_msg=leaf.name)


def test_a_restore_into_another_structure_raises(jax_steps):
    d, _, tcfg = jax_steps["llama", 2]
    ck = tck.OrbaxCheckpointer(d)
    with pytest.raises(ValueError, match="structure drift"):
        ck.restore(_fresh("llama", 0, tcfg))  # no schedule state
    _, _, mcfg = jax_steps["mixtral", 2]
    with pytest.raises(ValueError, match="structure drift"):
        ck.restore_params(tmix.empty_params(mcfg, "cpu"))
    with pytest.raises(FileNotFoundError):
        tck.OrbaxCheckpointer(os.path.join(d, "empty")).restore(_fresh("llama", 2, tcfg))


def test_a_corrupt_chunk_raises_naming_it(tmp_path):
    """A chunk frame cut short in the data file: the restore raises naming
    the chunk, and the store's mapped files still close."""
    _, tstate, tcfg = _states("llama", 0)
    tck.OrbaxCheckpointer(str(tmp_path)).save(tstate)
    store = os.path.join(str(tmp_path), "0", "default")
    with ocdbt.Reader(store) as r:
        ref = r.entries()[b"params.embed/0.0"]
    assert isinstance(ref, ocdbt.Ref)
    with open(os.path.join(store, ref.path), "r+b") as f:
        f.seek(ref.offset + 13)  # the first block header, after the frame header
        f.write((10 << 3 | 1).to_bytes(3, "little"))  # a last raw block of 10 bytes
    with pytest.raises(ValueError, match=r"chunk params\.embed/0\.0: corrupt zstd frame at "
                                         r"byte \d+: frame content size"):
        tck.OrbaxCheckpointer(str(tmp_path)).restore_params(tllama.empty_params(tcfg, "cpu"))


def test_keep_prunes_the_oldest_steps_and_staging_is_never_a_step(tmp_path, monkeypatch):
    _, tstate, _ = _states("llama", 0)
    ck = tck.OrbaxCheckpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        tstate.step = s
        ck.save(tstate)
    assert ck.all_steps() == [3, 4] == jck.all_steps(str(tmp_path))
    assert ck.save(tstate) == 4  # already durable: left as it is
    os.makedirs(tmp_path / "7.orbax-checkpoint-tmp-1")  # a save interrupted mid-write
    os.makedirs(tmp_path / ".tmp-9-123")
    assert tck.latest_step(str(tmp_path)) == 4 == jck.latest_step(str(tmp_path))
    assert tck.detect_format(str(tmp_path)) == "orbax" == jck.detect_format(str(tmp_path))
    staged = []

    def broken(path, state):
        staged.append(os.path.basename(path))
        os.makedirs(os.path.join(path, "default"))
        raise OSError("disk full")

    monkeypatch.setattr(tob, "write_step", broken)
    tstate.step = 5
    with pytest.raises(OSError, match="disk full"):
        ck.save(tstate)
    assert staged[0].startswith("5.orbax-checkpoint-tmp-")
    assert ck.all_steps() == [3, 4] and not os.path.exists(tmp_path / staged[0])


# ------------------------------------------------------------- entry points


def _spec(family, ck_dir, steps, warmup=0, **extra):
    spec = {"kind": "jax_xla", "mode": "train",
            "model": {"family": family, "preset": "tiny", "overrides": {"dtype": "float32"}},
            "train": {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                      "warmupSteps": warmup, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(ck_dir), "intervalSteps": 100,
                           "keep": 3}}
    spec.update(extra)
    return spec


def _jax_run(spec, **kw):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1], **kw)


def _ts_arrays(step_dir):
    """name -> float32 array of every array of a step, read by tensorstore."""
    base = {"driver": "ocdbt", "base": f"file://{step_dir}/default/"}
    kv = ts.KvStore.open(base).result()
    names = sorted({k.decode().rsplit("/", 1)[0] for k in kv.list().result()})
    out = {}
    for name in names:
        arr = ts.open({"driver": "zarr", "kvstore": dict(base, path=name + "/")}).result().read().result()
        out[name] = np.asarray(arr, np.float32)
    return out


@pytest.mark.parametrize("family,warmup", [("llama", 0), ("mixtral", 2)])
def test_the_port_resumes_a_jax_orbax_step_and_its_next_step_equals_jax(tmp_path, family,
                                                                           warmup):
    """JAX trains 2 steps and saves in its default format; both packages
    resume that step and take step 3 on the same batch; the step-3 steps
    agree array by array (read by tensorstore)."""
    _jax_run(_spec(family, tmp_path / "jax", 2, warmup))
    assert os.path.isdir(tmp_path / "jax" / "2" / "default")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    ref = _jax_run(_spec(family, tmp_path / "jax", 3, warmup))
    got = run_template_runtime(_spec(family, tmp_path / "port", 3, warmup), device="cpu")
    assert got["resumed_from_step"] == ref["resumed_from_step"] == 2
    assert got["checkpoint_saved"] and ref["checkpoint_saved"]
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
    want, have = _ts_arrays(tmp_path / "jax" / "3"), _ts_arrays(tmp_path / "port" / "3")
    assert want.keys() == have.keys()
    for name in want:
        np.testing.assert_allclose(have[name], want[name], rtol=1e-5, atol=1e-7, err_msg=name)


def test_infer_and_serve_restore_from_a_port_orbax_step(tmp_path):
    m = run_template_runtime(_spec("llama", tmp_path / "ck", 2), device="cpu")
    assert m["checkpoint_saved"] and tck.detect_format(str(tmp_path / "ck")) == "orbax"
    infer = _spec("llama", tmp_path / "ck", 2, mode="infer", infer={
        "promptLength": 8, "maxNewTokens": 6, "iterations": 1})
    m = run_template_runtime(infer, device="cpu")
    assert m["weights_loaded"] and m["restored_step"] == 2
    serve = _spec("llama", tmp_path / "ck", 2, mode="serve", serve={
        "numRequests": 3, "promptLengthMin": 4, "promptLengthMax": 16, "maxNewMin": 2,
        "maxNewMax": 5, "kvBlockSize": 8})
    m = run_template_runtime(serve, device="cpu")
    assert m["weights_loaded"] and m["restored_step"] == 2 and m["ok_requests"] == 3


# ------------------------------------------------------------- the templates


def _checkpoint_templates():
    out = []
    for path in sorted(glob.glob(os.path.join(ROOT, "examples", "*.yaml"))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                rt = ((doc or {}).get("spec") or {}).get("runtime")
                if rt and (rt.get("checkpoint") or {}).get("enabled"):
                    out.append((os.path.basename(path), rt))
    return out


TEMPLATES = _checkpoint_templates()


def test_six_templates_enable_a_checkpoint_in_the_default_format():
    names = [n for n, rt in TEMPLATES if "format" not in rt["checkpoint"]]
    assert names == ["infer-llama8b-speculative.yaml", "infer-llama8b.yaml",
                     "moe-mixtral-fanout.yaml", "train-failover.yaml",
                     "train-gptneox-long-context.yaml", "train-llama8b-fsdp.yaml"]
    for name, rt in TEMPLATES:
        if name in names:
            assert PortRuntime.from_dict(rt).checkpoint.format == "orbax"
            assert jspec.JaxXlaRuntime.from_dict(rt).checkpoint.format == "orbax"


def _tiny(rt, ck_dir, steps):
    """A template at the tiny preset on one device, its checkpoint in
    ``ck_dir``: synthetic data, no profile window, 2 rows of 32 tokens.
    Ring attention (ROADMAP item 4) is left out of the overrides."""
    rt = dict(rt, tpu={}, parallelism={}, data={})
    rt.pop("profile", None)
    overrides = {k: v for k, v in (rt["model"].get("overrides") or {}).items()
                 if k in ("remat", "remat_policy")}
    rt["model"] = dict(rt["model"], preset="tiny", overrides=overrides)
    rt["train"] = dict(rt["train"], batchSize=2, seqLen=32, steps=steps)
    rt["checkpoint"] = dict(rt["checkpoint"], directory=str(ck_dir))
    return rt


@pytest.mark.parametrize("name", [n for n, rt in TEMPLATES if rt["mode"] == "train"
                                  and "format" not in rt["checkpoint"]])
def test_the_train_templates_save_and_resume(tmp_path, name):
    rt = dict(TEMPLATES)[name]
    first = run_template_runtime(_tiny(rt, tmp_path, 2), device="cpu")
    assert first["checkpoint_saved"] and tck.latest_step(str(tmp_path)) == 2
    assert os.path.isfile(tmp_path / "2" / "default" / "manifest.ocdbt")
    again = run_template_runtime(_tiny(rt, tmp_path, 3), device="cpu")
    assert again["resumed_from_step"] == 2 and tck.latest_step(str(tmp_path)) == 3


@pytest.mark.parametrize("name", [n for n, rt in TEMPLATES if rt["mode"] == "infer"
                                  and "format" not in rt["checkpoint"]])
def test_the_infer_templates_restore(tmp_path, name):
    rt = dict(TEMPLATES)[name]
    train = dict(_tiny(rt, tmp_path, 2), mode="train")
    run_template_runtime(train, device="cpu")
    infer = _tiny(rt, tmp_path, 1)
    infer["infer"] = dict(infer["infer"], promptLength=8, maxNewTokens=4, iterations=1)
    if "draft" in infer["infer"]:
        infer["infer"].update(draft={"family": "llama", "preset": "tiny"},
                              draftCheckpointDirectory=str(tmp_path))
    m = run_template_runtime(infer, device="cpu")
    assert m["weights_loaded"] and m["restored_step"] == 2
    if "draft" in infer["infer"]:
        assert m["draft_weights_loaded"] and m["acceptance_rate"] == 1.0


# ------------------------------------------------- across world sizes


def _fsdp_block(bits, n, index):
    """Block ``index`` of ``n`` of a tensor's flat elements, padded with
    zeros as train/trainer.py::FsdpShards lays them."""
    flat = bits.reshape(-1)
    flat = np.pad(flat, (0, -flat.size % n))
    c = flat.size // n
    return flat[index * c:(index + 1) * c]


@pytest.fixture(scope="module")
def across_world_sizes(tmp_path_factory):
    """Both directions in both formats from one spawn of 2 ranks with
    {fsdp: 2}: {(direction, fmt): (directory, what the saving side
    returned, what the restoring ranks returned, or None for the 1-rank
    restore the test makes)}."""
    root = tmp_path_factory.mktemp("worlds")
    calls, out = [], {}
    for fmt in ("orbax", "npz"):
        ck = str(root / f"2to1-{fmt}")
        calls.append(("save_and_restore", (ck, {"fsdp": 2}, fmt, "save", 7)))
        out[("2to1", fmt)] = ck
        ck = str(root / f"1to2-{fmt}")
        # one rank saves here before the ranks restore
        out[("1to2", fmt)] = (ck, workers.save_and_restore(ck, {}, fmt, "save", 7))
        calls.append(("save_and_restore", (ck, {"fsdp": 2}, fmt, "restore", 7)))
    ranks = spawn(workers.many, 2, (calls,), tmpdir=str(root))
    for i, key in enumerate(k for fmt in ("orbax", "npz") for k in (("2to1", fmt), ("1to2", fmt))):
        got = [r[i] for r in ranks]
        out[key] = ((out[key], got[0], None) if key[0] == "2to1"
                    else (out[key][0], out[key][1], got))
    return out


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
@pytest.mark.parametrize("direction", ["2to1", "1to2"])
def test_a_step_restores_bit_for_bit_across_world_sizes(across_world_sizes, fmt, direction):
    """A tiny bf16 Llama trained 2 steps and saved by 2 gloo ranks with
    {fsdp: 2} (rank 0 writes the gathered state) restores into one rank bit
    for bit, and a step one rank saved restores into 2: each rank holds the
    whole parameters and its blocks of the AdamW moments."""
    ck, saved, loaded = across_world_sizes[(direction, fmt)]
    if loaded is None:
        loaded = [workers.save_and_restore(ck, {}, fmt, "restore", 7)]
    assert tck.latest_step(ck) == saved["step"] == 2
    n_params = len(loaded[0]["params"])
    whole_params, moments = saved["tensors"][:n_params], saved["tensors"][n_params:]
    for got in loaded:
        assert (got["step"], got["count"], got["schedule_count"]) == (
            saved["step"], saved["count"], saved["schedule_count"])
        for a, b in zip(got["params"], whole_params):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got["blocks"], moments):
            np.testing.assert_array_equal(a.reshape(-1),
                                          _fsdp_block(b, got["fsdp"], got["fsdp_index"]))

