"""Parameters sharded over the ``fsdp`` axis in training (module item 4e)
against the JAX package, float32 on the CPU.

In the main process (no group needed: a rank's shard is its mesh
coordinates):

* the layout: each rank's block of every leaf, cut from the JAX params and
  drawn by the port's own init, equals JAX's addressable shard of the leaf
  (``shard_params``) on the device at the same mesh coordinates, for Llama,
  GPT-NeoX, Mixtral and the MLP over {fsdp: 4} and {fsdp: 2, tensor: 2},
  and Mixtral over {fsdp: 2, expert: 2};
* a d_model (the MLP: a layer's input width) that does not tile ``fsdp``
  is refused by both packages.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs:

* three train steps of each family over those meshes, remat off, ``full``,
  ``dots`` and ``dots_attn``, ``grad_accum`` 1 and 2, against JAX's jitted
  step under the same mesh on the conftest's CPU devices: each step's loss
  and grad norm, and the whole parameters joined from every rank's blocks,
  to 1e-4 relative; each rank holds blocks of its leaves and moments;
* one forward of a step under each remat setting: no gathered whole layer
  weight is alive between the forward and the backward (a tensor the graph
  saves keeps its Python object alive), and with the trainer's
  ``saved_as_blocks`` left out the same check fails; and Mixtral's steps
  over {fsdp: 2, expert: 2} leave no tensor alive behind them;
* ``examples/train-llama8b-fsdp.yaml`` at the tiny preset over 4 ranks with
  its parallelism declared {fsdp: 4}, against JAX's entry point on 4
  devices: both resume one JAX-written step;
* an Orbax and an npz step of tiny Llama written over {fsdp: 4}: the step
  equals the state the ranks hold, joined, bit for bit; it restores into
  {fsdp: 2, tensor: 2} (each rank its blocks) and into one rank, and both
  resume with JAX's next loss from the same step.
"""

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
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.parallel import sharding as jsharding
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch import interop
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models import mlp as tmlp
from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
from nexus_tpu_torch.parallel.sharding import ModelShard, param_shard
from nexus_tpu_torch.runtime import entrypoints
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFAMILIES = {"llama": jllama, "gptneox": jneox, "mixtral": jmix, "mlp": jmlp}
TFAMILIES = {"llama": tllama, "gptneox": tneox, "mixtral": tmix, "mlp": tmlp}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
REL = 1e-4
F32 = dict(dtype="float32")
# a capacity factor under which JAX drops selections (routing then crosses
# the ranks' tokens)
MIX = dict(F32, attn_impl="xla", capacity_factor=0.5)
FSDP4, FSDP_TP, FSDP_EP = {"fsdp": 4}, {"fsdp": 2, "tensor": 2}, {"fsdp": 2, "expert": 2}
LAYOUT_CASES = [(f, p) for f in ("llama", "gptneox", "mixtral", "mlp") for p in (FSDP4, FSDP_TP)]
LAYOUT_CASES.append(("mixtral", FSDP_EP))
# (family, mesh, port overrides, grad_accum): every remat policy and both
# accumulations spread over the families (the MLP over {fsdp: 2, tensor:
# 2}: tests/test_torch_sequence_tensor.py). Mixtral accumulates once: a
# microbatch routes its own tokens, and the two packages cut the global
# batch into microbatches otherwise (rows of each rank, rows of the batch)
STEP_CASES = [
    ("llama", FSDP4, F32, 1),
    ("llama", FSDP4, dict(F32, remat=True, remat_policy="full"), 2),
    ("llama", FSDP_TP, dict(F32, remat=True, remat_policy="dots_attn", ce_chunk=100), 1),
    ("gptneox", FSDP4, dict(F32, remat=True, remat_policy="dots"), 1),
    ("gptneox", FSDP_TP, F32, 2),
    ("mixtral", FSDP4, dict(MIX, dispatch_impl="scatter"), 1),
    ("mixtral", FSDP_EP, dict(MIX, dispatch_impl="einsum", remat=True, remat_policy="full"), 1),
    ("mlp", FSDP4, {}, 2),
]
# GPT-NeoX's key bias has a gradient of rounding noise (as in
# tests/test_torch_tensor_train.py): that third of b_qkv is left out of the
# parameter comparison
_NOISY = "layers/b_qkv"
# the step that checks what stays saved: d_ff 96, so that every layer
# leaf's whole slice has a shape of its own
SAVED_KW = dict(F32, d_ff=96)
REMATS = [None, "full", "dots", "dots_attn"]
CK_SEED = 7


def _world(plan):
    return int(np.prod(list(plan.values())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _case_id(case):
    family, plan, kw, accum = case[0], case[1], case[2], case[3] if len(case) > 3 else 1
    extra = [kw.get("remat_policy", "")] + (["accum2"] if accum > 1 else [])
    return "-".join([family, *(f"{a}{n}" for a, n in plan.items()), *filter(None, extra)])


def _jax_kw(family, kw):
    """A case's JAX config overrides: no remat (the same function)."""
    out = {k: v for k, v in kw.items() if k not in ("remat", "remat_policy", "dtype")}
    return out if family == "mlp" else {**out, "dtype": jnp.float32}


def _inputs(family, kw, n_batches=3):
    jcfg = JFAMILIES[family].config("tiny", **_jax_kw(family, kw))
    jparams = JFAMILIES[family].init(jax.random.PRNGKey(3), jcfg)
    if family == "mlp":
        data = jdata.synthetic_mlp_batches(8, jcfg.in_dim, jcfg.out_dim, seed=5)
    else:
        data = jdata.synthetic_lm_batches(8, 32, jcfg.vocab_size, seed=5)
    return jcfg, jparams, [next(data) for _ in range(n_batches)]


def _jax_mesh(plan):
    return jmesh.build_mesh(jmesh.MeshPlan(**plan), jax.devices()[:_world(plan)])


def _leaf_paths(family, cfg):
    fam = TFAMILIES[family]
    params = fam.empty_params(cfg, "meta")
    path = {id(t): p for p, t in tree_items(params)}
    return [path[id(t)] for t in fam.leaves(params)]


def _ck_spec(steps, ck_dir):
    """examples/train-llama8b-fsdp.yaml cut to the tiny preset in float32:
    its model overrides (remat dots_attn, ce_chunk 8192), its parallelism
    declared {fsdp: 4} (the template's own fsdp axis at 4 ranks), synthetic
    data, 4 rows of 32 tokens, its checkpoint block in ``ck_dir``."""
    with open(os.path.join(ROOT, "examples", "train-llama8b-fsdp.yaml")) as f:
        rt = yaml.safe_load(f)["spec"]["runtime"]
    rt = dict(rt, tpu={}, data={}, profile={"enabled": False}, parallelism=FSDP4)
    rt["model"] = dict(rt["model"], preset="tiny",
                       overrides=dict(rt["model"]["overrides"], dtype="float32"))
    rt["train"] = {"batchSize": 4, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                   "warmupSteps": 1, "weightDecay": 0.1, "seed": 0}
    rt["checkpoint"] = dict(rt["checkpoint"], directory=str(ck_dir), intervalSteps=100)
    return rt


def _jax_run(spec, n_devices):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:n_devices])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranked(tmp_path_factory):
    """Every multi-rank case in one spawn of 4: {key: each rank's result}."""
    root = tmp_path_factory.mktemp("fsdp")
    calls, keys = [], []
    for i, (family, plan, kw, accum) in enumerate(STEP_CASES):
        _, jparams, batches = _inputs(family, kw)
        calls.append(("fsdp_train_steps", (family, kw, _np_tree(jparams), batches, plan, OPT,
                                           accum)))
        keys.append(("step", i))
    _, jparams, batches = _inputs("llama", SAVED_KW, 1)
    for policy in REMATS:
        kw = SAVED_KW if policy is None else dict(SAVED_KW, remat=True, remat_policy=policy)
        calls.append(("fsdp_saved_wholes", ("llama", kw, _np_tree(jparams), batches[0], FSDP4,
                                            OPT)))
        keys.append(("saved", policy))
    calls.append(("fsdp_saved_wholes", ("llama", SAVED_KW, _np_tree(jparams), batches[0],
                                        FSDP4, OPT, True)))
    keys.append(("saved", "planted"))
    # Mixtral's routing saves outputs (a softmax's): what the hooks keep of
    # them must not hold their own nodes
    _, mparams, mbatches = _inputs("mixtral", MIX, 1)
    calls.append(("fsdp_left_behind", ("mixtral", dict(MIX, dispatch_impl="einsum"),
                                       _np_tree(mparams), mbatches[0], FSDP_EP, OPT, 1)))
    keys.append(("left", None))
    # the template: JAX trains 2 steps on one device and saves; both resume
    _jax_run(_ck_spec(2, root / "jax-entry"), 1)
    shutil.copytree(root / "jax-entry", root / "port-entry")
    calls.append(("run_entry", (_ck_spec(6, root / "port-entry"),)))
    keys.append(("entry", None))
    # checkpoints: written over {fsdp: 4}, restored and resumed over
    # {fsdp: 2, tensor: 2} in the same spawn (and over one rank after it)
    for fmt in ("orbax", "npz"):
        ck = str(root / f"ck-{fmt}")
        calls.append(("model_save_and_restore", ("llama", F32, ck, FSDP4, fmt, "save",
                                                 CK_SEED)))
        keys.append(("ck-save", fmt))
        calls.append(("model_save_and_restore", ("llama", F32, ck, FSDP_TP, fmt, "restore",
                                                 CK_SEED)))
        keys.append(("ck-restore", fmt))
    ranks = spawn(workers.many, 4, (calls,), tmpdir=str(root), timeout_s=400)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys)}
    out["root"] = root
    return out


# ------------------------------------------------------------- the layout


def _jax_addressable(jleaf, device):
    (shard,) = [s for s in jleaf.addressable_shards if s.device == device]
    return np.asarray(shard.data)


def _in_port_runs(x, dims, runs, tensor):
    """``x`` with the dim its logical dims put on ``tensor`` re-laid so that
    each rank's block of every fused run lies together: JAX's contiguous cut
    of it is then the port's cut of the runs (a deliberate difference of the
    port, train/ and parallel/sharding.py)."""
    i = [d for d in dims].index("qkv")
    n = x.shape[i]
    y = x.reshape(x.shape[:i] + (runs, tensor, n // (runs * tensor)) + x.shape[i + 1:])
    return np.swapaxes(y, i, i + 1).reshape(x.shape)


@pytest.mark.parametrize("family,plan", LAYOUT_CASES,
                         ids=[_case_id((f, p, {})) for f, p in LAYOUT_CASES])
def test_each_ranks_blocks_are_jaxs_addressable_shards(family, plan):
    jcfg, jparams, _ = _inputs(family, F32, 0)
    cfg = TFAMILIES[family].config("tiny", **({} if family == "mlp" else F32))
    jfam, fam = JFAMILIES[family], TFAMILIES[family]
    mesh = _jax_mesh(plan)
    np_params = _np_tree(jparams)
    logical = dict(tree_items(fam.logical_axes(cfg)))
    groups, tensor = fam.TENSOR_GROUPS, plan.get("tensor", 1)
    relaid = {path: (_in_port_runs(leaf, logical[path], groups[path], tensor)
                     if path in groups and tensor > 1 else leaf)
              for path, leaf in tree_items(np_params)}
    placed = dict(tree_items(jsharding.shard_params(
        _tree_like(np_params, relaid), jfam.logical_axes(jcfg), mesh)))
    devices = mesh.devices.reshape(-1)
    whole_init = dict(tree_items(fam.init(torch.Generator().manual_seed(0), cfg, "cpu")))
    for rank in range(_world(plan)):
        mesh_r = Mesh(MeshPlan(**plan), rank)
        shard = param_shard(mesh_r)
        assert shard.on("fsdp") == (mesh_r.index("fsdp"), plan.get("fsdp", 1))
        blocks = dict(tree_items(getattr(interop, f"{family}_params_from_jax")(
            np_params, cfg, "cpu", mesh=shard)))
        drawn = dict(tree_items(fam.init(torch.Generator().manual_seed(0), cfg, "cpu",
                                         shard=shard)))
        cuts = LeafCuts(fam.logical_axes(cfg), shard, groups)
        for path, block in blocks.items():
            want = _jax_addressable(placed[path], devices[rank])
            np.testing.assert_array_equal(block.detach().numpy(), want, err_msg=path)
            # the port's own init: every slice drawn whole, the rank's block kept
            assert torch.equal(drawn[path], cuts.take(path)(whole_init[path])), path
            # a leaf is a block over fsdp where it has an embed dim; the
            # others (norms, biases) stay whole
            assert cuts.is_cut(path, "fsdp") == ("embed" in logical[path]), path


def _tree_like(tree, flat):
    """``tree``'s structure with the leaves of ``flat`` (by tree path)."""
    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [build(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return flat[prefix[:-1]]

    return build(tree, "")


@pytest.mark.parametrize("family,over", [("llama", dict(d_model=6, n_heads=2, n_kv_heads=2)),
                                         ("mlp", dict(in_dim=6))])
def test_a_d_model_that_does_not_tile_fsdp_is_refused_by_both(monkeypatch, family, over):
    monkeypatch.setattr(entrypoints, "world_size", lambda: 4)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    spec = {"kind": "jax_xla", "mode": "train", "parallelism": FSDP4,
            "model": {"family": family, "preset": "tiny", "overrides": over},
            "train": {"batchSize": 4, "seqLen": 16, "steps": 1}}
    name = next(iter(over))
    with pytest.raises(ValueError, match=f"fsdp axis of 4 ranks does not tile the model "
                                         f".{name} 6"):
        entrypoints.run_template_runtime(spec, device="cpu")
    # JAX cannot place such a leaf either: its embed dim of 6 over 4 devices
    leaf = {"w": np.zeros((6, 8), np.float32)}
    with pytest.raises(ValueError):
        jsharding.shard_params(leaf, {"w": ("embed", "mlp")}, _jax_mesh(FSDP4))


# ---------------------------------------------------------- train steps


def _jax_steps(family, plan, kw, accum):
    jcfg, jparams, batches = _inputs(family, kw)
    mesh = _jax_mesh(plan)
    jfam = JFAMILIES[family]
    jopt = jtrainer.build_optimizer(**OPT)
    with mesh:
        jstate = jtrainer.init_train_state(lambda: jparams, jopt, mesh=mesh,
                                           logical_tree=jfam.logical_axes(jcfg))
        jstep = jtrainer.make_train_step(lambda p, b: jfam.loss_fn(p, jcfg, b), jopt,
                                         mesh=mesh, grad_accum=accum, donate=False)
        losses, norms = [], []
        for batch in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, dict(tree_items(_np_tree(jstate.params)))


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_id(c) for c in STEP_CASES])
def test_train_steps_over_fsdp_match_jax(ranked, case):
    family, plan, kw, accum = case
    ref_loss, ref_norm, want = _jax_steps(family, plan, kw, accum)
    ranks = ranked[("step", STEP_CASES.index(case))]
    assert len(ranks) == _world(plan)
    for r in ranks:  # every rank reports the global metrics, the same ones
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=REL)
        np.testing.assert_allclose(r["grad_norm"], ref_norm, rtol=REL)
        assert r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
    got = ranks[0]["params"]
    assert got.keys() == want.keys()
    for name, ref in want.items():
        g = got[name]
        if family == "gptneox" and name == _NOISY:
            third = ref.shape[-1] // 3
            keep = np.r_[0:third, 2 * third:3 * third]
            g, ref = g[..., keep], ref[..., keep]
        np.testing.assert_allclose(g, ref, rtol=REL, atol=1e-6, err_msg=name)
    # each rank holds its blocks of the leaves and of their moments alone
    fam = TFAMILIES[family]
    cfg = fam.config("tiny", **kw)
    paths = _leaf_paths(family, cfg)
    for rank, r in enumerate(ranks):
        shard = param_shard(Mesh(MeshPlan(**plan), rank))
        cuts = LeafCuts(fam.logical_axes(cfg), shard, fam.TENSOR_GROUPS)
        blocks = [cuts.shape(p, want[p].shape) for p in paths]
        assert r["shapes"]["params"] == blocks
        assert r["shapes"]["moments"] == blocks + blocks


# --------------------------------------------- what the forward leaves saved


def _layer_shapes():
    """The shape of each whole layer leaf's slice (what a layer gathers)."""
    cfg = tllama.config("tiny", **SAVED_KW)
    shapes = tllama.param_shapes(cfg)
    return {shapes[k][1:] for k in tllama.LAYER_KEYS if len(shapes[k]) == 3}


@pytest.mark.parametrize("policy", REMATS, ids=[str(p) for p in REMATS])
def test_no_whole_layer_weight_stays_saved_for_backward(ranked, policy):
    layer = _layer_shapes()
    assert len(layer) == 4  # (64, 64), (64, 32), (64, 96), (96, 64): all distinct
    for r in ranked[("saved", policy)]:
        # embed, the 7 matrices of each of the 2 layers, lm_head
        assert r["gathered"] == 1 + 2 * 7 + 1, r
        assert not [s for s in r["alive"] if s in layer], r["alive"]
        assert np.isfinite(r["loss"])


def test_without_the_hooks_whole_layer_weights_stay_saved(ranked):
    """The planted fault: the trainer's ``saved_as_blocks`` left out, the
    forward keeps every layer's whole weights for the backward."""
    layer = _layer_shapes()
    ref = ranked[("saved", None)][0]["loss"]
    for r in ranked[("saved", "planted")]:
        alive = [s for s in r["alive"] if s in layer]
        assert len(alive) >= 2 * 7, alive  # 2 layers x the 7 matrices
        assert r["loss"] == ref


def test_a_step_leaves_no_tensor_behind(ranked):
    """A train step of a fresh state dropped after it leaves no tensor
    alive: the saved-tensor hooks keep nothing that holds the graph
    (a saved output kept as itself would hold its own node, a cycle that
    kept every step's graph, parameters and activations alive)."""
    for left in ranked[("left", None)]:
        assert left == 0, left


# --------------------------------------------------------- the entry point


def test_the_fsdp_template_over_four_ranks_matches_jax(ranked):
    root = ranked["root"]
    ref = _jax_run(_ck_spec(6, root / "jax-entry"), 4)
    assert ref["n_devices"] == 4 and ref["resumed_from_step"] == 2
    for m in ranked[("entry", None)]:
        assert m["n_devices"] == 4 and m["resumed_from_step"] == 2 and m["checkpoint_saved"]
        np.testing.assert_allclose(m["loss_history"], ref["loss_history"], rtol=REL)
        assert m["tokens_per_sec_per_chip"] == m["tokens_per_sec"] / 4


# ----------------------------------------------------------- checkpoints


def _whole_saved(saved):
    """The tensors rank 0 wrote (over {fsdp: 4} every rank's blocks joined
    are the whole leaves): equal on every rank."""
    for r in saved[1:]:
        for a, b in zip(r["tensors"], saved[0]["tensors"]):
            np.testing.assert_array_equal(a, b)
    return saved[0]


def _jax_next_loss(ck_dir, fmt):
    """JAX restores the step and trains the next one on the same batch as
    the port's resumed step: its loss."""
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jopt = jtrainer.build_optimizer(1e-2, warmup_steps=1, total_steps=4)
    template = jtrainer.init_train_state(lambda: jllama.init(jax.random.PRNGKey(0), jcfg), jopt)
    ck = jck.Checkpointer(ck_dir) if fmt == "orbax" else jck.NpzCheckpointer(ck_dir)
    state = ck.restore(template)
    if fmt == "orbax":
        ck.close()
    assert int(state.step) == 2
    data = jdata.synthetic_lm_batches(4, 16, jcfg.vocab_size, seed=CK_SEED)
    for _ in range(2):
        next(data)
    jstep = jtrainer.make_train_step(lambda p, b: jllama.loss_fn(p, jcfg, b), jopt,
                                     donate=False)
    _, m = jstep(state, {"tokens": jnp.asarray(next(data)["tokens"])})
    return float(m["loss"])


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
def test_an_fsdp_step_restores_into_other_meshes_and_resumes_as_jax(ranked, fmt):
    saved = _whole_saved(ranked[("ck-save", fmt)])
    ck_dir = str(ranked["root"] / f"ck-{fmt}")
    cfg = tllama.config("tiny", **F32)
    paths = _leaf_paths("llama", cfg)
    # one rank reads the step: the state the ranks held, bit for bit
    one = workers.model_save_and_restore("llama", F32, ck_dir, {}, fmt, "restore", CK_SEED)
    assert (one["step"], one["count"], one["schedule_count"]) == (
        saved["step"], saved["count"], saved["schedule_count"]) == (2, 2, 2)
    for i, (a, b) in enumerate(zip(one["params"] + one["blocks"], saved["tensors"])):
        np.testing.assert_array_equal(a, b, err_msg=paths[i % len(paths)])
    # {fsdp: 2, tensor: 2}: each rank its blocks of the parameters and moments
    ranks = ranked[("ck-restore", fmt)]
    for r in ranks:
        assert (r["step"], r["count"]) == (2, 2) and r["fsdp"] == 2
        coords = r["coords"]
        shard = ModelShard((coords["fsdp"], 0, coords["tensor"]), (2, 1, 2))
        cuts = LeafCuts(tllama.logical_axes(cfg), shard, tllama.TENSOR_GROUPS)
        for i, (a, b) in enumerate(zip(r["params"] + r["blocks"], saved["tensors"])):
            path = paths[i % len(paths)]
            want = cuts.take(path)(torch.from_numpy(b.view(np.float32))).contiguous()
            np.testing.assert_array_equal(a, want.numpy().view(np.int16), err_msg=path)
    # both resume with JAX's next loss from the same step
    jax_loss = _jax_next_loss(ck_dir, fmt)
    np.testing.assert_allclose(one["resumed_loss"], jax_loss, rtol=REL)
    for r in ranks:
        np.testing.assert_allclose(r["resumed_loss"], jax_loss, rtol=REL)
