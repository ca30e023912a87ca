"""Training over a sharded ``tensor`` axis (module item 4b, part two), alone
and with ``fsdp``, against the JAX package, float32 on the CPU.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs every
multi-rank case: the meshes of 4 ranks over the whole group, and those of
2 ranks in two worlds of 2 (``workers.worlds``, each seen by the port as
its whole world), side by side:

* the train step of tiny Llama and GPT-NeoX over {tensor: 2}, {tensor: 4}
  and {fsdp: 2, tensor: 2}, remat ``dots_attn`` and the chunked loss among
  the cases: per-step loss and grad norm, and the parameters after 3
  steps (every rank's blocks joined), against JAX's jitted
  ``make_train_step`` under the same mesh on the conftest's CPU devices,
  to 1e-4 relative;
* the vocab-parallel cross entropy, dense and chunked, over 4 and 2 ranks
  (a vocabulary that leaves each rank a masked tail chunk): values and
  gradients against JAX's ``dense_softmax_xent`` / ``chunked_softmax_xent``;
* ``run_template_runtime`` of ``examples/train-llama8b-fsdp.yaml`` at the
  tiny preset over 2 ranks (re-planned to {tensor: 2}, as JAX plans 2
  devices) against JAX's on 2 devices: both resume one JAX-written step;
* a {tensor: 2} step (Orbax and npz) restored by one port rank and (Orbax)
  by JAX, and a one-rank step restored over {tensor: 2}.

In the main process: ``TensorShard.join`` undoes ``take`` for every leaf,
the gradients' peers exclude ``tensor``, and the refusals that remain.
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
from nexus_tpu.ops import losses as jlosses
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
from nexus_tpu_torch.parallel.sharding import TensorShard
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.testing.dist import spawn
from nexus_tpu_torch.train import checkpoint as tck
from nexus_tpu_torch.train import trainer as Tr

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFAMILIES = {"gptneox": jneox, "llama": jllama}
TFAMILIES = {"gptneox": tneox, "llama": tllama}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
REL = 1e-4
# (family, mesh, model overrides): each case's world is the mesh's ranks.
# Llama over 4 tensor ranks needs 4 kv heads (the tiny preset has 2). The
# chunked cases leave each rank a masked tail chunk of its 64 or 128
# columns (V 256).
STEP_CASES = [
    ("llama", {"tensor": 2}, {}),
    ("gptneox", {"tensor": 2}, {"remat": True, "remat_policy": "dots_attn"}),
    ("llama", {"tensor": 4}, {"n_heads": 8, "n_kv_heads": 4, "ce_chunk": 48}),
    ("gptneox", {"tensor": 4}, {"ce_chunk": 48}),
    ("llama", {"fsdp": 2, "tensor": 2},
     {"remat": True, "remat_policy": "dots_attn", "ce_chunk": 100}),
    ("gptneox", {"fsdp": 2, "tensor": 2}, {}),
]
# GPT-NeoX's key bias has a gradient that is rounding noise (softmax
# ignores a shift of a row's logits): AdamW turns it into updates of up to
# ~lr/10 of either sign in either package, so that third of b_qkv is left
# out of the parameter comparison (as in tests/test_torch_parallel_train.py)
_NOISY = ("layers/b_qkv", 1)
# the vocab-parallel loss: V 200 over 4 ranks (50 columns a rank, chunks of
# 32: a tail of 14 real columns and 18 masked) and over 2 (100 a rank: a
# tail of 4 real and 28 masked)
CE = dict(b=2, s=8, d=16, v=200, chunk=32)


def _case_id(case):
    family, plan, kw = case
    return f"{family}-" + "-".join(f"{a}{n}" for a, n in plan.items()) + (
        "-" + "-".join(sorted(k for k in kw if k in ("remat", "ce_chunk"))) if kw else "")


def _world(plan):
    return int(np.prod(list(plan.values())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _step_inputs(family, kw):
    jcfg = JFAMILIES[family].config("tiny", dtype=jnp.float32, **kw)
    jparams = JFAMILIES[family].init(jax.random.PRNGKey(3), jcfg)
    data = jdata.synthetic_lm_batches(4, 32, jcfg.vocab_size, seed=5)
    return jcfg, jparams, [next(data)["tokens"] for _ in range(3)]


def _ce_inputs():
    rng = np.random.default_rng(11)
    hidden = rng.standard_normal((CE["b"], CE["s"], CE["d"])).astype(np.float32)
    lm_head = (rng.standard_normal((CE["d"], CE["v"])) * 0.5).astype(np.float32)
    targets = rng.integers(0, CE["v"], (CE["b"], CE["s"])).astype(np.int32)
    # a target in each rank's tail chunk at 4 and at 2 ranks
    targets[0, :4] = [40, 95, 199, 148]
    return hidden, lm_head, targets


def template_spec(ck_dir, steps):
    """examples/train-llama8b-fsdp.yaml cut to the tiny preset in float32:
    its model overrides (remat dots_attn, ce_chunk 8192) and its
    parallelism (re-planned for the ranks), synthetic data, 2 rows of 32
    tokens, its checkpoint block in ``ck_dir`` (Orbax, the default)."""
    with open(os.path.join(ROOT, "examples", "train-llama8b-fsdp.yaml")) as f:
        rt = yaml.safe_load(f)["spec"]["runtime"]
    rt = dict(rt, tpu={}, data={}, profile={"enabled": False})
    rt["model"] = dict(rt["model"], preset="tiny",
                       overrides=dict(rt["model"]["overrides"], dtype="float32"))
    rt["train"] = {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
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
    """Every multi-rank case in one spawn of 4: {key: each rank's result}
    (for a case of 2 ranks, its world's two)."""
    root = tmp_path_factory.mktemp("tp-train")
    four, worlds = [], [[], []]
    keys4, keys2 = [], [[], []]
    for i, (family, plan, kw) in enumerate(STEP_CASES):
        _, jparams, batches = _step_inputs(family, kw)
        call = ("tp_train_steps", (family, {"dtype": "float32", **kw}, _np_tree(jparams),
                                   batches, plan, OPT))
        if _world(plan) == 4:
            four.append(call)
            keys4.append(("step", i))
        else:
            worlds[i % 2].append(call)
            keys2[i % 2].append(("step", i))
    ce = (*_ce_inputs(), CE["chunk"])
    four.append(("vocab_ce", ce))
    keys4.append(("ce", 4))
    worlds[1].append(("vocab_ce", ce))
    keys2[1].append(("ce", 2))
    # the template: JAX trains 2 steps on one device and saves; both resume
    _jax_run(template_spec(root / "jax-entry", 2), 1)
    shutil.copytree(root / "jax-entry", root / "port-entry")
    worlds[0].append(("run_entry", (template_spec(root / "port-entry", 7),)))
    keys2[0].append(("entry", None))
    # checkpoints: a {tensor: 2} step in each format; a one-rank step
    # (saved here, before the spawn) restored over {tensor: 2}
    for fmt in ("orbax", "npz"):
        worlds[1].append(("save_and_restore", (str(root / f"2to1-{fmt}"), {"tensor": 2}, fmt,
                                               "save", 7)))
        keys2[1].append(("2to1", fmt))
    one = str(root / "1to2-orbax")
    saved_by_one = workers.save_and_restore(one, {}, "orbax", "save", 7)
    worlds[0].append(("save_and_restore", (one, {"tensor": 2}, "orbax", "restore", 7)))
    keys2[0].append(("1to2", "orbax"))
    four.append(("worlds", (worlds,)))
    ranks = spawn(workers.many, 4, (four,), tmpdir=str(root))
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys4)}
    for w in (0, 1):
        for i, key in enumerate(keys2[w]):
            out[key] = [r[-1][i] for r in ranks[2 * w:2 * w + 2]]
    out["root"] = root
    out["saved_by_one"] = saved_by_one
    return out


def _joined(family, cfg, ranks):
    """The whole parameters from every tensor rank's blocks (by path)."""
    size = len({r["tensor_index"] for r in ranks})
    by_index = {r["tensor_index"]: r["params"] for r in ranks}
    fam = TFAMILIES[family]
    cuts = LeafCuts(fam.logical_axes(cfg), TensorShard(0, size), fam.TENSOR_GROUPS)
    return {path: cuts.join(path, [torch.from_numpy(by_index[i][path]) for i in range(size)])
            .numpy() for path in by_index[0]}


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_id(c) for c in STEP_CASES])
def test_train_steps_over_the_tensor_axis_match_jax(ranked, case):
    family, plan, kw = case
    i = STEP_CASES.index(case)
    jcfg, jparams, batches = _step_inputs(family, kw)
    n = _world(plan)
    mesh = jmesh.build_mesh(jmesh.MeshPlan(**plan), jax.devices()[:n])
    jopt = jtrainer.build_optimizer(**OPT)
    with mesh:
        jstate = jtrainer.init_train_state(lambda: jparams, jopt, mesh=mesh,
                                           logical_tree=JFAMILIES[family].logical_axes(jcfg))
        jstep = jtrainer.make_train_step(
            lambda p, b: JFAMILIES[family].loss_fn(p, jcfg, b), jopt, mesh=mesh, donate=False)
        ref_loss, ref_norm = [], []
        for batch in batches:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(batch)})
            ref_loss.append(float(m["loss"]))
            ref_norm.append(float(m["grad_norm"]))
    ranks = ranked[("step", i)]
    assert len(ranks) == n
    for r in ranks:  # every rank reports the global metrics, the same ones
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=REL)
        np.testing.assert_allclose(r["grad_norm"], ref_norm, rtol=REL)
        assert r["loss"] == ranks[0]["loss"] and r["grad_norm"] == ranks[0]["grad_norm"]
    cfg = TFAMILIES[family].config("tiny", dtype="float32", **kw)
    # under fsdp the ranks of one tensor index hold the same blocks
    for r in ranks:
        for s in ranks:
            if s["tensor_index"] == r["tensor_index"]:
                for path in r["params"]:
                    np.testing.assert_array_equal(r["params"][path], s["params"][path])
    got = _joined(family, cfg, ranks)
    want = dict(tree_items(_np_tree(jstate.params)))
    assert got.keys() == want.keys()
    for name, ref in want.items():
        g = got[name]
        if family == "gptneox" and name == _NOISY[0]:
            third = ref.shape[-1] // 3
            keep = np.r_[0:third, 2 * third:3 * third]
            g, ref = g[..., keep], ref[..., keep]
        np.testing.assert_allclose(g, ref, rtol=REL, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("ranks_n", [4, 2])
def test_vocab_parallel_cross_entropy_matches_jax(ranked, ranks_n):
    hidden, lm_head, targets = _ce_inputs()
    fns = {"dense": lambda h, w: jlosses.dense_softmax_xent(h, w, jnp.asarray(targets)),
           "chunked": lambda h, w: jlosses.chunked_softmax_xent(h, w, jnp.asarray(targets),
                                                                chunk=CE["chunk"])}
    n = CE["v"] // ranks_n
    for name, fn in fns.items():
        loss, (d_h, d_w) = jax.value_and_grad(fn, argnums=(0, 1))(jnp.asarray(hidden),
                                                                  jnp.asarray(lm_head))
        for r in ranked[("ce", ranks_n)]:
            got, t = r[name], r["tensor_index"]
            np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5, err_msg=name)
            np.testing.assert_allclose(got["d_hidden"], np.asarray(d_h), rtol=1e-4, atol=1e-7,
                                       err_msg=name)
            np.testing.assert_allclose(got["d_lm_head"], np.asarray(d_w)[:, t * n:(t + 1) * n],
                                       rtol=1e-4, atol=1e-7, err_msg=name)


def _orbax_params(step_dir_parent, step, cfg):
    ck = tck.OrbaxCheckpointer(str(step_dir_parent))
    return dict(tree_items(ck.restore_params(tllama.empty_params(cfg, "cpu"), step=step)))


def test_the_template_over_two_tensor_ranks_matches_jax(ranked):
    root = ranked["root"]
    ref = _jax_run(template_spec(root / "jax-entry", 7), 2)
    assert ref["n_devices"] == 2 and ref["resumed_from_step"] == 2
    for m in ranked[("entry", None)]:
        assert m["n_devices"] == 2 and m["resumed_from_step"] == 2 and m["checkpoint_saved"]
        assert len(m["loss_history"]) == 3
        np.testing.assert_allclose(m["loss_history"], ref["loss_history"], rtol=REL)
        assert m["tokens_per_sec_per_chip"] == m["tokens_per_sec"] / 2
    # the step the ranks wrote holds JAX's global arrays: its params equal
    # the ones JAX wrote from its sharded run
    cfg = tllama.config("tiny", dtype="float32")
    got = _orbax_params(root / "port-entry", 7, cfg)
    for name, ref_leaf in _orbax_params(root / "jax-entry", 7, cfg).items():
        np.testing.assert_allclose(got[name].numpy(), ref_leaf.numpy(), rtol=REL, atol=1e-6,
                                   err_msg=name)


def _whole_from_blocks(saved_by_rank):
    """The whole tensors (params, then moments, as bits) of a state whose
    tensor ranks returned their blocks."""
    cfg = tllama.config("tiny")
    order = {r["tensor_index"]: r for r in saved_by_rank}
    cuts = LeafCuts(tllama.logical_axes(cfg), TensorShard(0, 2), tllama.TENSOR_GROUPS)
    names = _leaf_order_paths(cfg)
    out = []
    for i in range(len(order[0]["tensors"])):
        path = names[i % len(names)]
        blocks = [torch.from_numpy(order[r]["tensors"][i]) for r in (0, 1)]
        out.append(cuts.join(path, blocks).numpy())
    return out


def _leaf_order_paths(cfg):
    """The tree path of each of ``llama.leaves``, in that order."""
    params = tllama.empty_params(cfg, "meta")
    path = {id(t): p for p, t in tree_items(params)}
    return [path[id(t)] for t in tllama.leaves(params)]


def _cut(bits, path, index, cfg):
    cuts = LeafCuts(tllama.logical_axes(cfg), TensorShard(index, 2), tllama.TENSOR_GROUPS)
    return cuts.take(path)(torch.from_numpy(bits)).contiguous().numpy()


@pytest.mark.parametrize("fmt", ["orbax", "npz"])
def test_a_tensor_sharded_step_restores_into_one_rank(ranked, fmt):
    """Tiny bf16 Llama trained 2 steps over {tensor: 2} and saved: the
    step holds the whole leaves (every rank's blocks joined), and one rank
    restores them bit for bit."""
    saved = ranked[("2to1", fmt)]
    assert [s["tensor_index"] for s in saved] == [0, 1]
    whole = _whole_from_blocks(saved)
    ck = str(ranked["root"] / f"2to1-{fmt}")
    assert tck.latest_step(ck) == 2
    got = workers.save_and_restore(ck, {}, fmt, "restore", 7)
    assert (got["step"], got["count"], got["schedule_count"]) == (
        saved[0]["step"], saved[0]["count"], saved[0]["schedule_count"])
    for a, b in zip(got["params"] + got["blocks"], whole):
        np.testing.assert_array_equal(a, b)


def test_jax_restores_a_tensor_sharded_orbax_step(ranked):
    whole = _whole_from_blocks(ranked[("2to1", "orbax")])
    jcfg = jllama.config("tiny")
    jopt = jtrainer.build_optimizer(1e-2, warmup_steps=1, total_steps=4)
    template = jtrainer.init_train_state(lambda: jllama.init(jax.random.PRNGKey(0), jcfg), jopt)
    ck = jck.Checkpointer(str(ranked["root"] / "2to1-orbax"))
    restored = ck.restore(template)
    ck.close()
    assert int(restored.step) == 2
    n = len(tllama.leaves(tllama.empty_params(tllama.config("tiny"), "meta")))
    names = _leaf_order_paths(tllama.config("tiny"))
    jparams = dict(tree_items(_np_tree(restored.params)))
    adam = restored.opt_state[1][0]
    jmu, jnu = dict(tree_items(_np_tree(adam.mu))), dict(tree_items(_np_tree(adam.nu)))
    for i, path in enumerate(names):
        for tree, offset in ((jparams, 0), (jmu, n), (jnu, 2 * n)):
            np.testing.assert_array_equal(np.asarray(tree[path]).view(np.int16),
                                          whole[offset + i], err_msg=path)


def test_a_one_rank_step_restores_over_two_tensor_ranks(ranked):
    saved = ranked["saved_by_one"]
    cfg = tllama.config("tiny")
    names = _leaf_order_paths(cfg)
    for got in ranked[("1to2", "orbax")]:
        assert (got["step"], got["count"], got["schedule_count"]) == (
            saved["step"], saved["count"], saved["schedule_count"])
        t = got["tensor_index"]
        for i, bits in enumerate(got["params"] + got["blocks"]):
            np.testing.assert_array_equal(
                bits, _cut(saved["tensors"][i], names[i % len(names)], t, cfg))


@pytest.mark.parametrize("family", ["llama", "gptneox"])
@pytest.mark.parametrize("size", [2, 4])
def test_join_undoes_take_for_every_leaf(family, size):
    fam = TFAMILIES[family]
    cfg = fam.config("tiny", n_heads=4) if family == "gptneox" else fam.config(
        "tiny", n_heads=8, n_kv_heads=4)
    gen = torch.Generator().manual_seed(0)
    whole = fam.init(gen, cfg, "cpu")
    blocks = [fam.init(torch.Generator().manual_seed(0), cfg, "cpu",
                       shard=TensorShard(r, size)) for r in range(size)]
    cuts = LeafCuts(fam.logical_axes(cfg), TensorShard(0, size), fam.TENSOR_GROUPS)
    by_rank = [dict(tree_items(b)) for b in blocks]
    for path, leaf in tree_items(whole):
        joined = cuts.join(path, [b[path] for b in by_rank])
        assert torch.equal(joined, leaf), path
        assert cuts.is_cut(path) == (by_rank[0][path].shape != leaf.shape), path
        assert cuts.whole_shape(path, by_rank[0][path].shape) == tuple(leaf.shape), path


def test_fsdp_peers_are_the_other_batch_axes_never_tensor(monkeypatch):
    """The gradient of a leaf gathered over fsdp is all-reduced over the
    other batch axes, a whole leaf's over every batch axis: never over
    tensor; both divided by the batch ranks."""
    monkeypatch.setattr(Mesh, "group", lambda self, *axes: axes)
    seen = []
    monkeypatch.setattr(Tr, "all_reduce_coalesced",
                        lambda ts, group: seen.append(group) or list(ts))
    grads = [torch.full((2,), 8.0), torch.full((3,), 4.0)]
    out = Tr.reduce_grads(grads, [True, False], Mesh(MeshPlan(data=2, fsdp=2, tensor=2)))
    assert seen == [("data", "sequence"), ("data", "fsdp", "sequence")]
    assert not any("tensor" in axes for axes in seen)
    # the divisor: the 4 ranks of other rows
    torch.testing.assert_close(out, [torch.full((2,), 2.0), torch.full((3,), 1.0)])


# each case's id is the one from when it was refused for item 4b, part
# three: training over sequence x tensor, the MLP over tensor and Mixtral
# over sequence x tensor run since (tests/test_torch_sequence_tensor.py), and
# each case now holds what still refuses beside those axes
@pytest.mark.parametrize("over,match,world", [
    # an attention other than the ring over the sequence axis beside tensor
    pytest.param(dict(model={"overrides": {"attn_impl": "flash"}},
                      parallelism={"sequence": 2, "tensor": 2}),
                 "attn_impl 'flash' over the sequence axis", 4,
                 id="over0-sequence axis together with the tensor axis .item 4b, part three-4"),
    # the MLP over tensor beside the pipeline axis (item 4d)
    pytest.param(dict(model={"family": "mlp", "preset": "small"},
                      parallelism={"pipeline": 2, "tensor": 2}), "pipeline axis .item 4d", 4,
                 id="over1-mlp family over the tensor axis .item 4b, part three-2"),
    # Mixtral over sequence beside a tensor axis its 2 kv heads do not tile
    # (item 4b part four: tests/test_torch_untiled_heads.py), beside the
    # pipeline axis (item 4d)
    pytest.param(dict(model={"family": "mixtral"},
                      parallelism={"pipeline": 2, "sequence": 2, "tensor": 4}),
                 "pipeline axis .item 4d", 16, id="mixtral-sequence-tensor-4b"),
    # GPT-NeoX's 4 heads over a tensor axis of 8 (item 4b part four), beside
    # the pipeline axis (item 4d). The id is the one the case was given when
    # it held the refusal of heads that do not tile the axis
    pytest.param(dict(model={"family": "gptneox", "preset": "tiny"},
                      parallelism={"pipeline": 2, "tensor": 8}), "pipeline axis .item 4d", 16,
                 id="over3-does not tile the model .q heads 4.*item 4b-8"),
])
def test_what_training_over_tensor_still_refuses(monkeypatch, over, match, world):
    from nexus_tpu_torch.runtime import entrypoints

    monkeypatch.setattr(entrypoints, "world_size", lambda: world)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda group=None: 0)
    spec = {"kind": "jax_xla", "mode": "train", "model": {"family": "llama", "preset": "tiny"},
            "train": {"batchSize": 2, "seqLen": 64, "steps": 2}}
    for key, val in over.items():
        spec[key] = {**spec.get(key, {}), **val}
    with pytest.raises(NotImplementedError, match=match):
        run_template_runtime(spec, device="cpu")


def test_a_mesh_over_part_of_the_world_refuses_subgroups():
    """``use_world``'s meshes run collectives over their whole world only."""
    from nexus_tpu_torch.parallel import mesh as M

    mesh = M.Mesh(M.MeshPlan(fsdp=2, tensor=2))
    mesh.world_group = object()  # as inside use_world
    with pytest.raises(ValueError, match="part of the initialised group"):
        mesh.group("tensor")
