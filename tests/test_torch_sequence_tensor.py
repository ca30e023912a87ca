"""Training over ``sequence`` × ``tensor`` and the MLP family over
``tensor`` (module item 4b, part three) against the JAX package, float32
on the CPU.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs every
multi-rank case: those of 4 ranks over the whole group, the MLP over
{tensor: 2} in a world of 2 beside an idle one (``workers.worlds``):

* the train step of tiny Llama, GPT-NeoX and Mixtral over {sequence: 2,
  tensor: 2}: the ring over the sequence group of the rank's tensor index
  at the rank's heads, the vocab-parallel loss over the rank's column
  block of tokens, Mixtral's routing over the global token population
  (capacity factor 0.5, so JAX drops): every step's loss and grad norm
  (Mixtral: aux loss and dropped share) and the parameters after 3 steps
  (every rank's blocks joined) against JAX's jitted step under the same
  mesh on the conftest's CPU devices (its attention dense, exact as the
  ring is), to 1e-4 relative;
* ``run_template_runtime`` of the MLP ``small`` preset over {tensor: 2}
  (Orbax) and {fsdp: 2, tensor: 2} (npz), both resuming one JAX-written
  step: its losses against JAX's entry point on as many devices with the
  same parallelism, and the step the ranks save (JAX's global arrays),
  which JAX's checkpointer restores, against the one JAX saves.

In the main process: the MLP's random init over {tensor: 2} is each
rank's block of the one-rank init, the gradients' peers and the norm count
the copies right under {fsdp, sequence, tensor}.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.models import mlp as jmlp
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models import mlp as tmlp
from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
from nexus_tpu_torch.parallel.sharding import ModelShard, TensorShard, shard_params
from nexus_tpu_torch.testing.dist import spawn
from nexus_tpu_torch.train.trainer import sharded_norm

import torch_dist_workers as workers

JFAMILIES = {"llama": jllama, "gptneox": jneox, "mixtral": jmix}
TFAMILIES = {"llama": tllama, "gptneox": tneox, "mixtral": tmix}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
REL = 1e-4
SEQ_TP = {"sequence": 2, "tensor": 2}
RING = dict(dtype="float32", attn_impl="ring")
# (family, port overrides): remat, the chunked loss and both MoE dispatches
# spread over the cases; Mixtral's window cuts the ring (12 of 16 positions
# a rank) and its capacity factor makes JAX drop selections
STEP_CASES = [
    ("llama", dict(RING, remat=True, remat_policy="dots_attn", ce_chunk=100)),
    ("gptneox", dict(RING)),
    ("mixtral", dict(RING, capacity_factor=0.5, sliding_window=12, dispatch_impl="einsum",
                     ce_chunk=100)),
]
# GPT-NeoX's key bias has a gradient of rounding noise (as in
# tests/test_torch_tensor_train.py): that third of b_qkv is left out of the
# parameter comparison
_NOISY = ("layers/b_qkv", 1)
# the MLP template: the small preset (widths 64 → 256 → 256 → 32), 8 rows
MLP_STEPS = (2, 5)  # JAX trains and saves the first; both resume to the second
MLP_CASES = {"tensor2-orbax": ({"tensor": 2}, "orbax"),
             "fsdp2-tensor2-npz": ({"fsdp": 2, "tensor": 2}, "npz")}


def _world(plan):
    return int(np.prod(list(plan.values())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_kw(kw):
    """A case's JAX config overrides: the ring's dense twin, no remat."""
    out = {k: v for k, v in kw.items() if k not in ("remat", "remat_policy")}
    return {**out, "attn_impl": "xla", "dtype": jnp.float32}


def _step_inputs(family, kw):
    jcfg = JFAMILIES[family].config("tiny", **_jax_kw(kw))
    jparams = JFAMILIES[family].init(jax.random.PRNGKey(3), jcfg)
    data = jdata.synthetic_lm_batches(4, 32, jcfg.vocab_size, seed=5)
    return jcfg, jparams, [next(data)["tokens"] for _ in range(3)]


def mlp_spec(directory, steps, plan, fmt):
    return {"kind": "jax_xla", "mode": "train", "model": {"family": "mlp", "preset": "small"},
            "parallelism": plan,
            "train": {"batchSize": 8, "steps": steps, "learningRate": 1e-2, "warmupSteps": 1,
                      "weightDecay": 0.1, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(directory), "format": fmt,
                           "intervalSteps": 100}}


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
    root = tmp_path_factory.mktemp("seq-tp")
    four, keys4 = [], []
    for i, (family, kw) in enumerate(STEP_CASES):
        _, jparams, batches = _step_inputs(family, kw)
        four.append(("model_train_steps", (family, kw, _np_tree(jparams), batches, SEQ_TP,
                                           OPT)))
        keys4.append(("step", i))
    worlds, keys2 = [[], []], []
    for name, (plan, fmt) in MLP_CASES.items():
        first, last = MLP_STEPS
        _jax_run(mlp_spec(root / f"jax-{name}", first, {}, fmt), 1)
        shutil.copytree(root / f"jax-{name}", root / f"port-{name}")
        call = ("run_entry", (mlp_spec(root / f"port-{name}", last, plan, fmt),))
        if _world(plan) == 4:
            four.append(call)
            keys4.append(("mlp", name))
        else:
            worlds[0].append(call)
            keys2.append(("mlp", name))
    four.append(("worlds", (worlds,)))
    ranks = spawn(workers.many, 4, (four,), tmpdir=str(root), timeout_s=400)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys4)}
    for i, key in enumerate(keys2):
        out[key] = [r[-1][i] for r in ranks[:2]]
    out["root"] = root
    return out


def _joined(family, cfg, ranks):
    """The whole parameters from the blocks of the sequence-0 ranks."""
    fam = TFAMILIES[family]
    cuts = LeafCuts(fam.logical_axes(cfg), ModelShard((0, 0), (1, 2)), fam.TENSOR_GROUPS)
    first = {r["coords"]["tensor"]: r["params"] for r in ranks if r["coords"]["sequence"] == 0}
    order = [first[t] for t in range(2)]
    return {path: cuts.join(path, [torch.from_numpy(b[path]) for b in order]).numpy()
            for path in order[0]}


@pytest.mark.parametrize("case", STEP_CASES, ids=[c[0] for c in STEP_CASES])
def test_train_steps_over_sequence_and_tensor_match_jax(ranked, case):
    family, kw = case
    i = STEP_CASES.index(case)
    jcfg, jparams, batches = _step_inputs(family, kw)
    mesh = jmesh.build_mesh(jmesh.MeshPlan(**SEQ_TP), jax.devices()[:4])
    jopt = jtrainer.build_optimizer(**OPT)
    keys = ("loss", "grad_norm") + (("aux", "router_dropped_fraction")
                                    if family == "mixtral" else ())
    ref = {k: [] for k in keys}
    with mesh:
        jstate = jtrainer.init_train_state(lambda: jparams, jopt, mesh=mesh,
                                           logical_tree=JFAMILIES[family].logical_axes(jcfg))
        jstep = jtrainer.make_train_step(
            lambda p, b: JFAMILIES[family].loss_fn(p, jcfg, b), jopt, mesh=mesh, donate=False)
        for batch in batches:
            jstate, m = jstep(jstate, {"tokens": jnp.asarray(batch)})
            for k in keys:
                ref[k].append(float(m[k]))
    if family == "mixtral":
        assert min(ref["router_dropped_fraction"]) > 0.05  # JAX drops selections
    ranks = ranked[("step", i)]
    assert len(ranks) == 4
    for r in ranks:  # every rank reports the global metrics, the same ones
        for k in keys:
            np.testing.assert_allclose(r[k], ref[k], rtol=REL, err_msg=k)
            assert r[k] == ranks[0][k], k
    # the sequence ranks of one tensor index hold the same blocks
    for r in ranks:
        for s in ranks:
            if s["coords"]["tensor"] == r["coords"]["tensor"]:
                for path in r["params"]:
                    np.testing.assert_array_equal(r["params"][path], s["params"][path])
    cfg = TFAMILIES[family].config("tiny", **kw)
    got = _joined(family, cfg, ranks)
    want = dict(tree_items(_np_tree(jstate.params)))
    assert got.keys() == want.keys()
    for name, ref_leaf in want.items():
        g = got[name]
        if family == "gptneox" and name == _NOISY[0]:
            third = ref_leaf.shape[-1] // 3
            keep = np.r_[0:third, 2 * third:3 * third]
            g, ref_leaf = g[..., keep], ref_leaf[..., keep]
        np.testing.assert_allclose(g, ref_leaf, rtol=REL, atol=1e-6, err_msg=name)


def _jax_restored_params(directory, fmt, step):
    """The params of ``step`` under ``directory``, as JAX's checkpointer
    restores them into its own MLP train state."""
    jcfg = jmlp.config("small")
    jopt = jtrainer.build_optimizer(1e-2, warmup_steps=1, total_steps=MLP_STEPS[1])
    template = jtrainer.init_train_state(lambda: jmlp.init(jax.random.PRNGKey(0), jcfg), jopt)
    ck = jck.make_checkpointer(str(directory), fmt=fmt)
    restored = ck.restore(template, step=step)
    ck.close()
    assert int(restored.step) == step
    return dict(tree_items(_np_tree(restored.params)))


@pytest.mark.parametrize("name", sorted(MLP_CASES))
def test_the_mlp_over_the_tensor_axis_matches_jax_and_jax_restores_its_step(ranked, name):
    plan, fmt = MLP_CASES[name]
    n = _world(plan)
    root = ranked["root"]
    ref = _jax_run(mlp_spec(root / f"jax-{name}", MLP_STEPS[1], plan, fmt), n)
    assert ref["n_devices"] == n and ref["resumed_from_step"] == MLP_STEPS[0]
    runs = ranked[("mlp", name)]
    assert len(runs) == n
    for m in runs:
        assert m["n_devices"] == n and m["resumed_from_step"] == MLP_STEPS[0]
        assert m["checkpoint_saved"] and m["family"] == "mlp"
        np.testing.assert_allclose(m["loss_history"], ref["loss_history"], rtol=REL)
        assert m["loss_history"] == runs[0]["loss_history"]
    got = _jax_restored_params(root / f"port-{name}", fmt, MLP_STEPS[1])
    want = _jax_restored_params(root / f"jax-{name}", fmt, MLP_STEPS[1])
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_allclose(got[path], leaf, rtol=REL, atol=1e-6, err_msg=path)


def test_an_mlp_ranks_random_init_is_its_block_of_the_one_rank_init():
    cfg = tmlp.config("small")
    whole = tmlp.init(torch.Generator().manual_seed(7), cfg, "cpu")
    for r in range(2):
        shard = TensorShard(r, 2)
        local = tmlp.init(torch.Generator().manual_seed(7), cfg, "cpu", shard=shard)
        want = shard_params(whole, tmlp.logical_axes(cfg), shard, tmlp.TENSOR_GROUPS)
        assert isinstance(want["layers"], list)
        for (path, got), (_, ref) in zip(tree_items(local), tree_items(want)):
            assert got.shape[-1] * 2 == dict(tree_items(whole))[path].shape[-1], path
            assert torch.equal(got, ref), path


def test_fsdp_peers_and_the_norm_count_the_copies_under_sequence_and_tensor(monkeypatch):
    """Over {fsdp: 2, sequence: 2, tensor: 2}: the fsdp blocks' peers are the
    other batch axes (never tensor), the divisor their ranks; the norm sums
    each leaf's squares over fsdp and tensor and divides a replicated
    leaf's by its copies."""
    monkeypatch.setattr(Mesh, "group", lambda self, *axes: axes)
    mesh = Mesh(MeshPlan(fsdp=2, sequence=2, tensor=2))
    from nexus_tpu_torch.train import trainer as Tr

    peers = []
    monkeypatch.setattr(Tr, "all_reduce_coalesced",
                        lambda ts, group: peers.append(group) or list(ts))
    out = Tr.reduce_grads([torch.full((2,), 8.0)], [True], mesh)
    assert peers == [("data", "sequence")]
    torch.testing.assert_close(out[0], torch.full((2,), 2.0))  # over the 4 batch ranks
    seen = {}
    monkeypatch.setattr(Tr, "all_reduce", lambda x, group: seen.update(group=group) or x)
    cut, whole = torch.full((3,), 2.0), torch.full((2,), 3.0)
    norm = sharded_norm([cut, whole], [1, 2], mesh)
    assert seen["group"] == ("fsdp", "expert", "tensor")
    torch.testing.assert_close(norm, torch.sqrt(torch.tensor(12.0 + 18.0 / 2)))
