"""Training over several ranks (the mesh, the batch and sequence axes, ring
attention, parameters sharded over fsdp) against the JAX package, float32
on the CPU. One spawn of 4 gloo ranks runs every multi-rank case
(tests/torch_dist_workers.py::many):

* the train step of tiny GPT-NeoX and Llama with ``attn_impl: ring`` over
  {fsdp: 2, sequence: 2}: per-step loss and grad norm and the parameters
  after 3 steps (Llama's; see _NOISY_GRADIENTS) against JAX's jitted step
  on one device (sharding does not change the result), to 1e-4 relative;
* ``run_template_runtime`` over the same mesh, the long-context GPT-NeoX
  template and a Llama spec at the tiny preset, against JAX's
  ``run_template_runtime`` with the same parallelism on 4 of the conftest's
  devices: both resume one JAX-written step (the two packages draw their
  random weights differently) and train 5 more; per-step losses (and
  Llama's saved parameters) to 1e-4 relative;
* a Mixtral forward under its window with the ring over 2 ranks of
  {data: 2, sequence: 2} against JAX's dense forward;
* the fsdp gather's dtype buckets (parallel/fsdp.py).
"""

import dataclasses
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
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models.params import tree_items
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = {"fsdp": 2, "sequence": 2}
JFAMILIES = {"gptneox": jneox, "llama": jllama}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
# the Mixtral case: a window past one of the 16-token blocks; a capacity
# factor under which no token is dropped in either package (MoE over a
# sharded token axis, whose capacity JAX counts over the global tokens, is
# ROADMAP item 4c: this case checks the ring inside the block)
# Parameters are compared for Llama only: GPT-NeoX's key bias has a
# gradient that is rounding noise (softmax ignores a shift of a row's
# logits), which AdamW turns into updates of up to ~lr/10 of either sign in
# either package; its losses and grad norms are held all the same.
_NOISY_GRADIENTS = "gptneox: b_qkv's key third"
MIX_KW = dict(dtype="float32", attn_impl="ring", sliding_window=12, capacity_factor=8.0)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _step_case(family):
    jfam = JFAMILIES[family]
    jcfg = jfam.config("tiny", dtype=jnp.float32, attn_impl="ring")
    jparams = jfam.init(jax.random.PRNGKey(3), jcfg)
    data = jdata.synthetic_lm_batches(4, 32, jcfg.vocab_size, seed=5)
    batches = [next(data)["tokens"] for _ in range(3)]
    return jcfg, jparams, batches


def _long_context_runtime():
    with open(os.path.join(ROOT, "examples", "train-gptneox-long-context.yaml")) as f:
        return yaml.safe_load(f)["spec"]["runtime"]


def entry_spec(family, ck_dir, steps):
    """The long-context template (gptneox) or a Llama spec at the tiny
    preset in float32 over {fsdp: 2, sequence: 2}: synthetic data, an npz
    checkpoint in ``ck_dir``, 2 rows of 32 tokens."""
    if family == "gptneox":
        rt = dict(_long_context_runtime(), tpu={}, data={}, parallelism=PAR)
        rt["model"] = dict(rt["model"], preset="tiny",
                           overrides=dict(rt["model"]["overrides"], dtype="float32"))
    else:
        rt = {"kind": "jax_xla", "mode": "train", "parallelism": PAR,
              "model": {"family": "llama", "preset": "tiny", "overrides": {"dtype": "float32"}}}
    rt["train"] = {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                   "warmupSteps": 1, "weightDecay": 0.1, "seed": 0}
    rt["checkpoint"] = {"enabled": True, "directory": str(ck_dir), "format": "npz",
                        "intervalSteps": 100, "keep": 3, "resume": True}
    return rt


def _jax_run(spec, n_devices):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:n_devices])


# each leaf's shape and the dim its fsdp blocks cut
_BUCKETS = [((4, 5), 0), ((6,), 0), ((3, 4), 1), ((2,), 0), ((3, 2, 3), 1)]


def _bucket_arrays():
    """Leaves of two dtypes, of several sizes and cut dims, interleaved:
    the gather's buckets (one a dtype) must keep each leaf's blocks
    apart."""
    rng = np.random.default_rng(3)
    return [rng.standard_normal(s).astype(np.float32 if i % 2 else np.float64)
            for i, (s, _) in enumerate(_BUCKETS)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """Every multi-rank case in one spawn: {case: rank results}."""
    root = tmp_path_factory.mktemp("par")
    calls, keys = [], []
    for family in ("gptneox", "llama"):
        _, jparams, batches = _step_case(family)
        calls.append(("train_steps", (family, {"dtype": "float32", "attn_impl": "ring"},
                                      _np_tree(jparams), batches, PAR, OPT)))
        keys.append(("step", family))
        # JAX trains 2 steps on one device and saves; both packages resume
        _jax_run(entry_spec(family, root / f"jax-{family}", 2), 1)
        shutil.copytree(root / f"jax-{family}", root / f"port-{family}")
        calls.append(("run_entry", (entry_spec(family, root / f"port-{family}", 7),)))
        keys.append(("entry", family))
    jcfg = jmix.config("tiny", **{**MIX_KW, "dtype": jnp.float32})
    mix_params = jmix.init(jax.random.PRNGKey(4), jcfg)
    tokens = np.asarray(jax.random.randint(jax.random.PRNGKey(5), (2, 32), 0, jcfg.vocab_size))
    calls.append(("forward_logits", ("mixtral", MIX_KW, _np_tree(mix_params), tokens,
                                     {"data": 2, "sequence": 2})))
    keys.append(("mixtral", None))
    calls.append(("fsdp_gather_buckets", (PAR, _bucket_arrays(), [d for _, d in _BUCKETS])))
    keys.append(("buckets", None))
    ranks = spawn(workers.many, 4, (calls,), tmpdir=str(root))
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys)}
    out["root"] = root
    out["mixtral_inputs"] = (jcfg, mix_params, tokens)
    return out


@pytest.mark.parametrize("family", ["gptneox", "llama"])
def test_train_steps_over_fsdp_and_sequence_match_jax(four_ranks, family):
    jcfg, jparams, batches = _step_case(family)
    jopt = jtrainer.build_optimizer(**OPT)
    jstep = jtrainer.make_train_step(lambda p, b: JFAMILIES[family].loss_fn(p, jcfg, b), jopt,
                                     donate=False)
    jstate = jtrainer.init_train_state(lambda: jparams, jopt)
    ref_loss, ref_norm = [], []
    for batch in batches:
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(batch)})
        ref_loss.append(float(m["loss"]))
        ref_norm.append(float(m["grad_norm"]))
    ranks = four_ranks[("step", family)]
    for r in ranks:  # every rank reports the global metrics
        np.testing.assert_allclose(r["loss"], ref_loss, rtol=1e-4)
        np.testing.assert_allclose(r["grad_norm"], ref_norm, rtol=1e-4)
    if family == "gptneox":
        return  # see _NOISY_GRADIENTS
    want = dict(tree_items(_np_tree(jstate.params)))
    for r in ranks:  # and holds the same whole parameters
        assert r["params"].keys() == want.keys()
        for name, ref in want.items():
            np.testing.assert_allclose(r["params"][name], ref, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("family", ["gptneox", "llama"])
def test_entry_point_over_fsdp_and_sequence_matches_jax(four_ranks, family):
    root = four_ranks["root"]
    ref = _jax_run(entry_spec(family, root / f"jax-{family}", 7), 4)
    assert ref["n_devices"] == 4 and ref["resumed_from_step"] == 2
    ranks = four_ranks[("entry", family)]
    for m in ranks:
        assert m["n_devices"] == 4 and m["resumed_from_step"] == 2 and m["checkpoint_saved"]
        assert len(m["loss_history"]) == 3
        np.testing.assert_allclose(m["loss_history"], ref["loss_history"], rtol=1e-4)
        assert m["tokens_per_sec_per_chip"] == m["tokens_per_sec"] / 4
    if family == "gptneox":
        return  # see _NOISY_GRADIENTS
    with np.load(root / f"jax-{family}" / "7" / "params.npz") as a, \
            np.load(root / f"port-{family}" / "7" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            np.testing.assert_allclose(b[name], a[name], rtol=1e-4, atol=1e-6, err_msg=name)


def test_mixtral_ring_under_its_window_matches_dense_attention(four_ranks):
    jcfg, params, tokens = four_ranks["mixtral_inputs"]
    ref, _ = jmix.forward(params, dataclasses.replace(jcfg, attn_impl="xla"),
                          jnp.asarray(tokens))
    ref = np.asarray(ref)
    got = np.zeros_like(ref)
    for r in four_ranks[("mixtral", None)]:
        rows, cols = r["logits"].shape[:2]
        got[r["row0"]:r["row0"] + rows, r["col0"]:r["col0"] + cols] = r["logits"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_fsdp_gather_buckets_keep_each_leafs_blocks(four_ranks):
    """One collective a dtype over leaves of mixed dtypes, sizes and cut
    dims: each rank's blocks gather back into the whole leaves exactly,
    and its reduce-scattered gradients are its blocks of the sum over its
    fsdp group (rank r's whole gradients were the leaves times r + 1)."""
    arrays = _bucket_arrays()
    ranks = four_ranks[("buckets", None)]
    for r in ranks:
        for got, a in zip(r["gathered"], arrays):
            np.testing.assert_array_equal(got, a)
        assert r["dtypes"] == [str(torch.float64 if a.dtype == np.float64 else torch.float32)
                               for a in arrays]
        # its fsdp group: the ranks of its sequence index (rank = 2 fsdp + sequence)
        factor = sum(s["rank"] + 1 for s in ranks if s["rank"] % 2 == r["rank"] % 2)
        for got, a, (_, dim) in zip(r["blocks"], arrays, _BUCKETS):
            want = np.split(factor * a, 2, axis=dim)[r["fsdp_index"]]
            np.testing.assert_allclose(got, want, rtol=1e-6)
