"""Mixtral and the ``expert`` axis over several ranks (module item 4c)
against the JAX package, float32 on the CPU unless a case says bf16.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs every
multi-rank case: the meshes of 4 ranks over the whole group, and those of
2 ranks in two worlds of 2 (``workers.worlds``) side by side:

* routing over the global token population: ``global_top_k_routing`` over
  {data: 2}, {sequence: 2} and {data: 2, fsdp: 2} equals JAX's
  ``top_k_routing`` of the whole token set (slots, valid flags, the
  dropped fraction, the mean of the ranks' aux losses), with selections
  dropped, where routing each rank's tokens alone would not;
* the tiny Mixtral's train step over {data: 2}, {sequence: 2} (the ring),
  {expert: 2}, {expert: 4}, {tensor: 2}, {fsdp: 2, expert: 2} and
  {expert: 2, tensor: 2} at a capacity factor under which JAX drops
  selections: every step's loss, aux, dropped fraction and grad norm, and
  the parameters after 3 steps (every rank's blocks joined), against JAX's
  jitted ``make_train_step`` under the same mesh on the conftest's CPU
  devices, to 1e-4 relative; the tiny Llama over {data: 2, expert: 2}, a
  replica axis for a dense family;
* ``run_template_runtime`` of ``examples/moe-mixtral-fanout.yaml`` at the
  tiny preset over 2 and 4 ranks (re-planned to {tensor: 2} and {tensor:
  4}, as JAX plans them) against JAX's on as many devices, both resuming
  one JAX-written step: losses and ``moe_dispatch``;
* Mixtral's decode over {tensor: 2}: logits and greedy tokens against
  JAX's, and the serving engine's tokens and ledger against JAX's engine;
* checkpoints: a bf16 {fsdp: 2, expert: 2} Orbax step restored by JAX and
  by one port rank bit for bit, and a one-rank step restored and resumed
  over {expert: 2}.

In the main process: ``ModelShard`` take / join / copies at {expert: 2,
tensor: 2}, init over ranks equal to one rank's draw, the norm's copies,
the gradients' peers that exclude ``expert``, and the dispatch rule.
"""

import copy
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.ops import moe as jmoe
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
from nexus_tpu_torch.parallel.sharding import ModelShard, model_shard
from nexus_tpu_torch.runtime.entrypoints import resolve_overrides
from nexus_tpu_torch.testing.dist import spawn
from nexus_tpu_torch.train import trainer as Tr

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JFAMILIES = {"llama": jllama, "mixtral": jmix}
TFAMILIES = {"llama": tllama, "mixtral": tmix}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
REL = 1e-4
# a capacity factor under which JAX drops selections in every case (the
# tiny preset's 4 experts at 1.25 drop few or none at these token counts,
# and a per-rank routing would then pass by accident)
CF = 0.5
MIX = dict(dtype="float32", attn_impl="xla", capacity_factor=CF)
# (family, mesh, port overrides): the dispatch, remat and the chunked loss
# spread over the cases. The ring case's JAX step runs dense attention
# under the same mesh (exact, as the ring is).
STEP_CASES = [
    ("mixtral", {"data": 2}, dict(MIX, dispatch_impl="scatter")),
    ("mixtral", {"sequence": 2}, dict(MIX, dispatch_impl="scatter", attn_impl="ring",
                                      sliding_window=12)),
    ("mixtral", {"expert": 2}, dict(MIX, dispatch_impl="scatter", remat=True,
                                    remat_policy="full")),
    ("mixtral", {"expert": 4}, dict(MIX, dispatch_impl="einsum")),
    ("mixtral", {"tensor": 2}, dict(MIX, dispatch_impl="einsum", remat=True,
                                    remat_policy="dots")),
    ("mixtral", {"fsdp": 2, "expert": 2}, dict(MIX, dispatch_impl="scatter", remat=True,
                                               remat_policy="dots_attn")),
    ("mixtral", {"expert": 2, "tensor": 2}, dict(MIX, dispatch_impl="einsum", ce_chunk=100,
                                                 remat=True, remat_policy="dots_attn")),
    ("llama", {"data": 2, "expert": 2}, dict(dtype="float32", attn_impl="xla")),
]
# routing: the global (B, S, E) logits, capacity over the global tokens
ROUTE = dict(b=4, s=8, e=4, k=2)
ROUTE_CASES = [{"data": 2}, {"sequence": 2}, {"data": 2, "fsdp": 2}]
# decode and serve over {tensor: 2} (the capacity factor of the preset)
DECODE_KW = dict(dtype="float32", attn_impl="xla")
ENGINE = dict(batch_size=2, max_len=64, kv_block_size=8, chunk=2, prefill_chunk=4)
CK_SEED = 7


def _case_id(case):
    family, plan, kw = case
    extra = [kw.get("dispatch_impl", "")] + [k for k in ("remat", "ce_chunk") if k in kw]
    return "-".join([family, *(f"{a}{n}" for a, n in plan.items()), *filter(None, extra)])


def _world(plan):
    return int(np.prod(list(plan.values())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_kw(family, kw):
    """The JAX config's overrides of a case: the ring's dense twin."""
    out = dict(kw)
    out.pop("remat", None), out.pop("remat_policy", None)
    if out.get("attn_impl") == "ring":
        out["attn_impl"] = "xla"
    return {**out, "dtype": jnp.float32}


def _step_inputs(family, kw):
    jcfg = JFAMILIES[family].config("tiny", **_jax_kw(family, kw))
    jparams = JFAMILIES[family].init(jax.random.PRNGKey(3), jcfg)
    data = jdata.synthetic_lm_batches(4, 32, jcfg.vocab_size, seed=5)
    return jcfg, jparams, [next(data)["tokens"] for _ in range(3)]


def _route_logits():
    rng = np.random.default_rng(13)
    return rng.standard_normal((ROUTE["b"], ROUTE["s"], ROUTE["e"])).astype(np.float32)


def _route_capacity(tokens):
    return jmoe.default_capacity(tokens, ROUTE["e"], ROUTE["k"], CF)


def _template(steps, ck_dir, kv_heads=None):
    """examples/moe-mixtral-fanout.yaml cut to the tiny preset in float32:
    its model overrides (remat, ce_chunk 8192) and a capacity factor that
    drops, its parallelism (re-planned for the ranks), synthetic data, 2
    rows of 32 tokens, its checkpoint block in ``ck_dir``; 4 ranks need 4
    kv heads (the tiny preset has 2)."""
    with open(os.path.join(ROOT, "examples", "moe-mixtral-fanout.yaml")) as f:
        rt = [d for d in yaml.safe_load_all(f) if d["kind"] == "NexusAlgorithmTemplate"]
    rt = copy.deepcopy(rt[0]["spec"]["runtime"])
    over = dict(rt["model"]["overrides"], dtype="float32", capacity_factor=CF)
    if kv_heads:
        over["n_kv_heads"] = kv_heads
    rt = dict(rt, tpu={}, data={}, profile={"enabled": False})
    rt["model"] = dict(rt["model"], preset="tiny", overrides=over)
    rt["train"] = {"batchSize": 2, "seqLen": 32, "steps": steps, "learningRate": 3e-3,
                   "warmupSteps": 1, "weightDecay": 0.1, "seed": 0}
    rt["checkpoint"] = dict(rt["checkpoint"], directory=str(ck_dir), intervalSteps=100)
    return rt


def _jax_run(spec, n_devices):
    from nexus_tpu.runtime.entrypoints import run_template_runtime as jrun

    return jrun(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:n_devices])


def _decode_inputs():
    jcfg = jmix.config("tiny", **_jax_kw("mixtral", DECODE_KW))
    return jcfg, _np_tree(jmix.init(jax.random.PRNGKey(9), jcfg))


def _serve_queue():
    rng = np.random.RandomState(3)
    return [(rng.randint(0, 256, size=n).tolist(), m) for n, m in ((9, 5), (5, 6), (12, 4),
                                                                    (7, 5))]


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
    root = tmp_path_factory.mktemp("moe-parallel")
    four, worlds = [], [[], []]
    keys4, keys2 = [], [[], []]

    def add(key, call, world, side=0):
        if world == 4:
            four.append(call)
            keys4.append(key)
        else:
            worlds[side].append(call)
            keys2[side].append(key)

    logits = _route_logits()
    for i, plan in enumerate(ROUTE_CASES):
        cap = _route_capacity(ROUTE["b"] * ROUTE["s"])
        add(("route", i), ("moe_routing", (logits, plan, cap, ROUTE["k"])), _world(plan), i % 2)
    for i, (family, plan, kw) in enumerate(STEP_CASES):
        _, jparams, batches = _step_inputs(family, kw)
        add(("step", i), ("model_train_steps", (family, kw, _np_tree(jparams), batches, plan,
                                                OPT)), _world(plan), i % 2)
    # decode and serve over {tensor: 2}
    _, dparams = _decode_inputs()
    tokens = np.random.RandomState(0).randint(0, 256, size=(2, 12)).astype(np.int64)
    add("logits", ("tp_logits", ("mixtral", DECODE_KW, dparams, tokens)), 2, 0)
    add("generate", ("tp_generate", ("mixtral", DECODE_KW, dparams, tokens[:, :6], 6)), 2, 1)
    add("engine", ("tp_engine", (DECODE_KW, dparams, _serve_queue(), ENGINE, "mixtral")), 2, 1)
    # the template: JAX trains 2 steps on one device and saves; both resume
    for n, kv in ((2, None), (4, 4)):
        _jax_run(_template(2, root / f"jax-entry-{n}", kv), 1)
        shutil.copytree(root / f"jax-entry-{n}", root / f"port-entry-{n}")
        add(("entry", n), ("run_entry", (_template(4, root / f"port-entry-{n}", kv),)), n, 0)
    # checkpoints: a bf16 {fsdp: 2, expert: 2} step; a one-rank f32 step
    # (saved here, before the spawn) restored and resumed over {expert: 2}
    add("ck-4to1", ("model_save_and_restore", ("mixtral", {"dtype": "bfloat16"},
                                               str(root / "4to1"), {"fsdp": 2, "expert": 2},
                                               "orbax", "save", CK_SEED)), 4)
    one = str(root / "1to2")
    saved_by_one = workers.model_save_and_restore("mixtral", {"dtype": "float32"}, one, {},
                                                  "orbax", "save", CK_SEED)
    add("ck-1to2", ("model_save_and_restore", ("mixtral", {"dtype": "float32"}, one,
                                               {"expert": 2}, "orbax", "restore", CK_SEED)),
        2, 0)
    four.append(("worlds", (worlds,)))
    ranks = spawn(workers.many, 4, (four,), tmpdir=str(root), timeout_s=400)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys4)}
    for w in (0, 1):
        for i, key in enumerate(keys2[w]):
            out[key] = [r[-1][i] for r in ranks[2 * w:2 * w + 2]]
    out.update(root=root, saved_by_one=saved_by_one, one=one)
    return out


# ----------------------------------------------------------------- routing


@pytest.mark.parametrize("i", range(len(ROUTE_CASES)),
                         ids=["-".join(f"{a}{n}" for a, n in p.items()) for p in ROUTE_CASES])
def test_routing_covers_the_global_token_population(ranked, i):
    logits = _route_logits()
    b, s, e, k = ROUTE["b"], ROUTE["s"], ROUTE["e"], ROUTE["k"]
    ref = jmoe.top_k_routing(jnp.asarray(logits.reshape(b * s, e)), k, _route_capacity(b * s))
    ref_slot = np.asarray(ref.slot_index).reshape(b, s, k)
    ref_valid = np.asarray(ref.valid).reshape(b, s, k)
    assert float(ref.dropped_fraction) > 0.1  # drops occur
    ranks = ranked[("route", i)]
    plan = ROUTE_CASES[i]
    rows, cols = plan.get("data", 1) * plan.get("fsdp", 1), plan.get("sequence", 1)
    bl, sl = b // rows, s // cols
    per_rank_differs = False
    for r in ranks:
        c = r["coords"]
        row = c["data"] * plan.get("fsdp", 1) + c["fsdp"]
        blk = (slice(row * bl, (row + 1) * bl), slice(c["sequence"] * sl,
                                                     (c["sequence"] + 1) * sl))
        np.testing.assert_array_equal(r["slot_index"], ref_slot[blk].reshape(-1, k))
        np.testing.assert_array_equal(r["valid"], ref_valid[blk].reshape(-1, k))
        np.testing.assert_array_equal(
            r["expert_index"], np.asarray(ref.expert_index).reshape(b, s, k)[blk].reshape(-1, k))
        np.testing.assert_allclose(r["dropped"], float(ref.dropped_fraction), rtol=1e-6)
        # routing this rank's tokens alone: local capacity, local slots
        local = jmoe.top_k_routing(jnp.asarray(logits[blk].reshape(-1, e)), k,
                                   _route_capacity(bl * sl))
        per_rank_differs |= not (np.array_equal(np.asarray(local.slot_index), r["slot_index"])
                                 and np.array_equal(np.asarray(local.valid), r["valid"]))
    assert per_rank_differs, "a per-rank routing would pass this case"
    # the mean of the ranks' local aux losses is the global one
    np.testing.assert_allclose(np.mean([r["aux"] for r in ranks]), float(ref.aux_loss),
                               rtol=1e-6)


# -------------------------------------------------------------- train steps


def _joined(family, cfg, plan, ranks):
    """The whole parameters from the blocks of the ranks whose batch
    coordinates are 0, by path (each leaf's cuts over the model axes)."""
    ne, nt = plan.get("expert", 1), plan.get("tensor", 1)
    fam = TFAMILIES[family]
    cuts = LeafCuts(fam.logical_axes(cfg), ModelShard((0, 0), (ne, nt)), fam.TENSOR_GROUPS)
    first = {(r["coords"]["expert"], r["coords"]["tensor"]): r["params"] for r in ranks
             if all(r["coords"][a] == 0 for a in ("data", "fsdp", "sequence"))}
    order = [first[(e, t)] for e in range(ne) for t in range(nt)]
    return {path: cuts.join(path, [torch.from_numpy(b[path]) for b in order]).numpy()
            for path in order[0]}


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_id(c) for c in STEP_CASES])
def test_train_steps_over_ranks_match_jax(ranked, case):
    family, plan, kw = case
    i = STEP_CASES.index(case)
    jcfg, jparams, batches = _step_inputs(family, kw)
    n = _world(plan)
    mesh = jmesh.build_mesh(jmesh.MeshPlan(**plan), jax.devices()[:n])
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
    assert len(ranks) == n
    for r in ranks:  # every rank reports the global metrics, the same ones
        for k in keys:
            np.testing.assert_allclose(r[k], ref[k], rtol=REL, err_msg=k)
            assert r[k] == ranks[0][k], k
    cfg = TFAMILIES[family].config("tiny", **kw)
    got = _joined(family, cfg, plan, ranks)
    want = dict(tree_items(_np_tree(jstate.params)))
    assert got.keys() == want.keys()
    for name, ref_leaf in want.items():
        np.testing.assert_allclose(got[name], ref_leaf, rtol=REL, atol=1e-6, err_msg=name)
    # the ranks that hold the same block of a leaf hold the same values
    n_model = plan.get("expert", 1) * plan.get("tensor", 1)
    paths = _leaf_paths(family, cfg)
    for r in ranks:
        for s in ranks:
            same_block = all(r["coords"][a] == s["coords"][a] for a in ("expert", "tensor"))
            for path, copies in zip(paths, r["copies"] or [1] * len(paths)):
                if same_block or copies == n_model:
                    np.testing.assert_array_equal(r["params"][path], s["params"][path], path)


def _leaf_paths(family, cfg):
    fam = TFAMILIES[family]
    params = fam.empty_params(cfg, "meta")
    path = {id(t): p for p, t in tree_items(params)}
    return [path[id(t)] for t in fam.leaves(params)]


def test_the_template_over_two_and_four_ranks_matches_jax(ranked):
    root = ranked["root"]
    for n, kv in ((2, None), (4, 4)):
        ref = _jax_run(_template(4, root / f"jax-entry-{n}", kv), n)
        assert ref["n_devices"] == n and ref["resumed_from_step"] == 2
        assert ref["moe_dispatch"] == "einsum"
        for m in ranked[("entry", n)]:
            assert m["n_devices"] == n and m["resumed_from_step"] == 2 and m["checkpoint_saved"]
            assert m["moe_dispatch"] == ref["moe_dispatch"]
            assert m["router_dropped_fraction"] > 0
            np.testing.assert_allclose(m["loss_history"], ref["loss_history"], rtol=REL)
            np.testing.assert_allclose(m["final_loss"], ref["final_loss"], rtol=REL)


# ------------------------------------------------------------ decode, serve


def test_decode_over_the_tensor_axis_matches_jax(ranked):
    jcfg, dparams = _decode_inputs()
    params = jax.tree.map(jnp.asarray, dparams)
    tokens = jnp.asarray(np.random.RandomState(0).randint(0, 256, size=(2, 12)), jnp.int32)
    cache = jmix.init_kv_cache(jcfg, 2, 16)
    first, cache = jmix.forward_decode(params, jcfg, tokens, cache)
    nxt = jnp.argmax(first[:, -1], axis=-1)[:, None].astype(jnp.int32)
    second, _ = jmix.forward_decode(params, jcfg, nxt, cache)
    for got in ranked["logits"]:
        assert got["heads"] == (jcfg.n_heads // 2, jcfg.n_kv_heads // 2)
        for name, ref in (("prefill", first), ("step", second)):
            ref = np.asarray(ref, dtype=np.float32)
            err = np.abs(got[name] - ref).max() / np.abs(ref).max()
            assert err <= 1e-5, (name, err)
    ids = np.asarray(jmix.generate(params, jcfg, tokens[:, :6], 6))
    for got in ranked["generate"]:
        np.testing.assert_array_equal(got["ids"], ids)


def _clock_free(m):
    """A metrics dict without its clocks and devices (recursively)."""
    if isinstance(m, dict):
        return {k: _clock_free(v) for k, v in m.items()
                if not (str(k).endswith(("_s", "_seconds")) or "per_sec" in str(k)
                        or k in ("device", "device_kind"))}
    return m


def test_the_engine_over_the_tensor_axis_matches_the_jax_engine(ranked):
    jcfg, dparams = _decode_inputs()
    clock = workers._FakeClock()
    eng = jserving.ServingEngine(jmix.forward_decode, jax.tree.map(jnp.asarray, dparams), jcfg,
                                 clock=clock, **ENGINE)
    res, met = eng.serve([jserving.ServeRequest(prompt=p, max_new_tokens=n)
                          for p, n in _serve_queue()], heartbeat=clock.tick)
    for run in ranked["engine"]:
        assert run["tokens"] == [[int(x) for x in r.tokens] for r in res]
        assert run["pool_heads"] == jcfg.n_kv_heads // 2
        keys = [k for k in met if k in run["metrics"]]
        assert _clock_free({k: run["metrics"][k] for k in keys}) == _clock_free(
            {k: met[k] for k in keys})


# ------------------------------------------------------------- checkpoints


def _whole_from_blocks(saved_by_rank, plan, cfg):
    """The whole tensors (params, then moments, as bits) of a state whose
    model-axes ranks returned theirs (one of each block)."""
    ne, nt = plan.get("expert", 1), plan.get("tensor", 1)
    cuts = LeafCuts(tmix.logical_axes(cfg), ModelShard((0, 0), (ne, nt)), tmix.TENSOR_GROUPS)
    by = {(s["coords"]["expert"], s["coords"]["tensor"]): s for s in saved_by_rank
          if s["coords"]["fsdp"] == 0 and s["coords"]["data"] == 0}
    order = [by[(e, t)] for e in range(ne) for t in range(nt)]
    paths = _leaf_paths("mixtral", cfg)
    out = []
    for i in range(len(order[0]["tensors"])):
        path = paths[i % len(paths)]
        blocks = [torch.from_numpy(r["tensors"][i]) for r in order]
        out.append(cuts.join(path, blocks).numpy())
    return out


def test_an_expert_sharded_step_restores_into_jax_and_one_rank(ranked):
    """Tiny bf16 Mixtral trained 2 steps over {fsdp: 2, expert: 2} and
    saved: the step holds the whole leaves, and both JAX and one port rank
    restore them bit for bit."""
    cfg = tmix.config("tiny", dtype="bfloat16")
    saved = ranked["ck-4to1"]
    whole = _whole_from_blocks(saved, {"expert": 2}, cfg)
    ck_dir = str(ranked["root"] / "4to1")
    got = workers.model_save_and_restore("mixtral", {"dtype": "bfloat16"}, ck_dir, {}, "orbax",
                                         "restore", CK_SEED)
    assert (got["step"], got["count"], got["schedule_count"]) == (
        saved[0]["step"], saved[0]["count"], saved[0]["schedule_count"])
    for a, b in zip(got["params"] + got["blocks"], whole):
        np.testing.assert_array_equal(a, b)
    jcfg = jmix.config("tiny")
    jopt = jtrainer.build_optimizer(1e-2, warmup_steps=1, total_steps=4)
    template = jtrainer.init_train_state(lambda: jmix.init(jax.random.PRNGKey(0), jcfg), jopt)
    ck = jck.Checkpointer(ck_dir)
    restored = ck.restore(template)
    ck.close()
    assert int(restored.step) == 2
    paths = _leaf_paths("mixtral", cfg)
    adam = restored.opt_state[1][0]
    trees = [dict(tree_items(_np_tree(t))) for t in (restored.params, adam.mu, adam.nu)]
    for i, path in enumerate(paths):
        for j, tree in enumerate(trees):
            np.testing.assert_array_equal(np.asarray(tree[path]).view(np.int16),
                                          whole[j * len(paths) + i], err_msg=path)


def test_a_one_rank_step_resumes_over_two_expert_ranks(ranked):
    saved = ranked["saved_by_one"]
    cfg = tmix.config("tiny", dtype="float32")
    paths = _leaf_paths("mixtral", cfg)
    one = workers.model_save_and_restore("mixtral", {"dtype": "float32"}, ranked["one"], {},
                                         "orbax", "restore", CK_SEED)
    for got in ranked["ck-1to2"]:
        assert (got["step"], got["count"], got["schedule_count"]) == (
            saved["step"], saved["count"], saved["schedule_count"])
        shard = ModelShard((got["coords"]["expert"], 0), (2, 1))
        cuts = LeafCuts(tmix.logical_axes(cfg), shard, tmix.TENSOR_GROUPS)
        for i, bits in enumerate(got["params"] + got["blocks"]):
            want = cuts.take(paths[i % len(paths)])(torch.from_numpy(saved["tensors"][i]))
            np.testing.assert_array_equal(bits, want.contiguous().numpy())
        np.testing.assert_allclose(got["resumed_loss"], one["resumed_loss"], rtol=1e-5)


# ----------------------------------------------------------- in the process


def test_join_undoes_take_over_expert_and_tensor():
    cfg = tmix.config("tiny")
    whole = tmix.init(torch.Generator().manual_seed(0), cfg, "cpu")
    shards = [ModelShard((e, t), (2, 2)) for e in range(2) for t in range(2)]
    blocks = [dict(tree_items(tmix.init(torch.Generator().manual_seed(0), cfg, "cpu",
                                        shard=s))) for s in shards]
    cuts = LeafCuts(tmix.logical_axes(cfg), shards[0], tmix.TENSOR_GROUPS)
    want_copies = {"layers/w_gate": 1, "layers/wq": 2, "layers/router": 4, "embed": 2}
    for path, leaf in tree_items(whole):
        assert torch.equal(cuts.join(path, [b[path] for b in blocks]), leaf), path
        assert cuts.whole_shape(path, blocks[0][path].shape) == tuple(leaf.shape), path
        if path in want_copies:
            assert cuts.copies(path) == want_copies[path], path
    # w_gate (L, E, d, f): experts over expert (dim 1), d_ff over tensor (dim 3)
    assert blocks[3]["layers/w_gate"].shape == (cfg.n_layers, 2, cfg.d_model, cfg.d_ff // 2)
    assert torch.equal(blocks[3]["layers/w_gate"],
                       whole["layers"]["w_gate"][:, 2:, :, cfg.d_ff // 2:])


def test_fsdp_peers_are_the_other_batch_axes_never_expert(monkeypatch):
    """A leaf gathered over fsdp (its gradient summed over fsdp by the
    gather's backward) is all-reduced over the other batch axes, a whole
    one over every batch axis: never over expert; both divided by the
    batch ranks."""
    monkeypatch.setattr(Mesh, "group", lambda self, *axes: axes)
    seen = []
    monkeypatch.setattr(Tr, "all_reduce_coalesced",
                        lambda ts, group: seen.append(group) or list(ts))
    grads = [torch.full((2,), 8.0), torch.full((3,), 4.0)]
    out = Tr.reduce_grads(grads, [True, False], Mesh(MeshPlan(data=2, fsdp=2, expert=2,
                                                               tensor=2)))
    assert seen == [("data", "sequence"), ("data", "fsdp", "sequence")]
    assert not any("expert" in axes for axes in seen)
    # the divisor: the 4 ranks of other rows
    torch.testing.assert_close(out, [torch.full((2,), 2.0), torch.full((3,), 1.0)])


def test_model_shard_of_a_mesh():
    mesh = Mesh(MeshPlan(fsdp=2, expert=2, tensor=2), rank=7)
    assert model_shard(mesh) == ModelShard((1, 1), (2, 2))
    assert model_shard(Mesh(MeshPlan(data=2, sequence=2), rank=1)) is None


@pytest.mark.parametrize("world,pin,want", [(1, None, "scatter"), (2, None, "einsum"),
                                            (4, None, "einsum"), (4, "scatter", "scatter")])
def test_dispatch_resolves_as_jax_on_each_mesh(world, pin, want):
    over = {} if pin is None else {"dispatch_impl": pin}
    assert resolve_overrides("mixtral", over, world=world)["dispatch_impl"] == want
