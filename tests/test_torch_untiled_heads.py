"""Heads that do not tile the ``tensor`` axis (module item 4b, part four)
against the JAX package, float32 on the CPU.

A rank holds JAX's block of the flat heads × head_dim columns; where the
heads do not tile the axis it gathers the columns over the tensor group,
attends the whole heads its block touches (its span) and keeps its own
columns of the output (parallel/tensor.py::RankHeads).

In the main process: ``head_span`` over a set of (heads, head_dim, ranks),
the spans covering every column exactly once at the right offsets; the
kv span of a GQA rank whose q heads break the kernels' group rule.

One spawn of 8 gloo ranks (tests/torch_dist_workers.py::many) runs:

* three train steps against JAX's jitted step under the same mesh on the
  conftest's 8 CPU devices: tiny Llama over {tensor: 8} (half a q head and
  a quarter of a kv head a rank), GPT-NeoX over {tensor: 8}, Mixtral over
  {sequence: 2, tensor: 4} (the ring over the span's heads), Llama over
  {fsdp: 2, tensor: 4} (the fsdp blocks beside it), a GQA Llama of 6 / 3
  heads over {data: 4, tensor: 2}, whose ranks' q heads read their kv
  heads unevenly (one kv head a q head), and in a world of 4 Llama over
  {tensor: 4} (its kv heads split): every step's loss and grad norm and
  the whole parameters after the third, to 1e-4 relative;
* the teacher-forced logits of Llama and GPT-NeoX over {tensor: 8} through
  a dense cache at the rank's kv span against JAX's ``forward_decode``, to
  1e-4;
* ``run_template_runtime`` of both over {tensor: 8} from a JAX-written npz
  step: greedy infer (ids equal to those JAX's entry point generates on 8
  devices) and paged serve with the int8 pool and the host tier under pool
  pressure (ids equal to the port's one-rank run, the clock-free ledger to
  JAX's entry point on 8 devices);
* an Orbax step of Llama saved over {tensor: 8}, which JAX's checkpointer
  restores equal to the ranks' blocks joined, and which a restore over
  {tensor: 8} reads back as each rank's blocks and resumes with JAX's next
  loss.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.parallel import mesh as jmesh
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import data as jdata
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models.params import LeafCuts, tree_items
from nexus_tpu_torch.parallel.sharding import TensorShard, head_span
from nexus_tpu_torch.parallel.tensor import rank_heads
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

JFAMILIES = {"llama": jllama, "gptneox": jneox, "mixtral": jmix}
TFAMILIES = {"llama": tllama, "gptneox": tneox, "mixtral": tmix}
OPT = dict(learning_rate=3e-3, warmup_steps=1, total_steps=3, weight_decay=0.1)
REL = 1e-4
F32 = dict(dtype="float32")
# 6 q / 3 kv heads of 8: over 2 tensor ranks a rank's 3 q heads read kv
# heads 0, 0, 1 (or 1, 2, 2), which no group size maps
GQA = dict(F32, d_model=48, n_heads=6, n_kv_heads=3)
# (family, plan, port overrides): the 8-rank cases, then the 4-rank ones
STEP_CASES = [
    ("llama", {"tensor": 8}, F32),
    ("gptneox", {"tensor": 8}, F32),
    ("mixtral", {"sequence": 2, "tensor": 4}, dict(F32, attn_impl="ring")),
    ("llama", {"fsdp": 2, "tensor": 4}, dict(F32, remat=True, remat_policy="dots_attn")),
    ("llama", {"data": 4, "tensor": 2}, GQA),
    ("llama", {"tensor": 4}, F32),
]
# GPT-NeoX's key bias has a gradient of rounding noise (as in
# tests/test_torch_tensor_train.py): that third of b_qkv is left out
_NOISY = "layers/b_qkv"
SERVE = {"numRequests": 8, "promptLengthMin": 4, "promptLengthMax": 30, "maxNewMin": 3,
         "maxNewMax": 10, "sharedPrefixLength": 16, "kvBlockSize": 8, "chunk": 4,
         # 12 blocks of 8 for 4 rows of up to 40 positions: parked prefixes
         # spill into the host tier
         "kvNumBlocks": 12, "hostCacheBytes": 1 << 20, "hostCacheDtype": "int8",
         "kvPoolDtype": "int8", "admissionPolicy": "fifo"}
PROMPT = [7, 3, 11, 200, 31, 5, 64, 9, 17, 123]
CK_SEED = 7
SPAN_CASES = [(12, 64, 8), (4, 16, 8), (2, 16, 4), (8, 128, 16), (2, 16, 8), (32, 128, 64),
              (3, 64, 4)]


def _world(plan):
    return int(np.prod(list(plan.values())))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _case_id(case):
    family, plan, kw = case
    return "-".join([family, *(f"{a}{n}" for a, n in plan.items())]) + (
        "-gqa" if kw is GQA else "")


def _jax_kw(kw):
    out = {k: v for k, v in kw.items() if k not in ("remat", "remat_policy", "dtype",
                                                   "attn_impl")}
    return {**out, "dtype": jnp.float32, "attn_impl": "xla"}


def _inputs(family, kw):
    jcfg = JFAMILIES[family].config("tiny", **_jax_kw(kw))
    jparams = JFAMILIES[family].init(jax.random.PRNGKey(3), jcfg)
    data = jdata.synthetic_lm_batches(8, 32, jcfg.vocab_size, seed=5)
    return jcfg, jparams, [next(data) for _ in range(3)]


def _npz_step(family, directory):
    """A JAX-written npz step of the tiny model's init in float32."""
    jfam = JFAMILIES[family]
    cfg = jfam.config("tiny", dtype=jnp.float32)
    state = jtrainer.init_train_state(lambda: jfam.init(jax.random.PRNGKey(4), cfg),
                                      jtrainer.build_optimizer(3e-3, warmup_steps=0,
                                                               total_steps=8))
    jck.make_checkpointer(str(directory), fmt="npz").save(state, step=1, wait=True)
    return _np_tree(state.params)


def _spec(family, mode, directory, **block):
    return {"kind": "jax_xla", "mode": mode,
            "model": {"family": family, "preset": "tiny", "overrides": {"dtype": "float32"}},
            "parallelism": {"tensor": 8}, "train": {"batchSize": 4, "seqLen": 32, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(directory), "format": "npz"},
            **block}


def _entry_specs(root):
    return {(family, mode): _spec(family, mode, root / f"npz-{family}", **block)
            for family in ("llama", "gptneox")
            for mode, block in (("infer", {"infer": {"promptTokenIds": PROMPT,
                                                     "maxNewTokens": 6, "iterations": 1}}),
                                ("serve", {"serve": SERVE}))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("untiled-heads")
    a = {"root": root, "params": {f: _npz_step(f, root / f"npz-{f}")
                                  for f in ("llama", "gptneox")}}
    a["tokens"] = np.random.RandomState(8).randint(0, 256, size=(2, 12))
    a["specs"] = _entry_specs(root)
    return a


def _jax_entries(specs):
    """JAX's entry point on each entry spec on 8 devices, its generate's
    last output recorded (JAX's infer metrics carry no ids)."""
    out = {}
    for (family, mode), spec in specs.items():
        jfam, seen = JFAMILIES[family], []
        generate = jfam.generate

        def recording(*a, **kw):
            ids = generate(*a, **kw)
            seen.append(np.asarray(ids[0] if isinstance(ids, tuple) else ids))
            return ids

        jfam.generate = recording
        try:
            out[(family, mode)] = jax_run(jspec.JaxXlaRuntime.from_dict(spec),
                                          devices=jax.devices()[:8])
        finally:
            jfam.generate = generate
        out[(family, mode)]["generated"] = seen[-1] if seen else None
    return out


@pytest.fixture(scope="module")
def ranked(assets):
    """Every multi-rank case in one spawn of 8: {key: each rank's result};
    the references (JAX's steps and entry points, the port's one-rank
    serves) computed in this process while the ranks run, under "ref"."""
    root = assets["root"]
    calls, keys, worlds = [], [], [[], []]  # the 4-rank case in the first world of 4
    for i, (family, plan, kw) in enumerate(STEP_CASES):
        _, jparams, batches = _inputs(family, kw)
        call = ("fsdp_train_steps", (family, kw, _np_tree(jparams), batches, plan, OPT, 1))
        if _world(plan) == 8:
            calls.append(call)
            keys.append(("step", i))
        else:
            worlds[0].append(call)
    calls.append(("worlds", (worlds,)))
    for family in ("llama", "gptneox"):
        calls.append(("tp_logits", (family, F32, assets["params"][family], assets["tokens"])))
        keys.append(("logits", family))
    for key, spec in assets["specs"].items():
        calls.append(("tp_entry", (spec,)))
        keys.append(key)
    ck = str(root / "orbax")
    for mode in ("save", "restore"):
        calls.append(("model_save_and_restore", ("llama", F32, ck, {"tensor": 8}, "orbax", mode,
                                                 CK_SEED)))
        keys.append(("ck", mode))
    with ThreadPoolExecutor(2) as pool:
        running = pool.submit(spawn, workers.many, 8, (calls,), tmpdir=str(root),
                              timeout_s=400)
        # JAX's compiles release the interpreter: its steps beside its entries
        steps = pool.submit(lambda: {("step", i): _jax_steps(*case)
                                     for i, case in enumerate(STEP_CASES)})
        ref = {("logits", f): _jax_logits(assets, f) for f in ("llama", "gptneox")}
        ref.update(_jax_entries(assets["specs"]))
        ref.update({("one", f): run_template_runtime(
            dict(assets["specs"][(f, "serve")], parallelism={}), device="cpu")
            for f in ("llama", "gptneox")})
        ref["orbax"] = _jax_resume()
        ranks = running.result()
        ref.update(steps.result())
    at = calls.index(("worlds", (worlds,)))
    out = {key: [r[i if i < at else i + 1] for r in ranks] for i, key in enumerate(keys)}
    (small,) = [i for i, c in enumerate(STEP_CASES) if _world(c[1]) == 4]
    out[("step", small)] = [r[at][0] for r in ranks[:4]]
    out["ref"] = ref
    return out


# ------------------------------------------------------------- the spans


@pytest.mark.parametrize("heads,head_dim,size", SPAN_CASES)
def test_head_spans_cover_every_column_once(heads, head_dim, size):
    cols = heads * head_dim
    seen = np.zeros(cols, dtype=int)
    for r in range(size):
        span = head_span(heads, head_dim, r, size)
        start = span.first * head_dim + span.offset
        assert start == r * cols // size  # the block's first column
        block = cols // size
        assert span.offset + block <= span.heads * head_dim  # the block lies in the span
        assert (start + block - 1) // head_dim == span.last
        seen[start:start + block] += 1
    assert (seen == 1).all()
    if (heads, head_dim, size) == (12, 64, 8):  # Pythia-160M: every span 2 heads
        assert [head_span(12, 64, r, 8)[:2] for r in range(8)] == [
            (0, 1), (1, 2), (3, 4), (4, 5), (6, 7), (7, 8), (9, 10), (10, 11)]


def test_a_gqa_rank_reads_the_kv_heads_its_q_heads_read():
    # Llama-3-8B over 16: 2 whole q heads, half a kv head; q tiles, kv gathered
    h = rank_heads(32, 8, 128, 5, 16)
    assert (h.q[:2], h.kv[:2], h.gather_q, h.gather_kv, h.kv_index) == (
        (10, 11), (2, 2), False, True, None)
    assert (h.q_heads, h.kv_heads) == (2, 1)
    # the tiled heads: the rank's own, nothing gathered
    h = rank_heads(32, 8, 128, 3, 4)
    assert (h.q[:2], h.kv[:2], h.gather_q, h.gather_kv) == ((24, 31), (6, 7), False, False)
    # 6 / 3 heads over 2: q heads 0-2 read kv heads 0, 0, 1: one a q head
    h = rank_heads(6, 3, 8, 0, 2)
    assert (h.q[:2], h.kv[:2], h.kv_index, h.kv_heads) == ((0, 2), (0, 1), (0, 0, 1), 3)


# ----------------------------------------------------------- training


def _jax_steps(family, plan, kw):
    jcfg, jparams, batches = _inputs(family, kw)
    mesh = jmesh.build_mesh(jmesh.MeshPlan(**plan), jax.devices()[:_world(plan)])
    jfam = JFAMILIES[family]
    jopt = jtrainer.build_optimizer(**OPT)
    with mesh:
        jstate = jtrainer.init_train_state(lambda: jparams, jopt, mesh=mesh,
                                           logical_tree=jfam.logical_axes(jcfg))
        jstep = jtrainer.make_train_step(lambda p, b: jfam.loss_fn(p, jcfg, b), jopt,
                                         mesh=mesh, donate=False)
        losses, norms = [], []
        for batch in batches:
            jstate, m = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    return losses, norms, dict(tree_items(_np_tree(jstate.params)))


@pytest.mark.parametrize("case", STEP_CASES, ids=[_case_id(c) for c in STEP_CASES])
def test_train_steps_with_untiled_heads_match_jax(ranked, case):
    family, plan, kw = case
    heads = TFAMILIES[family].config("tiny", **kw)
    assert heads.n_kv_heads % plan["tensor"]  # the kv heads do not tile the axis
    i = STEP_CASES.index(case)
    ref_loss, ref_norm, want = ranked["ref"][("step", i)]
    ranks = ranked[("step", i)]
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


# ------------------------------------------------------ infer and serve


def _jax_logits(assets, family):
    """JAX's teacher-forced feed of the tokens into a dense cache, then one
    more token: both feeds' logits."""
    jfam = JFAMILIES[family]
    cfg = jfam.config("tiny", dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, assets["params"][family])
    tokens = jnp.asarray(assets["tokens"], jnp.int32)
    cache = jfam.init_kv_cache(cfg, tokens.shape[0], tokens.shape[1] + 4)
    first, cache = jfam.forward_decode(params, cfg, tokens, cache)
    nxt = jnp.argmax(first[:, -1], -1)[:, None]
    second, _ = jfam.forward_decode(params, cfg, nxt, cache)
    return {"prefill": np.asarray(first, np.float32), "step": np.asarray(second, np.float32)}


@pytest.mark.parametrize("family", ["llama", "gptneox"])
def test_teacher_forced_logits_over_tensor_8_match_jax(ranked, family):
    ref = ranked["ref"][("logits", family)]
    cfg = TFAMILIES[family].config("tiny", **F32)
    for rank, got in enumerate(ranked[("logits", family)]):
        for key, want in ref.items():
            err = np.abs(got[key] - want).max() / np.abs(want).max()
            assert err <= REL, (rank, key, err)
        # the dense cache holds the rank's kv span: the kv heads its q heads read
        span = head_span(cfg.n_heads, cfg.head_dim, rank, 8)
        assert got["heads"] == (span.heads, span.heads) == (1, 1)
        assert got["cache_heads"] == 1


def _clock_free(m):
    if isinstance(m, dict):
        return {k: _clock_free(v) for k, v in m.items()
                if not (str(k).endswith(("_s", "_seconds")) or "per_sec" in str(k)
                        or k in ("device", "device_kind"))}
    return m


def _common(port, ref):
    keys = [k for k in ref if k in port and k != "generated"]
    return _clock_free({k: port[k] for k in keys}), _clock_free({k: ref[k] for k in keys})


@pytest.mark.parametrize("family", ["llama", "gptneox"])
def test_infer_over_tensor_8_gives_jax_ids(ranked, family):
    ref = ranked["ref"][(family, "infer")]
    want = ref["generated"][:, len(PROMPT):].tolist()
    runs = ranked[(family, "infer")]
    assert len(runs) == 8
    for m in runs:
        assert m["n_devices"] == 8 and m["last_logits_finite"]
        assert m["completion_ids_by_row"] == want
        got, exp = _common(m, ref)
        assert got == exp


@pytest.mark.parametrize("family", ["llama", "gptneox"])
def test_serve_over_tensor_8_matches_jax_and_one_rank(ranked, family):
    one, ref = ranked["ref"][("one", family)], ranked["ref"][(family, "serve")]
    assert ref["spilled_blocks"] > 0 and ref["n_devices"] == 8
    for m in ranked[(family, "serve")]:
        assert m["completion_ids"] == one["completion_ids"]
        assert m["committed_tokens"] == m["budget_tokens"]
        got, exp = _common(m, ref)
        assert got == exp


# ---------------------------------------------------------- checkpoints


def _jax_resume():
    """What JAX resumes the tiny Llama's Orbax step with: its state's
    template, its jitted step (compiled on the template) and the batch past
    the step's two (Orbax imported here, beside the ranks)."""
    import orbax.checkpoint  # noqa: F401 (its import is the slow part of a restore)

    jcfg = jllama.config("tiny", dtype=jnp.float32)
    jopt = jtrainer.build_optimizer(1e-2, warmup_steps=1, total_steps=4)
    template = jtrainer.init_train_state(lambda: jllama.init(jax.random.PRNGKey(0), jcfg), jopt)
    data = jdata.synthetic_lm_batches(4, 16, jcfg.vocab_size, seed=CK_SEED)
    for _ in range(2):
        next(data)
    batch = {"tokens": jnp.asarray(next(data)["tokens"])}
    jstep = jtrainer.make_train_step(lambda p, b: jllama.loss_fn(p, jcfg, b), jopt,
                                     donate=False)
    jstep(template, batch)
    return template, jstep, batch


def test_an_orbax_step_saved_over_tensor_8_restores_in_jax(assets, ranked):
    saved, restored = ranked[("ck", "save")], ranked[("ck", "restore")]
    cfg = tllama.config("tiny", **F32)
    params = tllama.empty_params(cfg, "meta")
    path = {id(t): p for p, t in tree_items(params)}
    paths = [path[id(t)] for t in tllama.leaves(params)]
    cuts = LeafCuts(tllama.logical_axes(cfg), TensorShard(0, 8), tllama.TENSOR_GROUPS)
    n = len(paths)
    whole = [cuts.join(paths[i % n], [torch.from_numpy(r["tensors"][i].view(np.float32))
                                      for r in saved])
             for i in range(3 * n)]
    template, jstep, batch = ranked["ref"]["orbax"]
    ck = jck.Checkpointer(str(assets["root"] / "orbax"))
    state = ck.restore(template)
    ck.close()
    assert int(state.step) == 2
    jleaves = dict(tree_items(_np_tree(state.params)))
    for i, p in enumerate(paths):
        np.testing.assert_array_equal(jleaves[p], whole[i].numpy(), err_msg=p)
    # a restore over {tensor: 8}: each rank its blocks, bit for bit
    for rank, r in enumerate(restored):
        mine = LeafCuts(tllama.logical_axes(cfg), TensorShard(rank, 8), tllama.TENSOR_GROUPS)
        for i, (a, b) in enumerate(zip(r["params"] + r["blocks"], whole)):
            want = mine.take(paths[i % n])(b).contiguous().numpy().view(np.int32)
            np.testing.assert_array_equal(a.view(np.int32), want, err_msg=paths[i % n])
    # and resumes with JAX's next loss on the same batch
    _, m = jstep(state, batch)
    for r in restored:
        np.testing.assert_allclose(r["resumed_loss"], float(m["loss"]), rtol=REL)
