"""Infer and serve over a sharded ``tensor`` axis (module item 4b, part one)
against the JAX package and against the port's own one-rank runs, float32
on the CPU.

In the main process, without ranks:

* ``shard_params``' blocks reassemble every leaf of tiny Llama and GPT-NeoX
  params (NeoX's ``wqkv`` / ``b_qkv`` block by block of each q, k, v third);
  each rank holds only its block of the leaves ``logical_axes`` puts on
  ``tensor``, and the replicated leaves whole;
* a rank's random init equals its block of the one-rank init.

One spawn of 2 gloo ranks (tests/torch_dist_workers.py::many) runs the rest:

* ``examples/infer-llama8b.yaml`` and ``serve-llama8b.yaml`` at the tiny
  preset (re-planned to {tensor: 2}, as JAX's rule plans 2 devices), the
  pretrained text path, GPT-NeoX's infer and serve, and a draft whose kv
  heads do not tile the axis (it runs whole on every rank): each against
  JAX's ``run_template_runtime`` on 2 of the conftest's devices with the
  same parallelism (the clock-free ledger, the text completions) and the
  port's one-rank run (every new token id);
* teacher-forced logits of both families against JAX's ``forward_decode``
  to 1e-5 relative;
* the engine's int8 pool and host tier against the JAX engine: tokens, the
  clock-free ledger, and the host stores' stats summed over the ranks;
* the tiny HF fixture and the JAX-written Orbax step loaded into shards.

A second spawn plants a divergence (one rank given another prompt): the
lockstep audit raises on every rank instead of hanging.
"""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke as cs
from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import serving as jserving
from nexus_tpu.runtime import weights as jw
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models.params import tree_items
from nexus_tpu_torch.parallel.sharding import TensorShard, shard_params
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORBAX_STEP = os.path.join(ROOT, "tests", "data", "orbax_llama_tiny", "orbax")
W = 2  # tensor ranks
F32 = {"dtype": "float32"}
# the tiny Llama behind the text paths (a vocabulary that holds the
# tokenizer's ids), as tests/test_torch_pretrained.py exports it
TEXT = {"dtype": "float32", "vocab_size": 640, "max_seq_len": 1024}
DRAFT = {"dtype": "float32", "n_kv_heads": 1}  # 1 kv head does not tile 2 ranks
PROMPTS = ["the quick brown fox", "hello world, the market square at noon"]
# the engine-level host tier (tests/test_torch_host_cache.py's pressure)
ENGINE = dict(batch_size=1, max_len=64, chunk=4, prefill_chunk=4, kv_block_size=8,
              kv_num_blocks=4, prefix_cache=True, admission_policy="fifo",
              host_cache_bytes=1 << 20)
ENGINE_CASES = {"native": dict(kv_pool_dtype="native", host_cache_dtype="native"),
                "int8": dict(kv_pool_dtype="int8", host_cache_dtype="int8")}
REL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _template(name):
    with open(os.path.join(ROOT, "examples", name)) as f:
        return yaml.safe_load(f)["spec"]["runtime"]


def _jax_step(directory, jfam, jcfg, seed):
    """A JAX-written npz step of ``jfam``'s init (the weights both
    packages' entry points restore); returns the params."""
    state = jtrainer.init_train_state(lambda: jfam.init(jax.random.PRNGKey(seed), jcfg),
                                      jtrainer.build_optimizer(3e-3, warmup_steps=0,
                                                               total_steps=8))
    jck.make_checkpointer(str(directory), fmt="npz").save(state, step=1, wait=True)
    return state.params


def _pressure_queue(seed=5, groups=2, repeats=3):
    rng = np.random.RandomState(seed)
    fams = [rng.randint(0, 256, size=16).tolist() for _ in range(groups)]
    return [(g + rng.randint(0, 256, size=4).tolist(), 4) for _ in range(repeats) for g in fams]


def _specs(a):
    """{case: the runtime block every package runs}."""
    infer = copy.deepcopy(_template("infer-llama8b.yaml"))
    # template: 8b, promptLength 128, 512 new tokens, 5 iterations, an Orbax
    # step of the 8B run; here the tiny preset from a JAX-written step
    infer["model"] = {"family": "llama", "preset": "tiny", "overrides": F32}
    infer["infer"].update(promptLength=16, maxNewTokens=8, iterations=1)
    infer["checkpoint"]["directory"] = str(a["llama"])
    serve = copy.deepcopy(_template("serve-llama8b.yaml"))
    # template: 8b from HF safetensors, 16 rows, 256 requests of up to 1024 +
    # 1024 tokens, a 192-token preamble, 32-slot blocks; here the tiny text
    # model from its HF export and the queue cut to the CPU (the fleet of 4
    # replicas, prompt lookup, the host tier and the trace kept)
    serve["model"] = {"family": "llama", "preset": "tiny", "overrides": TEXT,
                      "weights": {"format": "safetensors", "path": a["hf"],
                                  "tokenizer": a["tok"]}}
    serve["train"]["batchSize"] = 4
    serve["serve"].update(numRequests=10, promptLengthMin=8, promptLengthMax=64, maxNewMin=2,
                          maxNewMax=10, sharedPrefixLength=32, kvBlockSize=8, chunk=4,
                          prefillChunk=8, arrivalDurationSeconds=1.0)
    text = {"kind": "jax_xla", "model": serve["model"], "parallelism": {"tensor": W},
            "train": {"batchSize": 2, "seqLen": 32, "seed": 0}}

    def neox(mode, **block):
        return {"kind": "jax_xla", "mode": mode,
                "model": {"family": "gptneox", "preset": "tiny", "overrides": F32},
                "parallelism": {"tensor": W}, "train": {"batchSize": 2, "seqLen": 32, "seed": 0},
                "checkpoint": {"enabled": True, "directory": str(a["neox"]), "format": "npz"},
                **block}

    small_serve = {"numRequests": 5, "promptLengthMin": 4, "promptLengthMax": 30,
                   "maxNewMin": 3, "maxNewMax": 10, "sharedPrefixLength": 16, "kvBlockSize": 8}
    draft = {"kind": "jax_xla", "mode": "serve",
             "model": {"family": "llama", "preset": "tiny", "overrides": F32},
             "parallelism": {"tensor": W}, "train": {"batchSize": 2, "seqLen": 32, "seed": 0},
             "checkpoint": {"enabled": True, "directory": str(a["llama"]), "format": "npz"},
             "serve": dict(small_serve, numSpeculative=3, draftCheckpointDirectory=str(a["draft"]),
                           draft={"family": "llama", "preset": "tiny", "overrides": DRAFT})}
    orbax = copy.deepcopy(infer)  # the fixture's bf16 leaves, read into float32
    orbax["checkpoint"]["directory"] = ORBAX_STEP
    return {
        "infer-template": infer,
        "serve-template": serve,
        "infer-text": dict(text, mode="infer", infer={"prompt": PROMPTS[1], "maxNewTokens": 8,
                                                      "iterations": 1}),
        "serve-text": dict(text, mode="serve", serve={"prompts": PROMPTS, "maxNewMax": 6,
                                                      "chunk": 4, "kvBlockSize": 8}),
        "infer-neox": neox("infer", infer={"promptLength": 8, "maxNewTokens": 6,
                                           "iterations": 1}),
        "serve-neox": neox("serve", serve=small_serve),
        "serve-draft": draft,
        "infer-orbax": orbax,
    }


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("tensor-parallel")
    a = {}
    for name, jfam, cfg_kw, seed in (("llama", jllama, {}, 3), ("neox", jneox, {}, 4),
                                     ("draft", jllama, {"n_kv_heads": 1}, 6)):
        a[name] = root / name
        a[f"{name}_params"] = _np_tree(_jax_step(
            a[name], jfam, jfam.config("tiny", dtype=jnp.float32, **cfg_kw), seed))
    cfg = jllama.config("tiny", dtype=jnp.float32, vocab_size=640, max_seq_len=1024)
    a["hf"] = jw.export_hf_llama(jllama.init(jax.random.PRNGKey(5), cfg), cfg,
                                 str(root / "model.safetensors"))
    a["tok"] = cs.write_tokenizer_json(str(root / "tokenizer.json"))
    a["tokens"] = np.random.RandomState(0).randint(0, 256, size=(2, 12)).astype(np.int64)
    a["specs"] = _specs(a)
    return a


@pytest.fixture(scope="module")
def ranked(assets, tmp_path_factory):
    """Every multi-rank case in one spawn of W ranks: {case: each rank's
    result}."""
    calls = {name: ("tp_entry", (spec, name == "serve-draft"))
             for name, spec in assets["specs"].items()}
    calls["logits-llama"] = ("tp_logits", ("llama", F32, assets["llama_params"],
                                           assets["tokens"]))
    calls["logits-neox"] = ("tp_logits", ("gptneox", F32, assets["neox_params"],
                                          assets["tokens"]))
    for name, kw in ENGINE_CASES.items():
        calls[f"engine-{name}"] = ("tp_engine", (F32, assets["llama_params"], _pressure_queue(),
                                                 dict(ENGINE, **kw)))
    calls["loaded-hf"] = ("tp_loaded_blocks", ("llama", TEXT, assets["hf"], ""))
    calls["loaded-orbax"] = ("tp_loaded_blocks", ("llama", {}, "", ORBAX_STEP))
    by_rank = spawn(workers.many, W, (list(calls.values()),),
                    tmpdir=str(tmp_path_factory.mktemp("ranks")), timeout_s=300)
    return {name: [rank[i] for rank in by_rank] for i, name in enumerate(calls)}


# ------------------------------------------------------------ the blocks


def _whole(family, cfg, seed=0):
    return family.init(torch.Generator().manual_seed(seed), cfg, "cpu")


def _reassemble(blocks, dims, groups):
    """The whole leaf from the ranks' blocks, along its tensor dim (each
    of ``groups`` runs from every rank's block of it, in turn)."""
    axis = [i for i, d in enumerate(dims) if d in ("vocab", "mlp", "heads", "kv_heads", "qkv")]
    if not axis:
        assert all(torch.equal(b, blocks[0]) for b in blocks)
        return blocks[0]
    i = axis[0]
    runs = [b.chunk(groups, dim=i) for b in blocks]
    return torch.cat([r[g] for g in range(groups) for r in runs], dim=i)


@pytest.mark.parametrize("family,n", [(tllama, 2), (tneox, 2), (tneox, 4)],
                         ids=["llama-2", "gptneox-2", "gptneox-4"])
def test_shard_params_blocks_reassemble_the_whole_params(family, n):
    cfg = family.config("tiny", dtype="float32")
    whole = _whole(family, cfg)
    dims = dict(tree_items(family.logical_axes(cfg)))
    blocks = [dict(tree_items(shard_params(whole, family.logical_axes(cfg), TensorShard(r, n),
                                           family.TENSOR_GROUPS))) for r in range(n)]
    for path, leaf in tree_items(whole):
        got = [b[path] for b in blocks]
        cut = any(d in ("vocab", "mlp", "heads", "kv_heads", "qkv") for d in dims[path])
        # a cut leaf's block is 1/n of it, a replicated one whole
        assert got[0].numel() * (n if cut else 1) == leaf.numel(), path
        torch.testing.assert_close(
            _reassemble(got, dims[path], family.TENSOR_GROUPS.get(path, 1)), leaf.detach(),
            rtol=0, atol=0, msg=path)
    if family is tneox:
        # rank r's qkv columns are its heads of q, then of k, then of v
        d, hd = cfg.d_model, cfg.head_dim
        cols = d // n
        for r in range(n):
            for third in range(3):
                torch.testing.assert_close(
                    blocks[r]["layers/wqkv"][..., third * cols:(third + 1) * cols],
                    whole["layers"]["wqkv"][..., third * d + r * cols:third * d + (r + 1) * cols]
                    .detach(), rtol=0, atol=0)
        assert cols % hd == 0


@pytest.mark.parametrize("family", [tllama, tneox], ids=["llama", "gptneox"])
def test_a_ranks_random_init_is_its_block_of_the_one_rank_init(family):
    cfg = family.config("tiny", dtype="bfloat16")
    whole = _whole(family, cfg, seed=7)
    for r in range(2):
        shard = TensorShard(r, 2)
        local = family.init(torch.Generator().manual_seed(7), cfg, "cpu", shard=shard)
        want = shard_params(whole, family.logical_axes(cfg), shard, family.TENSOR_GROUPS)
        for (path, got), (_, ref) in zip(tree_items(local), tree_items(want)):
            assert torch.equal(got, ref), path


# ------------------------------------------------------- against JAX


def _clock_free(m):
    """A metrics dict without its clocks and devices (recursively)."""
    if isinstance(m, dict):
        return {k: _clock_free(v) for k, v in m.items()
                if not (str(k).endswith(("_s", "_seconds")) or "per_sec" in str(k)
                        or k in ("device", "device_kind"))}
    return m


def _common(port, ref):
    keys = [k for k in ref if k in port]
    return _clock_free({k: port[k] for k in keys}), _clock_free({k: ref[k] for k in keys})


@pytest.fixture(scope="module")
def jax_runs(assets):
    """Each entry case in JAX on W of the conftest's CPU devices (the same
    parallelism: every template re-plans to {tensor: W} there too)."""
    return {name: jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:W])
            for name, spec in assets["specs"].items()}


@pytest.mark.parametrize("case", ["infer-template", "serve-template", "infer-text",
                                  "serve-text", "infer-neox", "serve-neox", "serve-draft",
                                  "infer-orbax"])
def test_each_entry_case_equals_jax_and_the_one_rank_run(assets, ranked, jax_runs, case):
    runs, ref = ranked[case], jax_runs[case]
    spec = assets["specs"][case]
    one = run_template_runtime(dict(spec, parallelism={}), device="cpu")
    # every rank returns the same ids, those of the one-rank run
    for m in runs:
        assert m["completion_ids"] == one["completion_ids"], case
        assert m["n_devices"] == ref["n_devices"] == W
    # the ledger (and the text completions) of JAX on a {tensor: W} mesh
    got, want = _common(runs[0], ref)
    assert got == want, case
    if case.endswith("-text"):
        key = "completion" if case.startswith("infer") else "completions"
        assert runs[0][key] == ref[key] and runs[0][key]
    if case.startswith("serve"):
        assert runs[0]["finished_requests"] == len(runs[0]["completion_ids"])
        assert runs[0]["committed_tokens"] == runs[0]["budget_tokens"]


def test_the_infer_template_decodes_jax_greedy_ids(assets, ranked):
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    spec = assets["specs"]["infer-template"]
    b, p = spec["train"]["batchSize"], spec["infer"]["promptLength"]
    prompt = torch.randint(0, jcfg.vocab_size, (b, p), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(spec["train"]["seed"]))
    out = jllama.generate(jax.tree.map(jnp.asarray, assets["llama_params"]), jcfg,
                          jnp.asarray(prompt.numpy()), spec["infer"]["maxNewTokens"])
    out = out[0] if isinstance(out, tuple) else out
    assert ranked["infer-template"][0]["completion_ids"] == [int(t) for t in out[0, p:]]


@pytest.mark.parametrize("family,jfam,key", [("llama", jllama, "llama_params"),
                                             ("neox", jneox, "neox_params")])
def test_teacher_forced_logits_equal_jax(assets, ranked, family, jfam, key):
    jcfg = jfam.config("tiny", dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, assets[key])
    tokens = jnp.asarray(assets["tokens"], dtype=jnp.int32)
    cache = jfam.init_kv_cache(jcfg, tokens.shape[0], tokens.shape[1] + 4)
    first, cache = jfam.forward_decode(params, jcfg, tokens, cache)
    nxt = jnp.argmax(first[:, -1], axis=-1)[:, None].astype(jnp.int32)
    second, _ = jfam.forward_decode(params, jcfg, nxt, cache)
    for r, got in enumerate(ranked[f"logits-{family}"]):
        # each rank holds its heads and a cache of them, and sees the
        # whole logits
        assert got["heads"] == (jcfg.n_heads // W, getattr(jcfg, "n_kv_heads", jcfg.n_heads) // W)
        assert got["cache_heads"] == got["heads"][1]
        for name, ref in (("prefill", first), ("step", second)):
            ref = np.asarray(ref, dtype=np.float32)
            err = np.abs(got[name] - ref).max() / np.abs(ref).max()
            assert err <= REL, (family, r, name, err)


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_the_engine_pool_and_host_tier_equal_the_jax_engine(assets, ranked, case):
    """The int8 or native pool with a host tier under pressure: tokens, the
    clock-free ledger, and the stores' stats summed over the ranks."""
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    clock = workers._FakeClock()
    eng = jserving.ServingEngine(jllama.forward_decode,
                                 jax.tree.map(jnp.asarray, assets["llama_params"]), jcfg,
                                 clock=clock, **ENGINE, **ENGINE_CASES[case])
    res, met = eng.serve([jserving.ServeRequest(prompt=p, max_new_tokens=n)
                          for p, n in _pressure_queue()], heartbeat=clock.tick)
    runs = ranked[f"engine-{case}"]
    for run in runs:
        assert run["tokens"] == [[int(x) for x in r.tokens] for r in res]
        assert run["pool_heads"] == jcfg.n_kv_heads // W
        got, want = _common(run["metrics"], met)
        assert got == want
    assert met["spilled_blocks"] > 0 and met["restored_blocks"] > 0
    jstats = eng.last_host_store.stats()
    for key in ("bytes", "bytes_peak", "budget_bytes"):
        assert sum(run["host"][key] for run in runs) == jstats[key], key
    for key in ("entries", "puts", "takes", "drops"):
        assert all(run["host"][key] == jstats[key] for run in runs), key


def test_the_hf_fixture_and_an_orbax_step_load_into_shards(assets, ranked):
    from nexus_tpu_torch.runtime.weights import load_pretrained
    from nexus_tpu_torch.train.checkpoint import make_checkpointer

    for case, cfg, whole in (
            ("loaded-hf", tllama.config("tiny", **TEXT),
             lambda cfg: load_pretrained("llama", assets["hf"], cfg, "cpu")),
            ("loaded-orbax", tllama.config("tiny"),
             lambda cfg: make_checkpointer(ORBAX_STEP, fmt="auto").restore_params(
                 tllama.empty_params(cfg, "cpu"), step=1))):
        key = "hf" if case == "loaded-hf" else "ck"
        whole_params = whole(cfg)
        for r, run in enumerate(ranked[case]):
            want = shard_params(whole_params, tllama.logical_axes(cfg), TensorShard(r, W))
            for path, leaf in tree_items(want):
                np.testing.assert_array_equal(run[key][path], leaf.detach().float().numpy(),
                                              err_msg=f"{case} rank {r} {path}")


def test_a_planted_divergence_fails_the_lockstep_audit(assets, tmp_path):
    with pytest.raises(RuntimeError, match="lockstep audit") as info:
        spawn(workers.tp_diverge, W, (F32, assets["llama_params"], _pressure_queue()[:3], 1),
              tmpdir=str(tmp_path), timeout_s=60)
    # every rank saw the mismatch at the same boundary
    assert str(info.value).count("lockstep audit") == W
