"""Infer and serve over the batch axes beside ``tensor`` (module item 4b,
part three) against the JAX package and the port's own one-rank runs,
float32 on the CPU.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs every
case: those of 4 ranks over the whole group, those of 2 in two worlds of 2
side by side (``workers.worlds``). Each entry case restores a JAX-written
npz step of the tiny Llama (its draft's too), so both packages decode the
same weights:

* infer over {data: 2, tensor: 2} (the rows over data, the heads over
  tensor), {fsdp: 2}, {sequence: 2} (replicas: the decode reads its cache,
  never the ring) and a batch of 3 rows over {data: 2} (rows that do not
  tile the axis: replicas, as JAX replicates them): every row's greedy ids
  against JAX's ``generate`` of the same prompt and the port's one-rank
  run, and the clock-free metrics against JAX's entry point on as many
  of the conftest's devices with the same parallelism;
* a sampled infer over {data: 2, tensor: 2}: each row's draw is keyed by
  its global row, so every row equals the one-rank run's;
* a draft's speculative infer over {data: 2} (one fixed prompt): the
  speculation ledger summed over the rows' blocks equals JAX's;
* serve over {fsdp: 2, tensor: 2} with the int8 pool and the host tier
  under pool pressure (spilling), over {data: 2} with a draft, and the text path over
  {data: 2}: every rank's ids and the clock-free ledger (and the text)
  equal JAX's and the one-rank run's;
* a serve over {data: 2} whose second rank gets another first prompt,
  with ``NEXUS_SANITIZE`` armed: the lockstep audit, which now spans the
  replicas too, fires on both ranks.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import weights as jw
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.parallel.mesh import Mesh, MeshPlan
from nexus_tpu_torch.parallel.sharding import decode_rows
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

F32 = {"dtype": "float32"}
TEXT = {"dtype": "float32", "vocab_size": 640, "max_seq_len": 1024}
PROMPTS = ["the quick brown fox", "hello world, the market square at noon",
           "a third prompt of the queue", "and a fourth one"]
SMALL_SERVE = {"numRequests": 6, "promptLengthMin": 4, "promptLengthMax": 30, "maxNewMin": 3,
               "maxNewMax": 10, "sharedPrefixLength": 16, "kvBlockSize": 8, "chunk": 4}
# the pool: 12 blocks of 8 for 4 rows of up to 40 positions, so that parked
# prefixes spill into the host tier (a closed synthetic queue brings none
# back: tests/test_torch_tensor_parallel.py restores at the engine)
PRESSURE = dict(SMALL_SERVE, kvNumBlocks=12, hostCacheBytes=1 << 20, hostCacheDtype="int8",
                kvPoolDtype="int8", admissionPolicy="fifo", numRequests=8)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_step(directory, seed, **cfg_kw):
    """A JAX-written npz step of the tiny Llama's init; returns its params."""
    cfg = jllama.config("tiny", dtype=jnp.float32, **cfg_kw)
    state = jtrainer.init_train_state(lambda: jllama.init(jax.random.PRNGKey(seed), cfg),
                                      jtrainer.build_optimizer(3e-3, warmup_steps=0,
                                                               total_steps=8))
    jck.make_checkpointer(str(directory), fmt="npz").save(state, step=1, wait=True)
    return state.params


def _base(a, mode, par, batch=4, **block):
    return {"kind": "jax_xla", "mode": mode,
            "model": {"family": "llama", "preset": "tiny", "overrides": F32},
            "parallelism": par, "train": {"batchSize": batch, "seqLen": 32, "seed": 0},
            "checkpoint": {"enabled": True, "directory": str(a["llama"]), "format": "npz"},
            **block}


def _infer(a, par, batch=4, **kw):
    return _base(a, "infer", par, batch,
                 infer=dict({"promptLength": 12, "maxNewTokens": 6, "iterations": 1}, **kw))


def _specs(a):
    """{case: (runtime block, ranks)}."""
    draft = {"family": "llama", "preset": "tiny", "overrides": F32}
    text_model = {"family": "llama", "preset": "tiny", "overrides": TEXT,
                  "weights": {"format": "safetensors", "path": a["hf"], "tokenizer": a["tok"]}}
    return {
        "infer-data-tensor": (_infer(a, {"data": 2, "tensor": 2}), 4),
        "infer-fsdp": (_infer(a, {"fsdp": 2}), 2),
        "infer-sequence": (_infer(a, {"sequence": 2}), 2),
        "infer-untiled-rows": (_infer(a, {"data": 2}, batch=3), 2),
        "infer-sampled": (_infer(a, {"data": 2, "tensor": 2}, temperature=0.8), 4),
        "infer-draft": (_infer(a, {"data": 2}, promptTokenIds=[3, 4, 5, 3, 4, 5, 3, 4],
                               maxNewTokens=10, numSpeculative=3, draft=draft,
                               draftCheckpointDirectory=str(a["draft"])), 2),
        "serve-fsdp-tensor": (_base(a, "serve", {"fsdp": 2, "tensor": 2}, serve=PRESSURE), 4),
        "serve-data-draft": (_base(a, "serve", {"data": 2},
                                   serve=dict(SMALL_SERVE, numSpeculative=3, draft=draft,
                                              draftCheckpointDirectory=str(a["draft"]))), 2),
        "serve-text-data": ({"kind": "jax_xla", "mode": "serve", "model": text_model,
                             "parallelism": {"data": 2},
                             "train": {"batchSize": 2, "seqLen": 32, "seed": 0},
                             "serve": {"prompts": PROMPTS, "maxNewMax": 6, "chunk": 4,
                                       "kvBlockSize": 8}}, 2),
    }


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("batch-axes")
    a = {"llama": root / "llama", "draft": root / "draft"}
    a["llama_params"] = _np_tree(_jax_step(a["llama"], 3))
    _jax_step(a["draft"], 6)
    cfg = jllama.config("tiny", dtype=jnp.float32, vocab_size=640, max_seq_len=1024)
    a["hf"] = jw.export_hf_llama(jllama.init(jax.random.PRNGKey(5), cfg), cfg,
                                 str(root / "model.safetensors"))
    a["tok"] = cs.write_tokenizer_json(str(root / "tokenizer.json"))
    a["specs"] = _specs(a)
    a["root"] = root
    return a


@pytest.fixture(scope="module")
def ranked(assets):
    """Every case in one spawn of 4: {case: each rank's result}."""
    four, worlds, keys4, keys2 = [], [[], []], [], [[], []]
    side = 0
    for name, (spec, world) in assets["specs"].items():
        call = ("tp_entry", (spec,))
        if world == 4:
            four.append(call)
            keys4.append(name)
        else:
            worlds[side].append(call)
            keys2[side].append(name)
            side = 1 - side
    diverge = _base(assets, "serve", {"data": 2}, serve=dict(SMALL_SERVE, numRequests=3))
    worlds[side].append(("diverged_entry", (diverge, 1)))
    keys2[side].append("diverged")
    four.append(("worlds", (worlds,)))
    ranks = spawn(workers.many, 4, (four,), tmpdir=str(assets["root"]), timeout_s=400)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys4)}
    for w in (0, 1):
        for i, key in enumerate(keys2[w]):
            out[key] = [r[-1][i] for r in ranks[2 * w:2 * w + 2]]
    return out


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
    """Each case but the port-only sampled one in JAX, on as many of the
    conftest's CPU devices as the case has ranks, with its parallelism."""
    return {name: jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:world])
            for name, (spec, world) in assets["specs"].items() if name != "infer-sampled"}


@pytest.fixture(scope="module")
def one_rank(assets):
    """Each case on the port's one rank."""
    return {name: run_template_runtime(dict(spec, parallelism={}), device="cpu")
            for name, (spec, _) in assets["specs"].items()}


ENTRY_CASES = ["infer-data-tensor", "infer-fsdp", "infer-sequence", "infer-untiled-rows",
               "infer-draft", "serve-fsdp-tensor", "serve-data-draft", "serve-text-data"]


@pytest.mark.parametrize("case", ENTRY_CASES)
def test_each_case_equals_jax_and_the_one_rank_run(assets, ranked, jax_runs, one_rank, case):
    runs, ref, one = ranked[case], jax_runs[case], one_rank[case]
    world = assets["specs"][case][1]
    assert len(runs) == world
    ids = "completion_ids_by_row" if case.startswith("infer") else "completion_ids"
    for m in runs:  # every rank returns the whole batch's ids, the one-rank run's
        assert m[ids] == one[ids], case
        assert m["n_devices"] == ref["n_devices"] == world
        got, want = _common(m, ref)
        assert got == want, case
    if case.startswith("serve"):
        assert runs[0]["finished_requests"] == len(runs[0]["completion_ids"])
        assert runs[0]["committed_tokens"] == runs[0]["budget_tokens"]
    if case == "serve-text-data":
        assert runs[0]["completions"] == ref["completions"] and runs[0]["completions"]
    if case == "serve-fsdp-tensor":  # the host tier took the pool's evictions
        assert ref["spilled_blocks"] > 0
    if case == "infer-draft":
        assert runs[0]["rounds"] >= 1 and runs[0]["acceptance_rate"] == ref["acceptance_rate"]


@pytest.mark.parametrize("case", ["infer-data-tensor", "infer-fsdp", "infer-sequence",
                                  "infer-untiled-rows"])
def test_every_row_decodes_jax_greedy_ids(assets, ranked, case):
    """The port's prompt (every rank draws the whole batch from the seed
    and keeps its rows) through JAX's greedy ``generate``: every row's new
    ids."""
    spec, _ = assets["specs"][case]
    jcfg = jllama.config("tiny", dtype=jnp.float32)
    b, p = spec["train"]["batchSize"], spec["infer"]["promptLength"]
    prompt = torch.randint(0, jcfg.vocab_size, (b, p), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(spec["train"]["seed"]))
    out = jllama.generate(jax.tree.map(jnp.asarray, assets["llama_params"]), jcfg,
                          jnp.asarray(prompt.numpy()), spec["infer"]["maxNewTokens"])
    out = out[0] if isinstance(out, tuple) else out
    want = np.asarray(out)[:, p:].tolist()
    for m in ranked[case]:
        assert m["completion_ids_by_row"] == want
        assert m["output_shape"] == [b, p + spec["infer"]["maxNewTokens"]]


def test_sampled_rows_draw_as_the_one_rank_run(ranked, one_rank):
    """Each row's Gumbel draw is keyed by its global row: the rows a rank
    decodes sample what the one-rank run samples for them."""
    runs, one = ranked["infer-sampled"], one_rank["infer-sampled"]
    for m in runs:
        assert m["completion_ids_by_row"] == one["completion_ids_by_row"]
    greedy = ranked["infer-data-tensor"][0]["completion_ids_by_row"]
    assert one["completion_ids_by_row"] != greedy


def test_a_replica_that_diverges_fails_the_lockstep_audit(ranked):
    for message in ranked["diverged"]:
        assert message is not None and "lockstep audit (first admission" in message


@pytest.mark.parametrize("plan,batch,axes,blocks", [
    ({"data": 2, "tensor": 2}, 8, ("data",), [(0, 4), (0, 4), (4, 8), (4, 8)]),
    ({"data": 2, "fsdp": 2}, 8, ("data", "fsdp"), [(0, 2), (2, 4), (4, 6), (6, 8)]),
    # 2 rows do not tile data x fsdp = 4: over data alone
    ({"data": 2, "fsdp": 2}, 2, ("data",), [(0, 1), (0, 1), (1, 2), (1, 2)]),
    ({"fsdp": 2, "sequence": 2}, 6, ("fsdp",), [(0, 3), (0, 3), (3, 6), (3, 6)]),
    ({"data": 2}, 3, (), [(0, 3), (0, 3)]),
    ({"sequence": 2, "tensor": 2}, 4, (), [(0, 4)] * 4),
])
def test_decode_rows_follow_jax_cache_layout(plan, batch, axes, blocks):
    """JAX's ``batch_axes`` rule: (data, fsdp) where they tile the rows,
    else data where it does, else none; rows data-major."""
    for rank, (start, stop) in enumerate(blocks):
        rows = decode_rows(Mesh(MeshPlan(**plan), rank), batch)
        assert rows.axes == axes
        assert (rows.start, rows.stop, rows.total) == (start, stop, batch)
