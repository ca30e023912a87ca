"""Mixtral infers and serves over the ``expert`` axis (module item 4c, part
two), its decode routes the whole batch when infer splits the rows, and a
training rank's expert buffers hold its own selections only (part three):
against the JAX package and the port's own one-rank runs, float32 on the
CPU.

One spawn of 4 gloo ranks (tests/torch_dist_workers.py::many) runs every
multi-rank case: those of 4 ranks over the whole group, those of 2 in two
worlds of 2 side by side (``workers.worlds``). The Mixtral cases restore a
JAX-written npz step of the tiny preset, so both packages decode the same
weights:

* the repaired fault: infer over {data: 2} of one prompt in 8 rows, whose
  identical rows overflow their experts' capacity, so that a rank routing
  its own rows alone drops other selections than JAX's routing of the
  whole feed: every row's ids against JAX's ``run_template_runtime`` on 2
  of the conftest's devices (its generate's output, recorded), the
  clock-free metrics too; and each rank's teacher-forced logits of its
  rows of a random batch (a prefill, then one position a feed) against
  JAX's ``forward_decode`` of the whole batch;
* infer over {data: 2, expert: 2} and {expert: 2, tensor: 2}: every row's
  ids against JAX's ``generate`` of the port's prompt and the port's
  one-rank run, the clock-free metrics against JAX's entry point;
* serve over {expert: 2, tensor: 2} with the int8 pool and the host tier
  under pool pressure: ids and the clock-free ledger against JAX's entry
  point and the one-rank run;
* against the port's one-rank run: a speculative infer over {data: 2}
  with a Llama draft, and with the target as its own draft, whose rows
  accept unevenly (the rounds run in step over the rows' ranks), a Llama
  serve over {expert: 2} (its expert ranks are replicas), and infer over
  {expert: 2} from an Orbax step (written by the port) and from HF
  safetensors (written by JAX).

In the main process: the expert buffers of a training rank at {fsdp: 2,
expert: 2} shapes with drops hold C_local rows, the most valid selections
any of its experts keeps, and give the outputs and gradients of the
C_global buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.ops import moe as jmoe
from nexus_tpu.runtime import weights as jw
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu.train import checkpoint as jck
from nexus_tpu.train import trainer as jtrainer
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.ops import moe as tmoe
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.testing.dist import spawn

import torch_dist_workers as workers

F32 = {"dtype": "float32", "attn_impl": "xla"}
LLAMA = {"family": "llama", "preset": "tiny", "overrides": {"dtype": "float32"}}
SERVE = {"numRequests": 8, "promptLengthMin": 4, "promptLengthMax": 30, "maxNewMin": 3,
         "maxNewMax": 10, "sharedPrefixLength": 16, "kvBlockSize": 8, "chunk": 4,
         # 12 blocks of 8 for 4 rows of up to 40 positions: parked prefixes
         # spill into the host tier
         "kvNumBlocks": 12, "hostCacheBytes": 1 << 20, "hostCacheDtype": "int8",
         "kvPoolDtype": "int8", "admissionPolicy": "fifo"}
# one prompt in every row: 8 identical tokens a decode step choose the same
# two of the 4 experts, past the capacity of 5 a step (a rank's 4 rows alone:
# 2), so that where a routing cuts the rows decides which selections drop
FAULT_PROMPT = [7, 3, 11, 200, 31, 5, 64, 9, 17, 123]
# the teacher-forced batch: 8 random rows of 12, the last 4 fed one a feed
LOGIT_STEPS = 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _mixtral_step(directory, seed):
    """A JAX-written npz step of the tiny Mixtral's init; its params."""
    cfg = jmix.config("tiny", dtype=jnp.float32)
    state = jtrainer.init_train_state(lambda: jmix.init(jax.random.PRNGKey(seed), cfg),
                                      jtrainer.build_optimizer(3e-3, warmup_steps=0,
                                                               total_steps=8))
    jck.make_checkpointer(str(directory), fmt="npz").save(state, step=1, wait=True)
    return _np_tree(state.params)


def _spec(a, mode, par, batch=8, family="mixtral", **block):
    model = {"family": family, "preset": "tiny",
             "overrides": F32 if family == "mixtral" else LLAMA["overrides"]}
    spec = {"kind": "jax_xla", "mode": mode, "model": model, "parallelism": par,
            "train": {"batchSize": batch, "seqLen": 32, "seed": 0}, **block}
    if family == "mixtral":
        spec["checkpoint"] = {"enabled": True, "directory": str(a["npz"]), "format": "npz"}
    return spec


def _infer(a, par, **kw):
    return _spec(a, "infer", par,
                 infer=dict({"promptLength": 10, "maxNewTokens": 6, "iterations": 1}, **kw))


def _specs(a):
    """{case: (runtime block, ranks)} of the entry-point cases."""
    orbax = _infer(a, {"expert": 2})
    orbax["checkpoint"] = {"enabled": True, "directory": str(a["orbax"]), "format": "orbax"}
    hf = _infer(a, {"expert": 2})
    hf["model"] = dict(hf["model"], weights={"format": "safetensors", "path": a["hf"]})
    return {
        "fault-data": (_infer(a, {"data": 2}, promptTokenIds=FAULT_PROMPT), 2),
        "infer-data-expert": (_infer(a, {"data": 2, "expert": 2}), 4),
        "infer-expert-tensor": (_infer(a, {"expert": 2, "tensor": 2}), 4),
        "serve-expert-tensor": (_spec(a, "serve", {"expert": 2, "tensor": 2}, batch=4,
                                      serve=SERVE), 4),
        "infer-draft-data": (_infer(a, {"data": 2}, maxNewTokens=12, numSpeculative=3,
                                    draft=LLAMA), 2),
        # the target as its own draft: the verify feeds route k + 1 tokens a
        # row, the draft's feeds one, so capacity parts them now and then and
        # the rows' blocks finish after different rounds
        "infer-self-draft-data": (_infer(a, {"data": 2}, maxNewTokens=12, numSpeculative=3,
                                         draft={"family": "mixtral", "preset": "tiny",
                                                "overrides": F32},
                                         draftCheckpointDirectory=str(a["npz"])), 2),
        "serve-llama-expert": (_spec(a, "serve", {"expert": 2}, batch=4, family="llama",
                                     serve=dict(SERVE, numRequests=6)), 2),
        "infer-orbax-expert": (orbax, 2),
        "infer-hf-expert": (hf, 2),
    }


# the cases JAX's entry point runs on as many of the conftest's devices
JAX_CASES = ("fault-data", "infer-data-expert", "infer-expert-tensor", "serve-expert-tensor")


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("expert-serving")
    a = {"root": root, "npz": root / "npz", "orbax": root / "orbax"}
    a["params"] = _mixtral_step(a["npz"], 3)
    cfg = jmix.config("tiny", dtype=jnp.float32)
    a["hf"] = jw.export_hf_mixtral(jax.tree.map(jnp.asarray, a["params"]), cfg,
                                   str(root / "model.safetensors"))
    # an Orbax step the port writes: one step of the tiny Mixtral
    run_template_runtime({"kind": "jax_xla", "mode": "train",
                          "model": {"family": "mixtral", "preset": "tiny", "overrides": F32},
                          "train": {"batchSize": 2, "seqLen": 16, "steps": 1, "seed": 4},
                          "checkpoint": {"enabled": True, "directory": str(a["orbax"]),
                                         "format": "orbax"}}, device="cpu")
    a["tokens"] = np.random.RandomState(8).randint(0, cfg.vocab_size, size=(8, 12))
    a["specs"] = _specs(a)
    return a


@pytest.fixture(scope="module")
def ranked(assets):
    """Every multi-rank case in one spawn of 4: {case: each rank's result}."""
    four, worlds, keys4, keys2 = [], [[], []], [], [[], []]
    side = 0
    for name, (spec, world) in assets["specs"].items():
        if world == 4:
            four.append(("tp_entry", (spec,)))
            keys4.append(name)
        else:
            worlds[side].append(("tp_entry", (spec,)))
            keys2[side].append(name)
            side = 1 - side
    worlds[side].append(("rows_logits", ("mixtral", F32, assets["params"], assets["tokens"],
                                         {"data": 2}, LOGIT_STEPS)))
    keys2[side].append("logits-data")
    four.append(("worlds", (worlds,)))
    ranks = spawn(workers.many, 4, (four,), tmpdir=str(assets["root"]), timeout_s=400)
    out = {key: [r[i] for r in ranks] for i, key in enumerate(keys4)}
    for w in (0, 1):
        for i, key in enumerate(keys2[w]):
            out[key] = [r[-1][i] for r in ranks[2 * w:2 * w + 2]]
    return out


@pytest.fixture(scope="module")
def one_rank(assets):
    return {name: run_template_runtime(dict(spec, parallelism={}), device="cpu")
            for name, (spec, _) in assets["specs"].items() if name != "fault-data"}


@pytest.fixture(scope="module")
def jax_runs(assets):
    """JAX's entry point on each of JAX_CASES, on as many devices with the
    same parallelism; its generate's last output recorded (JAX's infer
    metrics carry no ids)."""
    out, generate = {}, jmix.generate

    def recording(*a, **kw):
        ids = generate(*a, **kw)
        seen.append(np.asarray(ids[0] if isinstance(ids, tuple) else ids))
        return ids

    jmix.generate = recording
    try:
        for name in JAX_CASES:
            spec, world = assets["specs"][name]
            seen = []
            out[name] = jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:world])
            out[name]["generated"] = seen[-1] if seen else None
    finally:
        jmix.generate = generate
    return out


def _clock_free(m):
    if isinstance(m, dict):
        return {k: _clock_free(v) for k, v in m.items()
                if not (str(k).endswith(("_s", "_seconds")) or "per_sec" in str(k)
                        or k in ("device", "device_kind"))}
    return m


def _common(port, ref):
    keys = [k for k in ref if k in port and k != "generated"]
    return _clock_free({k: port[k] for k in keys}), _clock_free({k: ref[k] for k in keys})


def _jax_ids(assets, spec):
    """JAX's greedy ``generate`` of the port's prompt (the whole batch,
    drawn from the seed as the port draws it): every row's new ids."""
    b, p = spec["train"]["batchSize"], spec["infer"]["promptLength"]
    prompt = torch.randint(0, 256, (b, p), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(spec["train"]["seed"]))
    out = jmix.generate(jax.tree.map(jnp.asarray, assets["params"]),
                        jmix.config("tiny", dtype=jnp.float32), jnp.asarray(prompt.numpy()),
                        spec["infer"]["maxNewTokens"])
    return np.asarray(out[0] if isinstance(out, tuple) else out)[:, p:].tolist()


def test_split_rows_decode_jax_ids(assets, ranked, jax_runs):
    """The repaired fault: infer over {data: 2} of rows whose decode drops
    selections gives JAX's ids in every row, from JAX's own entry point on
    2 devices, and its clock-free metrics."""
    ref = jax_runs["fault-data"]
    want = ref["generated"][:, len(FAULT_PROMPT):].tolist()
    assert len({tuple(r) for r in want}) > 1, "the rows' routing never parts them"
    for m in ranked["fault-data"]:
        assert m["completion_ids_by_row"] == want
        got, exp = _common(m, ref)
        assert got == exp


def test_split_rows_teacher_forced_logits_match_jax(assets, ranked):
    """Each rank's rows of a random batch, fed as infer feeds them, give
    JAX's logits of the whole batch's feeds, to 1e-5 relative."""
    cfg = jmix.config("tiny", dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, assets["params"])
    tokens = jnp.asarray(assets["tokens"], jnp.int32)
    p = tokens.shape[1]
    cache = jmix.init_kv_cache(cfg, tokens.shape[0], p)
    feeds = []
    for at, width in [(0, p - LOGIT_STEPS)] + [(i, 1) for i in range(p - LOGIT_STEPS, p)]:
        logits, cache = jmix.forward_decode(params, cfg, tokens[:, at:at + width], cache)
        feeds.append(np.asarray(logits, dtype=np.float32))
    ref = np.concatenate(feeds, axis=1)
    runs = ranked["logits-data"]
    assert [r["rows"] for r in runs] == [[0, 4], [4, 8]]
    for got in runs:
        err = np.abs(got["logits"] - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, err


@pytest.mark.parametrize("case", ["infer-data-expert", "infer-expert-tensor"])
def test_infer_over_the_expert_axis_matches_jax(assets, ranked, jax_runs, one_rank, case):
    spec, world = assets["specs"][case]
    want = _jax_ids(assets, spec)
    assert one_rank[case]["completion_ids_by_row"] == want
    for m in ranked[case]:
        assert len(ranked[case]) == world and m["n_devices"] == world
        assert m["completion_ids_by_row"] == want and m["last_logits_finite"]
        got, exp = _common(m, jax_runs[case])
        assert got == exp, case


def test_serve_over_expert_and_tensor_matches_jax(ranked, jax_runs, one_rank):
    ref, one = jax_runs["serve-expert-tensor"], one_rank["serve-expert-tensor"]
    assert ref["spilled_blocks"] > 0 and ref["n_devices"] == 4
    for m in ranked["serve-expert-tensor"]:
        assert m["completion_ids"] == one["completion_ids"]
        assert m["committed_tokens"] == m["budget_tokens"]
        assert m["finished_requests"] == len(m["completion_ids"])
        got, exp = _common(m, ref)
        assert got == exp


@pytest.mark.parametrize("case", ["infer-draft-data", "infer-self-draft-data",
                                  "serve-llama-expert", "infer-orbax-expert", "infer-hf-expert"])
def test_each_case_equals_the_one_rank_run(ranked, one_rank, case):
    one = one_rank[case]
    ids = "completion_ids_by_row" if case.startswith("infer") else "completion_ids"
    assert one[ids]
    for m in ranked[case]:
        assert m[ids] == one[ids], case
        assert m["n_devices"] == 2
        if case.startswith("serve"):
            assert m["committed_tokens"] == one["committed_tokens"] == m["budget_tokens"]
        if "draft" in case:
            for key in ("rounds", "acceptance_rate", "target_forwards_per_token"):
                assert m[key] == one[key], key
        if case == "infer-self-draft-data":
            assert 0.5 < m["acceptance_rate"] < 1.0
        if case in ("infer-orbax-expert", "infer-hf-expert"):
            assert m["weights_loaded"]


# --------------------------------------------- part three: C_local buffers


def _rank_routes(dispatch, fsdp, expert):
    """At {fsdp: 2, expert: 2} shapes (B 4 × S 16 global tokens, rank
    rows 2 of them, 2 of the tiny preset's 4 experts, a capacity factor
    that drops): this rank's input and layer, its grid, and JAX's routing
    of the whole token set."""
    cfg = tmix.config("tiny", dtype="float32", capacity_factor=0.5, dispatch_impl=dispatch)
    rng = np.random.RandomState(21)
    b, s, d = 4, 16, cfg.d_model
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    layer = {"router": rng.standard_normal((d, cfg.n_experts)).astype(np.float32),
             "w_gate": rng.standard_normal((cfg.n_experts, d, cfg.d_ff)).astype(np.float32) / 8,
             "w_up": rng.standard_normal((cfg.n_experts, d, cfg.d_ff)).astype(np.float32) / 8,
             "w_down": rng.standard_normal((cfg.n_experts, cfg.d_ff, d)).astype(np.float32) / 11}
    cap = jmoe.default_capacity(b * s, cfg.n_experts, cfg.n_experts_per_token,
                                cfg.capacity_factor)
    ref = jmoe.top_k_routing(jnp.asarray(x.reshape(b * s, d) @ layer["router"]),
                             cfg.n_experts_per_token, cap)
    rows, n_local = slice(2 * fsdp, 2 * fsdp + 2), cfg.n_experts // 2
    first = expert * n_local
    mine = {k: torch.from_numpy(v[first:first + n_local].copy() if k != "router" else v.copy())
            for k, v in layer.items()}
    grid = tmoe.TokenGrid(None, 2, 1, fsdp, 0)
    return cfg, torch.from_numpy(x[rows].copy()), mine, first, grid, ref, cap


def _global_buffers_ffn(cfg, x, layer, first, grid, cap):
    """The rank's MoE output at the global capacity: its expert block of
    the global routing in (E_local, C_global, D) buffers."""
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    routing = tmoe.global_top_k_routing(xf.float() @ layer["router"], cfg.n_experts_per_token,
                                        cap, (b, s), grid)
    n_local = layer["w_gate"].shape[0]
    dense = cfg.dispatch_impl == "einsum"
    routing = tmoe.expert_block(routing, first, n_local, cap, dense=dense)
    buf = (tmoe.moe_dispatch_dense(xf, routing) if dense
           else tmoe.moe_dispatch_scatter(xf, routing, n_local, cap))
    gated = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", buf, layer["w_gate"])) * \
        torch.einsum("ecd,edf->ecf", buf, layer["w_up"])
    out = torch.einsum("ecf,efd->ecd", gated, layer["w_down"])
    combined = (tmoe.moe_combine_dense(out, routing) if dense
                else tmoe.moe_combine_scatter(out, routing))
    assert buf.shape[1] == cap
    return combined.reshape(b, s, d)


@pytest.mark.parametrize("dispatch", ["einsum", "scatter"])
@pytest.mark.parametrize("fsdp,expert", [(0, 0), (0, 1), (1, 0), (1, 1)])
def test_a_ranks_expert_buffers_hold_its_own_selections(monkeypatch, dispatch, fsdp, expert):
    cfg, x, layer, first, grid, ref, cap = _rank_routes(dispatch, fsdp, expert)
    k, n_local = cfg.n_experts_per_token, layer["w_gate"].shape[0]
    assert float(ref.dropped_fraction) > 0.1  # drops occur
    # the gathered (T, k) indices over the grid: JAX's choices of every rank's rows
    monkeypatch.setattr(tmoe, "all_gather", lambda t, group: torch.from_numpy(
        np.asarray(ref.expert_index).astype(np.int32).reshape(-1)))
    # what this rank's experts keep of its own rows' selections, by JAX
    idx = np.asarray(ref.expert_index).reshape(4, 16, k)[2 * fsdp:2 * fsdp + 2]
    valid = np.asarray(ref.valid).reshape(4, 16, k)[2 * fsdp:2 * fsdp + 2] > 0
    kept = [int(((idx == e) & valid).sum()) for e in range(first, first + n_local)]
    seen = []
    for name in ("moe_dispatch_dense", "moe_dispatch_scatter"):
        orig = getattr(tmix, name)
        monkeypatch.setattr(tmix, name, lambda *a, _f=orig: seen.append(_f(*a)) or seen[-1])

    def run(ffn):
        xs = x.clone().requires_grad_()
        ws = {n: w.clone().requires_grad_() for n, w in layer.items()}
        out = ffn(xs, ws)
        probe = torch.from_numpy(np.random.RandomState(5).standard_normal(out.shape)
                                 .astype(np.float32))
        (out * probe).sum().backward()
        return out.detach(), [xs.grad] + [ws[n].grad for n in sorted(ws)]

    out, grads = run(lambda xs, ws: tmix._moe_ffn(cfg, xs, ws, first, None, grid)[0])
    assert [t.shape[1] for t in seen] == [max(max(kept), 1)] and max(kept) <= cap
    ref_out, ref_grads = run(lambda xs, ws: _global_buffers_ffn(cfg, xs, ws, first, grid, cap))
    np.testing.assert_allclose(out, ref_out, rtol=1e-6, atol=1e-6 * float(ref_out.abs().max()))
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))
