"""The port's entry point with ``model.weights`` and text prompts against the
JAX package's, on the CPU.

A tiny float32 Llama (vocabulary 640, context 1024) is exported by JAX's
``export_hf_llama``; the tokenizer.json is the one ``chip_smoke.py`` writes
(Llama-3's layout). Both packages load the same file and tokenize with the
same engine, so prompt counts, completions and token ids must be equal."""

import glob
import os

import jax
import jax.numpy as jnp
import pytest
import torch
import yaml

import chip_smoke as cs
from nexus_tpu.api import runtime_spec as jspec
from nexus_tpu.models import llama as jllama
from nexus_tpu.runtime import weights as jw
from nexus_tpu.runtime.entrypoints import run_template_runtime as jax_run
from nexus_tpu_torch.api import runtime_spec as tspec
from nexus_tpu_torch.runtime.entrypoints import run_template_runtime
from nexus_tpu_torch.utils.tokenizer import load_tokenizer

OVERRIDES = {"dtype": "float32", "vocab_size": 640, "max_seq_len": 1024}
PROMPTS = ["the quick brown fox", "hello world, the market square at noon",
           "1234567890 what, where, when?"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def assets(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrained")
    cfg = jllama.config("tiny", **dict(OVERRIDES, dtype=jnp.float32))
    path = jw.export_hf_llama(jllama.init(jax.random.PRNGKey(5), cfg), cfg,
                              str(root / "model.safetensors"))
    tok = cs.write_tokenizer_json(str(root / "tokenizer.json"))
    return {"path": path, "tok": tok}


def _spec(assets, mode, **blocks):
    spec = {"kind": "jax_xla", "mode": mode,
            "model": {"family": "llama", "preset": "tiny", "overrides": dict(OVERRIDES),
                      "weights": {"format": "safetensors", "path": assets["path"],
                                  "tokenizer": assets["tok"]}},
            "train": {"batchSize": 2, "seqLen": 32, "seed": 0}}
    spec.update(blocks)
    return spec


def _both(spec):
    port = run_template_runtime(spec, device="cpu")
    ref = jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1])
    return port, ref


@pytest.mark.parametrize("lookup", [False, True], ids=["plain", "prompt-lookup"])
def test_infer_from_weights_and_a_text_prompt_equals_jax(assets, lookup):
    infer = {"prompt": PROMPTS[1], "maxNewTokens": 8, "iterations": 1, "temperature": 0.0}
    if lookup:
        infer.update(promptLookupNgram=2, numSpeculative=3)
    port, ref = _both(_spec(assets, "infer", infer=infer))
    for key in ("weights_loaded", "restored_step", "prompt_tokens", "prompt_len", "new_tokens",
                "completion"):
        assert port[key] == ref[key], key
    assert port["weights_loaded"] is True and port["restored_step"] == -1
    ids = load_tokenizer(assets["tok"]).encode(PROMPTS[1])
    assert port["prompt_tokens"] == len(ids) and len(port["completion_ids"]) == 8
    assert load_tokenizer(assets["tok"]).decode(port["completion_ids"]) == port["completion"]


def test_infer_completion_ids_equal_jax_generate(assets):
    """The port's new token ids equal JAX's greedy decode of the same ids on
    the same converted weights."""
    cfg = jllama.config("tiny", **dict(OVERRIDES, dtype=jnp.float32))
    params = jw.convert_hf_llama(assets["path"], cfg)
    ids = load_tokenizer(assets["tok"]).encode(PROMPTS[0])
    out = jllama.generate(params, cfg, jnp.asarray([ids, ids], jnp.int32), 8)
    out = out[0] if isinstance(out, tuple) else out
    port = run_template_runtime(_spec(assets, "infer", infer={
        "prompt": PROMPTS[0], "maxNewTokens": 8, "iterations": 1}), device="cpu")
    assert port["completion_ids"] == [int(t) for t in out[0, len(ids):]]


def test_serve_text_prompts_equal_jax(assets):
    serve = {"prompts": PROMPTS, "maxNewMax": 6, "chunk": 4, "kvBlockSize": 8,
             "prefixCache": True}
    port, ref = _both(_spec(assets, "serve", serve=serve))
    assert port["completions"] == ref["completions"] and len(port["completions"]) == 3
    assert port["weights_loaded"] is True and port["finished_requests"] == 3
    tok = load_tokenizer(assets["tok"])
    assert [tok.decode(c) for c in port["completion_ids"]] == port["completions"]
    assert port["committed_tokens"] == ref["committed_tokens"] == 18


@pytest.mark.parametrize("case", [
    {"model": {"weights": {"format": "npz", "path": "/x"}}},
    {"model": {"weights": {"format": "safetensors"}}},
    {"model": {"family": "mlp", "weights": {"path": "/x"}}},
    {"mode": "serve", "serve": {"prompts": ["hi"]}},
    {"mode": "serve", "serve": {"prompts": ["hi"], "sharedPrefixLength": 4},
     "model": {"weights": {"path": "/x", "tokenizer": "/t"}}},
    {"mode": "serve", "serve": {"prompts": ["hi"], "maxNewMax": -1},
     "model": {"weights": {"path": "/x", "tokenizer": "/t"}}},
], ids=["format", "no-path", "mlp", "no-tokenizer", "shared-prefix", "max-new"])
def test_the_validation_errors_equal_jax(case):
    spec = {"kind": "jax_xla", "mode": case.get("mode", "infer"),
            "model": {"family": "llama", "preset": "tiny", **case.get("model", {})}}
    if "serve" in case:
        spec["serve"] = case["serve"]
    got = tspec.JaxXlaRuntime.from_dict(spec).validate()
    ref = jspec.JaxXlaRuntime.from_dict(spec).validate()
    assert got and set(got) <= set(ref)


@pytest.mark.parametrize("mode,block,match", [
    # the prompt is cut to the context, and the verify window's reserve is left
    ("infer", {"infer": {"prompt": "x " * 1200, "maxNewTokens": 8, "promptLookupNgram": 2,
                         "numSpeculative": 3}}, "leaves no room"),
    ("serve", {"serve": {"prompts": ["a", "x " * 1200], "maxNewMax": 4, "kvBlockSize": 8}},
     r"serve.prompts\[1\]"),
], ids=["infer", "serve"])
def test_a_prompt_that_does_not_fit_fails_before_any_weights_load(assets, mode, block, match):
    spec = _spec(assets, mode, **block)
    spec["model"]["weights"]["path"] = "/no/such/checkpoint"  # never opened
    errors = []
    for run in (lambda: run_template_runtime(spec, device="cpu"),
                lambda: jax_run(jspec.JaxXlaRuntime.from_dict(spec), devices=jax.devices()[:1])):
        with pytest.raises(ValueError, match=match) as e:
            run()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_a_text_prompt_without_a_tokenizer_raises_as_jax(assets):
    spec = _spec(assets, "infer", infer={"prompt": "hello", "maxNewTokens": 4})
    del spec["model"]["weights"]["tokenizer"]
    with pytest.raises(ValueError, match="requires model.weights.tokenizer"):
        run_template_runtime(spec, device="cpu")
    spec["mode"], spec["serve"] = "serve", {"prompts": ["hello"]}
    with pytest.raises(ValueError, match="serve.prompts requires model.weights.tokenizer"):
        run_template_runtime(spec, device="cpu")


def _template(name):
    path = os.path.join(ROOT, "examples", name)
    with open(path) as f:
        return next(d for d in yaml.safe_load_all(f) if d)["spec"]["runtime"]


@pytest.mark.parametrize("name", ["infer-llama8b-pretrained.yaml",
                                  "infer-llama8b-prompt-lookup.yaml"])
def test_the_pretrained_templates_run_through_the_entry_point(assets, name):
    """The repo's two pretrained infer templates, as written but for the
    preset (tiny), the weights' paths (the tiny export) and the shapes
    (2 rows, 8 new tokens, 1 iteration, one device): their completions
    equal JAX's."""
    rt = _template(name)
    assert rt["model"]["weights"]["format"] == "safetensors" and rt["infer"]["prompt"]
    rt = dict(rt, tpu={}, parallelism={})
    rt["model"] = dict(rt["model"], preset="tiny", overrides=dict(OVERRIDES),
                       weights=dict(rt["model"]["weights"], path=assets["path"],
                                    tokenizer=assets["tok"]))
    rt["train"] = dict(rt["train"], batchSize=2)
    rt["infer"] = dict(rt["infer"], maxNewTokens=8, iterations=1)
    port, ref = _both(rt)
    assert port["completion"] == ref["completion"] and port["weights_loaded"] is True
    assert port["prompt_tokens"] == ref["prompt_tokens"] > 0
    assert port.get("speculative_kind") == ref.get("speculative_kind")


def test_the_weights_templates_are_the_ones_named():
    named = []
    for path in sorted(glob.glob(os.path.join(ROOT, "examples", "*.yaml"))):
        with open(path) as f:
            for doc in yaml.safe_load_all(f):
                if doc and ((doc.get("spec") or {}).get("runtime") or {}).get(
                        "model", {}).get("weights"):
                    named.append(os.path.basename(path))
    assert named == ["infer-llama8b-pretrained.yaml", "infer-llama8b-prompt-lookup.yaml",
                     "serve-llama8b.yaml"]
