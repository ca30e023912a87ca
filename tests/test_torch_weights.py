"""The port's safetensors converters and exporters
(nexus_tpu_torch/runtime/weights.py) against the JAX package's, on the CPU.

Tiny presets of the three families with converters, in float32 and in
bfloat16. Parameters must agree bit for bit; logits from converted
parameters agree with JAX's at the f32 tolerance of the families' own
tests (rtol 1e-4, atol 1e-5)."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from nexus_tpu.models import gptneox as jneox
from nexus_tpu.models import llama as jllama
from nexus_tpu.models import mixtral as jmix
from nexus_tpu.runtime import weights as jw
from nexus_tpu_torch import interop
from nexus_tpu_torch.models import gptneox as tneox
from nexus_tpu_torch.models import llama as tllama
from nexus_tpu_torch.models import mixtral as tmix
from nexus_tpu_torch.models.params import tree_items
from nexus_tpu_torch.runtime import weights as tw

FAMILIES = {
    "llama": (jllama, tllama, interop.llama_params_from_jax),
    "gptneox": (jneox, tneox, interop.gptneox_params_from_jax),
    "mixtral": (jmix, tmix, interop.mixtral_params_from_jax),
}
CASES = [(f, d) for f in FAMILIES for d in ("float32", "bfloat16")]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(family, dtype, seed=0, **over):
    jmod, tmod, from_jax = FAMILIES[family]
    jcfg = jmod.config("tiny", dtype=getattr(jnp, dtype), **over)
    jparams = jmod.init(jax.random.PRNGKey(seed), jcfg)
    tcfg = tmod.config("tiny", dtype=dtype, **over)
    return jcfg, jparams, tcfg, from_jax


def _bits_np(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype == ml_dtypes.bfloat16 else x.view(
        {4: np.uint32, 2: np.uint16, 8: np.uint64}[x.dtype.itemsize])


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return _bits_np(t.numpy())


def _assert_same_params(a, b) -> None:
    ia, ib = dict(tree_items(a)), dict(tree_items(b))
    assert ia.keys() == ib.keys()
    for name, x in ia.items():
        y = ib[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(_bits(x), _bits(y)), name


def _assert_same_jax(a, b) -> None:
    fa, fb = jax.tree_util.tree_leaves_with_path(a), jax.tree_util.tree_leaves_with_path(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(_bits_np(x), _bits_np(y)), path


@pytest.mark.parametrize("family,dtype", CASES)
def test_port_reads_a_jax_export_bit_for_bit(tmp_path, family, dtype):
    """JAX's ``export_hf_*`` writes; the port's converter reads: equal to the
    interop copy of the same JAX params, leaf by leaf, with no autograd."""
    jcfg, jparams, tcfg, from_jax = _setup(family, dtype)
    path = getattr(jw, f"export_hf_{family}")(jparams, jcfg, str(tmp_path / "m.safetensors"))
    got = tw.CONVERTERS[family](path, tcfg, device="cpu")
    _assert_same_params(got, from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu"))
    assert not any(t.requires_grad for _, t in tree_items(got))


@pytest.mark.parametrize("family,dtype", CASES)
def test_jax_reads_a_port_export_bit_for_bit(tmp_path, family, dtype):
    jcfg, jparams, tcfg, from_jax = _setup(family, dtype, seed=1)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    path = getattr(tw, f"export_hf_{family}")(tparams, tcfg, str(tmp_path / "m.safetensors"))
    _assert_same_jax(jw.CONVERTERS[family](path, jcfg), jparams)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_converted_params_give_jax_logits(tmp_path, family):
    jcfg, jparams, tcfg, _ = _setup(family, "float32", seed=2)
    path = getattr(jw, f"export_hf_{family}")(jparams, jcfg, str(tmp_path / "m.safetensors"))
    tparams = tw.load_pretrained(family, path, tcfg, device="cpu")
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 64)).astype(np.int32)
    ref = FAMILIES[family][0].forward(jparams, jcfg, jnp.asarray(tokens))
    with torch.no_grad():
        got = FAMILIES[family][1].forward(tparams, tcfg, torch.from_numpy(tokens))
    if isinstance(ref, tuple):  # mixtral: (logits, aux)
        ref, got = ref[0], got[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def test_tied_embeddings_use_the_embedding_transposed(tmp_path):
    jcfg, jparams, tcfg, from_jax = _setup("llama", "bfloat16")
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    tensors = tw.hf_tensors_llama(tparams, tcfg)
    del tensors["lm_head.weight"]
    path = tw.save_safetensors(tensors, str(tmp_path / "tied.safetensors"))
    got = tw.convert_hf_llama(path, tcfg, device="cpu")
    assert torch.equal(got["lm_head"], tparams["embed"].T)
    _assert_same_params(got, from_jax(jax.tree.map(np.asarray, jw.convert_hf_llama(path, jcfg)),
                                      tcfg, "cpu"))


def _write_shards(tensors, directory, n, index: bool):
    os.makedirs(directory, exist_ok=True)
    names = list(tensors)
    weight_map = {}
    for i in range(n):
        fname = f"model-{i + 1:05d}-of-{n:05d}.safetensors"
        part = {k: tensors[k] for k in names[i::n]}
        tw.save_safetensors(part, os.path.join(directory, fname))
        weight_map.update({k: fname for k in part})
    if index:
        with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return str(directory)


@pytest.mark.parametrize("index", [True, False], ids=["index", "directory"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_layouts_read_like_one_file(tmp_path, family, index):
    """A sharded set with model.safetensors.index.json, and a bare directory
    of shards: both packages read them as the one-file export."""
    jcfg, jparams, tcfg, from_jax = _setup(family, "bfloat16", seed=3)
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu")
    directory = _write_shards(tw.HF_TENSORS[family](tparams, tcfg), tmp_path / "sharded", 3,
                              index)
    _assert_same_params(tw.CONVERTERS[family](directory, tcfg, device="cpu"), tparams)
    _assert_same_jax(jw.CONVERTERS[family](directory, jcfg), jparams)


@pytest.mark.parametrize("source", ["float32", "float16"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_casts_to_bf16_round_as_jax(tmp_path, family, source):
    """F32 and F16 files read into a bf16 model: bit for bit what JAX's
    ``np.asarray(t, bfloat16)`` gives (round to nearest even), ties
    included."""
    _, _, scfg, from_jax = _setup(family, "float32", seed=4)
    jcfg, _, tcfg, _ = _setup(family, "bfloat16")
    g = torch.Generator().manual_seed(0)
    src = FAMILIES[family][1].init(g, scfg, "cpu")
    with torch.no_grad():
        emb = src["embed"].view(torch.int32)
        emb.view(-1)[::3] = (emb.view(-1)[::3] & ~0xFFFF) | 0x8000  # exact ties
        emb.view(-1)[1::3] = (emb.view(-1)[1::3] & ~0xFFFF) | 0x18000  # odd, a tie
    tensors = {k: v.detach().to(getattr(torch, source)) if v.dtype == torch.float32
               and "gate.weight" not in k else v
               for k, v in tw.HF_TENSORS[family](src, scfg).items()}
    path = tw.save_safetensors(tensors, str(tmp_path / "m.safetensors"))
    got = tw.CONVERTERS[family](path, tcfg, device="cpu")
    ref = jw.CONVERTERS[family](path, jcfg)
    _assert_same_params(got, from_jax(jax.tree.map(np.asarray, ref), tcfg, "cpu"))
    if source == "float32":  # the ties round to even, not up
        exp = torch.from_numpy(np.asarray(src["embed"].detach().numpy(),
                                          ml_dtypes.bfloat16).view(np.int16))
        assert torch.equal(got["embed"].view(torch.int16), exp)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_config_mismatch_and_missing_tensor_raise_as_jax(tmp_path, family):
    jcfg, jparams, tcfg, _ = _setup(family, "float32")
    path = getattr(jw, f"export_hf_{family}")(jparams, jcfg, str(tmp_path / "m.safetensors"))
    jmod, tmod, _ = FAMILIES[family]
    d_ff = jcfg.d_ff * 2
    for jc, tc in ((jmod.config("tiny", dtype=jnp.float32, d_ff=d_ff),
                    tmod.config("tiny", dtype="float32", d_ff=d_ff)),
                   (jmod.config("tiny", dtype=jnp.float32, n_layers=jcfg.n_layers + 1),
                    tmod.config("tiny", dtype="float32", n_layers=jcfg.n_layers + 1))):
        with pytest.raises(ValueError):
            jw.CONVERTERS[family](path, jc)
        with pytest.raises(ValueError):
            tw.CONVERTERS[family](path, tc, device="cpu")
    tparams = tw.CONVERTERS[family](path, tcfg, device="cpu")
    tensors = tw.HF_TENSORS[family](tparams, tcfg)
    victim = sorted(k for k in tensors if ".1." in k and "input_layernorm" not in k)[0]
    del tensors[victim]
    holed = tw.save_safetensors(tensors, str(tmp_path / "holed.safetensors"))
    with pytest.raises(KeyError):
        jw.CONVERTERS[family](holed, jcfg)
    with pytest.raises(KeyError, match="not in checkpoint"):
        tw.CONVERTERS[family](holed, tcfg, device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_hf_library_reads_the_port_writer(tmp_path, dtype):
    """safetensors.numpy.load_file (the HF package, in this container only)
    reads what the port writes: the same names, shapes and bits."""
    from safetensors.numpy import load_file

    _, _, tcfg, _ = _setup("gptneox", dtype)
    params = tneox.init(torch.Generator().manual_seed(0), tcfg, "cpu")
    tensors = tw.hf_tensors_gptneox(params, tcfg)
    path = tw.save_safetensors(tensors, str(tmp_path / "m.safetensors"))
    loaded = load_file(path)
    assert loaded.keys() == tensors.keys()
    for name, t in tensors.items():
        assert loaded[name].shape == tuple(t.shape)
        assert np.array_equal(_bits_np(loaded[name]), _bits(t.detach().contiguous())), name
    with open(path, "rb") as f:
        header_len = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(header_len))
    assert header_len % 8 == 0
    spans = sorted(v["data_offsets"] for v in header.values())
    assert spans[0][0] == 0 and all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert os.path.getsize(path) == 8 + header_len + spans[-1][1]


def test_reader_and_loader_refusals(tmp_path, monkeypatch):
    with pytest.raises(FileNotFoundError):
        tw.CheckpointReader(str(tmp_path / "nope"))
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        tw.CheckpointReader(str(tmp_path / "empty"))
    cfg = tllama.config("tiny")
    with pytest.raises(ValueError, match="no safetensors converter"):
        tw.load_pretrained("mlp", str(tmp_path), cfg, device="cpu")
    jcfg, jparams, _, _ = _setup("llama", "float32")
    path = jw.export_hf_llama(jparams, jcfg, str(tmp_path / "m.safetensors"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.load_pretrained("llama", path, tllama.config("tiny", dtype="float32"))
