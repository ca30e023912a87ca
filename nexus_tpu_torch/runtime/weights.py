"""Pretrained-weight ingestion (counterpart of ``nexus_tpu/runtime/weights.py``):
HF safetensors checkpoints → the port's parameter dicts, and back.

A template points ``model.weights`` at a HuggingFace-format checkpoint of a
Llama, GPT-NeoX or Mixtral model: one ``model.safetensors``, a sharded set
with ``model.safetensors.index.json``, or a directory of ``*.safetensors``.
``load_pretrained`` converts it, and infer and serve decode with those
weights instead of random ones.

  * The container is parsed with the stdlib (an 8-byte little-endian header
    length, a JSON header, the raw buffer) and tensors are read through
    ``np.memmap`` slices: no whole-file load.
  * BF16 is read as raw 16-bit patterns and viewed as ``torch.bfloat16``
    (numpy has no bfloat16); no ``ml_dtypes``, no ``safetensors`` package.
  * Each leaf of the family's parameter dict is allocated once on the target
    device (``family.empty_params``) and filled one layer (one expert) at a
    time: the host never holds more than one layer's tensor. The (out, in)
    → (in, out) transpose and the cast to the leaf's dtype happen on the
    device; the cast rounds to nearest even, as numpy's cast to
    ``ml_dtypes.bfloat16`` does in the JAX package.
  * The parameters carry no autograd state.

HF → port mapping: the RoPE is rotate-half in both, so q/k need no head
permutation; projections are stored (out, in) and used (in, out); layers
stack along a leading dim; GPT-NeoX's fused ``query_key_value`` is
interleaved per head in HF and in contiguous thirds (q | k | v) here.

``export_hf_*`` are the inverse maps, one file each, written by the port's
own stdlib writer (``save_safetensors``).
"""

from __future__ import annotations

import functools

import json
import logging
import os
import struct
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from nexus_tpu_torch.models.params import LeafCuts
from nexus_tpu_torch.models.registry import get_family
from nexus_tpu_torch.utils.hw import resolve_device

logger = logging.getLogger("nexus_tpu_torch.runtime.weights")

# safetensors dtype → (numpy dtype of the raw elements, torch dtype); BF16
# is read as int16 bit patterns and viewed as bfloat16
_DTYPES: Dict[str, Tuple[Any, torch.dtype]] = {
    "F64": (np.float64, torch.float64),
    "F32": (np.float32, torch.float32),
    "F16": (np.float16, torch.float16),
    "BF16": (np.int16, torch.bfloat16),
    "I64": (np.int64, torch.int64),
    "I32": (np.int32, torch.int32),
    "I16": (np.int16, torch.int16),
    "I8": (np.int8, torch.int8),
    "U8": (np.uint8, torch.uint8),
    "BOOL": (np.bool_, torch.bool),
}
_ST_NAMES = {torch_dt: name for name, (_, torch_dt) in _DTYPES.items()}


def _dtypes(st_dtype: str):
    try:
        return _DTYPES[st_dtype]
    except KeyError:
        raise ValueError(f"unsupported safetensors dtype {st_dtype!r}")


class SafetensorsFile:
    """Reader for one ``.safetensors`` file (stdlib parsing, np.memmap-backed
    reads)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            (header_len,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(header_len))
        self._data_start = 8 + header_len
        header.pop("__metadata__", None)
        self.tensors: Dict[str, Dict[str, Any]] = header
        self._mmap: Optional[np.memmap] = None

    def keys(self) -> List[str]:
        return list(self.tensors)

    def _buffer(self) -> np.memmap:
        if self._mmap is None:
            self._mmap = np.memmap(self.path, dtype=np.uint8, mode="r")
        return self._mmap

    def tensor(self, name: str) -> torch.Tensor:
        """A CPU tensor holding a copy of the stored one (bf16 stays bf16)."""
        info = self.tensors[name]
        start, end = info["data_offsets"]
        np_dt, torch_dt = _dtypes(info["dtype"])
        raw = self._buffer()[self._data_start + start:self._data_start + end]
        t = torch.from_numpy(np.array(raw.view(np_dt).reshape(info["shape"])))
        return t.view(torch_dt) if torch_dt == torch.bfloat16 else t

    def close(self) -> None:
        self._mmap = None


class CheckpointReader:
    """Uniform tensor access over the three HF checkpoint layouts: one file,
    an index.json shard map, or a directory of shards."""

    def __init__(self, path: str):
        self.files: Dict[str, SafetensorsFile] = {}
        self.name_to_file: Dict[str, str] = {}
        if os.path.isfile(path) and path.endswith(".safetensors"):
            self._add_file(path)
            return
        if os.path.isdir(path):
            index = os.path.join(path, "model.safetensors.index.json")
            single = os.path.join(path, "model.safetensors")
            if os.path.isfile(index):
                with open(index) as f:
                    weight_map = json.load(f).get("weight_map") or {}
                for name, fname in weight_map.items():
                    fpath = os.path.join(path, fname)
                    if fpath not in self.files:
                        self.files[fpath] = SafetensorsFile(fpath)
                    self.name_to_file[name] = fpath
                return
            if os.path.isfile(single):
                self._add_file(single)
                return
            shards = sorted(os.path.join(path, p) for p in os.listdir(path)
                            if p.endswith(".safetensors"))
            if shards:
                for s in shards:
                    self._add_file(s)
                return
        raise FileNotFoundError(
            f"{path!r} is not a .safetensors file, a directory containing "
            "model.safetensors(.index.json), or a directory of shards")

    def _add_file(self, fpath: str) -> None:
        sf = SafetensorsFile(fpath)
        self.files[fpath] = sf
        for name in sf.keys():
            self.name_to_file[name] = fpath

    def __contains__(self, name: str) -> bool:
        return name in self.name_to_file

    def keys(self) -> List[str]:
        return list(self.name_to_file)

    def tensor(self, name: str) -> torch.Tensor:
        try:
            fpath = self.name_to_file[name]
        except KeyError:
            raise KeyError(f"tensor {name!r} not in checkpoint "
                           f"(have {len(self.name_to_file)} tensors)")
        return self.files[fpath].tensor(name)

    def close(self) -> None:
        for sf in self.files.values():
            sf.close()


def save_safetensors(tensors: Dict[str, torch.Tensor], path: str) -> str:
    """Write ``tensors`` (any device) as one safetensors file: the JSON
    header padded with spaces to 8 bytes, contiguous ``data_offsets`` with
    the widest dtypes first (every tensor stays aligned to its element
    size), each tensor copied to the host only while it is written."""
    order = sorted(tensors, key=lambda n: -tensors[n].element_size())  # stable
    header: Dict[str, Any] = {}
    offset = 0
    for name in order:
        t = tensors[name]
        if t.dtype not in _ST_NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in order:
            t = tensors[name].detach().contiguous().to("cpu")  # transposed on the device
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            f.write(memoryview(t.numpy().reshape(-1).view(np.uint8)))
    return path


# --------------------------------------------------------------- conversion


def _check_shape(name: str, t: torch.Tensor, shape: Tuple[int, ...], why: str = "") -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != expected {tuple(shape)}{why}")


@torch.no_grad()
def _fill(out: torch.Tensor, reader: CheckpointReader, name: str, transpose: bool,
          take=None) -> None:
    """``out`` = the checkpoint's ``name`` (transposed; a tensor-parallel
    rank's block of it by ``take``), cast to ``out``'s dtype on ``out``'s
    device."""
    t = reader.tensor(name)
    if transpose:
        t = t.T
    if take is not None:
        t = take(t)
    _check_shape(name, t, out.shape, " (config/checkpoint mismatch)")
    out.copy_(t.to(out.device))


def _fill_stacked(out: torch.Tensor, reader: CheckpointReader, template: str,
                  transpose: bool, take=None) -> None:
    """``out[i]`` = ``template.format(i)`` for every layer, one at a time."""
    for i in range(out.shape[0]):
        _fill(out[i], reader, template.format(i), transpose, take)


def _check_depth(reader: CheckpointReader, L: int, last: str, past_prefix: str = "") -> None:
    if last in reader:
        return
    extra = past_prefix and [n for n in reader.keys() if n.startswith(past_prefix)]
    raise ValueError(f"checkpoint does not match n_layers={L}: "
                     + (f"has layers past {L - 1}" if extra else f"missing {last!r}"))


Device = Optional[Union[str, torch.device]]


def _convert(family_name: str, body, path: str, cfg, device: Device,
             progress: Optional[Callable[[str], None]], shard=None) -> Dict[str, Any]:
    """The frame the three converters share: the checkpoint opened and
    closed, the family's empty parameters allocated on ``device`` and handed
    to ``body(reader, params, cfg, note, take)`` to fill. With a
    ``ModelShard`` the leaves are the rank's blocks, and ``take(path)``
    gives the function that cuts a whole tensor read for the leaf at
    ``path`` (None: keep it whole)."""
    reader = CheckpointReader(path)
    note = progress or (lambda msg: logger.info("%s", msg))
    family = get_family(family_name)
    try:
        params = family.empty_params(cfg, resolve_device(device), shard=shard)
        take = (lambda leaf_path: None) if shard is None else LeafCuts(
            family.logical_axes(cfg), shard, family.TENSOR_GROUPS).take
        body(reader, params, cfg, note, take)
        return params
    finally:
        reader.close()


# name templates in HF Llama checkpoints (transformers LlamaForCausalLM)
_HF_LLAMA_LAYERS: Dict[str, Tuple[str, bool]] = {
    # ours -> (HF template, transpose?)
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "w_gate": ("model.layers.{}.mlp.gate_proj.weight", True),
    "w_up": ("model.layers.{}.mlp.up_proj.weight", True),
    "w_down": ("model.layers.{}.mlp.down_proj.weight", True),
    "ln_attn": ("model.layers.{}.input_layernorm.weight", False),
    "ln_mlp": ("model.layers.{}.post_attention_layernorm.weight", False),
}


def _llama_body(reader, params, cfg, note, take) -> None:
    L = cfg.n_layers
    _check_depth(reader, L, f"model.layers.{L - 1}.input_layernorm.weight",
                 past_prefix=f"model.layers.{L}.")
    for ours, (tmpl, transpose) in _HF_LLAMA_LAYERS.items():
        note(f"converting {ours} ({L} layers)")
        _fill_stacked(params["layers"][ours], reader, tmpl, transpose, take(f"layers/{ours}"))
    note("converting embed / final_norm / lm_head")
    _fill(params["embed"], reader, "model.embed_tokens.weight", False, take("embed"))
    if "lm_head.weight" in reader:
        _fill(params["lm_head"], reader, "lm_head.weight", True, take("lm_head"))
    else:  # tied word embeddings (Llama-3.2 style)
        _fill(params["lm_head"], reader, "model.embed_tokens.weight", True, take("lm_head"))
    _fill(params["final_norm"], reader, "model.norm.weight", False)


def convert_hf_llama(path: str, cfg, device: Device = None,
                     progress: Optional[Callable[[str], None]] = None,
                     shard=None) -> Dict[str, Any]:
    """HF-format Llama safetensors checkpoint → the port's parameter dict on
    ``device`` (default CUDA; a rank's blocks with a ``ModelShard``).
    Tied-embedding checkpoints (no ``lm_head.weight``, e.g. Llama-3.2-1B)
    use the embedding transposed. Raises ValueError on a shape or
    layer-count mismatch with ``cfg``, KeyError on a missing tensor."""
    return _convert("llama", _llama_body, path, cfg, device, progress, shard)


def hf_tensors_llama(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The HF names of a Llama parameter dict: views of its leaves, in HF's
    (out, in) layout, still on their device."""
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].T}
    for ours, (tmpl, transpose) in _HF_LLAMA_LAYERS.items():
        for i in range(cfg.n_layers):
            t = params["layers"][ours][i]
            out[tmpl.format(i)] = t.T if transpose else t
    return out


def export_hf_llama(params: Dict[str, Any], cfg, path: str) -> str:
    """The port's Llama parameters → an HF-format single-file safetensors
    checkpoint (the inverse of :func:`convert_hf_llama`)."""
    return save_safetensors(hf_tensors_llama(params, cfg), path)


# ------------------------------------------------------------ gptneox


def _deinterleave_neox_qkv(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """HF NeoX fuses query_key_value with per-head interleaving on the output
    dim ([h0: q k v, h1: q k v, ...]); the port's ``wqkv`` is contiguous
    thirds (all q | all k | all v). (3d, ...) → (3d, ...) reordered."""
    rest = w.shape[1:]
    return w.reshape(n_heads, 3, head_dim, *rest).movedim(1, 0).reshape(
        3 * n_heads * head_dim, *rest)


def _interleave_neox_qkv(w: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """Inverse of :func:`_deinterleave_neox_qkv` (the export path)."""
    rest = w.shape[1:]
    return w.reshape(3, n_heads, head_dim, *rest).movedim(0, 1).reshape(
        3 * n_heads * head_dim, *rest)


_HF_NEOX_PLAIN: Dict[str, Tuple[str, bool]] = {
    # ours -> (HF template, transpose?): everything but the fused qkv
    "wo": ("gpt_neox.layers.{}.attention.dense.weight", True),
    "b_o": ("gpt_neox.layers.{}.attention.dense.bias", False),
    "w_in": ("gpt_neox.layers.{}.mlp.dense_h_to_4h.weight", True),
    "b_in": ("gpt_neox.layers.{}.mlp.dense_h_to_4h.bias", False),
    "w_out": ("gpt_neox.layers.{}.mlp.dense_4h_to_h.weight", True),
    "b_out": ("gpt_neox.layers.{}.mlp.dense_4h_to_h.bias", False),
    "ln1": ("gpt_neox.layers.{}.input_layernorm.weight", False),
    "ln1_b": ("gpt_neox.layers.{}.input_layernorm.bias", False),
    "ln2": ("gpt_neox.layers.{}.post_attention_layernorm.weight", False),
    "ln2_b": ("gpt_neox.layers.{}.post_attention_layernorm.bias", False),
}
_HF_NEOX_QKV = "gpt_neox.layers.{}.attention.query_key_value."


def _gptneox_body(reader, params, cfg, note, take) -> None:
    L, d = cfg.n_layers, cfg.d_model
    _check_depth(reader, L, f"gpt_neox.layers.{L - 1}.input_layernorm.weight")
    layers = params["layers"]
    for ours, (tmpl, transpose) in _HF_NEOX_PLAIN.items():
        note(f"converting {ours} ({L} layers)")
        _fill_stacked(layers[ours], reader, tmpl, transpose, take(f"layers/{ours}"))
    note("converting fused qkv")
    # a tensor-parallel rank cuts after the de-interleave: its heads' block
    # of each of the q, k and v thirds
    take_w = take("layers/wqkv") or (lambda t: t)
    take_b = take("layers/b_qkv") or (lambda t: t)
    with torch.no_grad():
        for i in range(L):
            w = reader.tensor(_HF_NEOX_QKV.format(i) + "weight")
            b = reader.tensor(_HF_NEOX_QKV.format(i) + "bias")
            if tuple(w.shape) != (3 * d, d):
                raise ValueError(f"query_key_value.weight shape {tuple(w.shape)} != "
                                 f"{(3 * d, d)}")
            _check_shape("query_key_value.bias", b, (3 * d,))
            w = _deinterleave_neox_qkv(w.to(layers["wqkv"].device), cfg.n_heads, cfg.head_dim)
            layers["wqkv"][i].copy_(take_w(w.T))
            layers["b_qkv"][i].copy_(take_b(_deinterleave_neox_qkv(
                b.to(layers["b_qkv"].device), cfg.n_heads, cfg.head_dim)))
    note("converting embed / final norm / head")
    _fill(params["embed"], reader, "gpt_neox.embed_in.weight", False, take("embed"))
    _fill(params["final_norm"], reader, "gpt_neox.final_layer_norm.weight", False)
    _fill(params["final_norm_b"], reader, "gpt_neox.final_layer_norm.bias", False)
    _fill(params["lm_head"], reader, "embed_out.weight", True, take("lm_head"))


def convert_hf_gptneox(path: str, cfg, device: Device = None,
                       progress: Optional[Callable[[str], None]] = None,
                       shard=None) -> Dict[str, Any]:
    """HF GPTNeoXForCausalLM safetensors checkpoint → the port's parameter
    dict on ``device`` (a rank's blocks with a ``ModelShard``): the
    fused ``query_key_value`` is de-interleaved per head
    (:func:`_deinterleave_neox_qkv`), ``embed_out`` is the untied head."""
    return _convert("gptneox", _gptneox_body, path, cfg, device, progress, shard)


def hf_tensors_gptneox(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The HF names of a GPT-NeoX parameter dict (the fused qkv interleaved
    per head again: a copy; every other tensor a view)."""
    hq, hd = cfg.n_heads, cfg.head_dim
    out = {"gpt_neox.embed_in.weight": params["embed"],
           "gpt_neox.final_layer_norm.weight": params["final_norm"],
           "gpt_neox.final_layer_norm.bias": params["final_norm_b"],
           "embed_out.weight": params["lm_head"].T}
    layers = params["layers"]
    for ours, (tmpl, transpose) in _HF_NEOX_PLAIN.items():
        for i in range(cfg.n_layers):
            t = layers[ours][i]
            out[tmpl.format(i)] = t.T if transpose else t
    for i in range(cfg.n_layers):
        out[_HF_NEOX_QKV.format(i) + "weight"] = _interleave_neox_qkv(layers["wqkv"][i].T, hq, hd)
        out[_HF_NEOX_QKV.format(i) + "bias"] = _interleave_neox_qkv(layers["b_qkv"][i], hq, hd)
    return out


def export_hf_gptneox(params: Dict[str, Any], cfg, path: str) -> str:
    """The port's GPT-NeoX parameters → HF-format safetensors (the inverse
    of :func:`convert_hf_gptneox`)."""
    return save_safetensors(hf_tensors_gptneox(params, cfg), path)


# ------------------------------------------------------------ mixtral


_HF_MIXTRAL_ATTN: Dict[str, Tuple[str, bool]] = {
    "wq": ("model.layers.{}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{}.self_attn.v_proj.weight", True),
    "wo": ("model.layers.{}.self_attn.o_proj.weight", True),
    "ln_attn": ("model.layers.{}.input_layernorm.weight", False),
    "ln_mlp": ("model.layers.{}.post_attention_layernorm.weight", False),
}
_HF_MIXTRAL_ROUTER = "model.layers.{}.block_sparse_moe.gate.weight"
# HF expert naming: w1 = gate, w2 = down, w3 = up (all stored (out, in))
_HF_MIXTRAL_EXPERTS: Dict[str, str] = {
    "w_gate": "model.layers.{}.block_sparse_moe.experts.{}.w1.weight",
    "w_down": "model.layers.{}.block_sparse_moe.experts.{}.w2.weight",
    "w_up": "model.layers.{}.block_sparse_moe.experts.{}.w3.weight",
}


def _mixtral_body(reader, params, cfg, note, take, shard=None) -> None:
    L, E = cfg.n_layers, cfg.n_experts
    _check_depth(reader, L, f"model.layers.{L - 1}.input_layernorm.weight")
    layers = params["layers"]
    for ours, (tmpl, transpose) in _HF_MIXTRAL_ATTN.items():
        note(f"converting {ours} ({L} layers)")
        _fill_stacked(layers[ours], reader, tmpl, transpose, take(f"layers/{ours}"))
    note("converting router")  # HF gate.weight is (E, d); the port's (L, d, E) f32
    _fill_stacked(layers["router"], reader, _HF_MIXTRAL_ROUTER, True)
    # a rank of the expert axis reads its own experts only, each cut to its
    # block of d_ff by ``take``
    experts = range(E) if shard is None else shard.experts(E)
    for ours, tmpl in _HF_MIXTRAL_EXPERTS.items():
        note(f"converting {ours} ({L} layers x {len(experts)} of {E} experts)")
        for i in range(L):
            for j, e in enumerate(experts):
                _fill(layers[ours][i, j], reader, tmpl.format(i, e), True,
                      take(f"layers/{ours}"))
    note("converting embed / final_norm / lm_head")
    _fill(params["embed"], reader, "model.embed_tokens.weight", False, take("embed"))
    _fill(params["final_norm"], reader, "model.norm.weight", False)
    _fill(params["lm_head"], reader, "lm_head.weight", True, take("lm_head"))


def convert_hf_mixtral(path: str, cfg, device: Device = None,
                       progress: Optional[Callable[[str], None]] = None,
                       shard=None) -> Dict[str, Any]:
    """HF MixtralForCausalLM safetensors checkpoint → the port's parameter
    dict on ``device`` (expert-stacked (L, E, in, out) FFN weights, the
    router in float32); with a ``ModelShard`` the rank's blocks: its heads
    and vocabulary block, and its experts at its block of d_ff."""
    return _convert("mixtral", functools.partial(_mixtral_body, shard=shard), path, cfg, device,
                    progress, shard)


def hf_tensors_mixtral(params: Dict[str, Any], cfg) -> Dict[str, torch.Tensor]:
    """The HF names of a Mixtral parameter dict (views; the router stays
    float32)."""
    layers = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"],
           "model.norm.weight": params["final_norm"],
           "lm_head.weight": params["lm_head"].T}
    for ours, (tmpl, transpose) in _HF_MIXTRAL_ATTN.items():
        for i in range(cfg.n_layers):
            t = layers[ours][i]
            out[tmpl.format(i)] = t.T if transpose else t
    for i in range(cfg.n_layers):
        out[_HF_MIXTRAL_ROUTER.format(i)] = layers["router"][i].T.float()
    for ours, tmpl in _HF_MIXTRAL_EXPERTS.items():
        for i in range(cfg.n_layers):
            for e in range(cfg.n_experts):
                out[tmpl.format(i, e)] = layers[ours][i, e].T
    return out


def export_hf_mixtral(params: Dict[str, Any], cfg, path: str) -> str:
    """The port's Mixtral parameters → HF-format safetensors (the inverse
    of :func:`convert_hf_mixtral`)."""
    return save_safetensors(hf_tensors_mixtral(params, cfg), path)


CONVERTERS: Dict[str, Callable[..., Dict[str, Any]]] = {
    "llama": convert_hf_llama,
    "gptneox": convert_hf_gptneox,
    "mixtral": convert_hf_mixtral,
}
# each family's HF names of its parameters (what the exporters write)
HF_TENSORS: Dict[str, Callable[..., Dict[str, torch.Tensor]]] = {
    "llama": hf_tensors_llama,
    "gptneox": hf_tensors_gptneox,
    "mixtral": hf_tensors_mixtral,
}


def load_pretrained(family_name: str, path: str, cfg, device: Device = None,
                    shard=None) -> Dict[str, Any]:
    """What the entry point calls: convert ``path`` for ``family_name`` onto
    ``device`` (default CUDA; raises when no card is visible). With a
    ``parallel.sharding.ModelShard`` each rank reads every tensor it holds
    a block of, a layer (and an expert) at a time, and keeps its block."""
    try:
        converter = CONVERTERS[family_name]
    except KeyError:
        raise ValueError(f"no safetensors converter for family {family_name!r} "
                         f"(have: {sorted(CONVERTERS)})")
    return converter(path, cfg, device=device, shard=shard)
