"""The Orbax checkpoint step layout, as the JAX package's ``Checkpointer``
(``nexus_tpu/train/checkpoint.py``) writes it through Orbax's
``StandardCheckpointHandler`` with OCDBT and zarr v2, read and written
without Orbax.

A step ``<directory>/<step>/``:

* ``_CHECKPOINT_METADATA`` — the item handler and the init / commit times;
* ``default/_METADATA`` — JSON: one ``tree_metadata`` entry per tree path of
  the train state, keyed ``str(path)`` (e.g. ``"('params', 'embed')"``),
  with each key's type (2: a dict key or field name, 1: a sequence index)
  and the value's type (``jax.Array`` with its ``write_shape``, or
  ``None`` for optax's empty states, which hold no array);
* ``default/_sharding`` and ``default/array_metadatas/process_0`` — each
  array's device and its write / chunk shapes;
* ``default/`` itself is an OCDBT store (utils/ocdbt.py) holding, for each
  array named ``'.'.join(path)``, ``<name>/.zarray`` (zarr v2 metadata
  JSON) and its chunks ``<name>/0.0`` (one per array from one device), each
  a zstd frame of the chunk's C-order bytes.

The tree paths of the port's ``TrainState`` (derived from a ``_METADATA``
that JAX wrote for each family, with and without warmup): the params by
sorted key (a list's items by index), then optax's
``chain(clip_by_global_norm, adamw)`` state: ``opt_state.0`` (None),
``opt_state.1.0.{count,mu.*,nu.*}``, ``opt_state.1.1`` (None),
``opt_state.1.2.count`` with a schedule or ``opt_state.1.2`` (None)
without, then ``step``. The counts and the step are Python ints in the
port and ``<i4`` scalars on disk.

Writes differ from Orbax's in bytes but not in content: chunks are zstd
frames of raw blocks (Orbax compresses at level 1), the OCDBT store is one
version with its own file names and uuid, and there is no per-process
sub-store. Values, shapes, dtypes and tree paths are equal.
"""

from __future__ import annotations

import base64
import itertools
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from nexus_tpu_torch.train.tensor_leaves import BlockTarget, is_array, materialize
from nexus_tpu_torch.utils import ocdbt, zstd

ITEM = "default"
HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
TMP_MARK = ".orbax-checkpoint-tmp-"
DICT_KEY, SEQUENCE_KEY = 2, 1

# zarr v2 dtype strings of a train state's leaves (as tensorstore writes
# them) and the numpy dtype a chunk decodes into (bf16 as its 16-bit
# patterns)
_ZARR_DTYPE = {torch.bfloat16: "bfloat16", torch.float32: "<f4", torch.float16: "<f2",
               torch.int32: "<i4"}
_HOST_DTYPE = {"bfloat16": np.int16, "<f4": np.float32, "<f2": np.float16, "<i4": np.int32}


@dataclass
class Leaf:
    """One tree path of a train state and its value: a tensor, a Python int
    (stored as an int32 scalar) or None (an empty optax state)."""
    keys: Tuple[str, ...]
    key_types: Tuple[int, ...]
    value: Any

    @property
    def name(self) -> str:
        return ".".join(self.keys)

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self.value.shape) if is_array(self.value) else ()


def _tree(tree, keys: Tuple[str, ...], types: Tuple[int, ...]):
    pairs = (sorted(tree.items()) if isinstance(tree, dict)
             else ((str(i), v) for i, v in enumerate(tree)))
    kind = DICT_KEY if isinstance(tree, dict) else SEQUENCE_KEY
    for key, value in pairs:
        if isinstance(value, (dict, list)):
            yield from _tree(value, keys + (key,), types + (kind,))
        else:
            yield Leaf(keys + (key,), types + (kind,), value)


def param_leaves(params) -> List[Leaf]:
    return list(_tree(params, ("params",), (DICT_KEY,)))


def state_leaves(state) -> List[Leaf]:
    """Every tree path of ``state`` in JAX's flatten order (the module doc)."""
    params = param_leaves(state.params)
    pos = {id(t): i for i, t in enumerate(state.leaves)}
    opt = state.opt_state
    adam = ("opt_state", "1", "0")
    adam_types = (DICT_KEY, SEQUENCE_KEY, SEQUENCE_KEY)
    out = list(params)
    out.append(Leaf(("opt_state", "0"), (DICT_KEY, SEQUENCE_KEY), None))
    out.append(Leaf(adam + ("count",), adam_types + (DICT_KEY,), opt.count))
    for moment, values in (("mu", opt.mu), ("nu", opt.nu)):
        for p in params:
            out.append(Leaf(adam + (moment,) + p.keys[1:], adam_types + (DICT_KEY,) + p.key_types[1:],
                            values[pos[id(p.value)]]))
    out.append(Leaf(("opt_state", "1", "1"), adam_types[:2] + (SEQUENCE_KEY,), None))
    if opt.schedule_count is None:
        out.append(Leaf(("opt_state", "1", "2"), adam_types[:2] + (SEQUENCE_KEY,), None))
    else:
        out.append(Leaf(("opt_state", "1", "2", "count"), adam_types + (DICT_KEY,),
                        opt.schedule_count))
    out.append(Leaf(("step",), (DICT_KEY,), state.step))
    return out


def zarr_dtype(x) -> str:
    if not is_array(x):
        return "<i4"
    if x.dtype not in _ZARR_DTYPE:
        raise ValueError(f"no zarr dtype for {x.dtype}")
    return _ZARR_DTYPE[x.dtype]


def zarray(shape: Sequence[int], dtype: str) -> bytes:
    """The ``.zarray`` JSON of a one-chunk array, byte for byte as
    tensorstore writes it for Orbax."""
    return json.dumps({"chunks": list(shape), "compressor": {"id": "zstd", "level": 1},
                       "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                       "filters": None, "order": "C", "shape": list(shape), "zarr_format": 2},
                      separators=(",", ":")).encode()


def _chunk_key(index: Sequence[int]) -> str:
    return ".".join(str(i) for i in index) if len(index) else "0"


def _host(x) -> np.ndarray:
    """The C-order host bytes of a leaf (a tensor, a gathered leaf or a
    Python int)."""
    x = materialize(x)
    if not torch.is_tensor(x):
        return np.asarray(x, dtype=np.int32)
    x = x.detach().contiguous().cpu()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return x.numpy()


def _device_str(x) -> str:
    """The device as JAX names it (``str(jax.Device)``)."""
    if is_array(x) and x.device.type == "cuda":
        return f"cuda:{x.device.index or 0}"
    return "TFRT_CPU_0"


# ------------------------------------------------------------------ writer
def write_step(path: str, state) -> int:
    """Write ``state`` as an Orbax step directory at ``path`` (created).
    Returns the bytes of array data written (chunk frames)."""
    init = time.time_ns()
    item = os.path.join(path, ITEM)
    store = ocdbt.Writer(item)
    leaves = state_leaves(state)
    arrays = [leaf for leaf in leaves if leaf.value is not None]
    written = 0
    for leaf in arrays:
        store.put(f"{leaf.name}/.zarray", zarray(leaf.shape, zarr_dtype(leaf.value)))
        host = _host(leaf.value)
        written += store.put_frame(f"{leaf.name}/{_chunk_key([0] * host.ndim)}",
                                   np.ascontiguousarray(host).reshape(-1).view(np.uint8))
        del host  # one leaf on the host at a time
    store.commit()
    tree = {}
    for leaf in leaves:
        value = ({"value_type": "None", "skip_deserialize": True} if leaf.value is None else
                 {"value_type": "jax.Array", "skip_deserialize": False,
                  "write_shape": list(leaf.shape)})
        tree[str(leaf.keys)] = {
            "key_metadata": [{"key": k, "key_type": t} for k, t in zip(leaf.keys, leaf.key_types)],
            "value_metadata": value}
    _write_json(os.path.join(item, "_METADATA"), {
        "tree_metadata": tree, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None})
    sharding = {base64.b64encode(leaf.name.encode()).decode(): json.dumps(
        {"sharding_type": "SingleDeviceSharding", "device_str": _device_str(leaf.value)})
        for leaf in sorted(arrays, key=lambda a: a.name)}
    _write_json(os.path.join(item, "_sharding"), sharding, separators=(",", ":"))
    os.makedirs(os.path.join(item, "array_metadatas"), exist_ok=True)
    _write_json(os.path.join(item, "array_metadatas", "process_0"), {"array_metadatas": [
        {"array_metadata": {"param_name": leaf.name, "write_shape": list(leaf.shape),
                            "chunk_shape": list(leaf.shape), "ext_metadata": None}}
        for leaf in arrays]})
    _write_json(os.path.join(path, "_CHECKPOINT_METADATA"), {
        "item_handlers": {ITEM: HANDLER}, "metrics": {}, "performance_metrics": {},
        "init_timestamp_nsecs": init, "commit_timestamp_nsecs": time.time_ns(),
        "custom_metadata": {}})
    return written


def _write_json(path: str, obj, separators=None) -> None:
    with open(path, "w") as f:
        f.write(json.dumps(obj, separators=separators))
        f.flush()
        os.fsync(f.fileno())


# ------------------------------------------------------------------ reader
class StepReader:
    """An Orbax step directory, open for restores into tensors in place."""

    def __init__(self, path: str):
        self.path = path
        item = os.path.join(path, ITEM)
        meta_path = os.path.join(item, "_METADATA")
        if not os.path.isfile(meta_path):
            raise FileNotFoundError(f"{path} is not an Orbax step (no {ITEM}/_METADATA)")
        with open(meta_path) as f:
            meta = json.load(f)
        if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
            raise ValueError(f"{meta_path}: only OCDBT with zarr v2 is supported "
                             f"(use_ocdbt {meta.get('use_ocdbt')}, use_zarr3 {meta.get('use_zarr3')})")
        self.tree: Dict[str, dict] = meta["tree_metadata"]
        self.store = ocdbt.Reader(item)

    @property
    def bytes_read(self) -> int:
        return self.store.bytes_read

    def check_structure(self, leaves: List[Leaf], what: str) -> None:
        """Raise when the step's tree paths (under the leaves' first key,
        or all of them for a whole state) differ from ``leaves``'."""
        want = [str(leaf.keys) for leaf in leaves]
        top = {leaf.keys[0] for leaf in leaves}
        have = [k for k, e in self.tree.items()
                if e["key_metadata"][0]["key"] in top]
        if have != want:
            missing = sorted(set(want) - set(have))[:4]
            extra = sorted(set(have) - set(want))[:4]
            raise ValueError(f"checkpoint {self.path} holds {len(have)} {what} entries but the "
                             f"restore target has {len(want)}: structure drift (another model "
                             f"or optimizer than the one saved; missing {missing}, extra {extra})")

    def _zarray(self, name: str) -> dict:
        meta = json.loads(self.store.read(f"{name}/.zarray"))
        if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{name}: only C-order zarr v2 without filters is supported: {meta}")
        if (meta.get("compressor") or {}).get("id") != "zstd":
            raise ValueError(f"{name}: compressor {meta.get('compressor')} is not zstd")
        if meta["dtype"] not in _HOST_DTYPE:
            raise ValueError(f"{name}: dtype {meta['dtype']} is not supported")
        return meta

    def _chunks(self, name: str, meta: dict):
        """(chunk index, host array of the chunk's shape), one at a time:
        the frame decodes straight into a buffer of the chunk's size."""
        shape, chunks = meta["shape"], meta["chunks"]
        dtype = np.dtype(_HOST_DTYPE[meta["dtype"]])
        grid = [-(-s // c) for s, c in zip(shape, chunks)]
        for index in itertools.product(*(range(g) for g in grid)):
            key = f"{name}/{_chunk_key(index)}"
            buf = np.empty(chunks, dtype=dtype)
            view = self.store.value(key)
            try:
                n = zstd.decompress(view, out=buf).nbytes
                err = None if n == buf.nbytes else f"{n} bytes, expected {buf.nbytes}"
            except ValueError as e:
                err = str(e)  # the traceback (and its views of the map) ends here
            view.release()
            if err is not None:
                raise ValueError(f"checkpoint chunk {key}: {err}")
            yield index, buf
            del buf  # the host holds one decoded chunk

    def read_into(self, name: str, target: torch.Tensor) -> None:
        """Copy the array ``name`` into ``target`` in place (cast to its
        dtype), one chunk at a time."""
        meta = self._zarray(name)
        if tuple(meta["shape"]) != tuple(target.shape):
            raise ValueError(f"checkpoint array {name} has shape {tuple(meta['shape'])}, the "
                             f"restore target {tuple(target.shape)}")
        chunks = meta["chunks"]
        with torch.no_grad():
            for index, buf in self._chunks(name, meta):
                src = torch.from_numpy(buf)
                if meta["dtype"] == "bfloat16":
                    src = src.view(torch.bfloat16)
                region = tuple(slice(i * c, min((i + 1) * c, s))
                               for i, c, s in zip(index, chunks, meta["shape"]))
                src = src[tuple(slice(0, r.stop - r.start) for r in region)]
                target[region].copy_(src)
                del src, buf

    def read_int(self, name: str) -> int:
        meta = self._zarray(name)
        if meta["shape"]:
            raise ValueError(f"checkpoint array {name} has shape {meta['shape']}, not a scalar")
        (_, buf), = self._chunks(name, meta)
        return int(buf)

    def close(self):
        self.store.close()


def restore_leaves(path: str, leaves: List[Leaf], what: str) -> Tuple[Dict[str, int], int]:
    """Read the step at ``path`` into ``leaves`` (tensors in place).
    Returns the ints by name and the value bytes read."""
    reader = StepReader(path)
    try:
        reader.check_structure(leaves, what)
        ints = {}
        for leaf in leaves:
            if leaf.value is None:
                continue
            if isinstance(leaf.value, BlockTarget):  # read whole on the host, keep the block
                whole = torch.empty(leaf.value.shape, dtype=leaf.value.dtype)
                reader.read_into(leaf.name, whole)
                leaf.value.copy_(whole)
                del whole
            elif torch.is_tensor(leaf.value):
                reader.read_into(leaf.name, leaf.value)
            else:
                ints[leaf.name] = reader.read_int(leaf.name)
        return ints, reader.bytes_read
    finally:
        reader.close()


def staging_name(step: int) -> str:
    return f"{step}{TMP_MARK}{time.time_ns()}"


def find_step(directory: str, step: int) -> str:
    path = os.path.join(directory, str(step))
    if not os.path.isdir(os.path.join(path, ITEM)):
        raise FileNotFoundError(f"checkpoint step {step} under {directory} has no {ITEM}/ item")
    return path
