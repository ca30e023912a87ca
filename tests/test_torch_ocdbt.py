"""The port's OCDBT reader and writer (nexus_tpu_torch.utils.ocdbt) and its
CRC32C (nexus_tpu_torch.utils.crc32c), against tensorstore.

The reader must list the same keys and values as tensorstore over a step
the JAX package wrote (the committed fixture tests/data/orbax_llama_tiny/)
and over a store tensorstore wrote with small nodes and many versions
(interior b-tree nodes, version-tree nodes, an empty first version).
tensorstore must read the stores the port writes. Every frame's CRC32C is
checked; a flipped byte raises.
"""

import os
import shutil
import struct

import numpy as np
import pytest

from nexus_tpu_torch.utils import ocdbt, zstd
from nexus_tpu_torch.utils.crc32c import crc32c

ts = pytest.importorskip("tensorstore")

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "orbax_llama_tiny")
JAX_STORE = os.path.join(FIXTURE, "orbax", "1", "default")


def _ts_items(root, version=None):
    spec = {"driver": "ocdbt", "base": f"file://{root}/"}
    if version is not None:
        spec["version"] = version
    kv = ts.KvStore.open(spec).result()
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _port_items(root, generation=None):
    with ocdbt.Reader(root, generation=generation) as r:
        return {k: r.read(k) for k in r.keys()}


@pytest.fixture(scope="module")
def many_versions(tmp_path_factory):
    """A store tensorstore wrote one key at a time: 61 versions (the first
    empty), nodes of at most 300 bytes (interior nodes), 2-entry version
    nodes (a version tree of height > 0), values inline and in data files."""
    root = str(tmp_path_factory.mktemp("ts") / "store")
    spec = {"driver": "ocdbt", "base": f"file://{root}/",
            "config": {"max_decoded_node_bytes": 300, "version_tree_arity_log2": 1,
                       "max_inline_value_bytes": 16, "compression": {"id": "zstd", "level": 5}}}
    kv = ts.KvStore.open(spec).result()
    rng = np.random.default_rng(0)
    for i in range(60):
        key = f"params.layer{i % 4}.w{int(rng.integers(0, 1000)):04d}/{i}"
        kv.write(key, rng.integers(0, 256, int(rng.integers(0, 40))).astype(np.uint8).tobytes()
                 ).result()
    return root


def test_the_reader_equals_tensorstore_over_a_jax_written_step():
    ref = _ts_items(JAX_STORE)
    got = _port_items(JAX_STORE)
    assert list(got) == sorted(ref)
    assert got == ref
    # the arrays' chunks and their zarr metadata, one of each per array
    names = {k.rsplit(b"/", 1)[0] for k in got}
    assert all(n + b"/.zarray" in got for n in names) and len(got) == 2 * len(names)


def test_the_reader_walks_interior_and_version_nodes(many_versions):
    with ocdbt.Reader(many_versions) as r:
        assert r.version.root_height > 0  # interior b-tree nodes
        assert r._version_nodes  # versions in version-tree nodes
        versions = r.versions()
    assert [v.generation for v in versions] == list(range(1, 62))
    assert versions[0].root is None and versions[0].num_keys == 0  # the empty first version
    assert _port_items(many_versions) == _ts_items(many_versions)
    for generation in (1, 2, 17, 40, 61):
        got = _port_items(many_versions, generation)
        assert got == _ts_items(many_versions, generation)
        assert len(got) == generation - 1


@pytest.mark.parametrize("node_bytes", [100_000_000, 400])
def test_tensorstore_reads_a_store_the_port_wrote(tmp_path, node_bytes):
    cfg = ocdbt.Config(uuid=os.urandom(16), max_decoded_node_bytes=node_bytes)
    writer = ocdbt.Writer(str(tmp_path), cfg)
    rng = np.random.default_rng(1)
    want = {}
    for i in range(120):
        key = f"opt_state.1.0.mu.w{i:03d}/" + ("0.0" if i % 2 else ".zarray")
        value = rng.integers(0, 256, int(rng.integers(0, 2500))).astype(np.uint8).tobytes()
        if i % 3:
            writer.put(key, value)
            want[key.encode()] = value
        else:
            writer.put_frame(key, value)
            want[key.encode()] = zstd.compress_raw(value)
    version = writer.commit()
    assert (version.root_height > 0) == (node_bytes == 400)
    assert version.num_keys == 120
    assert _ts_items(str(tmp_path)) == want
    assert _port_items(str(tmp_path)) == want
    with pytest.raises(KeyError, match="written twice"):
        writer.put("opt_state.1.0.mu.w001/0.0", b"x")


# ---------------------------------------------------------------- CRC32C


@pytest.mark.parametrize("data,crc", [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),  # RFC 3720 B.4
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
])
def test_crc32c_vectors(data, crc):
    assert crc32c(data) == crc
    assert crc32c(data[5:], crc32c(data[:5])) == crc


def _frames(root):
    """Every manifest and node frame under ``root``: (path, offset, length)
    from the frames' own length fields, files walked front to back."""
    out = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            path = os.path.join(dirpath, name)
            data = open(path, "rb").read()
            pos = 0
            while pos + 12 <= len(data) and data[pos:pos + 2] == b"\x0c\xdb":
                length = struct.unpack("<Q", data[pos + 4:pos + 12])[0]
                out.append((path, pos, length))
                pos += length
    return out


def test_every_frame_of_a_jax_step_carries_its_crc32c():
    frames = _frames(JAX_STORE)
    assert len(frames) >= 4  # two manifests, the root node, the sub-store's nodes
    for path, pos, length in frames:
        data = open(path, "rb").read()[pos:pos + length]
        assert crc32c(data[:-4]) == struct.unpack("<I", data[-4:])[0], (path, pos)


@pytest.mark.parametrize("where", ["manifest", "node"])
def test_a_flipped_byte_raises(tmp_path, where):
    root = str(tmp_path / "store")
    shutil.copytree(JAX_STORE, root)
    path = os.path.join(root, "manifest.ocdbt")
    if where == "node":
        path = os.path.join(root, "d", os.listdir(os.path.join(root, "d"))[0])
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x01
    open(path, "wb").write(bytes(data))
    with pytest.raises(ocdbt.CorruptStore, match="CRC32C"):
        with ocdbt.Reader(root) as r:
            r.keys()


def test_a_wrong_length_field_raises(tmp_path):
    root = str(tmp_path / "store")
    shutil.copytree(JAX_STORE, root)
    path = os.path.join(root, "manifest.ocdbt")
    data = bytearray(open(path, "rb").read())
    data[4:12] = struct.pack("<Q", len(data) + 1)
    open(path, "wb").write(bytes(data))
    with pytest.raises(ocdbt.CorruptStore, match="length field"):
        ocdbt.Reader(root)


def test_values_read_are_counted_and_views_are_of_the_mapped_file():
    with ocdbt.Reader(JAX_STORE) as r:
        key = next(k for k in r.keys() if k.endswith(b"/0.0"))
        ref = r.entries()[key]
        assert isinstance(ref, ocdbt.Ref) and ref.path.startswith("ocdbt.process_0/d/")
        with r.value(key) as view:
            assert len(view) == ref.length
            frame = bytes(view)
        assert r.bytes_read == ref.length
        assert zstd.decompress(frame).nbytes > 0
