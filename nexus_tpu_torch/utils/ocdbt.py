"""A reader and a writer of OCDBT, the on-disk format of tensorstore's
``ocdbt`` key-value store (tensorstore's "OCDBT on-disk format"), in which
Orbax keeps a checkpoint's arrays.

A store is a directory with ``manifest.ocdbt`` and data files under ``d/``.
Every manifest and node is framed the same way: a 4-byte big-endian magic
(``0x0cdb3a2a`` manifest, ``0x0cdb20de`` b-tree node, ``0x0cdb1234``
version-tree node), a little-endian u64 length (the frame's size), a
format version varint (0), a compression varint (0 none, 1 zstd), the body,
and the CRC32C of everything before it in the last 4 bytes. A data file
may hold several frames and values back to back: a reference is (data
file, offset, length).

The manifest holds the config, then the versions: the newest inline, the
older ones in version-tree nodes. A version names the root of its b-tree.
Interior b-tree entries hold a child reference and the length of the key
prefix that every key of the child shares (the child stores its keys
without it); leaf entries hold a value inline or a reference to one.
Fields are stored in columns (every entry's first field, then every
entry's second, ...), integers as LEB128 varints.

``Reader`` checks every frame's length and CRC32C, resolves inline and
indirect values (through ``mmap``) and counts the bytes it hands out.
``Writer`` makes a store of one version: values appended to one data file,
leaf nodes split under ``max_decoded_node_bytes``, interior nodes above
them when one leaf does not suffice, node bodies as zstd frames of raw
blocks (valid zstd: the config says zstd, as Orbax's does).
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import uuid as uuidlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from nexus_tpu_torch.utils import zstd
from nexus_tpu_torch.utils.crc32c import crc32c

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_MAGIC = 0x0CDB1234
_HEADER = 4 + 8


class CorruptStore(ValueError):
    pass


# ------------------------------------------------------------------ encoding
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Cursor:
    """Reads a decoded body front to back."""

    __slots__ = ("buf", "pos", "what")

    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def _need(self, n: int):
        if self.pos + n > len(self.buf):
            raise CorruptStore(f"{self.what}: truncated at byte {self.pos}")

    def varint(self) -> int:
        out, shift = 0, 0
        while True:
            self._need(1)
            b = self.buf[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7
            if shift > 63:
                raise CorruptStore(f"{self.what}: varint too long at byte {self.pos}")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8(self) -> int:
        self._need(1)
        self.pos += 1
        return self.buf[self.pos - 1]

    def fixed(self, n: int) -> bytes:
        self._need(n)
        self.pos += n
        return bytes(self.buf[self.pos - n:self.pos])

    def u64s(self, n: int) -> List[int]:
        return [struct.unpack("<Q", self.fixed(8))[0] for _ in range(n)]

    def end(self):
        if self.pos != len(self.buf):
            raise CorruptStore(f"{self.what}: {len(self.buf) - self.pos} bytes after the body")


def _frame(magic: int, body: bytes) -> bytes:
    """A frame of ``body``: compression zstd, the body a raw-block frame."""
    packed = zstd.compress_raw(body)
    head = struct.pack(">I", magic) + struct.pack("<Q", _HEADER + 2 + len(packed) + 4) + b"\x00\x01"
    data = head + packed
    return data + struct.pack("<I", crc32c(data))


def unframe(data, magic: int, what: str) -> bytes:
    """The decoded body of a frame, after checking its magic, length and
    CRC32C."""
    data = memoryview(data)
    if len(data) < _HEADER + 2 + 4:
        raise CorruptStore(f"{what}: {len(data)} bytes is too short for a frame")
    got_magic = struct.unpack(">I", data[:4])[0]
    if got_magic != magic:
        raise CorruptStore(f"{what}: magic {got_magic:#010x}, expected {magic:#010x}")
    length = struct.unpack("<Q", data[4:12])[0]
    if length != len(data):
        raise CorruptStore(f"{what}: length field {length} but the frame is {len(data)} bytes")
    want = struct.unpack("<I", data[-4:])[0]
    got = crc32c(data[:-4])
    if want != got:
        raise CorruptStore(f"{what}: CRC32C {got:#010x} computed, {want:#010x} stored")
    cur = _Cursor(bytes(data[_HEADER:-4]), what)
    version, compression = cur.varint(), cur.varint()
    if version != 0:
        raise CorruptStore(f"{what}: format version {version} is not 0")
    body = cur.buf[cur.pos:]
    if compression == 0:
        return body
    if compression == 1:
        try:
            return zstd.decompress(body).tobytes()
        except ValueError as e:
            raise CorruptStore(f"{what}: {e}") from e
    raise CorruptStore(f"{what}: compression format {compression} is not 0 or 1")


# ------------------------------------------------------------------ structures
@dataclass
class Config:
    uuid: bytes
    manifest_kind: int = 0  # 0: one manifest file
    max_inline_value_bytes: int = 1024
    max_decoded_node_bytes: int = 100_000_000
    version_tree_arity_log2: int = 4
    compression: int = 1  # 0 none, 1 zstd
    zstd_level: int = 0

    def encode(self) -> bytes:
        out = (self.uuid + _varint(self.manifest_kind) + _varint(self.max_inline_value_bytes)
               + _varint(self.max_decoded_node_bytes) + bytes([self.version_tree_arity_log2])
               + _varint(self.compression))
        if self.compression == 1:
            out += struct.pack("<i", self.zstd_level)
        return out

    @classmethod
    def decode(cls, cur: _Cursor) -> "Config":
        c = cls(uuid=cur.fixed(16), manifest_kind=cur.varint(),
                max_inline_value_bytes=cur.varint(), max_decoded_node_bytes=cur.varint(),
                version_tree_arity_log2=cur.u8(), compression=cur.varint())
        if c.compression == 1:
            c.zstd_level = struct.unpack("<i", cur.fixed(4))[0]
        elif c.compression != 0:
            raise CorruptStore(f"{cur.what}: config compression {c.compression}")
        return c


@dataclass(frozen=True)
class Ref:
    """``length`` bytes at ``offset`` of the data file ``path`` (relative to
    the store's directory)."""
    path: str
    offset: int
    length: int


@dataclass
class Version:
    generation: int
    root: Optional[Ref]
    root_height: int
    num_keys: int
    num_tree_bytes: int
    num_indirect_value_bytes: int
    commit_time: int


def _read_files(cur: _Cursor) -> List[str]:
    """A data file table: count, shared-prefix lengths (all but the first),
    suffix lengths, base-path lengths, then the suffixes; a path is its
    base path joined to its relative path."""
    n = cur.varint()
    prefix = [0] + cur.varints(max(n - 1, 0))
    suffix = cur.varints(n)
    cur.varints(n)  # base path lengths: the path is what resolves
    out, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            raise CorruptStore(f"{cur.what}: data file prefix past the previous path")
        path = prev[:prefix[i]] + cur.fixed(suffix[i])
        out.append(path.decode())
        prev = path
    return out


def _shared_prefixes(items: List[bytes]) -> List[int]:
    """The length of the prefix each item shares with the one before it."""
    out, prev = [], b""
    for it in items:
        n = 0
        while n < min(len(it), len(prev)) and it[n] == prev[n]:
            n += 1
        out.append(n)
        prev = it
    return out


def _write_files(paths: List[str]) -> bytes:
    """A data file table of paths relative to the store (base paths empty)."""
    enc = [p.encode() for p in paths]
    prefix = _shared_prefixes(enc)
    out = _varint(len(enc)) + b"".join(_varint(k) for k in prefix[1:])
    out += b"".join(_varint(len(p) - k) for p, k in zip(enc, prefix))
    out += b"".join(_varint(0) for _ in enc)
    return out + b"".join(p[k:] for p, k in zip(enc, prefix))


def _refs(cur: _Cursor, files: List[str], n: int, with_length: bool = True) -> List[Tuple]:
    ids = cur.varints(n)
    for i in ids:
        if i >= len(files):
            raise CorruptStore(f"{cur.what}: data file id {i} of {len(files)}")
    offsets = cur.varints(n)
    lengths = cur.varints(n) if with_length else [None] * n
    return [(files[i], o, ln) for i, o, ln in zip(ids, offsets, lengths)]


def _read_keys(cur: _Cursor, n: int) -> Tuple[List[int], List[int]]:
    prefix = [0] + cur.varints(n - 1)
    suffix = cur.varints(n)
    return prefix, suffix


def _decode_keys(cur: _Cursor, prefix: List[int], suffix: List[int]) -> List[bytes]:
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise CorruptStore(f"{cur.what}: key prefix past the previous key")
        k = prev[:p] + cur.fixed(s)
        keys.append(k)
        prev = k
    return keys


def _read_generation_refs(cur: _Cursor, files: List[str], n: int) -> List[Version]:
    gens = cur.varints(n)
    heights = [cur.u8() for _ in range(n)]
    refs = _refs(cur, files, n)
    num_keys, tree_bytes, indirect = cur.varints(n), cur.varints(n), cur.varints(n)
    times = cur.u64s(n)
    # an empty tree's root is missing: an empty data file path
    return [Version(g, Ref(*r) if r[0] else None, h, k, t, i, c)
            for g, h, r, k, t, i, c in zip(gens, heights, refs, num_keys, tree_bytes, indirect,
                                           times)]


# ------------------------------------------------------------------ reader
InlineOrRef = Union[bytes, Ref]


class Reader:
    """An OCDBT store at ``root``, opened at its newest version (or at
    ``generation``)."""

    def __init__(self, root: str, generation: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.bytes_read = 0  # value bytes handed out (inline and indirect)
        self._maps: Dict[str, mmap.mmap] = {}
        self._files: Dict[str, object] = {}
        path = os.path.join(self.root, "manifest.ocdbt")
        with open(path, "rb") as f:
            body = unframe(f.read(), MANIFEST_MAGIC, path)
        cur = _Cursor(body, path)
        self.config = Config.decode(cur)
        if self.config.manifest_kind != 0:
            raise CorruptStore(f"{path}: manifest kind {self.config.manifest_kind} (numbered "
                               "manifests) is not supported")
        files = _read_files(cur)
        self._inline = _read_generation_refs(cur, files, cur.varint())
        n = cur.varint()
        cur.varints(n)  # generation numbers
        refs = _refs(cur, files, n)
        cur.varints(n)  # generation counts
        cur.u64s(n)  # commit times
        heights = [cur.u8() for _ in range(n)]
        cur.end()
        self._version_nodes = [(Ref(*r), h) for r, h in zip(refs, heights)]
        versions = self.versions() if generation is not None else self._inline
        if not versions:
            raise CorruptStore(f"{path}: no versions")
        if generation is None:
            self.version = max(versions, key=lambda v: v.generation)
        else:
            match = [v for v in versions if v.generation == generation]
            if not match:
                raise KeyError(f"{self.root} has no generation {generation}")
            self.version = match[0]
        self._leaves: Optional[Dict[bytes, InlineOrRef]] = None

    # -------------------------------------------------------------- frames
    def _map(self, path: str) -> mmap.mmap:
        m = self._maps.get(path)
        if m is None:
            full = os.path.join(self.root, path)
            f = open(full, "rb")
            self._files[path] = f
            m = self._maps[path] = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return m

    def _slice(self, ref: Ref) -> memoryview:
        m = self._map(ref.path)
        if ref.offset + ref.length > len(m):
            raise CorruptStore(f"{ref.path}: reference [{ref.offset}, +{ref.length}) past the "
                               f"file's {len(m)} bytes")
        return memoryview(m)[ref.offset:ref.offset + ref.length]

    def _node(self, ref: Ref, magic: int) -> bytes:
        with self._slice(ref) as view:
            data = bytes(view)  # nodes are small; no view of the map outlives this
        return unframe(data, magic, f"{ref.path}@{ref.offset}")

    # ------------------------------------------------------------ versions
    def versions(self) -> List[Version]:
        """Every version, oldest first: the version-tree nodes' and the
        manifest's inline ones."""
        out: List[Version] = []

        def walk(ref: Ref, height: int):
            what = f"{ref.path}@{ref.offset}"
            cur = _Cursor(self._node(ref, VERSION_MAGIC), what)
            arity_log2, node_height = cur.u8(), cur.u8()
            if node_height != height or arity_log2 != self.config.version_tree_arity_log2:
                raise CorruptStore(f"{what}: version node height {node_height} / arity "
                                   f"{arity_log2}, expected {height} / "
                                   f"{self.config.version_tree_arity_log2}")
            files = _read_files(cur)
            n = cur.varint()
            if height == 0:
                out.extend(_read_generation_refs(cur, files, n))
                cur.end()
                return
            cur.varints(n)  # generation numbers
            refs = _refs(cur, files, n)
            cur.varints(n)  # generation counts
            cur.u64s(n)  # commit times
            cur.end()
            for r in refs:
                walk(Ref(*r), height - 1)

        for ref, height in self._version_nodes:
            walk(ref, height)
        return sorted(out + self._inline, key=lambda v: v.generation)

    # --------------------------------------------------------------- b-tree
    def _walk(self, ref: Ref, height: int, prefix: bytes, out: Dict[bytes, InlineOrRef]):
        what = f"{ref.path}@{ref.offset}"
        cur = _Cursor(self._node(ref, BTREE_MAGIC), what)
        node_height = cur.u8()
        if node_height != height:
            raise CorruptStore(f"{what}: b-tree node of height {node_height}, expected {height}")
        files = _read_files(cur)
        n = cur.varint()
        if n == 0:
            raise CorruptStore(f"{what}: b-tree node with no entries")
        kp, ks = _read_keys(cur, n)
        if height == 0:
            keys = _decode_keys(cur, kp, ks)
            lengths = cur.varints(n)
            kinds = [cur.u8() for _ in range(n)]
            if any(k > 1 for k in kinds):
                raise CorruptStore(f"{what}: value kind other than inline (0) or indirect (1)")
            n_ind = sum(kinds)
            refs = iter(_refs(cur, files, n_ind, with_length=False))
            for key, length, kind in zip(keys, lengths, kinds):
                if kind:
                    path, offset, _ = next(refs)
                    out[prefix + key] = Ref(path, offset, length)
                else:
                    out[prefix + key] = cur.fixed(length)
            cur.end()
            return
        common = cur.varints(n)
        keys = _decode_keys(cur, kp, ks)
        refs = _refs(cur, files, n)
        cur.varints(n), cur.varints(n), cur.varints(n)  # statistics
        cur.end()
        for key, c, r in zip(keys, common, refs):
            if c > len(key):
                raise CorruptStore(f"{what}: common prefix longer than its key")
            self._walk(Ref(*r), height - 1, prefix + key[:c], out)

    def entries(self) -> Dict[bytes, InlineOrRef]:
        """key → inline value bytes or a ``Ref``, for every key."""
        if self._leaves is None:
            out: Dict[bytes, InlineOrRef] = {}
            if self.version.root is not None:
                self._walk(self.version.root, self.version.root_height, b"", out)
            self._leaves = out
        return self._leaves

    def keys(self) -> List[bytes]:
        return sorted(self.entries())

    def value(self, key: Union[str, bytes]) -> memoryview:
        """The value of ``key``: a view of the mapped data file (release it,
        e.g. with ``with``, before ``close``) or of the inline bytes."""
        k = key.encode() if isinstance(key, str) else key
        v = self.entries().get(k)
        if v is None:
            raise KeyError(f"{self.root}: no key {k!r}")
        self.bytes_read += v.length if isinstance(v, Ref) else len(v)
        return self._slice(v) if isinstance(v, Ref) else memoryview(v)

    def read(self, key: Union[str, bytes]) -> bytes:
        with self.value(key) as view:
            return bytes(view)

    def close(self):
        for m in self._maps.values():
            m.close()
        for f in self._files.values():
            f.close()
        self._maps.clear()
        self._files.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ------------------------------------------------------------------ writer
def _write_durable(path: str, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def _new_name() -> str:
    return "d/" + uuidlib.uuid4().hex


class Writer:
    """A new store of one version at ``root`` (an empty or absent
    directory). ``put`` small values, ``put_frame`` an array's bytes as a
    raw-block zstd frame, then ``commit`` writes the nodes and, last, the
    manifest."""

    def __init__(self, root: str, config: Optional[Config] = None):
        self.root = os.path.abspath(root)
        self.config = config or Config(uuid=uuidlib.uuid4().bytes)
        os.makedirs(os.path.join(self.root, "d"), exist_ok=True)
        self._entries: Dict[bytes, InlineOrRef] = {}
        self._data_name = _new_name()
        self._data = None
        self._data_size = 0

    def _append(self, write) -> Ref:
        if self._data is None:
            self._data = open(os.path.join(self.root, self._data_name), "wb")
        offset = self._data_size
        n = write(self._data)
        self._data_size += n
        return Ref(self._data_name, offset, n)

    def _set(self, key: Union[str, bytes], value: InlineOrRef):
        k = key.encode() if isinstance(key, str) else key
        if k in self._entries:
            raise KeyError(f"key {k!r} written twice")
        self._entries[k] = value

    def put(self, key: Union[str, bytes], value: bytes):
        value = bytes(value)
        if len(value) <= self.config.max_inline_value_bytes:
            self._set(key, value)
        else:
            self._set(key, self._append(lambda f: f.write(value)))

    def put_frame(self, key: Union[str, bytes], src) -> int:
        """Store ``src`` (a contiguous buffer) as a zstd frame of raw blocks,
        written straight to the data file. Returns the value's size."""
        size = zstd.raw_frame_size(memoryview(src).nbytes)
        if size <= self.config.max_inline_value_bytes:
            self._set(key, zstd.compress_raw(src))
        else:
            self._set(key, self._append(lambda f: zstd.write_raw_frame(f, src)))
        return size

    # ------------------------------------------------------------- nodes
    def _write_node(self, magic: int, body: bytes) -> Tuple[Ref, int]:
        data = _frame(magic, body)
        name = _new_name()
        _write_durable(os.path.join(self.root, name), data)
        return Ref(name, 0, len(data)), len(data)

    @staticmethod
    def _table(refs: List[Ref]) -> Tuple[bytes, Dict[str, int]]:
        paths = sorted({r.path for r in refs})
        return _write_files(paths), {p: i for i, p in enumerate(paths)}

    @staticmethod
    def _keys(keys: List[bytes]) -> Tuple[bytes, bytes]:
        prefix = _shared_prefixes(keys)
        head = b"".join(_varint(p) for p in prefix[1:])
        head += b"".join(_varint(len(k) - p) for k, p in zip(keys, prefix))
        return head, b"".join(k[p:] for k, p in zip(keys, prefix))

    def _leaf(self, entries: List[Tuple[bytes, InlineOrRef]]) -> bytes:
        refs = [v for _, v in entries if isinstance(v, Ref)]
        table, ids = self._table(refs)
        head, suffixes = self._keys([k for k, _ in entries])
        body = bytes([0]) + table + _varint(len(entries)) + head + suffixes
        body += b"".join(_varint(v.length if isinstance(v, Ref) else len(v)) for _, v in entries)
        body += bytes(int(isinstance(v, Ref)) for _, v in entries)
        body += b"".join(_varint(ids[r.path]) for r in refs)
        body += b"".join(_varint(r.offset) for r in refs)
        return body + b"".join(v for _, v in entries if not isinstance(v, Ref))

    def _interior(self, height: int, children: List[Tuple]) -> bytes:
        """children: (first key, common prefix length, ref, keys, tree bytes,
        indirect bytes), keys relative to this node's prefix."""
        table, ids = self._table([c[2] for c in children])
        head, suffixes = self._keys([c[0] for c in children])
        body = bytes([height]) + table + _varint(len(children)) + head
        body += b"".join(_varint(c[1]) for c in children) + suffixes
        body += b"".join(_varint(ids[c[2].path]) for c in children)
        body += b"".join(_varint(c[2].offset) for c in children)
        body += b"".join(_varint(c[2].length) for c in children)
        for i in (3, 4, 5):
            body += b"".join(_varint(c[i]) for c in children)
        return body

    def _groups(self, items: List, cost, min_items: int = 1) -> List[List]:
        """``items`` split in order into runs whose summed ``cost`` (an
        upper bound of each item's encoded bytes) stays under the node
        limit, each of at least ``min_items`` (an interior node needs two
        children for the tree to narrow)."""
        limit = self.config.max_decoded_node_bytes - 256
        groups, cur, size = [], [], 0
        for it in items:
            c = cost(it)
            if len(cur) >= min_items and size + c > limit:
                groups.append(cur)
                cur, size = [], 0
            cur.append(it)
            size += c
        groups.append(cur)
        return groups

    def commit(self) -> Version:
        """Write the b-tree and the manifest; the store is readable once
        this returns."""
        if self._data is not None:
            self._data.flush()
            os.fsync(self._data.fileno())
            self._data.close()
            self._data = None
        items = sorted(self._entries.items())
        if not items:
            raise ValueError("an OCDBT store needs at least one key")

        def leaf_cost(it):
            k, v = it
            return len(k) + 64 + (len(v) if not isinstance(v, Ref) else 0)

        # level 0: (first key, all keys' common prefix, ref, ..., the entries)
        # a node with a parent stores its keys without their common prefix;
        # the root stores them whole
        level = []
        groups = self._groups(items, leaf_cost)
        for group in groups:
            keys = [k for k, _ in group]
            c = _shared_prefixes([keys[0], keys[-1]])[1] if len(groups) > 1 else 0
            ref, size = self._write_node(BTREE_MAGIC, self._leaf([(k[c:], v) for k, v in group]))
            indirect = sum(v.length for _, v in group if isinstance(v, Ref))
            level.append((keys[0], c, ref, len(group), size, indirect, keys[-1]))
        height = 0
        while len(level) > 1:
            height += 1
            nxt = []
            groups = self._groups(level, lambda ch: len(ch[0]) + 96, min_items=2)
            for group in groups:
                first, last = group[0][0], group[-1][6]
                c = _shared_prefixes([first, last])[1] if len(groups) > 1 else 0
                children = [(ch[0][c:], ch[1] - c, *ch[2:6]) for ch in group]
                ref, size = self._write_node(BTREE_MAGIC, self._interior(height, children))
                nxt.append((first, c, ref, sum(ch[3] for ch in group),
                            size + sum(ch[4] for ch in group), sum(ch[5] for ch in group), last))
            level = nxt
        _, _, root, n_keys, tree_bytes, indirect, _ = level[0]
        version = Version(1, root, height, n_keys, tree_bytes, indirect, time.time_ns())
        table = _write_files([root.path])
        body = self.config.encode() + table + _varint(1) + _varint(version.generation)
        body += bytes([height]) + _varint(0) + _varint(root.offset) + _varint(root.length)
        body += _varint(n_keys) + _varint(tree_bytes) + _varint(indirect)
        body += struct.pack("<Q", version.commit_time) + _varint(0)
        _write_durable(os.path.join(self.root, "manifest.ocdbt"), _frame(MANIFEST_MAGIC, body))
        return version
