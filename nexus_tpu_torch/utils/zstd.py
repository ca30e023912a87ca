"""Zstandard (RFC 8878) frames: a decoder in C and its twin in Python, and a
writer of raw-block frames.

Orbax stores every array chunk, and OCDBT every b-tree node, as a zstd
frame; the card's installs hold no zstd reader, so the port carries one.

* ``decompress(buf, out=None)`` decodes every frame of ``buf`` (concatenated
  frames and skippable frames included) with the C decoder
  (``csrc/zstd_decode.c``, built with the host C compiler at first use),
  straight into ``out`` or into a new buffer of the frames' content size.
* ``decompress_plain(buf)`` is the same decoder written in Python. The tests
  hold the C decoder to it byte for byte; no main path calls it.
* ``compress_raw(src)`` / ``write_raw_frame(f, src)`` make a frame of raw
  blocks (content size in the header, no checksum): valid zstd that any
  decoder reads, at the size of its input.

A corrupt frame raises ``ValueError`` naming the byte offset and the field;
a decoder never returns bytes for it.
"""

from __future__ import annotations

import ctypes
import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE_MAGIC = 0x184D2A50
BLOCK_MAX = 128 * 1024
_U64 = (1 << 64) - 1

# ---------------------------------------------------------------- tables
# RFC 8878 3.1.1.3.2.1.1: literal length and match length codes
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                             4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                        1027, 2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
# 3.1.1.3.2.2: the predefined distributions
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
               1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
LL_MAX_LOG, ML_MAX_LOG, OF_MAX_LOG = 9, 9, 8
HUF_MAX_BITS = 11


class _Corrupt(ValueError):
    pass


def _fail(offset: int, field: str, why: str):
    raise _Corrupt(f"corrupt zstd frame at byte {offset}: {field}: {why}")


# ---------------------------------------------------------------- XXH64
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _U64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _U64, 31) * _P1) & _U64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the frame checksum is its low 32 bits)."""
    data = memoryview(data).cast("B")
    n, p = len(data), 0
    if n >= 32:
        v = [(seed + _P1 + _P2) & _U64, (seed + _P2) & _U64, seed, (seed - _P1) & _U64]
        lanes = np.frombuffer(data[: n - n % 32], dtype="<u8").reshape(-1, 4)
        for row in lanes.tolist():
            v = [_round(a, x) for a, x in zip(v, row)]
        p = n - n % 32
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _U64
        for a in v:
            h = (((h ^ _round(0, a)) * _P1) + _P4) & _U64
    else:
        h = (seed + _P5) & _U64
    h = (h + n) & _U64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _U64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _U64
        h = (_rotl(h, 23) * _P2 + _P3) & _U64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _U64
        h = (_rotl(h, 11) * _P1) & _U64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _U64
    h ^= h >> 29
    h = (h * _P3) & _U64
    return h ^ (h >> 32)


# ---------------------------------------------------------------- frame headers
def frame_header(buf, pos: int = 0) -> Tuple[int, Optional[int], int, bool]:
    """(header length, content size or None, window size, checksum flag) of
    the zstd frame at ``pos`` (after its magic number)."""
    n = len(buf)
    if pos + 1 > n:
        _fail(pos, "frame header descriptor", "truncated")
    fhd = buf[pos]
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 0x08:
        _fail(pos, "frame header descriptor", "reserved bit set")
    p = pos + 1
    window = 0
    if not single:
        if p + 1 > n:
            _fail(p, "window descriptor", "truncated")
        exponent, mantissa = buf[p] >> 3, buf[p] & 7
        base = 1 << (10 + exponent)
        window = base + (base >> 3) * mantissa
        p += 1
    did_size = (0, 1, 2, 4)[dict_flag]
    if p + did_size > n:
        _fail(p, "dictionary id", "truncated")
    if did_size and int.from_bytes(buf[p:p + did_size], "little"):
        _fail(p, "dictionary id", "dictionaries are not supported")
    p += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if p + fcs_size > n:
        _fail(p, "frame content size", "truncated")
    fcs = int.from_bytes(buf[p:p + fcs_size], "little") if fcs_size else None
    if fcs_size == 2:
        fcs += 256
    p += fcs_size
    if single:
        window = fcs
    return p - pos, fcs, window, bool(checksum)


def content_size(buf) -> Optional[int]:
    """Total content size of the frames in ``buf`` when every frame's header
    gives it, else None."""
    buf = memoryview(buf).cast("B")
    pos, total = 0, 0
    while pos < len(buf):
        if pos + 4 > len(buf):
            _fail(pos, "magic number", "truncated")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            pos += 8 + int.from_bytes(buf[pos + 4:pos + 8], "little")
            continue
        if magic != MAGIC:
            _fail(pos, "magic number", f"{magic:#010x} is not a zstd frame")
        hlen, fcs, _, checksum = frame_header(buf, pos + 4)
        if fcs is None:
            return None
        total += fcs
        pos += 4 + hlen
        while True:  # walk the block headers to the next frame
            if pos + 3 > len(buf):
                _fail(pos, "block header", "truncated")
            bh = int.from_bytes(buf[pos:pos + 3], "little")
            size = bh >> 3
            pos += 3 + (1 if (bh >> 1) & 3 == 1 else size)
            if bh & 1:
                break
        pos += 4 if checksum else 0
    return total


# ---------------------------------------------------------------- bit streams
def _highbit(x: int) -> int:
    return x.bit_length() - 1


class _Backward:
    """A bit stream read from its end (literals, weights, sequences)."""

    __slots__ = ("src", "off", "base", "field")

    def __init__(self, src, base: int, field: str):
        self.src, self.base, self.field = src, base, field
        if not len(src) or src[-1] == 0:
            _fail(base + len(src) - 1 if len(src) else base, field, "no final bit in the stream")
        self.off = len(src) * 8 - (8 - _highbit(src[-1]))

    def read(self, bits: int) -> int:
        if bits == 0:
            return 0
        self.off -= bits
        off = self.off
        if off < 0:  # past the stream's start: zeros
            if off + bits <= 0:
                return 0
            v = int.from_bytes(self.src[0:(off + bits + 7) >> 3], "little") & ((1 << (off + bits)) - 1)
            return v << -off
        lo = off >> 3
        v = int.from_bytes(self.src[lo:(off + bits + 7) >> 3], "little")
        return (v >> (off & 7)) & ((1 << bits) - 1)


# ---------------------------------------------------------------- FSE
class _Fse:
    __slots__ = ("log", "sym", "nbits", "base")

    def __init__(self, norm: List[int], log: int):
        size = 1 << log
        sym = [0] * size
        high = size
        desc = [0] * len(norm)
        for s, f in enumerate(norm):
            if f == -1:
                high -= 1
                sym[high] = s
                desc[s] = 1
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, f in enumerate(norm):
            if f <= 0:
                continue
            desc[s] = f
            for _ in range(f):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise _Corrupt("FSE table: the distribution does not fill the table")
        nbits, base = [0] * size, [0] * size
        for i in range(size):
            d = desc[sym[i]]
            desc[sym[i]] += 1
            nbits[i] = log - _highbit(d)
            base[i] = (d << nbits[i]) - size
        self.log, self.sym, self.nbits, self.base = log, sym, nbits, base

    @classmethod
    def rle(cls, symbol: int) -> "_Fse":
        t = cls.__new__(cls)
        t.log, t.sym, t.nbits, t.base = 0, [symbol], [0], [0]
        return t


def _read_fse_table(buf, pos: int, end: int, max_log: int, max_sym: int, field: str):
    """(table, bytes read) of an FSE table description at ``pos``."""
    bitpos, start = 0, pos

    def bits(n):
        nonlocal bitpos
        lo = start + (bitpos >> 3)
        hi = start + ((bitpos + n + 7) >> 3)
        if hi > end:
            _fail(lo, field, "FSE table description truncated")
        v = (int.from_bytes(buf[lo:hi], "little") >> (bitpos & 7)) & ((1 << n) - 1)
        bitpos += n
        return v

    log = bits(4) + 5
    if log > max_log:
        _fail(start, field, f"FSE accuracy log {log} above {max_log}")
    remaining, norm = (1 << log) + 1, []
    while remaining > 1 and len(norm) <= max_sym:
        nb = _highbit(remaining) + 1
        val = bits(nb)
        lower = (1 << (nb - 1)) - 1
        threshold = (1 << nb) - 1 - remaining
        if (val & lower) < threshold:
            bitpos -= 1
            val &= lower
        elif val > lower:
            val -= threshold
        proba = val - 1
        remaining -= abs(proba)
        norm.append(proba)
        if proba == 0:
            while True:
                rep = bits(2)
                norm.extend([0] * rep)
                if rep != 3:
                    break
    if remaining != 1 or len(norm) > max_sym + 1:
        _fail(start, field, "FSE table description does not sum to its accuracy")
    try:
        return _Fse(norm, log), (bitpos + 7) >> 3
    except _Corrupt as e:
        _fail(start, field, str(e))


# ---------------------------------------------------------------- Huffman
class _Huffman:
    __slots__ = ("max_bits", "sym", "nbits")

    def __init__(self, weights: List[int], at: int):
        if len(weights) + 1 > 256:
            _fail(at, "Huffman tree", "more than 256 symbols")
        total = 0
        for w in weights:
            if w > HUF_MAX_BITS:
                _fail(at, "Huffman tree", f"weight {w} above {HUF_MAX_BITS}")
            total += (1 << (w - 1)) if w else 0
        if total == 0:
            _fail(at, "Huffman tree", "all weights zero")
        max_bits = _highbit(total) + 1
        left = (1 << max_bits) - total
        if left & (left - 1) or max_bits > HUF_MAX_BITS:
            _fail(at, "Huffman tree", "weights do not complete a prefix code")
        nbits = [(max_bits + 1 - w) if w else 0 for w in weights] + [max_bits + 1 - (_highbit(left) + 1)]
        size = 1 << max_bits
        count = [0] * (max_bits + 1)
        for b in nbits:
            count[b] += 1
        rank = [0] * (max_bits + 1)
        tsym, tbits = [0] * size, [0] * size
        for i in range(max_bits, 0, -1):
            rank[i - 1] = rank[i] + count[i] * (1 << (max_bits - i))
            for j in range(rank[i], rank[i - 1]):
                tbits[j] = i
        if rank[0] != size:
            _fail(at, "Huffman tree", "code lengths do not fill the table")
        for s, b in enumerate(nbits):
            if b:
                span = 1 << (max_bits - b)
                code = rank[b]
                for j in range(code, code + span):
                    tsym[j] = s
                rank[b] += span
        self.max_bits, self.sym, self.nbits = max_bits, tsym, tbits

    def decode_stream(self, src, base: int, count: int, out: bytearray):
        stream = _Backward(src, base, "Huffman literals stream")
        mb, sym, nbits = self.max_bits, self.sym, self.nbits
        mask = (1 << mb) - 1
        state = stream.read(mb)
        for _ in range(count):
            out.append(sym[state])
            b = nbits[state]
            state = ((state << b) + stream.read(b)) & mask
        if stream.off != -mb:
            _fail(base, "Huffman literals stream", "not consumed exactly by its symbols")


def _read_huffman_tree(buf, pos: int, end: int) -> Tuple[_Huffman, int]:
    if pos >= end:
        _fail(pos, "Huffman tree description", "truncated")
    head = buf[pos]
    if head >= 128:  # direct 4-bit weights
        n = head - 127
        size = (n + 1) // 2
        if pos + 1 + size > end:
            _fail(pos, "Huffman tree description", "direct weights truncated")
        weights = []
        for i in range(n):
            b = buf[pos + 1 + i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
        return _Huffman(weights, pos), 1 + size
    size = head
    if pos + 1 + size > end:
        _fail(pos, "Huffman tree description", "FSE weights truncated")
    table, used = _read_fse_table(buf, pos + 1, pos + 1 + size, 6, 255, "Huffman weights")
    stream = _Backward(buf[pos + 1 + used:pos + 1 + size], pos + 1 + used, "Huffman weights")
    weights = []
    s1, s2 = stream.read(table.log), stream.read(table.log)
    sym, nbits, base = table.sym, table.nbits, table.base
    while True:  # two interleaved states until the stream runs out
        weights.append(sym[s1])
        s1 = base[s1] + stream.read(nbits[s1])
        if stream.off < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + stream.read(nbits[s2])
        if stream.off < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            _fail(pos, "Huffman weights", "more than 255 weights")
    if len(weights) > 255:
        _fail(pos, "Huffman weights", "more than 255 weights")
    return _Huffman(weights, pos), 1 + size


# ---------------------------------------------------------------- blocks
class _FrameState:
    def __init__(self, window: int):
        self.window = window
        self.huffman: Optional[_Huffman] = None
        self.tables = {"LL": None, "OF": None, "ML": None}
        self.rep = [1, 4, 8]


def _literals(buf, pos: int, end: int, st: _FrameState) -> Tuple[bytes, int]:
    b0 = buf[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw, RLE
        hlen = 2 if fmt == 1 else 3 if fmt == 3 else 1
        if pos + hlen > end:
            _fail(pos, "literals section header", "truncated")
        if hlen == 1:
            size = b0 >> 3
        elif hlen == 2:
            size = (b0 >> 4) + (buf[pos + 1] << 4)
        else:
            size = (b0 >> 4) + (buf[pos + 1] << 4) + (buf[pos + 2] << 12)
        if size > BLOCK_MAX:
            _fail(pos, "literals section header", "literals above 128 KiB")
        p = pos + hlen
        if kind == 0:
            if p + size > end:
                _fail(p, "raw literals", "truncated")
            return bytes(buf[p:p + size]), hlen + size
        if p + 1 > end:
            _fail(p, "RLE literals", "truncated")
        return bytes([buf[p]]) * size, hlen + 1
    hlen = (3, 3, 4, 5)[fmt]
    if pos + hlen > end:
        _fail(pos, "literals section header", "truncated")
    h = int.from_bytes(buf[pos:pos + hlen], "little") >> 4
    nbits = (10, 10, 14, 18)[fmt]
    regen, csize = h & ((1 << nbits) - 1), h >> nbits
    streams = 1 if fmt == 0 else 4
    p, stop = pos + hlen, pos + hlen + csize
    if stop > end:
        _fail(pos, "compressed literals", "size runs past the block")
    if regen > BLOCK_MAX:
        _fail(pos, "compressed literals", "regenerated size above 128 KiB")
    if kind == 2:
        st.huffman, used = _read_huffman_tree(buf, p, stop)
        p += used
    elif st.huffman is None:
        _fail(pos, "treeless literals", "no earlier Huffman table in the frame")
    table = st.huffman
    out = bytearray()
    if streams == 1:
        table.decode_stream(buf[p:stop], p, regen, out)
    else:
        if p + 6 > stop:
            _fail(p, "Huffman jump table", "truncated")
        s1, s2, s3 = struct.unpack_from("<HHH", buf, p)
        p += 6
        s4 = stop - p - s1 - s2 - s3
        if s4 < 1:
            _fail(p - 6, "Huffman jump table", "stream sizes exceed the literals")
        each = (regen + 3) // 4
        if regen < 3 * each:
            _fail(pos, "compressed literals", "too few literals for four streams")
        for size, count in ((s1, each), (s2, each), (s3, each), (s4, regen - 3 * each)):
            table.decode_stream(buf[p:p + size], p, count, out)
            p += size
    return bytes(out), stop - pos


def _seq_table(mode: int, buf, p: int, end: int, st: _FrameState, name: str):
    default, max_log, max_sym = {"LL": (LL_DEFAULT, LL_MAX_LOG, 35),
                                 "OF": (OF_DEFAULT, OF_MAX_LOG, 31),
                                 "ML": (ML_DEFAULT, ML_MAX_LOG, 52)}[name]
    if mode == 0:
        table, used = _Fse(*default), 0
    elif mode == 1:
        if p >= end:
            _fail(p, f"{name} RLE symbol", "truncated")
        if buf[p] > max_sym:
            _fail(p, f"{name} RLE symbol", f"code {buf[p]} above {max_sym}")
        table, used = _Fse.rle(buf[p]), 1
    elif mode == 2:
        table, used = _read_fse_table(buf, p, end, max_log, max_sym, f"{name} FSE table")
    else:
        table, used = st.tables[name], 0
        if table is None:
            _fail(p, f"{name} table", "repeat mode with no earlier table")
    st.tables[name] = table
    return table, used


def _offset(rep: List[int], ofv: int, ll: int) -> int:
    """The match offset of an offset value, updating the repeat offsets
    ``rep`` (RFC 8878 3.1.1.5): values 1-3 name a repeat offset, shifted by
    one when the literal length is 0."""
    if ofv > 3:
        rep[2], rep[1], rep[0] = rep[1], rep[0], ofv - 3
        return ofv - 3
    idx = ofv - 1 + (ll == 0)
    if idx == 0:
        return rep[0]
    offset = rep[idx] if idx < 3 else rep[0] - 1
    if idx > 1:
        rep[2] = rep[1]
    rep[1], rep[0] = rep[0], offset
    return offset


def _sequences(buf, pos: int, end: int, st: _FrameState, lits: bytes, out: bytearray,
               frame_start: int):
    p = pos
    if p >= end:
        _fail(p, "sequences section", "truncated")
    b0 = buf[p]
    if b0 == 0:
        out += lits
        if p + 1 != end:
            _fail(p, "sequences section", "bytes after zero sequences")
        return
    if b0 < 128:
        n, p = b0, p + 1
    elif b0 < 255:
        if p + 2 > end:
            _fail(p, "number of sequences", "truncated")
        n, p = ((b0 - 128) << 8) + buf[p + 1], p + 2
    else:
        if p + 3 > end:
            _fail(p, "number of sequences", "truncated")
        n, p = buf[p + 1] + (buf[p + 2] << 8) + 0x7F00, p + 3
    if p >= end:
        _fail(p, "symbol compression modes", "truncated")
    modes = buf[p]
    if modes & 3:
        _fail(p, "symbol compression modes", "reserved bits set")
    p += 1
    ll_t, used = _seq_table(modes >> 6, buf, p, end, st, "LL")
    p += used
    of_t, used = _seq_table((modes >> 4) & 3, buf, p, end, st, "OF")
    p += used
    ml_t, used = _seq_table((modes >> 2) & 3, buf, p, end, st, "ML")
    p += used
    stream = _Backward(buf[p:end], p, "sequences bitstream")
    ll_s, of_s, ml_s = stream.read(ll_t.log), stream.read(of_t.log), stream.read(ml_t.log)
    rep, lit_pos = st.rep, 0
    for i in range(n):
        of_code, ll_code, ml_code = of_t.sym[of_s], ll_t.sym[ll_s], ml_t.sym[ml_s]
        if of_code > 31:
            _fail(p, "sequences bitstream", f"offset code {of_code} above 31")
        ofv = (1 << of_code) + stream.read(of_code)
        ml = ML_BASE[ml_code] + stream.read(ML_BITS[ml_code])
        ll = LL_BASE[ll_code] + stream.read(LL_BITS[ll_code])
        offset = _offset(rep, ofv, ll)
        if i + 1 < n:
            ll_s = ll_t.base[ll_s] + stream.read(ll_t.nbits[ll_s])
            ml_s = ml_t.base[ml_s] + stream.read(ml_t.nbits[ml_s])
            of_s = of_t.base[of_s] + stream.read(of_t.nbits[of_s])
        if lit_pos + ll > len(lits):
            _fail(p, "sequence", "literal length past the block's literals")
        out += lits[lit_pos:lit_pos + ll]
        lit_pos += ll
        produced = len(out) - frame_start
        if offset == 0 or offset > produced or offset > st.window:
            _fail(p, "sequence", f"offset {offset} past the window ({min(produced, st.window)} bytes)")
        src = len(out) - offset
        if offset >= ml:
            out += out[src:src + ml]
        else:  # overlapping copy: the match repeats its last `offset` bytes
            chunk = out[src:]
            out += (chunk * (ml // offset + 1))[:ml]
    if stream.off != 0:
        _fail(p, "sequences bitstream", "not consumed exactly by its sequences")
    out += lits[lit_pos:]


def decompress_plain(buf) -> bytes:
    """Decode every frame of ``buf`` in Python (the C decoder's twin)."""
    buf = memoryview(buf).cast("B")
    out = bytearray()
    pos, n = 0, len(buf)
    while pos < n:
        if pos + 4 > n:
            _fail(pos, "magic number", "truncated")
        magic = int.from_bytes(buf[pos:pos + 4], "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if pos + 8 > n:
                _fail(pos, "skippable frame", "truncated")
            size = int.from_bytes(buf[pos + 4:pos + 8], "little")
            if pos + 8 + size > n:
                _fail(pos, "skippable frame", "truncated")
            pos += 8 + size
            continue
        if magic != MAGIC:
            _fail(pos, "magic number", f"{magic:#010x} is not a zstd frame")
        hlen, fcs, window, checksum = frame_header(buf, pos + 4)
        pos += 4 + hlen
        start = len(out)
        st = _FrameState(window)
        block_cap = min(window, BLOCK_MAX) if window else BLOCK_MAX
        while True:
            if pos + 3 > n:
                _fail(pos, "block header", "truncated")
            bh = int.from_bytes(buf[pos:pos + 3], "little")
            last, btype, size = bh & 1, (bh >> 1) & 3, bh >> 3
            p = pos + 3
            if btype == 3:
                _fail(pos, "block header", "reserved block type")
            if btype == 1:
                if size > BLOCK_MAX:
                    _fail(pos, "RLE block", "size above 128 KiB")
                if p + 1 > n:
                    _fail(p, "RLE block", "truncated")
                out += bytes([buf[p]]) * size
                pos = p + 1
            else:
                if size > block_cap:
                    _fail(pos, "block header", f"block size {size} above {block_cap}")
                if p + size > n:
                    _fail(pos, "block", f"truncated: {size} bytes declared, {n - p} left")
                if btype == 0:
                    out += buf[p:p + size]
                else:
                    if size == 0:
                        _fail(pos, "compressed block", "empty")
                    before = len(out)
                    lits, used = _literals(buf, p, p + size, st)
                    _sequences(buf, p + used, p + size, st, lits, out, start)
                    if len(out) - before > BLOCK_MAX:
                        _fail(pos, "compressed block", "decodes to more than 128 KiB")
                pos = p + size
            if last:
                break
        if fcs is not None and len(out) - start != fcs:
            _fail(pos, "frame content size", f"{fcs} declared, {len(out) - start} decoded")
        if checksum:
            if pos + 4 > n:
                _fail(pos, "content checksum", "truncated")
            want = int.from_bytes(buf[pos:pos + 4], "little")
            got = xxh64(memoryview(out)[start:]) & 0xFFFFFFFF
            if want != got:
                _fail(pos, "content checksum", f"{got:#010x} computed, {want:#010x} stored")
            pos += 4
    return bytes(out)


# ---------------------------------------------------------------- C decoder
_ERR_CAP = 256
_lib = None


def _clib():
    global _lib
    if _lib is None:
        from nexus_tpu_torch.ops._kernels import host_library

        lib = host_library("zstd_decode.c")
        lib.nexus_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                              ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t]
        lib.nexus_zstd_decompress.restype = ctypes.c_int64
        _lib = lib
    return _lib


def _address(buf, writable: bool) -> Tuple[int, int, object]:
    """(address, byte length, keep-alive) of a contiguous buffer."""
    arr = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    if not arr.flags.c_contiguous:
        raise ValueError("zstd buffers must be contiguous")
    if writable and not arr.flags.writeable:
        raise ValueError("the output buffer is read-only")
    return arr.ctypes.data, arr.nbytes, arr


def decompress(buf, out=None) -> np.ndarray:
    """Decode every frame of ``buf`` with the C decoder into ``out`` (a
    writable contiguous buffer, e.g. a numpy array's bytes), or into a new
    uint8 array of the frames' content size. Returns the decoded bytes as a
    uint8 array (a view of ``out``). A frame without a content size and no
    ``out`` decodes into a buffer that doubles until it fits."""
    lib = _clib()
    src, n, keep_src = _address(buf, writable=False)
    err = ctypes.create_string_buffer(_ERR_CAP)
    if out is None:
        size = content_size(keep_src)
        cap = size if size is not None else max(4 * n, 1 << 16)
        while True:
            dst_arr = np.empty(max(cap, 1), dtype=np.uint8)
            got = lib.nexus_zstd_decompress(src, n, dst_arr.ctypes.data, cap, err, _ERR_CAP)
            if got >= 0:
                return dst_arr[:got]
            if got == -2 and size is None:  # output too small: no content size to go by
                cap *= 2
                continue
            raise ValueError(err.value.decode())
    dst, cap, keep_dst = _address(out, writable=True)
    got = lib.nexus_zstd_decompress(src, n, dst, cap, err, _ERR_CAP)
    if got < 0:
        raise ValueError(err.value.decode())
    return keep_dst.reshape(-1).view(np.uint8)[:got]


# ---------------------------------------------------------------- writer
def _raw_header(size: int) -> bytes:
    """Magic and frame header: single segment, 8-byte content size, no
    checksum, no dictionary."""
    return struct.pack("<IBQ", MAGIC, 0xE0, size)


def raw_frame_size(size: int) -> int:
    """Bytes of ``compress_raw`` of ``size`` bytes."""
    blocks = max(1, -(-size // BLOCK_MAX))
    return 13 + 3 * blocks + size


def write_raw_frame(f, src) -> int:
    """Write a raw-block frame of ``src`` to the binary file ``f``, one block
    header and one slice of ``src`` at a time (no copy of the whole).
    Returns the bytes written."""
    view = memoryview(src).cast("B")
    n = len(view)
    f.write(_raw_header(n))
    pos = 0
    while True:
        size = min(BLOCK_MAX, n - pos)
        last = pos + size >= n
        f.write((size << 3 | int(last)).to_bytes(3, "little"))  # block type 0: raw
        f.write(view[pos:pos + size])
        pos += size
        if last:
            return raw_frame_size(n)


def compress_raw(src) -> bytes:
    """A zstd frame of raw blocks holding ``src``."""
    import io

    f = io.BytesIO()
    write_raw_frame(f, src)
    return f.getvalue()
