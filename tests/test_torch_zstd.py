"""The port's zstd decoders (nexus_tpu_torch.utils.zstd: the C library and
its Python twin) against the zstandard package, and its raw-block writer.

Every frame here is made by zstandard from data drawn from numpy seeds or
by hypothesis; both decoders must give zstandard's bytes exactly. A
coverage test walks the same frames through the Python decoder and
requires every part of the format the tests claim to cover to have been
decoded at least once. Corrupt frames must raise in both decoders, with
the same offset and field.
"""

import io

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from nexus_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")


def _bf16(rng, n):
    return (rng.standard_normal(n).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16).tobytes()


def _data():
    rng = np.random.default_rng(0)
    runs = np.repeat(rng.integers(0, 6, 2000), rng.integers(1, 120, 2000)).astype(np.uint8)
    text = (b"the quick brown fox jumps over the lazy dog; " * 900
            + bytes(rng.integers(97, 123, 8000).astype(np.uint8)))
    block = bytes(rng.integers(0, 256, 700).astype(np.uint8))
    return {
        "bf16": _bf16(rng, 24_000),
        "f32": rng.standard_normal(10_000).astype(np.float32).tobytes(),
        "runs": runs.tobytes(),
        "repeats": block * 40 + bytes(30_000) + block[::-1] * 30,
        "text": text,
    }


def _copies():
    """128 KiB of words, then blocks made of copies of it, each after one
    unmatched byte: blocks of few sequences with alike statistics (zstd
    repeats their tables) and literals that are all one byte (RLE
    literals)."""
    rng = np.random.default_rng(3)
    vocab = [bytes(rng.integers(97, 123, int(rng.integers(2, 9))).astype(np.uint8))
             for _ in range(400)]
    first = b" ".join(vocab[i] for i in rng.integers(0, 400, 30000))[:zstd.BLOCK_MAX]
    starts, lengths = rng.integers(0, len(first) - 1300, 400), rng.integers(300, 1200, 400)
    return first + b"".join(b"z" + first[s:s + n] for s, n in zip(starts, lengths))


DATA = _data()
COPIES = _copies()
LEVELS = (-5, 1, 3, 19)
CASES = ([(name, level, True) for name in DATA for level in LEVELS]
         + [(name, 1, False) for name in DATA])


def _compress(data, level, checksum=False):
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)


def _both(frame):
    got_c = zstd.decompress(frame).tobytes()
    got_py = zstd.decompress_plain(frame)
    return got_c, got_py


@pytest.mark.parametrize("name,level,checksum", CASES,
                         ids=[f"{n}-{lv}-{'ck' if c else 'nock'}" for n, lv, c in CASES])
def test_both_decoders_equal_zstandard(name, level, checksum):
    data = DATA[name]
    frame = _compress(data, level, checksum)
    got_c, got_py = _both(frame)
    assert got_c == data
    assert got_py == data


def _multi_block(name):
    if name == "copies":
        return COPIES
    rng = np.random.default_rng(1)
    return _bf16(rng, 100_000) + DATA["text"] * 2 + DATA["runs"]


@pytest.mark.parametrize("name,level", [("mixed", 1), ("mixed", 19), ("copies", 9),
                                        ("copies", 19)])
def test_multi_block_frames_above_128_kib(name, level):
    """More than one 128 KiB block: later blocks reuse the earlier blocks'
    Huffman and FSE tables, and matches reach back across blocks."""
    data = _multi_block(name)
    assert len(data) > 3 * zstd.BLOCK_MAX
    frame = _compress(data, level, checksum=True)
    got_c, got_py = _both(frame)
    assert got_c == data and got_py == data


def test_streamed_concatenated_and_skippable_frames():
    """Frames without a content size (as tensorstore writes them), several
    frames back to back and a skippable frame between them."""
    cobj = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = cobj.compress(DATA["text"]) + cobj.flush()
    assert zstd.frame_header(streamed, 4)[1] is None  # no content size
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"skip!"
    frames = streamed + skippable + _compress(DATA["bf16"], 1) + zstd.compress_raw(b"tail")
    want = DATA["text"] + DATA["bf16"] + b"tail"
    got_c, got_py = _both(frames)
    assert got_c == want and got_py == want
    assert zstd.decompress(b"").nbytes == 0 == len(zstd.decompress_plain(b""))


def test_decoding_into_a_preallocated_buffer():
    data = DATA["f32"]
    out = np.empty(len(data) // 4, dtype=np.float32)
    view = zstd.decompress(_compress(data, 1), out=out)
    assert view.nbytes == len(data) and out.tobytes() == data
    with pytest.raises(ValueError, match="too small"):
        zstd.decompress(_compress(data, 1), out=np.empty(len(data) - 1, np.uint8))


def test_a_16_mib_level_1_bf16_frame_through_the_c_decoder():
    rng = np.random.default_rng(2)
    data = _bf16(rng, 8 << 20)
    frame = _compress(data, 1)
    assert len(frame) < 0.8 * len(data)  # Huffman-coded literals
    out = np.empty(len(data), dtype=np.uint8)
    zstd.decompress(frame, out=out)
    assert out.tobytes() == data


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(data=st.binary(max_size=3000), level=st.sampled_from(LEVELS), checksum=st.booleans(),
       repeat=st.integers(1, 4))
def test_hypothesis_bytes(data, level, checksum, repeat):
    data = data * repeat
    frame = _compress(data, level, checksum)
    got_c, got_py = _both(frame)
    assert got_c == data and got_py == data


# ---------------------------------------------------------------- coverage


def test_the_frames_cover_the_format(monkeypatch):
    """Decode the test frames with the Python decoder while recording which
    block types, literal kinds, Huffman weight encodings, sequence table
    modes and repeat offsets they used: each must appear."""
    seen = set()
    literals, huffman, seq_table, offset = (zstd._literals, zstd._read_huffman_tree,
                                            zstd._seq_table, zstd._offset)

    def rec_literals(buf, pos, end, state):
        kind, fmt = buf[pos] & 3, (buf[pos] >> 2) & 3
        seen.add(("literals", ("raw", "rle", "huffman", "treeless")[kind]))
        if kind >= 2:
            seen.add(("streams", 1 if fmt == 0 else 4))
        return literals(buf, pos, end, state)

    def rec_huffman(buf, pos, end):
        seen.add(("weights", "direct" if buf[pos] >= 128 else "fse"))
        return huffman(buf, pos, end)

    def rec_table(mode, buf, p, end, state, name):
        seen.add(("sequences", ("predefined", "rle", "fse", "repeat")[mode]))
        return seq_table(mode, buf, p, end, state, name)

    def rec_offset(rep, ofv, ll):
        seen.add(("offset", "repeat" if ofv <= 3 else "new"))
        return offset(rep, ofv, ll)

    monkeypatch.setattr(zstd, "_literals", rec_literals)
    monkeypatch.setattr(zstd, "_read_huffman_tree", rec_huffman)
    monkeypatch.setattr(zstd, "_seq_table", rec_table)
    monkeypatch.setattr(zstd, "_offset", rec_offset)
    frames = [_compress(DATA[n], lv) for n in DATA for lv in LEVELS]
    frames.append(_compress(COPIES, 19))
    frames.append(_compress(bytes(300_000) + b"x" * 10, 3))  # RLE blocks
    frames.append(_compress(bytes(range(256)) * 4 + b"ab", -5))
    for frame in frames:
        zstd.decompress_plain(frame)
        # the block types, from the block headers
        pos = 4 + zstd.frame_header(frame, 4)[0]
        while True:
            bh = int.from_bytes(frame[pos:pos + 3], "little")
            seen.add(("block", ("raw", "rle", "compressed")[(bh >> 1) & 3]))
            pos += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
            if bh & 1:
                break
    want = {("block", b) for b in ("raw", "rle", "compressed")}
    want |= {("literals", k) for k in ("raw", "rle", "huffman", "treeless")}
    want |= {("streams", 1), ("streams", 4), ("weights", "direct"), ("weights", "fse")}
    want |= {("sequences", m) for m in ("predefined", "rle", "fse", "repeat")}
    want |= {("offset", "repeat"), ("offset", "new")}
    assert want <= seen, sorted(want - seen)


# ---------------------------------------------------------------- the writer


@pytest.mark.parametrize("size", [0, 1, 1000, zstd.BLOCK_MAX, zstd.BLOCK_MAX + 1, 300_001])
def test_zstandard_reads_raw_frames(size):
    data = bytes(np.random.default_rng(size).integers(0, 256, size).astype(np.uint8))
    frame = zstd.compress_raw(data)
    assert len(frame) == zstd.raw_frame_size(size)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstd.content_size(frame) == size
    got_c, got_py = _both(frame)
    assert got_c == data and got_py == data
    f = io.BytesIO()
    assert zstd.write_raw_frame(f, memoryview(data)) == len(frame)
    assert f.getvalue() == frame


# ---------------------------------------------------------------- corrupt frames


def _first_block_literals(frame):
    """Byte offset of the first block's literals section."""
    return 4 + zstd.frame_header(frame, 4)[0] + 3


def _corrupt_frames():
    bf16 = _compress(DATA["bf16"], 1)
    lit = _first_block_literals(bf16)
    assert bf16[lit] & 3 == 2  # a Huffman literals section with its tree
    fmt = (bf16[lit] >> 2) & 3
    tree = lit + (3, 3, 4, 5)[fmt]
    bad_weights = bytearray(bf16)
    bad_weights[tree:tree + 2] = bytes([0x80 + 2, 0xFF])  # two direct weights of 15
    bad_fse = bytearray(bf16)
    bad_fse[tree:tree + 2] = bytes([40, 0x0F])  # FSE weights with accuracy log 20
    checksummed = bytearray(_compress(DATA["text"], 3, checksum=True))
    checksummed[-1] ^= 0x55
    # a match into a dictionary the frame does not name: an offset past the
    # bytes decoded so far
    dictionary = zstandard.ZstdCompressionDict(DATA["text"][:4000],
                                               dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    dict_frame = zstandard.ZstdCompressor(level=3, dict_data=dictionary,
                                          write_dict_id=False).compress(DATA["text"][:4000])
    return {
        "truncated block": (_compress(DATA["text"], 3)[:-7], "truncated"),
        "bad Huffman table": (bytes(bad_weights), "Huffman"),
        "bad FSE table": (bytes(bad_fse), "FSE"),
        "checksum mismatch": (bytes(checksummed), "content checksum"),
        "offset past the window": (dict_frame, "offset"),
        "not a frame": (b"\x00\x01\x02\x03abcd", "magic number"),
    }


CORRUPT = _corrupt_frames()


@pytest.mark.parametrize("case", sorted(CORRUPT))
def test_a_corrupt_frame_raises_in_both_decoders(case):
    frame, field = CORRUPT[case]
    with pytest.raises(ValueError, match=field) as c_err:
        zstd.decompress(frame)
    with pytest.raises(ValueError, match=field) as py_err:
        zstd.decompress_plain(frame)
    # the same offset and field
    c_head = str(c_err.value).split(": ")[:2]
    py_head = str(py_err.value).split(": ")[:2]
    assert c_head == py_head and c_head[0].startswith("corrupt zstd frame at byte ")


def test_a_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    """The host library build does not fall back to the Python decoder."""
    from nexus_tpu_torch.ops import _kernels

    (tmp_path / "broken.c").write_text("int broken( {\n")
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    monkeypatch.setattr(_kernels, "BUILD_ROOT", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="(?s)cc broken.c failed.*error"):
        _kernels.host_library("broken.c")
    monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    with pytest.raises(RuntimeError, match="no host C compiler"):
        _kernels.host_library("broken.c")


def test_xxh64_matches_the_frame_checksums():
    for data in (b"", b"a", DATA["text"][:31], DATA["text"][:33], DATA["bf16"][:1001]):
        frame = _compress(data, 1, checksum=True)
        assert int.from_bytes(frame[-4:], "little") == zstd.xxh64(data) & 0xFFFFFFFF
