"""The port's corpus batches against the JAX package's, backend by backend.

JAX's ``corpus_batches`` draws from its C++ reader (``native``, and ``auto``
wherever that library builds) or from the numpy memmap stream (``python``);
the port reproduces both streams, and their errors, in Python."""

import numpy as np
import pytest

from nexus_tpu import native
from nexus_tpu.train import data as jdata
from nexus_tpu_torch.train import data as tdata

VOCAB = 300


def _corpus(tmp_path, dtype: str, tokens=None) -> str:
    path = str(tmp_path / f"corpus.{dtype}")
    if tokens is None:
        tokens = (np.arange(20000) * 7919) % VOCAB
    np.asarray(tokens, dtype=dtype).tofile(path)
    return path


def _jax_backend_runs(backend: str) -> None:
    # JAX's native path needs its C++ library; only that comparison may skip
    if backend == "native" and not native.available():
        pytest.skip("the JAX package's native library does not build here")


@pytest.mark.parametrize("backend", ["auto", "native", "python"])
@pytest.mark.parametrize("dtype", ["int32", "uint16"])
@pytest.mark.parametrize("shard", [0, 1])
def test_corpus_batches_equal_jax_for_each_backend(tmp_path, backend, dtype, shard):
    _jax_backend_runs(backend)
    path = _corpus(tmp_path, dtype)
    kw = dict(dtype=dtype, seed=3, shard_index=shard, num_shards=2, vocab_size=VOCAB)
    a = jdata.corpus_batches(path, 4, 32, backend=backend, **kw)
    b = tdata.corpus_batches(path, 4, 32, backend=backend, **kw)
    for _ in range(5):
        x, y = next(a)["tokens"], next(b)["tokens"]
        assert x.dtype == y.dtype == np.int32 and np.array_equal(x, y)


def test_auto_is_the_native_stream_not_the_numpy_one(tmp_path):
    path = _corpus(tmp_path, "int32")
    auto = next(tdata.corpus_batches(path, 2, 16, seed=3))["tokens"]
    assert np.array_equal(auto, next(tdata.corpus_batches(path, 2, 16, seed=3,
                                                          backend="native"))["tokens"])
    assert not np.array_equal(auto, next(tdata.corpus_batches(path, 2, 16, seed=3,
                                                              backend="python"))["tokens"])


@pytest.mark.parametrize("backend", ["native", "python"])
@pytest.mark.parametrize("fault", ["negative", "over_vocab"])
def test_corrupt_corpus_errors_equal_jax(tmp_path, backend, fault):
    _jax_backend_runs(backend)
    tokens = np.full(400, 7)
    tokens[::3] = -5 if fault == "negative" else VOCAB + 1
    path = _corpus(tmp_path, "int16" if fault == "negative" else "int32", tokens)
    dtype = "int16" if fault == "negative" else "int32"
    errors = []
    for pkg in (jdata, tdata):
        with pytest.raises(ValueError) as e:
            next(pkg.corpus_batches(path, 2, 16, dtype=dtype, seed=1, vocab_size=VOCAB,
                                    backend=backend))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("backend", ["native", "python"])
def test_a_shard_too_small_raises_in_both(tmp_path, backend):
    _jax_backend_runs(backend)
    path = _corpus(tmp_path, "int32", np.arange(40) % VOCAB)
    for pkg in (jdata, tdata):
        with pytest.raises(ValueError):
            next(iter(pkg.corpus_batches(path, 2, 32, num_shards=2, backend=backend)))


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown data backend"):
        tdata.corpus_batches("x", 2, 16, backend="rust")
