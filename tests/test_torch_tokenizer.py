"""The port's tokenizer (nexus_tpu_torch/utils/tokenizer.py) against the JAX
package's, on the CPU.

The port's pure engine compiles its pre-tokenization pattern with the
stdlib ``re`` (the card has no ``regex`` package); it must give the JAX
pure engine's ids (``regex``) on every input here, and the Rust engine's on
a Llama-3-style tokenizer.json. On a GPT-2-style file both pure engines
apply Llama-3's pattern where the Rust engine applies GPT-2's: a fault of
the reference that the port reproduces, pinned below."""

import builtins
import json

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from nexus_tpu.utils import tokenizer as jtok
from nexus_tpu_torch.utils import tokenizer as ttok

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "TPU native frameworks shard attention over meshes",
    "hello world, hello tokens! 12345",
    "multi-cluster controllers reconcile templates",
]
SPECIALS = ["<|begin_of_text|>", "<|eot_id|>"]
# JAX's own samples (tests/test_weights.py), and the separators on which
# re's \s and the regex package's part ways
SAMPLES = [
    "the quick brown fox",
    "hello world",
    "unseen wörds — with ünïcode! 67890",
    "  leading spaces\nand newlines\n\n",
    "",
    "don't",
    "hello   world\n\n x",
    "a\x1cb\x1d c\x1e\x1f d",
    "x\x85y\xa0 z\u2028w\u3000v",
    "数字 123 和 4567 字",
    "<|begin_of_text|>hello<|eot_id|>",
]


def _build_tokenizer_json(path: str) -> str:
    """A real (small) byte-level BPE tokenizer.json built with the HF
    `tokenizers` library from a tiny corpus (GPT-2 / GPT-NeoX style: a
    ByteLevel pre-tokenizer with its own regex, no Split)."""
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(path)
    return path


def _build_llama3_tokenizer_json(path: str) -> str:
    """Llama-3's layout: Sequence[Split(Regex(pattern), isolated),
    ByteLevel(use_regex=False)]."""
    from tokenizers import Regex, Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(jtok._LLAMA3_PATTERN), behavior="isolated"),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False),
    ])
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=SPECIALS,
                                  initial_alphabet=pre_tokenizers.ByteLevel.alphabet())
    tok.train_from_iterator(CORPUS, trainer)
    tok.save(path)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    return {"gpt2": _build_tokenizer_json(str(d / "gpt2.json")),
            "llama3": _build_llama3_tokenizer_json(str(d / "llama3.json"))}


@pytest.fixture(scope="module")
def engines(files):
    return {name: {"port": ttok.load_tokenizer(path, engine="pure"),
                   "jax": jtok.load_tokenizer(path, engine="pure"),
                   "rust": jtok.load_tokenizer(path, engine="rust")}
            for name, path in files.items()}


@pytest.mark.parametrize("style", ["gpt2", "llama3"])
@pytest.mark.parametrize("text", SAMPLES)
def test_port_pure_equals_jax_pure(engines, style, text):
    e = engines[style]
    assert e["port"].encode(text) == e["jax"].encode(text)


@pytest.mark.parametrize("text", SAMPLES)
def test_port_pure_equals_rust_on_a_llama3_style_file(engines, text):
    e = engines["llama3"]
    assert e["port"].encode(text) == e["rust"].encode(text)


ALPHABET = st.one_of(
    st.characters(min_codepoint=0x20, max_codepoint=0x7E),  # ASCII
    st.characters(min_codepoint=0xA0, max_codepoint=0xFF),  # Latin-1
    st.sampled_from(["\t", "\n", "\r", "\x0b", "\x0c", "\x1c", "\x1d", "\x1e", "\x1f",
                     "\x85", "\xa0", "\u2028", "\u3000", " ", "  "]),  # separators
    st.characters(min_codepoint=0x4E00, max_codepoint=0x9FFF),  # CJK
    st.characters(min_codepoint=0x30, max_codepoint=0x39),  # digits
    st.sampled_from(["'s", "'LL", "12345", "<|eot_id|>"]),
)


@settings(max_examples=150, deadline=None)
@given(text=st.lists(ALPHABET, max_size=40).map("".join))
def test_hypothesis_text_port_pure_equals_jax_pure_and_rust(engines, text):
    for style in ("gpt2", "llama3"):
        assert engines[style]["port"].encode(text) == engines[style]["jax"].encode(text)
    assert engines["llama3"]["port"].encode(text) == engines["llama3"]["rust"].encode(text)


def test_the_reference_fault_on_a_gpt2_style_file_is_reproduced(engines):
    """Both pure engines apply Llama-3's pattern (digits in threes, no
    leading-space merge) where the Rust engine applies GPT-2's."""
    e = engines["gpt2"]
    for text in ("12345", " 12345"):
        assert e["port"].encode(text) == e["jax"].encode(text) != e["rust"].encode(text)


@pytest.mark.parametrize("style", ["gpt2", "llama3"])
def test_decode_round_trips_and_special_tokens(files, engines, style):
    port = engines[style]["port"]
    for text in ("hello world, the quick fox", "unseen wörds — ünïcode 数字"):
        assert port.decode(port.encode(text)) == text
    with open(files[style]) as f:
        doc = json.load(f)
    ids = {t["content"]: t["id"] for t in doc["added_tokens"]}
    text = "<|begin_of_text|>hello<|eot_id|>"
    got = port.encode(text)
    assert got[0] == ids["<|begin_of_text|>"] and got[-1] == ids["<|eot_id|>"]
    assert port.decode(got) == text == engines[style]["jax"].decode(got)


def test_an_unknown_property_raises_naming_it():
    with pytest.raises(ValueError, match=r"\\p\{Han\}"):
        ttok.translate_pattern(r"\p{Han}+")
    with pytest.raises(ValueError, match="Greek"):
        ttok.PureBpeTokenizer({}, [], pattern=r"[\p{Greek}]")


@pytest.mark.parametrize("pattern,text", [
    (r"[^\s\p{L}]+", "ab 12!?\x1c\tcd"),
    (r"\P{N}+", "ab12cd 3"),
    (r"\pL+|\S+", "héllo wörld \x1c!"),
    (r"[]a]+|[^]a]+", "]]aab]c"),
    (r"\p{Lu}\p{Ll}+", "Hello World ÀÉé"),
])
def test_translated_patterns_split_as_the_regex_package(pattern, text):
    import re

    import regex

    assert re.findall(ttok.translate_pattern(pattern), text) == regex.findall(pattern, text)


def test_rust_engine_without_the_package_raises_as_jax(files, monkeypatch):
    real = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name == "tokenizers" or name.startswith("tokenizers."):
            raise ImportError("No module named 'tokenizers'")
        return real(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    for mod in (jtok, ttok):
        with pytest.raises(ImportError):
            mod.load_tokenizer(files["llama3"], engine="rust")
    assert isinstance(ttok.load_tokenizer(files["llama3"]), ttok.PureBpeTokenizer)
    assert isinstance(jtok.load_tokenizer(files["llama3"]), jtok.PureBpeTokenizer)
    with pytest.raises(ValueError, match="unknown tokenizer engine"):
        ttok.load_tokenizer(files["llama3"], engine="sentencepiece")


def test_auto_takes_the_rust_engine_when_it_imports(files):
    assert isinstance(ttok.load_tokenizer(files["llama3"]), ttok._RustTokenizer)
