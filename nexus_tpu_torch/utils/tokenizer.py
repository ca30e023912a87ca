"""Tokenizer loading for LM inference (counterpart of
``nexus_tpu/utils/tokenizer.py``): HF ``tokenizer.json`` byte-level BPE.

An infer or serve template can carry prompt text; the entry point tokenizes
it with the checkpoint's own tokenizer and detokenizes the decoded ids.

Two engines behind one surface, chosen as in the JAX package:
  * the ``tokenizers`` Rust library when it imports (exact HF behaviour);
  * a pure-Python byte-level BPE (``PureBpeTokenizer``) over the same
    tokenizer.json subset Llama-3 uses: the GPT-2 byte-to-unicode table,
    regex pre-tokenization, greedy lowest-rank merges, added tokens. Its
    pattern choice, merges, added tokens and decode are the JAX engine's.

The JAX pure engine compiles the pre-tokenization pattern with the
``regex`` package; this one translates it to the stdlib ``re``
(``translate_pattern``): each ``\\p{X}`` becomes a character class of the
code points whose Unicode general category starts with X (from
``unicodedata``), and ``\\s`` the ``regex`` package's whitespace set, which
leaves out U+001C..U+001F where ``re``'s takes them in. Code points that the
two Unicode versions (``unicodedata``'s and ``regex``'s) assign differently
may still split otherwise.
"""

from __future__ import annotations

import json
import re
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple


@lru_cache(maxsize=1)
def _byte_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte↔unicode table: printable bytes map to
    themselves, the rest to code points from 256 up."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("¡"), ord("¬") + 1))
        + list(range(ord("®"), ord("ÿ") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


# Llama-3's pre-tokenization pattern (tiktoken cl100k lineage; also what
# its tokenizer.json carries in pre_tokenizer.pattern.Regex)
_LLAMA3_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}|"
    r" ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

# the regex package's \s: the Unicode White_Space property
_WHITESPACE = (r"\t\n\x0b\x0c\r\x20\x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f"
               r"\u205f\u3000")
_CATEGORIES = frozenset(
    "L Lu Ll Lt Lm Lo M Mn Mc Me N Nd Nl No P Pc Pd Ps Pe Pi Pf Po S Sm Sc Sk So "
    "Z Zs Zl Zp C Cc Cf Cs Co Cn".split())


@lru_cache(maxsize=1)
def _category_runs() -> Tuple[Tuple[int, int, str], ...]:
    """(first, last, general category) of each run of code points that
    share one, over the whole code space (built once, ~0.5 s)."""
    runs = []
    start, cat = 0, unicodedata.category("\x00")
    for cp in range(1, 0x110000):
        c = unicodedata.category(chr(cp))
        if c != cat:
            runs.append((start, cp - 1, cat))
            start, cat = cp, c
    runs.append((start, 0x10FFFF, cat))
    return tuple(runs)


def _escape(cp: int) -> str:
    return f"\\U{cp:08x}"


@lru_cache(maxsize=None)
def _category_class(name: str) -> str:
    """The body of a character class (no brackets) matching the code points
    whose general category starts with ``name`` (``L``, ``Nd``, ...)."""
    if name not in _CATEGORIES:
        raise ValueError(f"\\p{{{name}}}: only Unicode general categories are supported "
                         f"(one of {' '.join(sorted(_CATEGORIES))})")
    merged: List[List[int]] = []
    for first, last, cat in _category_runs():
        if cat.startswith(name):
            if merged and merged[-1][1] == first - 1:
                merged[-1][1] = last
            else:
                merged.append([first, last])
    return "".join(_escape(a) if a == b else f"{_escape(a)}-{_escape(b)}" for a, b in merged)


def translate_pattern(pattern: str) -> str:
    """A ``regex``-package pattern → the same pattern for the stdlib ``re``:
    ``\\p{X}`` / ``\\pX`` and ``\\P{X}`` become category classes, ``\\s`` and
    ``\\S`` the ``regex`` package's whitespace set, inside and outside
    ``[...]``. Raises ValueError on a property that is not a general
    category (a script, say) and on a negated class inside a class."""
    out: List[str] = []
    i, n, in_class = 0, len(pattern), False
    while i < n:
        c = pattern[i]
        if c == "\\" and i + 1 < n:
            esc = pattern[i + 1]
            if esc in "pP":
                if pattern.startswith("{", i + 2):
                    end = pattern.find("}", i + 3)
                    if end < 0:
                        raise ValueError(f"unterminated \\{esc}{{ at {i} in {pattern!r}")
                    name, i = pattern[i + 3:end], end + 1
                else:
                    name, i = pattern[i + 2:i + 3], i + 3
                body = _category_class(name)
                if esc == "P" and in_class:
                    raise ValueError(f"\\P{{{name}}} inside a character class is not supported")
                out.append(body if in_class else f"[{'^' if esc == 'P' else ''}{body}]")
                continue
            if esc in "sS":
                if esc == "S" and in_class:
                    raise ValueError("\\S inside a character class is not supported")
                out.append(_WHITESPACE if in_class
                           else f"[{'^' if esc == 'S' else ''}{_WHITESPACE}]")
                i += 2
                continue
            out.append(pattern[i:i + 2])
            i += 2
            continue
        out.append(c)
        i += 1
        if in_class:
            in_class = c != "]"
        elif c == "[":
            in_class = True
            for lead in "^]":  # a leading ']' (after an optional '^') is literal
                if pattern.startswith(lead, i):
                    out.append(lead)
                    i += 1
    return "".join(out)


class PureBpeTokenizer:
    """Self-contained byte-level BPE over a parsed tokenizer.json."""

    def __init__(
        self,
        vocab: Dict[str, int],
        merges: Sequence[Tuple[str, str]],
        added_tokens: Optional[Dict[str, int]] = None,
        pattern: str = _LLAMA3_PATTERN,
    ):
        self.vocab = dict(vocab)
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self.ranks = {tuple(m): r for r, m in enumerate(merges)}
        self.added = dict(added_tokens or {})
        self.id_to_token.update({i: t for t, i in self.added.items()})
        self._pat = re.compile(translate_pattern(pattern))
        self._b2u = _byte_to_unicode()
        self._u2b = {u: b for b, u in self._b2u.items()}

    @classmethod
    def from_file(cls, path: str) -> "PureBpeTokenizer":
        with open(path) as f:
            doc = json.load(f)
        model = doc.get("model") or {}
        if model.get("type") != "BPE":
            raise ValueError(f"tokenizer.json model.type {model.get('type')!r} "
                             "unsupported (BPE only)")
        merges = [tuple(m.split(" ", 1)) if isinstance(m, str) else tuple(m)
                  for m in model.get("merges") or []]
        added = {t["content"]: t["id"] for t in doc.get("added_tokens") or []}
        # as the JAX engine: the first Split pattern of the pre-tokenizer (a
        # bare one or a Sequence of them), else Llama-3's, also for a
        # ByteLevel(use_regex=True) file, whose Rust engine applies GPT-2's
        pattern = _LLAMA3_PATTERN
        pre = doc.get("pre_tokenizer") or {}
        for p in pre.get("pretokenizers") or [pre]:
            pat = ((p or {}).get("pattern") or {}).get("Regex")
            if pat:
                pattern = pat
                break
        return cls(model.get("vocab") or {}, merges, added, pattern)

    # ------------------------------------------------------------------ BPE
    def _bpe(self, piece: str) -> List[str]:
        parts = list(piece)
        if len(parts) < 2:
            return parts
        while True:
            best = None
            best_rank = None
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = i, r
            if best is None:
                return parts
            parts = parts[:best] + [parts[best] + parts[best + 1]] + parts[best + 2:]
            if len(parts) < 2:
                return parts

    def encode(self, text: str) -> List[int]:
        """Text → token ids. Added (special) tokens match as whole pieces
        first, longest first; the rest goes through byte-level BPE."""
        if not text:
            return []
        if self.added:
            for tok in sorted(self.added, key=len, reverse=True):
                if tok in text:
                    left, _, right = text.partition(tok)
                    return self.encode(left) + [self.added[tok]] + self.encode(right)
        ids: List[int] = []
        for piece in self._pat.findall(text):
            mapped = "".join(self._b2u[b] for b in piece.encode("utf-8"))
            for unit in self._bpe(mapped):
                try:
                    ids.append(self.vocab[unit])
                except KeyError:
                    # merges and vocab disagree (a malformed file): per char
                    ids.extend(self.vocab[c] for c in unit if c in self.vocab)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = bytearray()
        for i in ids:
            tok = self.id_to_token.get(int(i))
            if tok is None:
                continue
            if tok in self.added:
                out += tok.encode("utf-8")
                continue
            for ch in tok:
                b = self._u2b.get(ch)
                if b is not None:
                    out.append(b)
                else:  # not a byte-level char (not in a BPE vocab)
                    out += ch.encode("utf-8")
        return out.decode("utf-8", errors="replace")


class _RustTokenizer:
    """Thin adapter over the HF ``tokenizers`` engine."""

    def __init__(self, path: str):
        from tokenizers import Tokenizer

        self._tk = Tokenizer.from_file(path)

    def encode(self, text: str) -> List[int]:
        return self._tk.encode(text, add_special_tokens=False).ids

    def decode(self, ids: Sequence[int]) -> str:
        return self._tk.decode(list(map(int, ids)), skip_special_tokens=False)


def load_tokenizer(path: str, engine: str = "auto"):
    """Load a tokenizer.json. ``engine``: 'auto' (Rust when ``tokenizers``
    imports, else pure), 'rust', or 'pure'."""
    if engine not in ("auto", "rust", "pure"):
        raise ValueError(f"unknown tokenizer engine {engine!r}")
    if engine in ("auto", "rust"):
        try:
            return _RustTokenizer(path)
        except ImportError:
            if engine == "rust":
                raise
    return PureBpeTokenizer.from_file(path)
