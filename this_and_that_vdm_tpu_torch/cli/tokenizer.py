"""Prompt tokenizers of the entry points: CLIP's byte-level BPE over a
``tokenizer/`` folder (counterpart of ``transformers.CLIPTokenizer`` as the
JAX CLI calls it, ``cli/inference.py:144-146``) and the ``--random-weights``
hash tokenizer (``cli/inference.py:128-141``, copied as written).

The BPE tokenizer behaves as transformers' does without ``ftfy``: control
characters dropped, whitespace normalised, CJK ideographs spaced, NFC, lower
case; CLIP's pre-tokenizer pattern (written for the ``regex`` package's
``\\p{L}`` / ``\\p{N}``) in the standard ``re`` module; then BPE by merge
rank, ``<|startoftext|>`` ... ``<|endoftext|>``, truncation to
``model_max_length`` and right padding with the pad token.
"""

from __future__ import annotations

import functools
import hashlib
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def hash_tokenizer(max_length: int = 77, vocab: int = 49000):
    """The ``--random-weights`` tokenizer: md5 of each whitespace word (a
    digest, not ``hash()``, which is salted per process), zero padding."""

    def tok_id(w: str) -> int:
        return int.from_bytes(hashlib.md5(w.encode()).digest()[:4], "little") % vocab

    return lambda s: np.asarray(
        [tok_id(w) for w in s.split()][:max_length] + [0] * max(0, max_length - len(s.split())),
        np.int32)[None]


@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """CLIP's reversible map of the 256 byte values to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


@functools.lru_cache(maxsize=None)
def _pattern() -> "re.Pattern":
    """CLIP's ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|
    [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` in ``re``: ``\\w`` is letters,
    numbers (and characters with a numeric value), and ``_``; the numbers
    outside ``\\d`` (categories Nl, No) and the numeric characters that are
    neither letters nor numbers are listed explicitly."""
    nums, odd = [], []
    for c in map(chr, range(sys.maxunicode + 1)):
        cat = unicodedata.category(c)
        if cat in ("Nl", "No"):
            nums.append(c)
        elif c.isnumeric() and cat[0] not in "LN":
            odd.append(c)
    nums, odd = re.escape("".join(nums)), re.escape("".join(odd))
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[^\W\d_{nums}{odd}]+|[\d{nums}]|(?:[^\s\w]|[_{odd}])+", re.IGNORECASE)


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_clean(text: str) -> str:
    """transformers' ``BasicTokenizer(strip_accents=False,
    do_split_on_punc=False)``, joined by single spaces."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch in " \t\n\r" or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif unicodedata.category(ch).startswith("C"):
            continue
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    return " ".join(w.lower() for w in unicodedata.normalize("NFC", "".join(out)).split())


def _special(value):
    return value["content"] if isinstance(value, dict) else value


class CLIPTokenizer:
    """CLIP BPE over ``vocab.json`` and ``merges.txt``; ``tokenizer_config.json``
    gives ``model_max_length`` (77 if absent) and ``special_tokens_map.json``
    the special tokens (pad defaults to ``<|endoftext|>``)."""

    def __init__(self, folder: str):
        with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
            self.encoder: Dict[str, int] = json.load(f)
        with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
            merges = f.read().strip().split("\n")[1:49152 - 256 - 2 + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        tokens = dict(bos_token="<|startoftext|>", eos_token="<|endoftext|>",
                      unk_token="<|endoftext|>", pad_token="<|endoftext|>")
        self.model_max_length = 77
        for name in ("tokenizer_config.json", "special_tokens_map.json"):
            path = os.path.join(folder, name)
            if os.path.exists(path):
                with open(path, encoding="utf-8") as f:
                    cfg = json.load(f)
                tokens.update({k: _special(cfg[k]) for k in tokens if cfg.get(k) is not None})
                self.model_max_length = int(cfg.get("model_max_length", self.model_max_length))
        self.special = {k: self.encoder[v] for k, v in tokens.items()}
        self.special_strings = sorted(set(tokens.values()), key=len, reverse=True)
        self.byte_encoder = bytes_to_unicode()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_pretrained(cls, root: str, subfolder: str = "tokenizer") -> "CLIPTokenizer":
        return cls(os.path.join(root, subfolder))

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word: Tuple[str, ...] = tuple(token[:-1]) + (token[-1] + "</w>",)
        if len(word) == 1:
            return token + "</w>"
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        self.cache[token] = " ".join(word)
        return self.cache[token]

    def _ids(self, text: str) -> List[int]:
        ids = []
        for piece in _pattern().findall(_basic_clean(text)):
            piece = "".join(self.byte_encoder[b] for b in piece.encode("utf-8"))
            ids += [self.encoder.get(t, self.special["unk_token"])
                    for t in self.bpe(piece).split(" ")]
        return ids

    def encode(self, text: str) -> List[int]:
        """Token ids without the start / end tokens; the special token
        strings are split off first and map to their own ids."""
        split = re.split("(" + "|".join(map(re.escape, self.special_strings)) + ")", text)
        ids = []
        for i, part in enumerate(split):
            if i % 2:
                ids.append(self.encoder[part])
            elif part:
                ids += self._ids(part)
        return ids

    def __call__(self, texts: Sequence[str], max_length: int = None) -> np.ndarray:
        """``[len(texts), max_length]`` int64: start, the ids truncated to
        ``max_length - 2``, end, then pad ids."""
        n = max_length or self.model_max_length
        rows = []
        for text in texts:
            ids = ([self.special["bos_token"]] + self.encode(text)[:n - 2]
                   + [self.special["eos_token"]])
            rows.append(ids + [self.special["pad_token"]] * (n - len(ids)))
        return np.asarray(rows, np.int64)
