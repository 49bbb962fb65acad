"""CLIP byte-level BPE tokenizer, PyTorch port's copy.

Port of ``vface_tpu/models/clip_tokenizer.py`` (the HF ``CLIPTokenizer`` of
REFace's ``FrozenCLIPTextEmbedder``): byte -> printable-unicode alphabet,
rank-driven BPE with ``</w>`` word terminals, the CLIP word-split pattern, and
``<|startoftext|>``/``<|endoftext|>`` specials with EOS doubling as the pad
token. It needs no ``regex`` package: the pattern's ``\\p{L}`` and ``\\p{N}``
classes are enumerated from :mod:`unicodedata` for the standard ``re`` module
(:func:`word_pattern`).

Text cleaning follows the tokenizer's no-ftfy path: control-char stripping,
CJK spacing, NFC normalisation, whitespace-collapse, lowercasing. The OpenAI
vocab / merges files are not bundled: load them with
:meth:`CLIPBPETokenizer.from_files`.
"""

from __future__ import annotations

import functools
import json
import re
import sys
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np


def _is_space(c: str) -> bool:
    """Unicode's White_Space, as the ``regex`` module's ``\\s``: Python's
    ``str.isspace`` less the four information separators U+001C-U+001F."""
    return c.isspace() and not "\x1c" <= c <= "\x1f"


def _classes() -> Tuple[str, str, str]:
    """The bodies of three ``re`` character classes (``\\U`` ranges): letters
    (general category L*), numbers (N*), and the rest that is not whitespace
    and has no case variant among the letters and numbers (``regex`` with
    IGNORECASE leaves such a character, U+0345, out of ``[^\\s\\p{L}\\p{N}]``)."""
    def kind(cp: int) -> int:
        c = chr(cp)
        cat = unicodedata.category(c)
        if cat[0] == "L":
            return 0
        if cat[0] == "N":
            return 1
        if _is_space(c) or any(len(v) == 1 and unicodedata.category(v)[0] in "LN"
                               for v in (c.lower(), c.upper(), c.casefold())):
            return 3
        return 2

    parts: Tuple[list, list, list] = ([], [], [])
    start, cur = 0, kind(0)
    for cp in range(1, sys.maxunicode + 2):
        k = kind(cp) if cp <= sys.maxunicode else -1
        if k != cur:
            if cur < 3:
                parts[cur].append(f"\\U{start:08x}" if cp - 1 == start else f"\\U{start:08x}-\\U{cp - 1:08x}")
            start, cur = cp, k
    return tuple("".join(p) for p in parts)


@functools.lru_cache(maxsize=1)
def word_pattern() -> "re.Pattern":
    """The CLIP word split (``regex``'s ``<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d
    |[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` under IGNORECASE) for the standard
    ``re`` module, which has no ``\\p{...}``: the classes come from
    :mod:`unicodedata` (:func:`_classes`), the case-insensitive part is the
    literal alternatives'. Characters assigned after the running Python's
    Unicode version (``unicodedata.unidata_version``) fall in no class."""
    letters, numbers, other = _classes()
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)"
        f"|[{letters}]+|[{numbers}]|[{other}]+"
    )


BOS = "<|startoftext|>"
EOS = "<|endoftext|>"


def byte_alphabet() -> Dict[int, str]:
    """Reversible byte → printable-unicode map (the GPT-2/CLIP scheme):
    printable latin-1 bytes map to themselves, everything else to 0x100+n in
    increasing byte order, so no token string ever contains whitespace."""
    printable = (
        set(range(0x21, 0x7F)) | set(range(0xA1, 0xAD)) | set(range(0xAE, 0x100))
    )
    table: Dict[int, str] = {}
    shift = 0
    for b in range(256):
        if b in printable:
            table[b] = chr(b)
        else:
            table[b] = chr(0x100 + shift)
            shift += 1
    return table


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def clean_text(text: str) -> str:
    """The no-ftfy cleaning chain (BasicTokenizer with strip_accents=False,
    do_split_on_punc=False, then whitespace-join): drop control chars, space
    out CJK codepoints, NFC-normalise, collapse whitespace, lowercase."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C") and ch not in ("\t", "\n", "\r"):
            continue
        if _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(tok.lower() for tok in text.split())


class CLIPBPETokenizer:
    """Greedy rank-driven BPE over the byte alphabet with ``</w>`` terminals."""

    def __init__(self, vocab: Dict[str, int], merges: Sequence[Tuple[str, str]]):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {v: k for k, v in self.vocab.items()}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.byte_map = byte_alphabet()
        self.bos_id = self.vocab[BOS]
        self.eos_id = self.vocab[EOS]
        self.unk_id = self.eos_id  # HF: unk_token == "<|endoftext|>"
        self._cache: Dict[str, List[str]] = {BOS: [BOS], EOS: [EOS]}

    @classmethod
    def from_files(cls, vocab_path: str, merges_path: str) -> "CLIPBPETokenizer":
        with open(vocab_path, encoding="utf-8") as f:
            vocab = json.load(f)
        with open(merges_path, encoding="utf-8") as f:
            lines = f.read().strip().split("\n")[1:]  # line 0 is a version header
        merges = [tuple(l.split()) for l in lines if l]
        return cls(vocab, merges)

    # ------------------------------------------------------------------ BPE
    def _bpe(self, word: str) -> List[str]:
        if word in self._cache:
            return self._cache[word]
        parts: List[str] = list(word[:-1]) + [word[-1] + "</w>"]
        while len(parts) > 1:
            pairs = [(parts[i], parts[i + 1]) for i in range(len(parts) - 1)]
            ranked = [(self.ranks[p], i) for i, p in enumerate(pairs) if p in self.ranks]
            if not ranked:
                break
            best_rank = min(r for r, _ in ranked)
            first, second = pairs[[i for r, i in ranked if r == best_rank][0]]
            merged: List[str] = []
            i = 0
            while i < len(parts):
                if (
                    i + 1 < len(parts)
                    and parts[i] == first
                    and parts[i + 1] == second
                ):
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(parts[i])
                    i += 1
            parts = merged
        self._cache[word] = parts
        return parts

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for word in word_pattern().findall(clean_text(text)):
            mapped = "".join(self.byte_map[b] for b in word.encode("utf-8"))
            toks.extend(self._bpe(mapped))
        return toks

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_id) for t in tokens]

    # ------------------------------------------------------------- batching
    def __call__(
        self,
        texts: Sequence[str] | str,
        max_length: int | None = None,
        padding: bool = True,
    ):
        """HF-call semantics: bos + tokens + eos per row, padded to the batch
        longest (pad id = eos id), plus the 1/0 attention mask. Returns
        ``{"input_ids": (B, L) int32, "attention_mask": (B, L) int32}``."""
        if isinstance(texts, str):
            texts = [texts]
        rows = []
        for t in texts:
            ids = [self.bos_id] + self.convert_tokens_to_ids(self.tokenize(t)) + [self.eos_id]
            if max_length is not None and len(ids) > max_length:
                ids = ids[: max_length - 1] + [self.eos_id]
            rows.append(ids)
        n = max(len(r) for r in rows)
        if max_length is not None and padding == "max_length":
            n = max_length
        ids_arr = np.full((len(rows), n), self.eos_id, np.int32)
        mask = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            ids_arr[i, : len(r)] = r
            mask[i, : len(r)] = 1
        return {"input_ids": ids_arr, "attention_mask": mask}
