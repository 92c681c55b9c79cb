"""CLIP byte-level BPE tokenizer.

The port's own copy of comfyui_distributed_tpu/models/clip_bpe.py, with
the same semantics: CLIP's no-ftfy text cleanup (control characters
dropped, CJK spaced out, NFC, whitespace collapsed, lowercased), CLIP's
pre-tokenization, the GPT-2 byte→unicode table and rank-ordered BPE
merges with a `</w>` end-of-word suffix.

The JAX copy pre-tokenizes with the third-party `regex` package's
\\p{L}/\\p{N} classes; this one classifies characters with
`unicodedata` instead, so the port needs nothing beyond the standard
library. The vocab is the JAX package's committed asset pair, read by
path as data (`CDT_CLIP_VOCAB` selects another).
"""

from __future__ import annotations

import functools
import gzip
import json
import logging
import os
import unicodedata

_ASSET_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "comfyui_distributed_tpu", "models", "assets", "clip_vocab",
)

_SPECIALS = ("<|startoftext|>", "<|endoftext|>")
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

# CLIP caps the merge table at 49152-256-2 entries regardless of file length.
_MAX_MERGES = 49152 - 256 - 2


@functools.lru_cache
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte→printable-unicode table."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _open_maybe_gz(path: str):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rt", encoding="utf-8")
    return open(path, encoding="utf-8")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def clean_text(text: str) -> str:
    """CLIP's no-ftfy normalization: strip control chars, space out CJK,
    NFC-normalize, collapse whitespace, lowercase (accents kept)."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if ch.isspace() or unicodedata.category(ch) == "Zs":
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFC", "".join(out))
    return " ".join(text.lower().split())


def _char_class(ch: str) -> str:
    """'L' letter, 'N' number, 'S' whitespace, 'O' anything else."""
    if ch.isspace():
        return "S"
    cat = unicodedata.category(ch)[0]
    return cat if cat in ("L", "N") else "O"


def pre_tokenize(text: str) -> list[str]:
    """CLIP's pre-tokenization pattern over cleaned (lowercased) text,
    matched left to right: specials | 's 't 're 've 'm 'll 'd |
    letters+ | one number | (not whitespace, letter or number)+."""
    pieces: list[str] = []
    i, n = 0, len(text)
    while i < n:
        special = next((s for s in _SPECIALS if text.startswith(s, i)), None)
        if special is not None:
            pieces.append(text[i:i + len(special)])
            i += len(special)
            continue
        contraction = next((c for c in _CONTRACTIONS if text.startswith(c, i)), None)
        if contraction is not None:
            pieces.append(text[i:i + len(contraction)])
            i += len(contraction)
            continue
        cls = _char_class(text[i])
        if cls == "S":
            i += 1
            continue
        if cls == "N":
            pieces.append(text[i])
            i += 1
            continue
        j = i + 1
        while j < n and _char_class(text[j]) == cls:
            j += 1
        pieces.append(text[i:j])
        i = j
    return pieces


class ClipBPE:
    """Encoder over a CLIP-format vocab.json + merges.txt pair."""

    def __init__(self, vocab_dir: str | None = None):
        vocab_dir = vocab_dir or _ASSET_DIR
        self.vocab_dir = vocab_dir
        with _open_maybe_gz(os.path.join(vocab_dir, "vocab.json")) as fh:
            self.encoder: dict[str, int] = json.load(fh)
        with _open_maybe_gz(os.path.join(vocab_dir, "merges.txt")) as fh:
            lines = fh.read().strip().split("\n")
        # line 0 is the "#version" header
        merges = [tuple(ln.split()) for ln in lines[1 : _MAX_MERGES + 1]]
        self.bpe_ranks: dict[tuple[str, str], int] = {m: i for i, m in enumerate(merges)}
        self.byte_encoder = bytes_to_unicode()
        self.bos_id = self.encoder["<|startoftext|>"]
        self.eos_id = self.encoder["<|endoftext|>"]
        # specials pass through BPE unsplit
        self._cache: dict[str, str] = {s: s for s in _SPECIALS}

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._cache[token] = result
        return result

    @functools.cached_property
    def is_canonical(self) -> bool:
        """True when this vocab behaves as OpenAI's published CLIP
        vocabulary (token ids from the official CLIP notebook)."""
        return (
            self.encode_text("hello world!") == [3306, 1002, 256]
            and self.encode_text("a photo of a cat") == [320, 1125, 539, 320, 2368]
        )

    def encode_text(self, text: str) -> list[int]:
        """Text → BPE ids (no specials, no padding)."""
        ids: list[int] = []
        for token in pre_tokenize(clean_text(text)):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            for piece in self._bpe(mapped).split(" "):
                ids.append(self.encoder.get(piece, self.eos_id))
        return ids


@functools.lru_cache(maxsize=4)
def _get_bpe_cached(vocab_dir: str) -> ClipBPE:
    bpe = ClipBPE(vocab_dir)
    if not bpe.is_canonical:
        logging.getLogger("cdt.clip_bpe").warning(
            "CLIP vocab at %s is NOT OpenAI's published table: real SD/SDXL "
            "checkpoints will receive wrong token ids. Point CDT_CLIP_VOCAB "
            "at OpenAI's vocab.json/merges.txt pair.",
            vocab_dir,
        )
    return bpe


def get_bpe(vocab_dir: str | None = None) -> ClipBPE:
    resolved = vocab_dir or os.environ.get("CDT_CLIP_VOCAB") or _ASSET_DIR
    return _get_bpe_cached(resolved)
