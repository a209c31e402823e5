"""Caption tokenization for the CLIP text tower (own copy of
``hig_tpu/models/tokenizer.py``; the port imports nothing of ``hig_tpu``).

OpenAI CLIP's byte-level BPE with a 49,408-token vocabulary, 77-token
context, <|startoftext|>/<|endoftext|> specials and truncation. The merge
table (``bpe_simple_vocab_16e6.txt.gz``) is an external asset; when it is
absent a deterministic hash tokenizer with the same id-space contract
(specials, context length, argmax-EOT pooling) keeps serving runnable. Both
paths give the ids the JAX package gives for the same caption.
"""

from __future__ import annotations

import functools
import gzip
import hashlib
import html
import os
import re

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = 49406
EOT = 49407

# Python's re lacks \p{L}; this ASCII approximation matches CLIP on English
# captions (the NTU caption vocabulary is pure ASCII).
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""",
    re.IGNORECASE,
)


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def _whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


@functools.lru_cache()
def bytes_to_unicode():
    """Reversible byte→unicode map used by byte-level BPE (GPT-2 convention)."""
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
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


class ClipBPETokenizer:
    """OpenAI CLIP byte-level BPE (needs the merges asset)."""

    def __init__(self, bpe_path: str):
        with gzip.open(bpe_path) as f:
            merges = f.read().decode("utf-8").split("\n")
        merges = merges[1 : 49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        byte_enc = bytes_to_unicode()
        vocab = list(byte_enc.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.byte_encoder = byte_enc
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        tokens = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for tok in _PAT.findall(text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            tokens.extend(self.encoder[t] for t in self._bpe(tok).split(" "))
        return tokens


class HashTokenizer:
    """Deterministic fallback: one id per lowercased word via md5."""

    def encode(self, text: str) -> list[int]:
        text = _whitespace_clean(_basic_clean(text)).lower()
        ids = []
        for tok in _PAT.findall(text):
            h = int.from_bytes(hashlib.md5(tok.encode()).digest()[:4], "little")
            ids.append(h % (SOT - 1))
        return ids


_DEFAULT_ASSET_PATHS = [
    os.environ.get("HIG_TPU_BPE_PATH", ""),
    os.path.join(os.path.dirname(__file__), "..", "..", "assets", "bpe_simple_vocab_16e6.txt.gz"),
]


@functools.lru_cache()
def default_tokenizer():
    for p in _DEFAULT_ASSET_PATHS:
        if p and os.path.exists(p):
            return ClipBPETokenizer(p)
    return HashTokenizer()


def tokenize(
    texts: str | list[str],
    tokenizer=None,
    context_length: int = CONTEXT_LENGTH,
    truncate: bool = True,
) -> np.ndarray:
    """Captions → (N, 77) int32 id matrix, CLIP layout."""
    if isinstance(texts, str):
        texts = [texts]
    tokenizer = tokenizer or default_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        ids = [SOT] + tokenizer.encode(text) + [EOT]
        if len(ids) > context_length:
            if not truncate:
                raise ValueError(f"caption too long: {text!r}")
            ids = ids[:context_length]
            ids[-1] = EOT
        result[i, : len(ids)] = ids
    return result
