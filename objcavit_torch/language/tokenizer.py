"""CLIP byte-pair-encoding tokenizer (host-side).

The port's own copy of ``objcavit_tpu/language/tokenizer.py`` (standard
library and numpy only), so that the port imports nothing of that package.

Implements the OpenAI CLIP ``SimpleTokenizer`` algorithm: byte-level unicode
mapping, BPE merges from the released ``bpe_simple_vocab_16e6.txt.gz``, basic
regex splitting, lowercasing + whitespace cleanup, <|startoftext|> /
<|endoftext|> framing, pad/truncate to 77.

The merges file is an external asset (not shipped here; zero-egress image).
Point ``CLIP_BPE_PATH`` or the constructor at it when available. Without it,
``HashTokenizer`` provides a deterministic stand-in so the language pipeline
stays exercisable end-to-end — NOT embedding-parity with CLIP (documented;
parity requires the asset + imported weights anyway).
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache

from objcavit_torch.errors import MissingAssetError  # importable from here too

CONTEXT_LENGTH = 77


@lru_cache()
def bytes_to_unicode():
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    """OpenAI CLIP SimpleTokenizer algorithm over a merges file."""

    def __init__(self, bpe_path: str | None = None):
        bpe_path = bpe_path or os.environ.get("CLIP_BPE_PATH")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; set CLIP_BPE_PATH or pass "
                "bpe_path (bpe_simple_vocab_16e6.txt.gz)"
            )
        self.byte_encoder = bytes_to_unicode()
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += ["<|startoftext|>", "<|endoftext|>"]
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<|startoftext|>": "<|startoftext|>",
            "<|endoftext|>": "<|endoftext|>",
        }
        # CLIP's pattern uses \p{L}/\p{N} (the `regex` module); stdlib `re`
        # lacks those, so ASCII classes stand in — identical for the English
        # WordNet/LVIS phrase vocabulary this framework feeds it.
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+",
            re.IGNORECASE,
        )

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
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
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> list[int]:
        text = whitespace_clean(basic_clean(text)).lower()
        ids = []
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def tokenize(self, texts: list[str], context_length: int = CONTEXT_LENGTH):
        import numpy as np

        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            toks = [sot] + self.encode(text) + [eot]
            # CLIP default truncates with EOT at the end
            if len(toks) > context_length:
                toks = toks[: context_length - 1] + [eot]
            out[i, : len(toks)] = toks
        return out


class HashTokenizer:
    """Deterministic stand-in when the BPE asset is unavailable (no parity)."""

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def tokenize(self, texts: list[str], context_length: int = CONTEXT_LENGTH):
        import numpy as np

        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            words = whitespace_clean(basic_clean(text)).lower().split(" ")
            ids = [hash(w) % (self.vocab_size - 2) for w in words]
            toks = [self.sot] + ids[: context_length - 2] + [self.eot]
            out[i, : len(toks)] = toks
        return out


def make_tokenizer(bpe_path: str | None = None, require: bool = False):
    """require=True: propagate a missing BPE asset as MissingAssetError
    instead of degrading to the non-parity HashTokenizer."""
    try:
        return ClipBPETokenizer(bpe_path)
    except FileNotFoundError as e:
        if require:
            raise MissingAssetError(str(e)) from e
        import logging

        logging.getLogger(__name__).warning(
            "CLIP BPE merges asset not found (CLIP_BPE_PATH unset) — using "
            "the deterministic HashTokenizer stand-in; embeddings are NOT "
            "CLIP-parity until the asset is provided"
        )
        return HashTokenizer()
