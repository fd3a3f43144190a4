"""Language embedding: phrase -> 512-d feature, cached off the hot path.

Port of ``objcavit_tpu/language/embedding.py``:

* ``ZerosEmbedder``: 'control_obj_zeros_512', zero features (the ablation);
* ``ClipEmbedder``: the CLIP text tower (``models/clip_text.py``) on an
  explicit device, with a host-side phrase cache; the tower runs only on
  cache misses, in batches padded to a fixed size;
* ``make_embedder`` and ``build_class_table``, the (num_classes + 1, 512)
  table of the fused server (per-class strategies only).

The tokenizer and ``ObjectLanguageStrategy`` are the port's copies of the
JAX package's numpy code (``language/tokenizer.py``, ``strategy.py``).
Without a BPE merges file the tokenizer is the hash tokenizer, as in JAX
(no CLIP parity). The embedder runs on the card unless given another
device. Importing released CLIP weights into the port is not done yet
(ROADMAP): a ``ClipEmbedder`` without a model gets random weights from
``seed``.
"""

from __future__ import annotations

import logging
from typing import Sequence

import numpy as np
import torch

from objcavit_torch.language.strategy import ObjectLanguageStrategy
from objcavit_torch.language.tokenizer import make_tokenizer
from objcavit_torch.models.clip_text import CLIP_CONTEXT, CLIPTextEncoder
from objcavit_torch.utils.device import card_device

OBJ_FEATURE_DIM = 512


class ZerosEmbedder:
    """'control_obj_zeros_512': zero features for every phrase."""

    def embed(self, phrases: Sequence[str]) -> np.ndarray:
        return np.zeros((len(phrases), OBJ_FEATURE_DIM), np.float32)


class ClipEmbedder:
    """CLIP text encoder with a host-side phrase cache.

    ``model``: a ``CLIPTextEncoder`` with loaded weights; None builds the
    full-width tower with random weights from ``seed`` (architecture
    complete, no parity). It runs in fp32 on ``device``.
    """

    def __init__(self, model: CLIPTextEncoder | None = None, bpe_path: str | None = None,
                 batch: int = 64, device="cuda", seed: int = 0):
        self.device = card_device(device)
        if model is None:
            model = CLIPTextEncoder().init_weights_(torch.Generator().manual_seed(seed))
        self.model = model.float().eval().to(self.device)
        self.tokenizer = make_tokenizer(bpe_path)
        self.batch = batch
        self._cache: dict[str, np.ndarray] = {}

    @torch.inference_mode()
    def embed(self, phrases: Sequence[str]) -> np.ndarray:
        missing = sorted({p for p in phrases if p not in self._cache})
        for start in range(0, len(missing), self.batch):
            chunk = missing[start:start + self.batch]
            toks = self.tokenizer.tokenize(list(chunk))
            # pad the chunk to the fixed batch size, as the JAX package pads
            # to its jit batch; the padded rows' EOT argmax lands on token 1
            pad = self.batch - len(chunk)
            if pad:
                toks = np.concatenate([toks, np.zeros((pad, CLIP_CONTEXT), np.int32)])
                toks[len(chunk):, 0] = 1
            tokens = torch.as_tensor(toks, dtype=torch.long, device=self.device)
            feats = self.model(tokens).float().cpu().numpy()[:len(chunk)]
            for p, f in zip(chunk, feats):
                self._cache[p] = f.astype(np.float32)
        return np.stack([self._cache[p] for p in phrases])


def make_embedder(strategy: str, clip_model: CLIPTextEncoder | None = None,
                  bpe_path: str | None = None, device="cuda", seed: int = 0):
    """'control_obj_zeros_512' -> ``ZerosEmbedder``; 'clip' -> ``ClipEmbedder``
    (random weights from ``seed`` when no model is given, with a warning)."""
    if strategy == "control_obj_zeros_512":
        return ZerosEmbedder()
    if strategy == "clip":
        if clip_model is None:
            logging.getLogger(__name__).warning(
                "no CLIP weights given: the text tower runs with RANDOM weights from seed %d "
                "(embeddings are noise, no parity)", seed,
            )
        return ClipEmbedder(clip_model, bpe_path, device=device, seed=seed)
    raise ValueError(f"Error: Language model {strategy} not recognised")


def build_class_table(class_names: Sequence[str], strategy_name: str, embedder) -> np.ndarray:
    """(num_classes + 1, 512) phrase-embedding table for fused serving.

    Row c embeds class c's phrase under a per-class strategy ('none' -> the
    class name, 'synset_def_wn' -> its WordNet definition); the last row
    embeds '<UNK>', the no-detection sentinel. The pairwise
    'name_synset_def_wn_rel_sz' strategy depends on the co-detected objects
    and has no table: the host-side provider serves it.
    """
    if strategy_name not in ("none", "synset_def_wn"):
        raise ValueError(
            f"strategy {strategy_name!r} is not per-class; the fused serving table supports "
            "'none' and 'synset_def_wn'"
        )
    strat = ObjectLanguageStrategy(strategy_name)
    phrases = [strat.phrases_for_image([n], None)[0] for n in class_names]
    return np.asarray(embedder.embed(list(phrases) + ["<UNK>"]), np.float32)
