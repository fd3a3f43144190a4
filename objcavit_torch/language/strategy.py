"""Object -> natural-language phrase strategies (reference
modules/ObjectLanguageStrategy.py).

The port's own copy of ``objcavit_tpu/language/strategy.py`` (numpy and
the standard library only), so that the port imports nothing of that
package.

Pure host Python: phrases depend only on (class synset, neighbour class,
quantised size-ratio bin) — a finite vocabulary — so downstream CLIP
embeddings are cached per phrase and the card only ever sees an embedding
lookup (the reference instead rebuilt strings + re-ran CLIP inside every
training step, GraphBins.py:92-106).

Strategies (:139-177):
  * none               — raw detector labels
  * synset_def_wn      — WordNet synset -> definition, with the stop_sign
                         special case and lemma fallback (:96-125)
  * name_synset_def_wn_rel_sz — "This is a {name}, defined as {def}. This
                         {name} appears {size clause} the {other}." with a
                         7-point log-area-ratio scale (:23-31, :69-83)

WordNet corpus data may be absent in deployment images; lookups then fall
back to the lemma (the reference's own fallback for non-synset labels).
"""

from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np

SEVEN_PT_SIZE_SCALE = (
    "much smaller than",
    "smaller than",
    "a bit smaller than",
    "about the same size as",
    "a bit bigger than",
    "bigger than",
    "much bigger than",
)

# First sentence of the English Wikipedia "Stop sign" article — the reference
# hard-codes this because stop_sign.n.01 is an LVIS label but not a real
# WordNet synset (ObjectLanguageStrategy.py:114-116).
_STOP_SIGN_DEF = (
    "A stop sign is a traffic sign designed to notify drivers that they must "
    "come to a complete stop and make sure the intersection is safely clear "
    "of vehicles and pedestrians before continuing past the sign."
)

STRATEGIES = ("none", "synset_def_wn", "name_synset_def_wn_rel_sz")


def synset_to_name(synset: str) -> str:
    name = synset.split(".", 1)[0]
    return re.sub(r"[^a-zA-Z0-9 \.]", " ", name)


class ObjectLanguageStrategy:
    def __init__(self, strategy: str):
        assert strategy in STRATEGIES, f"unrecognised strategy {strategy}"
        self.strategy = strategy
        self.rel_size_scale = SEVEN_PT_SIZE_SCALE
        self._wn = None
        self._definition_cache: dict[str, str] = {}

    def _wordnet(self):
        if self._wn is None:
            try:
                from nltk.corpus import wordnet as wn

                wn.synsets("dog")  # force corpus load; raises if data missing
                self._wn = wn
            except Exception:
                self._wn = False
        return self._wn

    def get_synset_definition(self, term: str | None) -> str:
        if term is None:
            return "<UNK>"
        if term in self._definition_cache:
            return self._definition_cache[term]
        definition = None
        wn = self._wordnet()
        if wn:
            try:
                definition = wn.synset(term).definition()
            except Exception:
                definition = None
        if definition is None:
            if term == "stop_sign.n.01":
                definition = _STOP_SIGN_DEF
            else:
                definition = synset_to_name(term)  # lemma fallback
        self._definition_cache[term] = definition
        return definition

    def size_clause_index(self, area: float, other_area: float) -> int:
        """7-point bin from the log area ratio (:69-83): everything within
        [1/e, e] x the other object maps onto the middle bins."""
        rel = math.log(area / other_area) + 1  # valid-bin range now 0..2
        rel = rel / 2 * (len(self.rel_size_scale) - 3)
        rel = int(np.clip(np.round(rel) + 1, 0, len(self.rel_size_scale) - 1))
        return rel

    def _relative_size_clause(
        self, xywh: np.ndarray, names: Sequence[str], j: int
    ) -> str:
        n = len(names)
        if n <= 1:
            return ""
        nj = (j + 1) % n
        area = float(xywh[j, 2] * xywh[j, 3])
        other_area = float(xywh[nj, 2] * xywh[nj, 3])
        clause = self.rel_size_scale[self.size_clause_index(area, other_area)]
        name = synset_to_name(names[j])
        other = synset_to_name(names[nj])
        other_prefix = "other " if other == name else ""
        return f"This {name} appears {clause} the {other_prefix}{other}"

    def phrases_for_image(
        self, names: Sequence[str] | None, xywh: np.ndarray | None
    ) -> list[str]:
        """Phrases for one image's detections; ['<UNK>'] when none."""
        if names is None or len(names) == 0:
            return ["<UNK>"]
        if self.strategy == "none":
            return list(names)
        if self.strategy == "synset_def_wn":
            return [self.get_synset_definition(s) for s in names]
        # name_synset_def_wn_rel_sz
        out = []
        for j, synset in enumerate(names):
            definition = self.get_synset_definition(synset)
            name = synset_to_name(synset)
            art = "an" if name[0] in "aeiou" else "a"
            base = f"This is {art} {name}, defined as {definition}"
            clause = self._relative_size_clause(xywh, names, j)
            out.append(f"{base}. {clause}.")
        return out

    def __call__(self, names_list, xywh_list) -> list[list[str]]:
        """Batch version: lists of per-image names / (N,4) xywh arrays."""
        return [
            self.phrases_for_image(n, x) for n, x in zip(names_list, xywh_list)
        ]
