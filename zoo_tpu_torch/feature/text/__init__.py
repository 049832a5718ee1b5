"""Text pipeline of the port (own copy of ``zoo_tpu/feature/text``):
``TextFeature`` and ``TextSet`` with the reference's transform chain,
corpus -> ``tokenize`` -> ``normalize`` -> ``word2idx`` ->
``shape_sequence`` -> ``generate_sample``, word-index persistence,
random split, relation pairs/lists for QA ranking, and GloVe
embedding-matrix loading. Plain Python and numpy: it imports no torch,
so a data-preparation process needs none; the arrays it gives (int32
ids, labels) feed ``fit``/``predict`` of the port's models, the same
word index and arrays as the JAX package's copy gives.
"""

from __future__ import annotations

import json
import os
import random as _random
import re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "TextFeature", "TextSet", "LocalTextSet", "DistributedTextSet",
    "load_glove_matrix",
]


class TextFeature(dict):
    """Keyed record flowing through the chain (reference:
    ``text_feature.py`` — keys text/uri/label/tokens/indexedTokens/sample)."""

    def __init__(self, text: Optional[str] = None, label: Optional[int] = None,
                 uri: Optional[str] = None):
        super().__init__()
        if text is not None:
            self["text"] = text
        if label is not None:
            self["label"] = int(label)
        if uri is not None:
            self["uri"] = uri

    def get_text(self):
        return self.get("text")

    def get_label(self):
        return self.get("label")

    def keys_(self):
        return list(self.keys())


_TOKEN_RE = re.compile(r"[^a-zA-Z0-9]+")


class TextSet:
    """Factory namespace + shared chain implementation."""

    def __init__(self, features: List[TextFeature]):
        self.features = features
        self.word_index: Optional[Dict[str, int]] = None

    # -- constructors ------------------------------------------------------
    @classmethod
    def read(cls, path: str) -> "LocalTextSet":
        """Directory layout ``path/<category>/*.txt`` exactly like the
        reference's ``TextSet.read`` (label = sorted category position)."""
        feats = []
        cats = sorted(d for d in os.listdir(path)
                      if os.path.isdir(os.path.join(path, d)))
        for label, cat in enumerate(cats):
            cdir = os.path.join(path, cat)
            for fname in sorted(os.listdir(cdir)):
                fpath = os.path.join(cdir, fname)
                if os.path.isfile(fpath):
                    with open(fpath, encoding="utf-8", errors="ignore") as f:
                        feats.append(TextFeature(f.read(), label, fpath))
        return LocalTextSet(feats)

    @classmethod
    def read_csv(cls, path: str) -> "LocalTextSet":
        """uri,text csv (reference ``read_csv``; no header)."""
        feats = []
        with open(path, encoding="utf-8") as f:
            for line in f:
                uri, _, text = line.rstrip("\n").partition(",")
                feats.append(TextFeature(text, uri=uri))
        return LocalTextSet(feats)

    @classmethod
    def from_relation_pairs(cls, relations, corpus1: "TextSet",
                            corpus2: "TextSet") -> "LocalTextSet":
        """Pairwise ranking set: each relation (id1, id2, label) joins the
        indexed tokens of both corpora into one feature whose sample is
        [tokens1 ++ tokens2] (reference ``from_relation_pairs``)."""
        c1 = {f["uri"]: f for f in corpus1.features}
        c2 = {f["uri"]: f for f in corpus2.features}
        feats = []
        for (id1, id2, label) in relations:
            f1, f2 = c1[id1], c2[id2]
            nf = TextFeature(label=int(label))
            nf["indexedTokens"] = np.concatenate(
                [np.asarray(f1["indexedTokens"]),
                 np.asarray(f2["indexedTokens"])])
            feats.append(nf)
        out = LocalTextSet(feats)
        out.word_index = corpus1.word_index
        return out

    @classmethod
    def from_relation_lists(cls, relations, corpus1: "TextSet",
                            corpus2: "TextSet") -> "LocalTextSet":
        """Listwise ranking set: all of a query's candidates grouped into
        ONE feature — ``indexedTokens`` (k, L1+L2) and ``label`` (k,) — so
        list-level metrics (NDCG/MAP) evaluate per query (reference
        ``from_relation_lists``)."""
        c1 = {f["uri"]: f for f in corpus1.features}
        c2 = {f["uri"]: f for f in corpus2.features}
        grouped: Dict[str, List] = {}
        for (id1, id2, label) in relations:
            grouped.setdefault(id1, []).append((id2, int(label)))
        feats = []
        for id1, cands in grouped.items():
            t1 = np.asarray(c1[id1]["indexedTokens"])
            rows = [np.concatenate([t1,
                                    np.asarray(c2[id2]["indexedTokens"])])
                    for id2, _ in cands]
            nf = TextFeature(uri=id1)
            nf["indexedTokens"] = np.stack(rows)
            nf["label"] = np.asarray([l for _, l in cands], np.int32)
            feats.append(nf)
        out = LocalTextSet(feats)
        out.word_index = corpus1.word_index
        return out

    # -- chain -------------------------------------------------------------
    def tokenize(self) -> "TextSet":
        """reference ``Tokenizer.scala``: split on non-alphanumerics."""
        for f in self.features:
            f["tokens"] = [t for t in _TOKEN_RE.split(f.get("text", ""))
                           if t]
        return self

    def normalize(self) -> "TextSet":
        """Lower-case and strip non-alphabetical tokens (reference
        ``Normalizer.scala``)."""
        for f in self.features:
            f["tokens"] = [t.lower() for t in f.get("tokens", [])
                           if not t.isdigit()]
        return self

    def generate_word_index_map(self, remove_topN: int = 0,
                                max_words_num: int = -1,
                                min_freq: int = 1,
                                existing_map: Optional[Dict] = None
                                ) -> Dict[str, int]:
        """Frequency-ranked word→index map, 1-based after dropping the
        ``remove_topN`` most frequent words (reference ``word2idx``
        semantics; index 0 is reserved for padding)."""
        if existing_map:
            self.word_index = dict(existing_map)
            return self.word_index
        counts = Counter()
        for f in self.features:
            counts.update(f.get("tokens", []))
        ranked = [w for w, c in counts.most_common() if c >= min_freq]
        ranked = ranked[remove_topN:]
        if max_words_num > 0:
            ranked = ranked[:max_words_num]
        self.word_index = {w: i + 1 for i, w in enumerate(ranked)}
        return self.word_index

    def word2idx(self, remove_topN: int = 0, max_words_num: int = -1,
                 min_freq: int = 1,
                 existing_map: Optional[Dict] = None) -> "TextSet":
        self.generate_word_index_map(remove_topN, max_words_num, min_freq,
                                     existing_map)
        wi = self.word_index
        for f in self.features:
            f["indexedTokens"] = np.asarray(
                [wi[t] for t in f.get("tokens", []) if t in wi], np.int32)
        return self

    def shape_sequence(self, len: int, trunc_mode: str = "pre",
                       pad_element: int = 0) -> "TextSet":
        """Pad/truncate to fixed length (reference ``SequenceShaper``;
        ``trunc_mode`` pre|post)."""
        L = len
        for f in self.features:
            seq = np.asarray(f["indexedTokens"], np.int32)
            if seq.shape[0] > L:
                seq = seq[-L:] if trunc_mode == "pre" else seq[:L]
            elif seq.shape[0] < L:
                pad = np.full((L - seq.shape[0],), pad_element, np.int32)
                seq = np.concatenate([seq, pad])
            f["indexedTokens"] = seq
        return self

    def generate_sample(self) -> "TextSet":
        for f in self.features:
            f["sample"] = (np.asarray(f["indexedTokens"], np.int32),
                           f.get("label"))
        return self

    def transform(self, fn) -> "TextSet":
        self.features = [fn(f) for f in self.features]
        return self

    # -- accessors ---------------------------------------------------------
    def get_word_index(self) -> Optional[Dict[str, int]]:
        return self.word_index

    def save_word_index(self, path: str):
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.word_index, f)

    def load_word_index(self, path: str) -> "TextSet":
        with open(path, encoding="utf-8") as f:
            self.word_index = json.load(f)
        return self

    def set_word_index(self, vocab: Dict[str, int]) -> "TextSet":
        self.word_index = dict(vocab)
        return self

    def get_texts(self) -> List[str]:
        return [f.get("text") for f in self.features]

    def get_uris(self) -> List[str]:
        return [f.get("uri") for f in self.features]

    def get_labels(self) -> List[int]:
        return [f.get("label") for f in self.features]

    def get_predicts(self) -> List:
        return [f.get("predict") for f in self.features]

    def get_samples(self) -> List[Tuple[np.ndarray, Optional[int]]]:
        return [f["sample"] for f in self.features]

    def to_arrays(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(x, y) batch arrays for estimator ``fit`` (the host-side
        equivalent of the reference's Sample RDD)."""
        xs = np.stack([np.asarray(f["indexedTokens"], np.int32)
                       for f in self.features])
        labels = [f.get("label") for f in self.features]
        ys = None if any(l is None for l in labels) \
            else np.asarray(labels, np.int32)
        return xs, ys

    def random_split(self, weights: Sequence[float],
                     seed: int = 42) -> List["LocalTextSet"]:
        rs = _random.Random(seed)
        idx = list(range(len(self.features)))
        rs.shuffle(idx)
        total = float(sum(weights))
        outs, lo = [], 0
        for i, w in enumerate(weights):
            hi = len(idx) if i == len(weights) - 1 \
                else lo + int(round(len(idx) * w / total))
            part = LocalTextSet([self.features[j] for j in idx[lo:hi]])
            part.word_index = self.word_index
            outs.append(part)
            lo = hi
        return outs

    def is_local(self) -> bool:
        return True

    def is_distributed(self) -> bool:
        return False

    def __len__(self):
        return len(self.features)


class LocalTextSet(TextSet):
    """reference: ``LocalTextSet`` — construct from texts (+labels)."""

    def __init__(self, features=None, texts: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[int]] = None):
        if features is None:
            features = [TextFeature(t, None if labels is None else labels[i])
                        for i, t in enumerate(texts or [])]
        super().__init__(list(features))


class DistributedTextSet(LocalTextSet):
    """reference ``DistributedTextSet`` (RDD-backed there). The rebuild
    processes text shard-wise per host; the distributed/local split is a
    placement detail, so this IS the local set under the reference's
    other name."""


def load_glove_matrix(path: str, word_index: Dict[str, int],
                      dim: Optional[int] = None) -> np.ndarray:
    """GloVe txt → (vocab+1, dim) matrix aligned to ``word_index`` (row 0 =
    padding). Missing words stay zero (reference ``WordEmbedding`` +
    ``TextSet.word2idx`` interplay)."""
    vocab = max(word_index.values()) + 1
    matrix = None
    with open(path, encoding="utf-8") as f:
        for line in f:
            parts = line.rstrip().split(" ")
            w, vec = parts[0], parts[1:]
            if dim is None:
                dim = len(vec)
            if matrix is None:
                matrix = np.zeros((vocab, dim), np.float32)
            i = word_index.get(w)
            if i is not None and i < vocab:
                matrix[i] = np.asarray(vec[:dim], np.float32)
    if matrix is None:
        matrix = np.zeros((vocab, dim or 50), np.float32)
    return matrix
