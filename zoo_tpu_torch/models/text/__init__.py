"""Sequence-tagging text models (counterpart of
``zoo_tpu/models/text/__init__.py``): ``NER`` (BiLSTM-CRF),
``SequenceTagger`` (POS and chunk heads) and ``IntentEntity`` (intent
and slot filling), on the Keras functional API.

Inputs, as in the JAX package: word indices ``(batch,
sequence_length)`` and character indices ``(batch, sequence_length,
word_length)``. ``load_model(path, device=None)`` reads the port's model
file onto the current CUDA device unless ``device`` names another.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from zoo_tpu_torch.common.device import resolve_device
from zoo_tpu_torch.models.text.crf import (
    CRF,
    crf_decode,
    crf_negative_log_likelihood,
    unpack_crf,
)
from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    Input,
    KerasNet,
    Model,
)
from zoo_tpu_torch.pipeline.api.keras.layers import (
    LSTM,
    Bidirectional,
    Conv1D,
    Dense,
    Dropout,
    Embedding,
    GlobalMaxPooling1D,
    Reshape,
    TimeDistributed,
    merge,
)

__all__ = ["NER", "SequenceTagger", "IntentEntity", "CRF", "crf_decode",
           "crf_negative_log_likelihood", "unpack_crf"]


def _char_features(chars_in, seq_len: int, word_length: int,
                   char_vocab_size: int, char_emb_dim: int,
                   out_dim: int):
    """Per-word character features: the characters embedded, convolved
    within each word, max-pooled (one batched conv for every word)."""
    h = Reshape((seq_len * word_length,))(chars_in)
    h = Embedding(char_vocab_size, char_emb_dim)(h)
    h = Reshape((seq_len, word_length, char_emb_dim))(h)
    h = TimeDistributed(Conv1D(out_dim, 3, border_mode="same",
                               activation="relu"))(h)
    return TimeDistributed(GlobalMaxPooling1D())(h)


def _tag_loss(classifier: str):
    return (crf_negative_log_likelihood if classifier == "crf"
            else "sparse_categorical_crossentropy")


class NER(Model):
    """Named-entity recognition: a BiLSTM tagger with a CRF (default) or
    softmax head; words (B, T) and chars (B, T, word_length) -> tags.
    ``crf_mode="reg"`` (full equal-length sequences) only; ``"pad"`` is
    refused, as in the JAX package. Compile with ``default_loss()``;
    decode with ``predict_tags``."""

    def __init__(self, num_entities: int, word_vocab_size: int,
                 char_vocab_size: int, sequence_length: int = 64,
                 word_length: int = 12, word_emb_dim: int = 100,
                 char_emb_dim: int = 30, tagger_lstm_dim: int = 100,
                 dropout: float = 0.5, crf_mode: str = "reg",
                 classifier: str = "crf"):
        if crf_mode != "reg":
            raise ValueError(
                'crf_mode="pad" is not supported; pad to equal length '
                'and use "reg" (the reference default)')
        if classifier not in ("crf", "softmax"):
            raise ValueError("classifier must be 'crf' or 'softmax'")
        self.classifier = classifier
        words = Input(shape=(sequence_length,), name="words")
        chars = Input(shape=(sequence_length, word_length), name="chars")
        w = Embedding(word_vocab_size, word_emb_dim)(words)
        c = _char_features(chars, sequence_length, word_length,
                           char_vocab_size, char_emb_dim, char_emb_dim)
        h = merge([w, c], mode="concat")
        h = Dropout(dropout)(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True))(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True))(h)
        h = Dropout(dropout)(h)
        if classifier == "crf":
            out = CRF()(Dense(num_entities)(h))
        else:
            out = Dense(num_entities, activation="softmax")(h)
        super().__init__(input=[words, chars], output=out, name="ner")

    def default_loss(self):
        return _tag_loss(self.classifier)

    def predict_tags(self, words, chars, batch_size: int = 32,
                     device=None) -> np.ndarray:
        """The best tag of each word (Viterbi through the CRF, else the
        argmax), decoded on the device the forward ran on."""
        dev = resolve_device(device)
        packed = self.predict([words, chars], batch_size=batch_size,
                              device=dev)
        if self.classifier == "crf":
            return crf_decode(torch.from_numpy(packed).to(dev)).cpu().numpy()
        return np.argmax(packed, axis=-1)

    @staticmethod
    def load_model(path: str, device=None) -> "NER":
        return KerasNet.load(path, device)


class SequenceTagger(Model):
    """POS tagger and chunker: three BiLSTM layers, a softmax POS head
    and a chunk head (softmax, or a CRF with ``classifier="crf"``).
    Inputs: words, and chars when ``char_vocab_size`` is given."""

    def __init__(self, num_pos_labels: int, num_chunk_labels: int,
                 word_vocab_size: int,
                 char_vocab_size: Optional[int] = None,
                 sequence_length: int = 64, word_length: int = 12,
                 feature_size: int = 100, dropout: float = 0.2,
                 classifier: str = "softmax"):
        classifier = classifier.lower()
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier should be softmax or crf")
        self.classifier = classifier
        words = Input(shape=(sequence_length,), name="words")
        inputs = [words]
        h = Embedding(word_vocab_size, feature_size)(words)
        if char_vocab_size is not None:
            chars = Input(shape=(sequence_length, word_length),
                          name="chars")
            inputs.append(chars)
            c = _char_features(chars, sequence_length, word_length,
                               char_vocab_size, 30, feature_size)
            h = merge([h, c], mode="concat")
        h = Dropout(dropout)(h)
        for _ in range(3):
            h = Bidirectional(LSTM(feature_size,
                                   return_sequences=True))(h)
        pos = Dense(num_pos_labels, activation="softmax")(h)
        if classifier == "crf":
            chunk = CRF()(Dense(num_chunk_labels)(h))
        else:
            chunk = Dense(num_chunk_labels, activation="softmax")(h)
        super().__init__(input=inputs, output=[pos, chunk],
                         name="sequence_tagger")

    def default_loss(self):
        return ["sparse_categorical_crossentropy",
                _tag_loss(self.classifier)]

    @staticmethod
    def load_model(path: str, device=None) -> "SequenceTagger":
        return KerasNet.load(path, device)


class IntentEntity(Model):
    """Joint intent classification and slot filling: a shared encoder,
    a sequence-level intent head and a per-token entity head."""

    def __init__(self, num_intents: int, num_entities: int,
                 word_vocab_size: int, char_vocab_size: int,
                 sequence_length: int = 64, word_length: int = 12,
                 word_emb_dim: int = 100, char_emb_dim: int = 30,
                 char_lstm_dim: int = 30, tagger_lstm_dim: int = 100,
                 dropout: float = 0.2, classifier: str = "softmax"):
        if classifier not in ("softmax", "crf"):
            raise ValueError("classifier must be 'softmax' or 'crf'")
        self.classifier = classifier
        words = Input(shape=(sequence_length,), name="words")
        chars = Input(shape=(sequence_length, word_length), name="chars")
        w = Embedding(word_vocab_size, word_emb_dim)(words)
        c = _char_features(chars, sequence_length, word_length,
                           char_vocab_size, char_emb_dim, char_lstm_dim)
        h = merge([w, c], mode="concat")
        h = Dropout(dropout)(h)
        h = Bidirectional(LSTM(tagger_lstm_dim, return_sequences=True))(h)
        # the intent rides the sequence summary, the tags every step
        intent_feat = Bidirectional(LSTM(tagger_lstm_dim))(h)
        intent = Dense(num_intents, activation="softmax")(intent_feat)
        tag_h = Bidirectional(LSTM(tagger_lstm_dim,
                                   return_sequences=True))(h)
        if classifier == "crf":
            tags = CRF()(Dense(num_entities)(tag_h))
        else:
            tags = Dense(num_entities, activation="softmax")(tag_h)
        super().__init__(input=[words, chars], output=[intent, tags],
                         name="intent_entity")

    def default_loss(self):
        return ["sparse_categorical_crossentropy",
                _tag_loss(self.classifier)]

    @staticmethod
    def load_model(path: str, device=None) -> "IntentEntity":
        return KerasNet.load(path, device)
