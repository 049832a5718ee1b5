"""Session-based recommender (counterpart of
``zoo_tpu/models/recommendation/session_recommender.py``): GRUs over the
session's item embeddings; with ``include_history``, the mean of the
history's item embeddings through an MLP, concatenated; a softmax over
the items."""

from __future__ import annotations

import numpy as np

from zoo_tpu_torch.models.recommendation.recommender import Recommender
from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    GRU,
    Dense,
    Embedding,
    Lambda,
    merge,
)


@model_file_part
def _mean_over_time(v):
    """(B, T, D) -> (B, D): a module-level function, so the model saves
    to a model file."""
    return v.mean(dim=1)


class SessionRecommender(Model, Recommender):
    def __init__(self, item_count: int, item_embed: int = 100,
                 rnn_hidden_layers=(40, 20), session_length: int = 10,
                 include_history: bool = False, mlp_hidden_layers=(40, 20),
                 history_length: int = 5):
        self.item_count = item_count
        sess = Input(shape=(session_length,), name="session")
        inputs = [sess]
        h = Embedding(item_count + 1, item_embed)(sess)
        for i, units in enumerate(rnn_hidden_layers):
            last = i == len(rnn_hidden_layers) - 1
            h = GRU(units, return_sequences=not last)(h)
        if include_history:
            hist = Input(shape=(history_length,), name="history")
            inputs.append(hist)
            g = Embedding(item_count + 1, item_embed)(hist)
            g = Lambda(_mean_over_time, output_shape=(item_embed,))(g)
            for units in mlp_hidden_layers:
                g = Dense(units, activation="relu")(g)
            h = merge([h, g], mode="concat")
        out = Dense(item_count + 1, activation="softmax")(h)
        Model.__init__(self, input=inputs if include_history else sess,
                       output=out, name="session_recommender")

    def recommend_for_session(self, sessions, max_items: int = 5,
                              device=None):
        """Top-``max_items`` next items per session, ``[(item,
        probability), ...]``; runs ``predict`` on the current CUDA device
        unless ``device`` names another."""
        probs = self.predict(sessions, device=device)
        top = np.argsort(-probs, axis=1)[:, :max_items]
        return [[(int(i), float(p[i])) for i in row]
                for row, p in zip(top, probs)]
