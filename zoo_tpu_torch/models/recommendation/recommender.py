"""Recommender base: the recommend-for-user/item helpers (counterpart
of ``zoo_tpu/models/recommendation/recommender.py``):
``predict_user_item_pair`` and ``recommend_for_user/item`` over (user,
item) pairs. Each runs the model's ``predict`` on the current CUDA
device unless ``device`` names another."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np


@dataclasses.dataclass
class UserItemFeature:
    """A (user, item) pair plus an optional label."""

    user_id: int
    item_id: int
    label: int = 1


@dataclasses.dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


class Recommender:
    """Mixin over a Keras model whose input is (batch, 2) int pairs."""

    def predict_user_item_pair(self, pairs: Sequence[UserItemFeature],
                               batch_size: int = 256, device=None
                               ) -> List[UserItemPrediction]:
        x = np.array([[p.user_id, p.item_id] for p in pairs], np.int32)
        probs = self.predict(x, batch_size=batch_size, device=device)
        cls = probs.argmax(axis=-1)
        return [UserItemPrediction(p.user_id, p.item_id, int(c),
                                   float(pr[c]))
                for p, c, pr in zip(pairs, cls, probs)]

    def _top(self, pairs, key: str, limit: int, device
             ) -> List[UserItemPrediction]:
        """The ``limit`` most probable predictions per ``key`` (a
        prediction's attribute), groups in order of first appearance."""
        groups = {}
        for pr in self.predict_user_item_pair(pairs, device=device):
            groups.setdefault(getattr(pr, key), []).append(pr)
        out = []
        for lst in groups.values():
            lst.sort(key=lambda p: -p.probability)
            out.extend(lst[:limit])
        return out

    def recommend_for_user(self, pairs: Sequence[UserItemFeature],
                           max_items: int, device=None
                           ) -> List[UserItemPrediction]:
        """Top-``max_items`` items per user among the candidate pairs."""
        return self._top(pairs, "user_id", max_items, device)

    def recommend_for_item(self, pairs: Sequence[UserItemFeature],
                           max_users: int, device=None
                           ) -> List[UserItemPrediction]:
        """Top-``max_users`` users per item among the candidate pairs."""
        return self._top(pairs, "item_id", max_users, device)
