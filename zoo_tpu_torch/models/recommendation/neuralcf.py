"""Neural Collaborative Filtering (counterpart of
``zoo_tpu/models/recommendation/neuralcf.py``).

User and item embeddings feed an MLP tower; with ``include_mf`` a GMF
branch (the element-wise product of separate MF embeddings) is
concatenated before the softmax head. Input: int pairs ``(batch, 2)``,
``[user_id, item_id]``; ``zero_based_ids=False`` keeps the 1-based ids
of the MovieLens pipeline (one extra embedding row absorbs the
offset)."""

from __future__ import annotations

from typing import Sequence

from zoo_tpu_torch.models.recommendation.recommender import Recommender
from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part
from zoo_tpu_torch.pipeline.api.keras.engine.topology import Input, Model
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Dense,
    Embedding,
    Lambda,
    Merge,
    merge,
)


@model_file_part
def _user_ids(pairs):
    return pairs[:, 0]


@model_file_part
def _item_ids(pairs):
    return pairs[:, 1]


class NeuralCF(Model, Recommender):
    def __init__(self, user_count: int, item_count: int, class_num: int,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 zero_based_ids: bool = True):
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.include_mf = include_mf
        offset = 0 if zero_based_ids else 1

        pair = Input(shape=(2,), name="user_item")
        # module-level functions, so the model saves to a model file
        user_id = Lambda(_user_ids, output_shape=(None,))(pair)
        item_id = Lambda(_item_ids, output_shape=(None,))(pair)

        mlp_user = Embedding(user_count + offset, user_embed)(user_id)
        mlp_item = Embedding(item_count + offset, item_embed)(item_id)
        h = merge([mlp_user, mlp_item], mode="concat")
        for units in hidden_layers:
            h = Dense(units, activation="relu")(h)

        if include_mf:
            mf_user = Embedding(user_count + offset, mf_embed)(user_id)
            mf_item = Embedding(item_count + offset, mf_embed)(item_id)
            gmf = Merge(mode="mul")([mf_user, mf_item])
            h = merge([gmf, h], mode="concat")

        out = Dense(class_num, activation="softmax")(h)
        Model.__init__(self, input=pair, output=out, name="neuralcf")
