"""Recommendation models of the port (counterpart of
``zoo_tpu/models/recommendation``): ``NeuralCF``, ``WideAndDeep`` with
``ColumnFeatureInfo``, ``SessionRecommender`` and the ``Recommender``
helpers."""

from zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from zoo_tpu_torch.models.recommendation.session_recommender import (
    SessionRecommender,
)
from zoo_tpu_torch.models.recommendation.wide_and_deep import (
    ColumnFeatureInfo,
    WideAndDeep,
)

__all__ = ["NeuralCF", "Recommender", "SessionRecommender",
           "UserItemFeature", "UserItemPrediction", "WideAndDeep",
           "ColumnFeatureInfo"]
