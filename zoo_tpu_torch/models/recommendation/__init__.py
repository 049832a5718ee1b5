"""Recommendation models of the port (counterpart of
``zoo_tpu/models/recommendation``): ``NeuralCF`` and the
``Recommender`` helpers. ``WideAndDeep`` and ``SessionRecommender`` are
not ported yet."""

from zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)

__all__ = ["NeuralCF", "Recommender", "UserItemFeature",
           "UserItemPrediction"]
