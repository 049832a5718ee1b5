"""Recommendation models of the port (counterpart of
``zoo_tpu/models/recommendation``): ``NeuralCF``,
``SessionRecommender`` and the ``Recommender`` helpers.
``WideAndDeep`` is not ported yet."""

from zoo_tpu_torch.models.recommendation.neuralcf import NeuralCF
from zoo_tpu_torch.models.recommendation.recommender import (
    Recommender,
    UserItemFeature,
    UserItemPrediction,
)
from zoo_tpu_torch.models.recommendation.session_recommender import (
    SessionRecommender,
)

__all__ = ["NeuralCF", "Recommender", "SessionRecommender",
           "UserItemFeature", "UserItemPrediction"]
