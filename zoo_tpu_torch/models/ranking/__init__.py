"""Ranking models of the port (counterpart of ``zoo_tpu/models/ranking``)."""

from zoo_tpu_torch.models.ranking.knrm import KNRM

__all__ = ["KNRM"]
