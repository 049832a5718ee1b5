"""Linear-chain CRF for sequence tagging (counterpart of
``zoo_tpu/models/text/crf.py``): the forward algorithm (the partition
function) and Viterbi decoding as loops over time.

Packing convention, as in the JAX package: the :class:`CRF` layer
appends its (E, E) transition matrix to the emissions along the time
axis, output ``(B, T+E, E)``, so the transitions reach the loss
(:func:`crf_negative_log_likelihood`) and the decoder
(:func:`crf_decode`) through the ``loss(y, preds)`` interface;
:func:`unpack_crf` splits them apart.
"""

from __future__ import annotations

from typing import Tuple

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import (
    Layer,
    model_file_part,
)

__all__ = ["CRF", "crf_negative_log_likelihood", "crf_decode",
           "unpack_crf"]


class CRF(Layer):
    """Terminal tagging layer: owns the transition matrix ``T`` (zeros
    at build) and packs it with the emissions."""

    def build(self, generator, input_shape):
        e = input_shape[-1]
        return {"T": torch.zeros((e, e), dtype=torch.float32,
                                 device=generator.device)}

    def call(self, params, inputs, *, training=False, rng=None):
        b, _, e = inputs.shape
        trans = params["T"].to(inputs.dtype).expand(b, e, e)
        return torch.cat([inputs, trans], dim=1)

    def compute_output_shape(self, input_shape):
        b, t, e = input_shape
        return (b, None if t is None else t + e, e)


def unpack_crf(packed: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T+E, E) -> emissions (B, T, E), transitions (E, E)."""
    e = packed.shape[-1]
    return packed[:, :-e, :], packed[0, -e:, :]


def _forward_log_z(emissions: torch.Tensor, trans: torch.Tensor
                   ) -> torch.Tensor:
    """The log partition function of each sequence: (B, T, E), (E, E)
    -> (B,)."""
    alpha = emissions[:, 0, :]
    for t in range(1, emissions.shape[1]):
        scores = alpha[:, :, None] + trans[None] + emissions[:, t, None, :]
        alpha = torch.logsumexp(scores, dim=1)
    return torch.logsumexp(alpha, dim=-1)


@model_file_part
def crf_negative_log_likelihood(y_true, packed):
    """Mean negative log-likelihood of the tag sequences (the CRF
    objective for full equal-length sequences, the reference's
    ``crf_mode='reg'``), in f32 whatever the packed dtype."""
    emissions, trans = unpack_crf(packed)
    emissions = emissions.float()
    trans = trans.float()
    y = y_true.long()
    if y.ndim == emissions.ndim:   # (B, T, 1) labels
        y = y[..., 0]
    em_score = torch.gather(emissions, -1, y[..., None])[..., 0].sum(1)
    tr_score = trans[y[:, :-1], y[:, 1:]].sum(1)
    return torch.mean(_forward_log_z(emissions, trans) - em_score - tr_score)


crf_negative_log_likelihood._handles_low_precision = True


@model_file_part
def crf_decode(packed: torch.Tensor) -> torch.Tensor:
    """Viterbi decode: (B, T+E, E) -> the best tag path (B, T), int32,
    on ``packed``'s device; among equal scores the lower tag wins, as
    ``jnp.argmax`` picks."""
    emissions, trans = unpack_crf(packed)
    emissions = emissions.float()
    trans = trans.float()
    score = emissions[:, 0, :]
    back = []
    for t in range(1, emissions.shape[1]):
        cand = score[:, :, None] + trans[None]          # (B, E_prev, E)
        back.append(torch.argmax(cand, dim=1))
        score = cand.amax(dim=1) + emissions[:, t, :]
    tag = torch.argmax(score, dim=-1)
    path = [tag]
    for bp in reversed(back):
        tag = torch.gather(bp, 1, tag[:, None])[:, 0]
        path.append(tag)
    return torch.stack(path[::-1], dim=1).to(torch.int32)
