"""Loss functions with keras-1 names (counterpart of
``zoo_tpu/pipeline/api/keras/objectives.py``): ``f(y_true, y_pred) ->
scalar`` reducing with a mean, as keras-1 does. This slice ports the
losses its training path and tests need; other names raise.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from zoo_tpu_torch.pipeline.api.keras.engine.base import model_file_part

_EPS = 1e-7


@model_file_part
def mean_squared_error(y_true, y_pred):
    return torch.mean((y_pred - y_true) ** 2)


@model_file_part
def mean_absolute_error(y_true, y_pred):
    return torch.mean(torch.abs(y_pred - y_true))


@model_file_part
def binary_crossentropy(y_true, y_pred):
    """``y_pred`` are probabilities (keras-1 contract), clipped to
    [eps, 1 - eps] as the JAX package clips them."""
    p = torch.clamp(y_pred, _EPS, 1.0 - _EPS)
    return -torch.mean(y_true * torch.log(p)
                       + (1.0 - y_true) * torch.log(1.0 - p))


@model_file_part
def binary_crossentropy_from_logits(y_true, logits):
    """torch ``nn.BCEWithLogitsLoss`` semantics, in the JAX package's
    stable form."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * y_true
                      + torch.log1p(torch.exp(-torch.abs(logits))))


@model_file_part
def categorical_crossentropy(y_true, y_pred):
    """One-hot (or soft) ``y_true`` against probabilities (keras-1
    contract), clipped to [eps, 1] as the JAX package clips them."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    return -torch.mean(torch.sum(y_true * torch.log(p), dim=-1))


@model_file_part
def sparse_categorical_crossentropy(y_true, y_pred):
    """``y_pred`` are probabilities (keras-1 contract)."""
    p = torch.clamp(y_pred, _EPS, 1.0)
    idx = y_true.long()
    if idx.ndim == p.ndim:  # (batch, 1) labels
        idx = idx.squeeze(-1)
    picked = torch.gather(torch.log(p), -1, idx[..., None])
    return -torch.mean(picked)


def _class_last(y_true, t):
    """Class axis last: it may be last (keras layout) or dim 1 (torch's
    (N, C, ...) layout for >2D inputs), told apart by the label shape,
    preferring the keras layout when ambiguous."""
    idx = y_true.long()
    if idx.ndim == t.ndim:  # (N, ..., 1)-shaped labels
        idx = idx.squeeze(-1)
    if t.ndim > 2 and tuple(idx.shape) != tuple(t.shape[:-1]) \
            and tuple(idx.shape) == (t.shape[0],) + tuple(t.shape[2:]):
        t = torch.movedim(t, 1, -1)
    return idx, t


@model_file_part
def sparse_categorical_crossentropy_from_logits(y_true, logits):
    """torch ``nn.CrossEntropyLoss`` semantics (logits in, int labels;
    channel-first layouts and ``ignore_index=-100`` respected).

    Logsumexp minus the picked logit: only the two reduced tensors are
    f32, the logits may stay bf16 (``_handles_low_precision``: the train
    step then skips its f32 upcast of the predictions); the reductions
    and the final arithmetic run in f32."""
    idx, logits = _class_last(y_true, logits)
    mask = idx != -100
    safe = torch.where(mask, idx, 0)
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, safe[..., None])[..., 0].float()
    total = torch.where(mask, lse - picked, 0.0).sum()
    return total / mask.sum().clamp(min=1)


sparse_categorical_crossentropy_from_logits._handles_low_precision = True


@model_file_part
def nll_loss(y_true, log_probs):
    """torch ``nn.NLLLoss`` semantics (log-probabilities in; labels equal
    to -100 masked out of the mean)."""
    idx, logp = _class_last(y_true, log_probs)
    mask = idx != -100
    safe = torch.where(mask, idx, 0)
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    total = torch.where(mask, -picked, 0.0).sum()
    return total / mask.sum().clamp(min=1)


_ALIASES = {
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "binary_crossentropy": binary_crossentropy,
    "binary_crossentropy_from_logits": binary_crossentropy_from_logits,
    "nll": nll_loss,
    "categorical_crossentropy": categorical_crossentropy,
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "sparse_categorical_crossentropy_from_logits":
        sparse_categorical_crossentropy_from_logits,
}


def get_loss(identifier: Union[str, Callable]) -> Callable:
    if callable(identifier):
        return identifier
    key = identifier.lower()
    if key not in _ALIASES:
        raise ValueError(f"unknown loss: {identifier} (this port has "
                         f"{', '.join(sorted(_ALIASES))})")
    return _ALIASES[key]
