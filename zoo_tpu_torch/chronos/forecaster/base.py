"""Forecaster base: ``fit``/``predict``/``evaluate`` over rolled arrays
or a TSDataset (counterpart of ``zoo_tpu/chronos/forecaster/base.py``).

Each forecaster builds one of the port's Keras models and trains it
with the model's ``fit`` on one device: the current CUDA device unless
the constructor's ``device`` names another (``device="cpu"`` runs every
plain version; with no card and no ``device`` the first ``fit`` or
``predict`` raises). The device is resolved once, when the model is
built. ``fit`` attaches the training guard configured from the
environment (``ZOO_GUARD*``; no checkpoint manager, so a diverging fit
raises instead of rolling back), as the JAX package's does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from zoo_tpu_torch.chronos.data.tsdataset import TSDataset


def _smape(y_true, y_pred):
    denom = (np.abs(y_true) + np.abs(y_pred)) / 2.0
    return float(np.mean(np.where(denom == 0, 0.0,
                                  np.abs(y_pred - y_true) /
                                  np.maximum(denom, 1e-12))) * 100)


def _mse(t, p):
    return float(np.mean((p - t) ** 2))


def _rmse(t, p):
    return float(np.sqrt(np.mean((p - t) ** 2)))


def _mae(t, p):
    return float(np.mean(np.abs(p - t)))


def _r2(t, p):
    return float(1 - ((t - p) ** 2).sum() /
                 max(((t - t.mean()) ** 2).sum(), 1e-12))


_EVAL_FNS = {"mse": _mse, "rmse": _rmse, "mae": _mae, "smape": _smape,
             "r2": _r2}


def compute_metrics(y_true, y_pred, metrics) -> Dict[str, float]:
    """The metrics named in ``metrics`` (mse, rmse, mae, smape, r2) of
    ``y_pred`` against ``y_true``, computed on the host."""
    out = {}
    for m in metrics:
        key = m.lower()
        if key not in _EVAL_FNS:
            raise ValueError(f"unknown metric: {m}")
        out[key] = _EVAL_FNS[key](np.asarray(y_true), np.asarray(y_pred))
    return out


class Forecaster:
    """Subclasses set ``self.model`` (a compiled Keras model) in
    ``_build``."""

    def __init__(self, past_seq_len: int, input_feature_num: int,
                 output_feature_num: int, future_seq_len: int = 1,
                 device=None):
        self.past_seq_len = int(past_seq_len)
        self.input_feature_num = int(input_feature_num)
        self.output_feature_num = int(output_feature_num)
        self.future_seq_len = int(future_seq_len)
        self.device = device
        self._dev = None
        self.model = None
        self.fitted = False
        self._ctor_args = {"past_seq_len": past_seq_len,
                           "input_feature_num": input_feature_num,
                           "output_feature_num": output_feature_num}

    # -- to override ------------------------------------------------------
    def _build(self):
        raise NotImplementedError

    # -- the device -------------------------------------------------------
    def _device(self):
        """The model's device, resolved on first use (raises without a
        card when none was named)."""
        if self._dev is None:
            from zoo_tpu_torch.common.device import resolve_device
            self._dev = resolve_device(self.device)
        return self._dev

    def _ensure_model(self):
        if self.model is None:
            self._device()
            self._build()
        return self.model

    # -- data plumbing ----------------------------------------------------
    def _unpack(self, data) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if isinstance(data, TSDataset):
            if data.numpy_x is None:
                data.roll(self.past_seq_len, self.future_seq_len)
            return data.to_numpy()
        if isinstance(data, tuple):
            return data[0], (data[1] if len(data) > 1 else None)
        return data, None

    @staticmethod
    def from_tsdataset(tsdataset: TSDataset, past_seq_len: int = 24,
                       future_seq_len: int = 1, **kwargs):
        raise NotImplementedError

    def _attach_guard(self):
        from zoo_tpu_torch.orca.learn.guard import TrainingGuard
        if getattr(self.model, "_guard", None) is None:
            g = TrainingGuard.from_env(name=type(self).__name__)
            if g is not None:
                self.model.set_guard(g)
        return getattr(self.model, "_guard", None)

    # -- API --------------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None, seed: int = 0) -> Dict:
        x, y = self._unpack(data)
        if y is None:
            raise ValueError("fit requires rolled targets")
        self._ensure_model()
        guard = self._attach_guard()
        y = y.reshape(y.shape[0], -1)  # (horizon, feat) flat for the head
        val = None
        if validation_data is not None:
            vx, vy = self._unpack(validation_data)
            val = (vx, vy.reshape(vy.shape[0], -1))
        if guard is not None:
            guard.install_signal_handler()
        try:
            hist = self.model.fit(x, y, batch_size=min(batch_size, len(x)),
                                  nb_epoch=epochs, validation_data=val,
                                  verbose=0, seed=seed,
                                  device=self._device())
        finally:
            if guard is not None:
                guard.uninstall_signal_handler()
        self.fitted = True
        return hist

    def predict(self, data, batch_size: int = 256) -> np.ndarray:
        x, _ = self._unpack(data)
        self._ensure_model()
        flat = self.model.predict(x, batch_size=batch_size,
                                  device=self._device())
        return flat.reshape(x.shape[0], self.future_seq_len,
                            self.output_feature_num)

    def evaluate(self, data, metrics=("mse",), batch_size: int = 256
                 ) -> Dict[str, float]:
        x, y = self._unpack(data)
        preds = self.predict((x, None), batch_size=batch_size)
        y = y.reshape(preds.shape)
        return compute_metrics(y, preds, metrics)

    def save(self, checkpoint_file: str):
        """The model's weights in the JAX package's weight file (either
        package reads the other's)."""
        self.model.save_weights(checkpoint_file)

    def load(self, checkpoint_file: str):
        self._ensure_model()
        self.model.load_weights(checkpoint_file, device=self._device())
        self.fitted = True
        return self
