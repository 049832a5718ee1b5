"""TCMF forecaster, temporal-regularized matrix factorization
(counterpart of ``zoo_tpu/chronos/forecaster/tcmf_forecaster.py``).

A panel Y (m series x t steps) factors into per-series embeddings F
(m x k) and temporal factors X (k x t), initialised by an SVD on the
host (numpy, as the JAX package does) and refined by alternating
closed-form ridge solves, ``torch.linalg.solve`` of k x k systems on
the device in f32. The temporal factors carry a temporal model that
forecasts them forward, and Y_future = F X_future:

* ``temporal_model="ar"``: an AR(lag) per factor by least squares
  (numpy ``lstsq`` on the host, as in JAX);
* ``temporal_model="tcn"``: a multivariate TCN (``TCNForecaster``) over
  windows of X, the k factors as channels, on the device; an AR(lag) is
  fitted too, as the fallback and the saved form.

``fit_incremental`` appends columns with F fixed. ``save``/``load``
write and read an npz (and the TCN's weight file beside it), the JAX
package's files.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class TCMFForecaster:
    def __init__(self, vbsize: int = 128, hbsize: int = 256,
                 num_channels_X=None, num_channels_Y=None,
                 kernel_size: int = 7, dropout: float = 0.1,
                 rank: int = 16, kernel_size_Y: int = 7, lr: float = 0.0005,
                 normalize: bool = False, use_time: bool = False,
                 svd: bool = True, ar_lag: int = 8, alt_iters: int = 10,
                 reg: float = 1e-2, temporal_model: str = "ar",
                 tcn_epochs: int = 40, device=None):
        if temporal_model not in ("ar", "tcn"):
            raise ValueError(
                f"temporal_model must be 'ar' or 'tcn', got "
                f"{temporal_model!r}")
        self.rank = int(rank)
        self.ar_lag = int(ar_lag)
        self.alt_iters = int(alt_iters)
        self.reg = float(reg)
        self.svd = svd
        self.normalize = normalize
        self.temporal_model = temporal_model
        self.num_channels_X = list(num_channels_X or [32, 32])
        self.kernel_size = int(kernel_size)
        self.dropout = float(dropout)
        self.lr = float(lr)
        self.tcn_epochs = int(tcn_epochs)
        self.device = device
        self.F: Optional[np.ndarray] = None   # (m, k)
        self.X: Optional[np.ndarray] = None   # (k, t)
        self.ar: Optional[np.ndarray] = None  # (k, lag + 1)
        self._tcn = None                      # TCNForecaster over X
        self._mean = self._std = None

    def _dev(self):
        from zoo_tpu_torch.common.device import resolve_device
        return resolve_device(self.device)

    def _solve_x(self, F: np.ndarray, Y, dev) -> np.ndarray:
        """argmin_X |Y - F X|^2 + reg |X|^2: (F'F + reg I)^-1 F'Y."""
        import torch
        f = torch.from_numpy(np.ascontiguousarray(F)).to(dev)
        eye = torch.eye(f.shape[1], device=dev) * self.reg
        return torch.linalg.solve(f.T @ f + eye, f.T @ Y).cpu().numpy()

    def fit(self, x, val_len: int = 0, **kwargs) -> Dict[str, float]:
        """``x``: ``{"y": (m, t) array}`` or the array."""
        import torch

        Y = np.asarray(x["y"] if isinstance(x, dict) else x, np.float32)
        if self.normalize:
            self._mean = Y.mean(axis=1, keepdims=True)
            self._std = Y.std(axis=1, keepdims=True) + 1e-8
            Y = (Y - self._mean) / self._std
        dev = self._dev()
        m, t = Y.shape
        k = min(self.rank, m, t)
        if self.svd:
            u, s, vt = np.linalg.svd(Y, full_matrices=False)
            F, X = u[:, :k] * s[:k], vt[:k]
        else:
            rs = np.random.RandomState(0)
            F = rs.randn(m, k).astype(np.float32) * 0.1
            X = rs.randn(k, t).astype(np.float32) * 0.1
        Yd = torch.from_numpy(Y).to(dev)
        eye = torch.eye(k, device=dev) * self.reg
        for _ in range(self.alt_iters):
            X = self._solve_x(F, Yd, dev)
            xd = torch.from_numpy(X).to(dev)
            F = torch.linalg.solve(xd @ xd.T + eye,
                                   xd @ Yd.T).T.cpu().numpy()
        self.F, self.X = F, X
        self._fit_temporal()
        recon = self.F @ self.X
        return {"mse": float(np.mean((recon - Y) ** 2))}

    def _fit_temporal(self):
        self._fit_ar()   # always: the fallback and the saved form
        if self.temporal_model == "tcn":
            self._fit_tcn()

    def _x_windows(self):
        k, t = self.X.shape
        lag = self.ar_lag
        Xs = self.X.T    # (t, k)
        wins = np.stack([Xs[j:j + lag] for j in range(t - lag)])
        tgts = Xs[lag:][:, None, :]    # (n, horizon 1, k)
        return wins.astype(np.float32), tgts.astype(np.float32)

    def _new_tcn(self):
        from zoo_tpu_torch.chronos.forecaster.tcn_forecaster import (
            TCNForecaster,
        )
        k = self.F.shape[1]
        return TCNForecaster(
            past_seq_len=self.ar_lag, future_seq_len=1, input_feature_num=k,
            output_feature_num=k, num_channels=self.num_channels_X,
            kernel_size=min(self.kernel_size, self.ar_lag),
            dropout=self.dropout, lr=self.lr, device=self.device)

    def _fit_tcn(self):
        """One TCN over the k factor series (the factors as channels)."""
        k, t = self.X.shape
        lag = self.ar_lag   # already clamped to t - 1 by _fit_ar
        if t - lag < 8:
            raise ValueError(
                f"temporal_model='tcn' needs at least ar_lag + 8 "
                f"timesteps to form training windows; got t={t} with "
                f"lag={lag} — use temporal_model='ar' for panels this "
                "short")
        wins, tgts = self._x_windows()
        self._tcn = self._new_tcn()
        self._tcn.fit((wins, tgts), epochs=self.tcn_epochs,
                      batch_size=min(128, len(wins)))

    def _fit_ar(self):
        k, t = self.X.shape
        lag = min(self.ar_lag, t - 1)
        self.ar_lag = lag
        coefs = np.zeros((k, lag + 1), np.float32)
        for i in range(k):
            series = self.X[i]
            rows = np.stack([series[j:j + lag] for j in range(t - lag)])
            A = np.concatenate([rows, np.ones((len(rows), 1))], axis=1)
            sol, *_ = np.linalg.lstsq(A, series[lag:], rcond=None)
            coefs[i] = sol
        self.ar = coefs

    def fit_incremental(self, x_incr, **kwargs):
        """Append new columns and refresh X and the temporal model with
        F fixed."""
        import torch

        Ynew = np.asarray(x_incr["y"] if isinstance(x_incr, dict)
                          else x_incr, np.float32)
        if self.normalize:
            Ynew = (Ynew - self._mean) / self._std
        dev = self._dev()
        Xnew = self._solve_x(self.F, torch.from_numpy(
            np.ascontiguousarray(Ynew)).to(dev), dev)
        self.X = np.concatenate([self.X, Xnew], axis=1)
        self._fit_temporal()
        return self

    def _roll_factors(self, horizon: int) -> np.ndarray:
        """The factor matrix forecast forward: (k, horizon)."""
        lag = self.ar_lag
        if self._tcn is not None:
            hist = self.X[:, -lag:].T.astype(np.float32)  # (lag, k)
            steps = []
            for _ in range(horizon):
                nxt = self._tcn.predict((hist[None], None))[0, 0]  # (k,)
                steps.append(nxt)
                hist = np.concatenate([hist[1:], nxt[None]], axis=0)
            return np.stack(steps, axis=1)
        hist = self.X[:, -lag:].copy()
        steps = []
        for _ in range(horizon):
            nxt = (hist * self.ar[:, :lag]).sum(axis=1) + self.ar[:, lag]
            steps.append(nxt)
            hist = np.concatenate([hist[:, 1:], nxt[:, None]], axis=1)
        return np.stack(steps, axis=1)

    def predict(self, horizon: int = 24, **kwargs) -> np.ndarray:
        if self.F is None:
            raise RuntimeError("call fit() first")
        Yf = self.F @ self._roll_factors(horizon)
        if self.normalize:
            Yf = Yf * self._std + self._mean
        return Yf

    def evaluate(self, target_value, metrics=("mse",), **kwargs
                 ) -> Dict[str, float]:
        from zoo_tpu_torch.chronos.forecaster.base import compute_metrics

        Yt = np.asarray(target_value["y"] if isinstance(target_value, dict)
                        else target_value, np.float32)
        return compute_metrics(Yt, self.predict(Yt.shape[1]), metrics)

    @staticmethod
    def _tcn_path(path: str) -> str:
        return (path[:-4] if path.endswith(".npz") else path) + ".tcn.pkl"

    def save(self, path: str):
        extras = {}
        if self.normalize:
            extras = {"mean": self._mean, "std": self._std}
        np.savez(path, F=self.F, X=self.X, ar=self.ar,
                 lag=np.asarray(self.ar_lag),
                 normalize=np.asarray(self.normalize),
                 reg=np.asarray(self.reg),
                 alt_iters=np.asarray(self.alt_iters),
                 svd=np.asarray(self.svd),
                 temporal_model=np.asarray(self.temporal_model),
                 num_channels_X=np.asarray(self.num_channels_X),
                 kernel_size=np.asarray(self.kernel_size),
                 dropout=np.asarray(self.dropout),
                 lr=np.asarray(self.lr),
                 tcn_epochs=np.asarray(self.tcn_epochs), **extras)
        if self._tcn is not None:
            self._tcn.save(self._tcn_path(path))

    @classmethod
    def load(cls, path: str, device=None) -> "TCMFForecaster":
        """A forecaster saved by either package; its TCN's weights on
        the current CUDA device unless ``device`` names another."""
        blob = np.load(path if path.endswith(".npz") else path + ".npz")
        tm = str(blob["temporal_model"]) if "temporal_model" in blob \
            else "ar"

        def opt(key, conv, default):
            return conv(blob[key]) if key in blob else default

        out = cls(rank=blob["F"].shape[1], ar_lag=int(blob["lag"]),
                  normalize=bool(blob["normalize"]),
                  reg=float(blob["reg"]), alt_iters=int(blob["alt_iters"]),
                  svd=bool(blob["svd"]), temporal_model=tm,
                  num_channels_X=opt("num_channels_X", list, None),
                  kernel_size=opt("kernel_size", int, 7),
                  dropout=opt("dropout", float, 0.1),
                  lr=opt("lr", float, 5e-4),
                  tcn_epochs=opt("tcn_epochs", int, 40), device=device)
        out.F, out.X, out.ar = blob["F"], blob["X"], blob["ar"]
        if out.normalize:
            out._mean, out._std = blob["mean"], blob["std"]
        if tm == "tcn":
            out._tcn = out._new_tcn()
            out._tcn.load(cls._tcn_path(path))
        return out
