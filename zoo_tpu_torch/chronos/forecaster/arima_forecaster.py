"""ARIMA forecaster by conditional sum of squares, and the gated Prophet
wrapper (counterpart of ``zoo_tpu/chronos/forecaster/
arima_forecaster.py``, the port's own copy).

ARIMA runs on the host: the ARMA recursion on the d-differenced series,
its CSS minimised by scipy's L-BFGS-B, then the recursion forward and
the differences integrated back. Univariate. ``ProphetForecaster``
needs the ``prophet`` package, which is imported only when one is
constructed.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ARIMAForecaster:
    """Order (p, d, q); ``fit``/``predict``/``evaluate`` on 1-D
    arrays."""

    def __init__(self, p: int = 2, d: int = 0, q: int = 2,
                 seasonality_mode: bool = False):
        if seasonality_mode:
            raise NotImplementedError("seasonal ARIMA not supported")
        self.p, self.d, self.q = int(p), int(d), int(q)
        self.params: Optional[np.ndarray] = None
        self._train: Optional[np.ndarray] = None
        self._resid: Optional[np.ndarray] = None

    def _css_resid(self, theta: np.ndarray, z: np.ndarray) -> np.ndarray:
        p, q = self.p, self.q
        c = theta[0]
        phi = theta[1:1 + p]
        psi = theta[1 + p:1 + p + q]
        n = len(z)
        resid = np.zeros(n)
        for t in range(n):
            ar = sum(phi[i] * z[t - 1 - i] for i in range(p) if t - 1 - i >= 0)
            ma = sum(psi[j] * resid[t - 1 - j] for j in range(q)
                     if t - 1 - j >= 0)
            resid[t] = z[t] - c - ar - ma
        return resid

    def fit(self, data, validation_data=None, **kwargs) -> Dict[str, float]:
        from scipy.optimize import minimize

        y = np.asarray(data, np.float64).reshape(-1)
        self._train = y.copy()
        z = np.diff(y, n=self.d) if self.d else y

        def objective(theta):
            r = self._css_resid(theta, z)
            return float(np.sum(r[self.p:] ** 2))

        x0 = np.zeros(1 + self.p + self.q)
        x0[0] = z.mean()
        self.params = minimize(objective, x0, method="L-BFGS-B").x
        self._resid = self._css_resid(self.params, z)
        out = {"mse": float(np.mean(self._resid[self.p:] ** 2))}
        if validation_data is not None:
            va = np.asarray(validation_data, np.float64).reshape(-1)
            out["val_mse"] = float(np.mean((self.predict(len(va)) - va)
                                           ** 2))
        return out

    def predict(self, horizon: int = 1, **kwargs) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("call fit() first")
        y = self._train
        z = np.diff(y, n=self.d) if self.d else y.copy()
        resid = self._resid if self._resid is not None \
            else self._css_resid(self.params, z)
        c = self.params[0]
        phi = self.params[1:1 + self.p]
        psi = self.params[1 + self.p:]
        zs, rs, preds = list(z), list(resid), []
        for _ in range(horizon):
            t = len(zs)
            ar = sum(phi[i] * zs[t - 1 - i] for i in range(self.p)
                     if t - 1 - i >= 0)
            ma = sum(psi[j] * rs[t - 1 - j] for j in range(self.q)
                     if t - 1 - j >= 0 and t - 1 - j < len(resid))
            nxt = c + ar + ma
            preds.append(nxt)
            zs.append(nxt)
            rs.append(0.0)
        preds = np.asarray(preds)
        # integrate the d differences back, one level a pass, each
        # anchored on the last value of its level
        levels = [y]
        for _ in range(self.d):
            levels.append(np.diff(levels[-1]))
        for k in range(self.d, 0, -1):
            preds = np.cumsum(preds) + levels[k - 1][-1]
        return preds

    def evaluate(self, target, metrics=("mse",), **kwargs
                 ) -> Dict[str, float]:
        from zoo_tpu_torch.chronos.forecaster.base import compute_metrics

        target = np.asarray(target, np.float64).reshape(-1)
        return compute_metrics(target, self.predict(len(target)), metrics)

    def save(self, checkpoint_file: str):
        np.savez(checkpoint_file, params=self.params, train=self._train,
                 order=np.asarray([self.p, self.d, self.q]))

    def load(self, checkpoint_file: str):
        """An npz of either package (``np.load`` without pickles)."""
        blob = np.load(checkpoint_file if checkpoint_file.endswith(".npz")
                       else checkpoint_file + ".npz")
        self.p, self.d, self.q = (int(v) for v in blob["order"])
        self.params = blob["params"]
        self._train = blob["train"]
        self._resid = None   # a stale cache from an earlier fit
        return self


class ProphetForecaster:
    """A wrapper of ``prophet.Prophet``; constructing one raises without
    the ``prophet`` package. ``save``/``load`` use prophet's own JSON
    serialisation (``prophet.serialize``), not a pickle."""

    def __init__(self, changepoint_prior_scale: float = 0.05,
                 seasonality_prior_scale: float = 10.0,
                 holidays_prior_scale: float = 10.0,
                 seasonality_mode: str = "additive",
                 changepoint_range: float = 0.8):
        try:
            from prophet import Prophet
        except ImportError as e:
            raise ImportError(
                "ProphetForecaster needs the 'prophet' package, which is "
                "not installed in this environment") from e
        self.model = Prophet(
            changepoint_prior_scale=changepoint_prior_scale,
            seasonality_prior_scale=seasonality_prior_scale,
            holidays_prior_scale=holidays_prior_scale,
            seasonality_mode=seasonality_mode,
            changepoint_range=changepoint_range)

    def fit(self, data, **kwargs):
        self._fit_rows = len(data)
        return self.model.fit(data)

    def predict(self, horizon: int = 1, freq: str = "D", **kwargs):
        """The forecast frame of the ``horizon`` future periods only."""
        future = self.model.make_future_dataframe(periods=horizon, freq=freq)
        return self.model.predict(future).tail(horizon)

    def evaluate(self, target, metrics=("mse",), **kwargs):
        from zoo_tpu_torch.chronos.forecaster.base import compute_metrics
        target = np.asarray(target, np.float64).reshape(-1)
        yhat = np.asarray(self.predict(len(target))["yhat"], np.float64)
        return compute_metrics(target, yhat, metrics)

    def save(self, checkpoint_file: str):
        from prophet.serialize import model_to_json
        with open(checkpoint_file, "w") as f:
            f.write(model_to_json(self.model))

    def load(self, checkpoint_file: str):
        from prophet.serialize import model_from_json
        with open(checkpoint_file) as f:
            self.model = model_from_json(f.read())
        return self
