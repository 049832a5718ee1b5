"""Automated ARIMA search (counterpart of
``zoo_tpu/chronos/autots/model/auto_arima.py``): each trial fits the
CSS :class:`~zoo_tpu_torch.chronos.forecaster.ARIMAForecaster` of its
orders on the host; the local engine runs them (threads with
``n_parallel``)."""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

logger = logging.getLogger("zoo_tpu_torch.chronos")


def arima_trial(config: dict, train: np.ndarray, val: np.ndarray,
                metric: str) -> dict:
    """One ARIMA trial: fit the orders of ``config`` on ``train``, score
    the ``val`` tail. :class:`AutoARIMA` and AutoTS's statistical family
    share it."""
    from zoo_tpu_torch.chronos.forecaster.arima_forecaster import (
        ARIMAForecaster,
    )

    f = ARIMAForecaster(p=int(config.get("p", 2)),
                        d=int(config.get("d", 0)),
                        q=int(config.get("q", 2)))
    f.fit(train)
    res = f.evaluate(val, metrics=[metric])
    return {metric: res[metric], "model": f}


def tail_split(y: np.ndarray, validation_data=None, frac: float = 0.8):
    """(train, val): the explicit validation series, else the last 20 %
    of ``y``."""
    if validation_data is not None:
        return y, np.asarray(validation_data, np.float64).reshape(-1)
    cut = max(1, int(len(y) * frac))
    return y[:cut], y[cut:]


class AutoARIMA:
    """A search over the orders (p, q[, d]); ``seasonal``/``P``/``Q``/
    ``m`` are accepted for the signature and ignored with a warning (the
    ARIMA is non-seasonal)."""

    def __init__(self, p=2, q=2, seasonal=True, P=1, Q=1, m=7, d=0,
                 metric: str = "mse", logs_dir: Optional[str] = None,
                 cpus_per_trial: int = 1, name: str = "auto_arima",
                 **arima_config):
        if seasonal:
            logger.warning(
                "AutoARIMA(seasonal=True): seasonal components (P/Q/m) "
                "are not carried by this ARIMA; searching the "
                "non-seasonal orders only")
        self.search_space = {"p": p, "q": q, "d": d}
        self.search_space.update(arima_config)
        self.metric = metric
        self._best_model = None
        self._best_config = None

    def fit(self, data, epochs: int = 1, validation_data=None,
            metric_threshold: Optional[float] = None, n_sampling: int = 1,
            search_alg=None, search_alg_params=None, scheduler=None,
            scheduler_params=None, n_parallel: int = 1):
        """``data``: a 1-D array; without ``validation_data`` its last
        20 % is held out."""
        from zoo_tpu_torch.automl.search import (
            LocalSearchEngine,
            TrialStopper,
        )

        y = np.asarray(data, np.float64).reshape(-1)
        train, val = tail_split(y, validation_data)

        def trial_fn(config):
            return arima_trial(config, train, val, self.metric)

        stopper = TrialStopper(metric_threshold=metric_threshold,
                               mode="min") \
            if metric_threshold is not None else None
        eng = LocalSearchEngine(n_parallel=n_parallel, stopper=stopper,
                                search_alg=search_alg, scheduler=scheduler)
        eng.compile(trial_fn, dict(self.search_space),
                    n_sampling=n_sampling, metric=self.metric, mode="min")
        eng.run()
        best = eng.get_best_trial()
        self._best_config = dict(best.config)
        self._best_model = best.artifacts["model"]
        return self

    def get_best_model(self):
        if self._best_model is None:
            raise RuntimeError("fit() first")
        return self._best_model

    def get_best_config(self):
        if self._best_config is None:
            raise RuntimeError("fit() first")
        return dict(self._best_config)
