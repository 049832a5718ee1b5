"""Automated Prophet search (counterpart of
``zoo_tpu/chronos/autots/model/auto_prophet.py``): importing works
everywhere; constructing one raises without the ``prophet`` package."""

from __future__ import annotations

from typing import Optional

import numpy as np


class AutoProphet:
    """A search over changepoint_prior_scale, seasonality_prior_scale,
    holidays_prior_scale, seasonality_mode and changepoint_range."""

    def __init__(self, changepoint_prior_scale=0.05,
                 seasonality_prior_scale=10.0, holidays_prior_scale=10.0,
                 seasonality_mode="additive", changepoint_range=0.8,
                 metric: str = "mse", logs_dir: Optional[str] = None,
                 cpus_per_trial: int = 1, name: str = "auto_prophet",
                 **prophet_config):
        try:
            import prophet  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "AutoProphet needs the 'prophet' package, which is not "
                "installed (the AutoARIMA statistical search works "
                "without it)") from e
        self.search_space = {
            "changepoint_prior_scale": changepoint_prior_scale,
            "seasonality_prior_scale": seasonality_prior_scale,
            "holidays_prior_scale": holidays_prior_scale,
            "seasonality_mode": seasonality_mode,
            "changepoint_range": changepoint_range,
        }
        self.search_space.update(prophet_config)
        self.metric = metric
        self._best_model = None
        self._best_config = None

    def fit(self, data, epochs: int = 1, validation_data=None,
            metric_threshold: Optional[float] = None, n_sampling: int = 1,
            search_alg=None, search_alg_params=None, scheduler=None,
            scheduler_params=None, n_parallel: int = 1):
        """``data``: a pandas frame with ``ds``/``y`` columns (prophet's
        contract)."""
        from zoo_tpu_torch.automl.search import LocalSearchEngine
        from zoo_tpu_torch.chronos.forecaster.arima_forecaster import (
            ProphetForecaster,
        )
        from zoo_tpu_torch.chronos.forecaster.base import compute_metrics

        if validation_data is None:
            cut = max(1, int(len(data) * 0.8))
            train, val = data.iloc[:cut], data.iloc[cut:]
        else:
            train, val = data, validation_data

        def trial_fn(config):
            f = ProphetForecaster(**config)
            f.fit(train)
            yhat = np.asarray(f.predict(len(val))["yhat"], np.float64)
            res = compute_metrics(np.asarray(val["y"], np.float64), yhat,
                                  [self.metric])
            return {self.metric: res[self.metric], "model": f}

        eng = LocalSearchEngine(n_parallel=n_parallel,
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
