"""AutoTS, a hyperparameter search over the Chronos forecasters, and
``TSPipeline``, the searched forecaster bundled with its dataset's
scaler (counterpart of ``zoo_tpu/chronos/autots/autotsestimator.py``).

The search runs on the local engine (``automl/search.py``): trials of
the LSTM, TCN and Seq2Seq forecasters train on one device, the current
CUDA device unless ``fit``'s ``device`` names another; ARIMA trials run
on the host. ``n_parallel`` threads share the card.

A pipeline's ``meta.pkl`` is the JAX package's file, and its
``forecaster.pkl`` the forecaster's weight file. The JAX package loads
``meta.pkl`` with ``pickle.load``, which runs whatever the file names;
the port reads it through the checkpoint unpickler of
``orca/learn/ckpt.py`` (numpy arrays, dicts, lists, strings and
numbers), which resolves besides only the scaler classes the caller
names in ``load(scaler_classes=...)``: a pipeline whose dataset was
scaled needs its scaler's class named to load.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, Optional, Sequence, Union

import numpy as np

from zoo_tpu_torch.automl.hp import Sampler
from zoo_tpu_torch.automl.search import make_search_engine
from zoo_tpu_torch.chronos.data.tsdataset import TSDataset, pandas_frame
from zoo_tpu_torch.orca.learn.ckpt import CheckpointRefused, _StateUnpickler

_MODELS = {"lstm", "tcn", "seq2seq", "arima", "prophet"}
_STATISTICAL = {"arima", "prophet"}


def _build_forecaster(model: str, past_seq_len: int, horizon: int,
                      n_features: int, n_targets: int, config: Dict,
                      device=None):
    from zoo_tpu_torch.chronos.forecaster import (
        LSTMForecaster,
        Seq2SeqForecaster,
        TCNForecaster,
    )

    if model == "lstm":
        return LSTMForecaster(
            past_seq_len=past_seq_len, input_feature_num=n_features,
            output_feature_num=n_targets, future_seq_len=horizon,
            hidden_dim=config.get("hidden_dim", 32),
            layer_num=config.get("layer_num", 1),
            dropout=config.get("dropout", 0.1),
            lr=config.get("lr", 1e-3), device=device)
    if model == "tcn":
        return TCNForecaster(
            past_seq_len=past_seq_len, future_seq_len=horizon,
            input_feature_num=n_features, output_feature_num=n_targets,
            num_channels=config.get("num_channels", [16, 16]),
            kernel_size=config.get("kernel_size", 3),
            dropout=config.get("dropout", 0.1),
            lr=config.get("lr", 1e-3), device=device)
    if model == "seq2seq":
        return Seq2SeqForecaster(
            past_seq_len=past_seq_len, future_seq_len=horizon,
            input_feature_num=n_features, output_feature_num=n_targets,
            lstm_hidden_dim=config.get("lstm_hidden_dim", 32),
            lstm_layer_num=config.get("lstm_layer_num", 1),
            dropout=config.get("dropout", 0.1),
            lr=config.get("lr", 1e-3), device=device)
    raise ValueError(f"unknown model {model!r}; choose from {_MODELS}")


class AutoTSEstimator:
    def __init__(self, model: str = "lstm",
                 search_space: Optional[Dict] = None,
                 past_seq_len: Union[int, Sampler] = 24,
                 future_seq_len: int = 1,
                 metric: str = "mse", logs_dir: Optional[str] = None,
                 cpus_per_trial: int = 1, name: str = "autots"):
        if model not in _MODELS:
            raise ValueError(f"model must be one of {_MODELS}")
        self.model = model
        self.search_space = dict(search_space or {})
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.metric = metric
        self._best = None

    def fit(self, data: TSDataset,
            validation_data: Optional[TSDataset] = None, epochs: int = 2,
            batch_size: int = 32, n_sampling: int = 1, seed: int = 0,
            search_alg=None, scheduler=None, n_parallel: int = 1,
            device=None) -> "TSPipeline":
        """Search and return the best :class:`TSPipeline`.
        ``search_alg="tpe"`` samples model-based (ask/tell, so its trials
        run one after another), ``scheduler="asha"`` stops trials that
        report per epoch at the rungs, ``n_parallel > 1`` runs trials of
        a random or grid search in threads on the one card. The
        forecasters train on the current CUDA device unless ``device``
        names another."""
        if not isinstance(data, TSDataset):
            raise ValueError("AutoTSEstimator.fit expects a TSDataset")
        n_features = data.get_feature_num()
        n_targets = data.get_target_num()
        horizon = self.future_seq_len
        if self.model not in _STATISTICAL:
            from zoo_tpu_torch.common.device import resolve_device
            device = resolve_device(device)
        space = dict(self.search_space)
        space["past_seq_len"] = self.past_seq_len

        def statistical_trial_fn(config: Dict, reporter=None) -> Dict:
            """ARIMA and Prophet trials fit the raw univariate series,
            held out on ``validation_data``'s series, else the last 20
            %."""
            from zoo_tpu_torch.chronos.autots.model.auto_arima import (
                arima_trial,
                tail_split,
            )

            config.pop("past_seq_len", None)
            if n_targets != 1 or data.id_col is not None:
                raise ValueError(
                    f"model={self.model!r} searches a univariate "
                    "series; got multiple targets/ids")
            y = data._col(data.target_col[0]).astype(np.float64)
            vy = validation_data._col(data.target_col[0]).astype(
                np.float64) if validation_data is not None else None
            train, val = tail_split(y, vy)
            if self.model == "arima":
                out = arima_trial(config, train, val, self.metric)
                f, res = out["model"], {self.metric: out[self.metric]}
            else:
                from zoo_tpu_torch.chronos.forecaster.arima_forecaster \
                    import ProphetForecaster
                f = ProphetForecaster(**config)
                f.fit(pandas_frame({
                    "ds": data._col(data.dt_col)[:len(train)], "y": train}))
                res = f.evaluate(val, metrics=[self.metric])
            return {self.metric: res[self.metric], "forecaster": f,
                    "lookback": 0}

        def trial_fn(config: Dict, reporter=None) -> Dict:
            lookback = int(config.pop("past_seq_len"))
            data.roll(lookback, horizon)
            val = validation_data
            if val is not None:
                val.roll(lookback, horizon)
            f = _build_forecaster(self.model, lookback, horizon,
                                  n_features, n_targets, config, device)
            eval_ds = val if val is not None else data
            if reporter is None:
                f.fit(data, epochs=epochs, batch_size=batch_size,
                      validation_data=val)
                res = f.evaluate(eval_ds, metrics=[self.metric])
            else:
                # per-epoch reports, which ASHA cuts at its rungs; a seed
                # an epoch, or every one-epoch fit would repeat one
                # permutation
                res = {self.metric: float("inf")}
                for e in range(epochs):
                    f.fit(data, epochs=1, batch_size=batch_size,
                          validation_data=val, seed=seed + e)
                    res = f.evaluate(eval_ds, metrics=[self.metric])
                    if reporter(e + 1, float(res[self.metric])):
                        break
            return {self.metric: res[self.metric], "forecaster": f,
                    "lookback": lookback}

        engine = make_search_engine(search_alg=search_alg,
                                    scheduler=scheduler,
                                    n_parallel=n_parallel)
        engine.compile(statistical_trial_fn
                       if self.model in _STATISTICAL else trial_fn,
                       space, n_sampling=n_sampling,
                       metric=self.metric, mode="min", seed=seed)
        engine.run()
        best = engine.get_best_trial()
        self._best = best
        winner = best.artifacts["forecaster"]
        if self.model in _STATISTICAL:
            # the trials fit the holdout split; the shipped model is fit
            # on the whole series, so predict forecasts past its end
            y_full = data._col(data.target_col[0]).astype(np.float64)
            if self.model == "arima":
                winner.fit(y_full)
            else:
                winner.fit(pandas_frame({"ds": data._col(data.dt_col),
                                         "y": y_full}))
        return TSPipeline(winner, lookback=best.artifacts["lookback"],
                          horizon=horizon, best_config=dict(best.config),
                          scaler=data.scaler)

    def get_best_config(self) -> Dict:
        if self._best is None:
            raise RuntimeError("fit() first")
        return dict(self._best.config)


class _PipelineUnpickler(_StateUnpickler):
    """The checkpoint unpickler, resolving besides the classes named."""

    def __init__(self, f, classes: Sequence[type]):
        super().__init__(f)
        self._classes = {(c.__module__, c.__qualname__): c for c in classes}

    def find_class(self, module, name):
        cls = self._classes.get((module, name))
        return cls if cls is not None else super().find_class(module, name)


class TSPipeline:
    """The best forecaster with its lookback, horizon, configuration and
    the dataset's scaler: ``fit``/``predict``/``evaluate``/``save``/
    ``load``."""

    def __init__(self, forecaster, lookback: int, horizon: int,
                 best_config: Dict, scaler=None):
        self.forecaster = forecaster
        self.lookback = lookback
        self.horizon = horizon
        self.best_config = best_config
        self.scaler = scaler

    def _rolled(self, data: TSDataset):
        if isinstance(data, TSDataset):
            data.roll(self.lookback, self.horizon)
        return data

    def _statistical(self) -> bool:
        """ARIMA and Prophet work on raw series, not rolled windows."""
        from zoo_tpu_torch.chronos.forecaster.arima_forecaster import (
            ARIMAForecaster,
            ProphetForecaster,
        )
        return isinstance(self.forecaster,
                          (ARIMAForecaster, ProphetForecaster))

    @staticmethod
    def _series(data: TSDataset) -> np.ndarray:
        return data._col(data.target_col[0]).astype(np.float64)

    def fit(self, data: TSDataset, epochs: int = 1, batch_size: int = 32):
        if self._statistical():
            self.forecaster.fit(self._series(data))
            return self
        self.forecaster.fit(self._rolled(data), epochs=epochs,
                            batch_size=batch_size)
        return self

    def predict(self, data: TSDataset) -> np.ndarray:
        if self._statistical():
            # ``horizon`` steps past the fitted series (the fit is the
            # state; ``data`` only names the target)
            out = self.forecaster.predict(self.horizon)
            if hasattr(out, "columns"):   # prophet's forecast frame
                out = out["yhat"]
            return np.asarray(out, np.float64).reshape(-1)
        return self.forecaster.predict(self._rolled(data))

    def evaluate(self, data: TSDataset, metrics=("mse",)) -> Dict:
        if self._statistical():
            return self.forecaster.evaluate(self._series(data),
                                            metrics=metrics)
        return self.forecaster.evaluate(self._rolled(data), metrics=metrics)

    def save(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.forecaster.save(os.path.join(path, "forecaster.pkl"))
        with open(os.path.join(path, "meta.pkl"), "wb") as f:
            pickle.dump({"lookback": self.lookback, "horizon": self.horizon,
                         "best_config": self.best_config,
                         "scaler": self.scaler,
                         "forecaster_cls": type(self.forecaster).__name__,
                         "forecaster_args": dict(
                             getattr(self.forecaster, "_ctor_args",
                                     {}))}, f)

    @staticmethod
    def load(path: str, device=None,
             scaler_classes: Sequence[type] = ()) -> "TSPipeline":
        """A pipeline saved by either package. ``meta.pkl`` is read by
        the checkpoint unpickler plus ``scaler_classes`` (the class of
        the saved scaler, if the dataset was scaled): any other class or
        function it names raises ``CheckpointRefused``. A neural
        forecaster's weights load onto the current CUDA device unless
        ``device`` names another."""
        from zoo_tpu_torch.chronos import forecaster as fmod

        with open(os.path.join(path, "meta.pkl"), "rb") as f:
            try:
                meta = _PipelineUnpickler(f, scaler_classes).load()
            except CheckpointRefused as e:
                raise CheckpointRefused(
                    f"{path}: {e}; a pipeline's scaler loads only when "
                    "its class is named in scaler_classes") from e
        cls = getattr(fmod, meta["forecaster_cls"])
        kwargs = dict(meta["forecaster_args"])
        if cls not in (fmod.ARIMAForecaster, fmod.ProphetForecaster):
            kwargs["device"] = device
        fc = cls(**kwargs)
        fc.load(os.path.join(path, "forecaster.pkl"))
        return TSPipeline(fc, meta["lookback"], meta["horizon"],
                          meta["best_config"], meta["scaler"])
