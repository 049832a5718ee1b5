"""AutoEstimator: hyperparameter search over model creators (counterpart
of ``zoo_tpu/orca/automl/auto_estimator.py``).

A creator receives a sampled ``config`` and returns a model ready to
train: a compiled Keras-facade model (``from_keras``) or a torch
``nn.Module`` that :class:`~zoo_tpu_torch.orca.learn.pytorch.Estimator`
wraps (``from_torch``). Each trial trains on ``device`` (default: the
runtime context's, else the current CUDA device) and reports the
validation metric; the best trial's model is kept. The search is the
port's :mod:`zoo_tpu_torch.automl.search`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from zoo_tpu_torch.automl.search import make_search_engine

_MINIMIZE = {"mse", "rmse", "mae", "smape", "loss", "binary_crossentropy"}


class AutoEstimator:
    def __init__(self, model_builder: Callable[[Dict], Any],
                 kind: str = "keras", device=None):
        self.model_builder = model_builder
        self.kind = kind
        self.device = device
        self._best_model = None
        self._best_config: Optional[Dict] = None
        self._best_metric: Optional[float] = None

    # -- factories (reference API) ----------------------------------------
    @staticmethod
    def from_keras(*, model_creator: Callable[[Dict], Any], device=None,
                   **kwargs) -> "AutoEstimator":
        """``model_creator(config)`` returns a compiled Keras-facade
        model."""
        return AutoEstimator(model_creator, kind="keras", device=device)

    @staticmethod
    def from_torch(*, model_creator: Callable[[Dict], Any],
                   optimizer=None, loss=None, device=None,
                   **kwargs) -> "AutoEstimator":
        """``model_creator(config)`` returns a torch ``nn.Module``;
        ``optimizer`` and ``loss`` as in the PyTorch Estimator. Creator
        functions go to ``Estimator.from_torch`` as creators, so the
        optimizer creator receives the real model."""
        def build(config: Dict):
            from zoo_tpu_torch.orca.learn.pytorch import Estimator
            from zoo_tpu_torch.orca.learn.pytorch.estimator import (
                _is_torch_loss,
            )

            kw: Dict[str, Any] = {}
            if callable(optimizer) and not isinstance(optimizer, str):
                kw["optimizer_creator"] = optimizer
            else:
                kw["optimizer"] = optimizer
            if callable(loss) and not _is_torch_loss(loss):
                kw["loss_creator"] = loss
            else:
                kw["loss"] = loss
            return Estimator.from_torch(model_creator=model_creator,
                                        config=config, device=device, **kw)

        return AutoEstimator(build, kind="torch", device=device)

    # -- search ------------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            validation_data=None, metric: str = "mse",
            metric_mode: Optional[str] = None,
            search_space: Optional[Dict] = None, n_sampling: int = 1,
            seed: int = 0, search_alg=None,
            scheduler=None, n_parallel: int = 1) -> "AutoEstimator":
        """Run the search: ``search_space``, ``n_sampling`` and
        ``metric`` as the reference takes them; ``search_alg="tpe"``
        samples model-based, ``scheduler="asha"`` stops trials early
        from per-epoch reports; ``n_parallel`` trials run at once,
        sharing the one card (TPE stays sequential)."""
        if search_space is None:
            raise ValueError("search_space is required")
        mode = metric_mode or ("min" if metric.lower() in _MINIMIZE
                               else "max")
        eval_data = validation_data if validation_data is not None else data
        dev = self.device

        def _xy(d):
            return d if isinstance(d, tuple) else (d, None)

        def _reported(e, res, reporter):
            val = res.get(metric, res.get("loss"))
            if val is None:
                raise ValueError(
                    f"metric {metric!r} not produced by evaluate(); "
                    f"available: {sorted(res)}")
            return reporter(e + 1, float(val))

        def trial_fn(config: Dict, reporter=None) -> Dict:
            bs = int(config.pop("batch_size", batch_size))
            model = self.model_builder(config)
            if hasattr(model, "torch_model"):  # PyTorchEstimator
                if reporter is None:
                    model.fit(data, epochs=epochs, batch_size=bs)
                    res = model.evaluate(eval_data, batch_size=bs)
                else:  # per-epoch reporting for the ASHA scheduler
                    res = {}
                    for e in range(epochs):
                        model.fit(data, epochs=1, batch_size=bs)
                        res = model.evaluate(eval_data, batch_size=bs)
                        if _reported(e, res, reporter):
                            break
            else:  # a compiled Keras-facade model
                x, y = _xy(data)
                ex, ey = _xy(eval_data)
                if reporter is None:
                    model.fit(x, y, batch_size=bs, nb_epoch=epochs,
                              verbose=0, device=dev)
                    res = model.evaluate(ex, ey, batch_size=bs, device=dev)
                else:
                    res = {}
                    for e in range(epochs):
                        # the seed varies per epoch: each nb_epoch=1 call
                        # re-creates the shuffle and dropout keys, and a
                        # constant seed would repeat them every epoch
                        model.fit(x, y, batch_size=bs, nb_epoch=1,
                                  verbose=0, seed=seed + e, device=dev)
                        res = model.evaluate(ex, ey, batch_size=bs,
                                             device=dev)
                        if _reported(e, res, reporter):
                            break
            if metric not in res:
                # res["loss"] stands in for the metric only when the
                # compiled loss is that metric (for the torch path the
                # name lives on the inner KerasNet or the torch loss)
                loss_name = (getattr(model, "loss_name", None)
                             or getattr(getattr(model, "model", None),
                                        "loss_name", None)
                             or type(getattr(model, "loss", None)
                                     ).__name__ or "").lower()
                torch_aliases = {"mseloss": "mse", "l1loss": "mae"}
                loss_name = torch_aliases.get(loss_name, loss_name)
                aliases = {"mse": {"mse", "mean_squared_error"},
                           "mae": {"mae", "mean_absolute_error"}}
                wanted = aliases.get(metric.lower(), {metric.lower()})
                if metric == "loss" or (set(res) == {"loss"}
                                        and loss_name in wanted):
                    value = res["loss"]
                else:
                    raise ValueError(
                        f"metric {metric!r} not produced by evaluate(); "
                        f"available: {sorted(res)}; compile the model "
                        f"with metrics=[{metric!r}]")
            else:
                value = res[metric]
            return {metric: float(value), "model": model}

        engine = make_search_engine(search_alg=search_alg,
                                    scheduler=scheduler,
                                    n_parallel=n_parallel)
        engine.compile(trial_fn, search_space, n_sampling=n_sampling,
                       metric=metric, mode=mode, seed=seed)
        engine.run()
        best = engine.get_best_trial()
        self._best_config = dict(best.config)
        self._best_metric = best.metric
        self._best_model = best.artifacts.get("model")
        return self

    def get_best_model(self):
        if self._best_model is None:
            raise RuntimeError("fit() first")
        return self._best_model

    def get_best_config(self) -> Dict:
        if self._best_config is None:
            raise RuntimeError("fit() first")
        return dict(self._best_config)

    @property
    def best_metric(self) -> float:
        return self._best_metric
