"""Orca Estimator over the Keras-facade models (counterpart of
``zoo_tpu/orca/learn/keras/estimator.py``).

Uniform ``fit``/``predict``/``evaluate``/``get_model``/``save``/``load``
over numpy and DataFrame inputs, with orca-style checkpointing, the
training guard, and train-summary read-back, driving the port's
:class:`~zoo_tpu_torch.pipeline.api.keras.engine.topology.KerasNet` on
one device: the ``device`` given to :meth:`Estimator.from_keras`, else
the runtime context's (``init_orca_context``), else the current CUDA
device. ``fit``, ``evaluate`` and ``predict`` take XShards too.

Checkpoints are the port's pickle codec (:mod:`..ckpt`): ``{"params",
"epoch"}`` as host numpy with the optimizer state beside it, restored
onto the model's device.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from zoo_tpu_torch.orca.learn.ckpt import CheckpointManager
from zoo_tpu_torch.orca.learn.guard import TrainingDiverged, TrainingGuard
from zoo_tpu_torch.orca.learn.trigger import EveryEpoch, Trigger

logger = logging.getLogger(__name__)


class Estimator:
    """Factory namespace (``Estimator.from_*``)."""

    @staticmethod
    def from_keras(model, model_dir: Optional[str] = None,
                   max_ckpt_to_keep: int = 5, guard=None,
                   device=None) -> "KerasEstimator":
        """Wrap a compiled Keras-facade model.

        ``guard``: a :class:`zoo_tpu_torch.orca.learn.guard.TrainingGuard`
        (or False to disable). Default: one configured from the
        ``ZOO_GUARD_*`` knobs — the in-step numeric-health guard,
        divergence rollback and preemption-safe checkpointing.
        ``device``: where the model trains and predicts (default the
        current CUDA device)."""
        return KerasEstimator(model, model_dir=model_dir,
                              max_ckpt_to_keep=max_ckpt_to_keep,
                              guard=guard, device=device)

    @staticmethod
    def from_bigdl(*, model, loss=None, optimizer=None, metrics=None,
                   feature_preprocessing=None, label_preprocessing=None,
                   model_dir: Optional[str] = None,
                   device=None) -> "KerasEstimator":
        """``Estimator.from_bigdl(model=..., loss=..., optimizer=...)``:
        "BigDL models" are the keras-facade models, so this compiles the
        given pieces and wraps the result exactly like ``from_keras``."""
        if loss is not None or optimizer is not None \
                or metrics is not None:
            model.compile(optimizer=optimizer or "adam",
                          loss=loss or "mse", metrics=metrics)
        elif model.loss_fn is None:
            raise ValueError("from_bigdl: pass loss=/optimizer= or a "
                             "compiled model")
        return KerasEstimator(model, model_dir=model_dir, device=device)


class KerasEstimator:
    def __init__(self, model, model_dir: Optional[str] = None,
                 max_ckpt_to_keep: int = 5, guard=None, device=None):
        self.model = model
        self.model_dir = model_dir
        self.device = device
        self._epoch = 0
        self._ckpt = None
        if model_dir:
            self._ckpt = CheckpointManager(
                os.path.join(model_dir, "ckpts"),
                max_to_keep=max_ckpt_to_keep)
            self.model.set_tensorboard(model_dir, "summaries")
        # the training guard: in-step NaN/inf skip, divergence rollback
        # from the last verified checkpoint, preemption-safe checkpoint-
        # and-exit. On by default; guard=False or ZOO_GUARD=0 turns it off
        if guard is False:
            self._guard = None
        elif guard is not None:
            self._guard = guard
        else:
            self._guard = TrainingGuard.from_env()
        self._bind_guard()

    def _bind_guard(self):
        """Wire the guard's checkpoint callbacks to the
        CheckpointManager and attach it to the model."""
        if self._guard is None:
            return
        if self._ckpt is not None:
            self._guard.bind(
                save_fn=self._save_checkpoint,
                restore_fn=lambda: self._ckpt.restore_with_aux(None)[1:],
                quarantine_path=os.path.join(
                    self.model_dir, "guard", "quarantine.jsonl"))
        if self.model is not None:
            self.model.set_guard(self._guard)

    # -- training ---------------------------------------------------------
    def fit(self, data, epochs: int = 1, batch_size: int = 32,
            feature_cols: Optional[Sequence[str]] = None,
            label_cols: Optional[Sequence[str]] = None,
            validation_data=None,
            checkpoint_trigger: Optional[Trigger] = None,
            shuffle: bool = True,
            max_failure_retries: int = 5,
            retry_time_interval: float = 120.0) -> Dict[str, List[float]]:
        """Train ``epochs`` epochs (``data``: ``{"x", "y"}`` numpy, a
        DataFrame with ``feature_cols``/``label_cols``, or XShards of
        either).

        With a ``model_dir`` checkpoint manager, any exception inside an
        epoch restores the latest snapshot (params + optimizer state)
        and retries, bounded by ``max_failure_retries`` failures within
        a ``retry_time_interval``-second sliding window and by twice
        that many failures with no completed epoch between them.
        Without a checkpoint manager failures propagate at once;
        :class:`TrainingDiverged` always does."""
        if checkpoint_trigger is None and self._ckpt is not None:
            checkpoint_trigger = EveryEpoch()
        if self._ckpt is not None and self._ckpt.latest_step() is None \
                and self.model.params is not None:
            # snapshot the starting point so a first-epoch failure has
            # somewhere to restore to
            self._save_checkpoint()
        if self._guard is not None:
            # the preemption signal is owned for the whole fit, including
            # the gaps between epochs; the guard acts on it at the next
            # step boundary
            self._guard.install_signal_handler()
        try:
            return self._fit_epochs(
                data, epochs, batch_size, feature_cols, label_cols,
                validation_data, checkpoint_trigger, shuffle,
                max_failure_retries, retry_time_interval)
        finally:
            if self._guard is not None:
                self._guard.uninstall_signal_handler()

    def _fit_epochs(self, data, epochs, batch_size, feature_cols,
                    label_cols, validation_data, checkpoint_trigger,
                    shuffle, max_failure_retries, retry_time_interval):
        history: Dict[str, List[float]] = {}
        retries, no_progress, last_failure = 0, 0, 0.0
        # train until the epoch counter reaches target — a rollback
        # lowers the counter, so lost epochs are retrained
        start_epoch = self._epoch
        target = self._epoch + epochs
        while self._epoch < target:
            try:
                h = self.model.fit(
                    data, batch_size=batch_size, nb_epoch=1,
                    validation_data=validation_data,
                    feature_cols=feature_cols, label_cols=label_cols,
                    shuffle=shuffle, seed=self._epoch, verbose=0,
                    device=self.device)
            except TrainingDiverged:
                # the guard already exhausted its rollback budget;
                # retrying from the same snapshot would diverge again
                raise
            except Exception as e:  # noqa: BLE001 — the retry perimeter
                now = time.monotonic()
                if now - last_failure > retry_time_interval:
                    retries = 0  # sliding window: old failures expire
                retries += 1
                no_progress += 1
                last_failure = now
                if (self._ckpt is None
                        or self._ckpt.latest_step() is None
                        or retries > max_failure_retries
                        # a deterministic failure slower than the window
                        # must not retry forever
                        or no_progress > 2 * max_failure_retries):
                    raise
                logger.warning(
                    "training failed (%s: %s); retry %d/%d from latest "
                    "checkpoint", type(e).__name__, e, retries,
                    max_failure_retries)
                epoch_before = self._epoch
                self._restore_latest()
                if self._epoch > epoch_before:
                    # the newest checkpoint is from a DIFFERENT run (stale
                    # model_dir): restoring it would silently skip training
                    raise RuntimeError(
                        f"latest checkpoint (epoch {self._epoch}) is ahead "
                        f"of this run (epoch {epoch_before}) — model_dir "
                        "holds checkpoints from a previous run; use "
                        "load_orca_checkpoint() to resume or point "
                        "model_dir at a fresh directory") from e
                # drop history entries for epochs the rollback undid
                keep = max(0, self._epoch - start_epoch)
                for k in history:
                    history[k] = history[k][:keep]
                continue
            no_progress = 0
            self._epoch += 1
            for k, v in h.items():
                history.setdefault(k, []).extend(v)
            if (self._ckpt is not None and checkpoint_trigger is not None
                    and checkpoint_trigger.fire_on_epoch(self._epoch)):
                self._save_checkpoint()
        return history

    def _save_checkpoint(self):
        state = {"params": self.model.params, "epoch": self._epoch}
        self._ckpt.save(self._epoch, state, aux=self.model._opt_state)

    def _device(self):
        """``device=`` when given, else the runtime context's device,
        else the current CUDA device."""
        from zoo_tpu_torch.pipeline.api.keras.engine.topology import _placed
        return _placed(self.device)

    @staticmethod
    def _restore_mesh():
        """The live mesh when it spans more than one device: the
        placement a restore would reshard onto. The port's meshes span
        one device (larger ones are ROADMAP A.14), so this is None and a
        restore lands on :meth:`_device`."""
        from zoo_tpu_torch.common.context import get_runtime_context
        ctx = get_runtime_context(required=False)
        mesh = ctx.mesh if ctx is not None else None
        return mesh if mesh is not None and mesh.size > 1 else None

    def _load_state(self, state, aux):
        from zoo_tpu_torch.pipeline.api.keras.optimizers import (
            state_to_device,
        )
        if self._restore_mesh() is not None:
            raise NotImplementedError(
                "restoring onto a mesh of more than one device is not "
                "ported to zoo_tpu_torch yet (ROADMAP A.14)")
        dev = self._device()
        self.model._place_params(state["params"], dev)
        self.model._opt_state = state_to_device(aux, dev)
        self._epoch = int(np.asarray(state.get("epoch", 0)))

    def _restore_latest(self):
        """Reload the newest verified snapshot: params, optimizer state
        and epoch counter, all from ONE step."""
        _, state, aux = self._ckpt.restore_with_aux(None)
        self._load_state(state, aux)

    def load_orca_checkpoint(self, path: Optional[str] = None,
                             version: Optional[int] = None):
        """Resume from a checkpoint dir (``version`` None picks the
        latest verified step): params, optimizer state and epoch."""
        mgr = self._ckpt if path is None else CheckpointManager(
            os.path.join(path, "ckpts") if os.path.isdir(
                os.path.join(path, "ckpts")) else path)
        if mgr is None:
            raise ValueError("no model_dir configured and no path given")
        if version is None:
            version = mgr.latest_verified_step()
            if version is None:
                raise FileNotFoundError(
                    f"no verified checkpoints under {mgr.directory}")
        self._load_state(mgr.restore(version), mgr.restore_aux(version))
        return self

    # -- inference / eval --------------------------------------------------
    def predict(self, data, batch_size: int = 256,
                feature_cols: Optional[Sequence[str]] = None) -> np.ndarray:
        return self.model.predict(data, batch_size=batch_size,
                                  feature_cols=feature_cols,
                                  device=self.device)

    def evaluate(self, data, batch_size: int = 32,
                 feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None
                 ) -> Dict[str, float]:
        return self.model.evaluate(data, batch_size=batch_size,
                                   feature_cols=feature_cols,
                                   label_cols=label_cols,
                                   device=self.device)

    # -- persistence / summaries ------------------------------------------
    def get_model(self):
        return self.model

    def save(self, model_path: str):
        self.model.save_weights(model_path)
        return model_path

    def load(self, model_path: str):
        self.model.load_weights(model_path, device=self.device)
        return self

    def set_tensorboard(self, log_dir: str, app_name: str):
        self.model.set_tensorboard(log_dir, app_name)

    def set_profile(self, trace_dir=None, trace_epochs: int = 1):
        """The model's step profiler for the next ``fit``
        (``KerasNet.set_profile``)."""
        return self.model.set_profile(trace_dir, trace_epochs)

    def clear_profile(self):
        self.model.clear_profile()

    def get_profile_stats(self):
        return self.model.get_profile_stats()

    def get_train_summary(self, tag: str = "Loss"):
        return self.model.get_train_summary(tag)

    def get_validation_summary(self, tag: str):
        return self.model.get_validation_summary(tag)

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float):
        self.model.set_constant_gradient_clipping(min_value, max_value)

    def set_l2_norm_gradient_clipping(self, clip_norm: float):
        self.model.set_gradient_clipping_by_l2_norm(clip_norm)

    def clear_gradient_clipping(self):
        self.model.clear_gradient_clipping()

    def shutdown(self):
        pass  # nothing to tear down
