"""Hyperparameter search engines (counterpart of
``zoo_tpu/automl/search.py``).

``LocalSearchEngine`` runs trials in this process: grid crossing and
random draws, or a model-based sampler (TPE) as ask/tell, with an
optional per-trial stopper and ASHA scheduler, and ``n_parallel``
threads for the random and grid searches. The JAX engine can give each
concurrent trial its own sub-mesh of the runtime context's devices; the
port's context holds one device (ROADMAP A.14), so concurrent trials
share the one card, as JAX trials share a one-device mesh.
``RayTuneSearchEngine`` needs ray, which it imports when constructed.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import zlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from zoo_tpu_torch.automl.hp import Sampler

logger = logging.getLogger("zoo_tpu_torch.automl")


@dataclasses.dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    metric: float = float("nan")
    artifacts: Dict[str, Any] = dataclasses.field(default_factory=dict)


class SearchEngine:
    """compile() then run(); get_best_trial() (reference base API)."""

    def compile(self, trial_fn: Callable[[Dict], Dict],
                search_space: Dict[str, Any], n_sampling: int = 1,
                metric: str = "mse", mode: str = "min", seed: int = 0):
        raise NotImplementedError

    def run(self) -> List[Trial]:
        raise NotImplementedError

    def get_best_trial(self) -> Trial:
        raise NotImplementedError


def _expand_configs(search_space: Dict[str, Any], n_sampling: int,
                    rng: np.random.RandomState) -> List[Dict[str, Any]]:
    """Grid dimensions are fully crossed; sampled dimensions drawn
    ``n_sampling`` times per grid point (ray.tune semantics)."""
    grid_keys = [k for k, v in search_space.items()
                 if isinstance(v, Sampler) and v.is_grid()]
    grid_values = [search_space[k].grid() for k in grid_keys]
    points = list(itertools.product(*grid_values)) if grid_keys else [()]
    configs = []
    for point in points:
        for _ in range(max(1, n_sampling)):
            cfg = {}
            for k, v in search_space.items():
                if k in grid_keys:
                    cfg[k] = point[grid_keys.index(k)]
                elif isinstance(v, Sampler):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    # dedupe pure-grid duplicates when n_sampling > 1 but nothing is sampled
    if grid_keys and not any(isinstance(v, Sampler) and not v.is_grid()
                             for v in search_space.values()):
        seen, uniq = set(), []
        for c in configs:
            key = tuple(sorted((k, repr(v)) for k, v in c.items()))
            if key not in seen:
                seen.add(key)
                uniq.append(c)
        configs = uniq
    return configs


class TrialStopper:
    """Early stop rule for a single trial (reference: ``TrialStopper`` in
    ``ray_tune_search_engine.py`` — metric threshold and/or epoch cap)."""

    def __init__(self, metric_threshold: Optional[float] = None,
                 mode: str = "min", max_steps: Optional[int] = None):
        self.metric_threshold = metric_threshold
        self.mode = mode
        self.max_steps = max_steps

    def __call__(self, step: int, metric: float) -> bool:
        if self.max_steps is not None and step >= self.max_steps:
            return True
        if self.metric_threshold is not None:
            if self.mode == "min" and metric <= self.metric_threshold:
                return True
            if self.mode == "max" and metric >= self.metric_threshold:
                return True
        return False


class ASHAScheduler:
    """Asynchronous Successive Halving (stopping form).

    The trial-scheduler role of the reference's ray.tune ``scheduler=``
    knob (``ray_tune_search_engine.py:151``): trials report per-epoch
    metrics; at each rung (``grace_period * reduction_factor**k``) a
    trial continues only if its metric is in the top ``1/reduction_
    factor`` quantile of results recorded at that rung so far. Thread-
    safe — the local engine runs trials concurrently."""

    def __init__(self, max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3, mode: str = "min"):
        import threading

        self.mode = mode
        self.rf = int(reduction_factor)
        self.rungs: List[int] = []
        r = int(grace_period)
        while r <= int(max_t):
            self.rungs.append(r)
            r *= self.rf
        self._recorded: Dict[int, Dict[int, float]] = \
            {r: {} for r in self.rungs}
        self._lock = threading.Lock()

    def on_result(self, trial_id: int, step: int, metric: float) -> bool:
        """True = stop this trial now."""
        stop = False
        with self._lock:
            for rung in self.rungs:
                if step < rung or trial_id in self._recorded[rung]:
                    continue
                self._recorded[rung][trial_id] = metric
                vals = list(self._recorded[rung].values())
                if len(vals) < self.rf:
                    continue  # too few results to cut anyone
                q = (np.quantile(vals, 1.0 / self.rf)
                     if self.mode == "min"
                     else np.quantile(vals, 1.0 - 1.0 / self.rf))
                survives = metric <= q if self.mode == "min" \
                    else metric >= q
                if not survives:
                    stop = True
        return stop


def _make_search_alg(search_alg, search_space, mode):
    if search_alg in (None, "random", "grid"):
        return None
    if search_alg == "tpe":
        from zoo_tpu_torch.automl.tpe import TPESampler

        return TPESampler(search_space, mode=mode)
    if hasattr(search_alg, "suggest"):
        return search_alg
    raise ValueError(
        f"unknown search_alg {search_alg!r}: use None/'random', 'tpe', "
        "or an object with suggest(rng, history)")


def _make_scheduler(scheduler, mode):
    if scheduler is None:
        return None
    if scheduler == "asha":
        return ASHAScheduler(mode=mode)
    if hasattr(scheduler, "on_result"):
        return scheduler
    raise ValueError(f"unknown scheduler {scheduler!r}: use None, "
                     "'asha', or an object with on_result(id, step, m)")


class LocalSearchEngine(SearchEngine):
    """In-process trials over a thread pool (reference value proposition:
    concurrent Ray Tune trials, ``ray_tune_search_engine.py:29``; torch
    releases the GIL in its ops, so ``n_parallel`` trials overlap on the
    host while sharing the card).

    ``search_alg``: None/'random' (grid-cross + random draws), 'tpe'
    (model-based, ``automl/tpe.py``), or any object with
    ``suggest(rng, history)``. ``scheduler``: None, 'asha', or any
    object with ``on_result(trial_id, step, metric) -> bool`` — consulted
    through the trial's ``reporter`` callback, so trials whose
    ``trial_fn`` accepts ``reporter`` get early-stopped at rungs."""

    def __init__(self, n_parallel: int = 1,
                 stopper: Optional[TrialStopper] = None,
                 search_alg=None, scheduler=None,
                 partition_devices: bool = False):
        self._trials: List[Trial] = []
        self._mode = "min"
        self._metric = "mse"
        self.n_parallel = max(1, int(n_parallel))
        self.stopper = stopper
        self.search_alg = search_alg
        self.scheduler = scheduler
        # kept for the JAX signature: the port's one-device context has
        # no devices to partition (_sub_contexts)
        self.partition_devices = bool(partition_devices)

    def _sub_contexts(self):
        """Disjoint sub-contexts for concurrent trials: none where there
        is no runtime context or it holds one device, as the port's
        context does (a split of more devices comes with ROADMAP A.14's
        multi-device context); concurrent trials then share the one
        card."""
        from zoo_tpu_torch.common.context import get_runtime_context

        ctx = get_runtime_context(required=False)
        if ctx is None or len(ctx.devices) < 2:
            return []
        raise NotImplementedError(
            "sub-contexts over more than one device are ROADMAP A.14")

    def compile(self, trial_fn, search_space, n_sampling=1, metric="mse",
                mode="min", seed=0, search_alg=None, scheduler=None):
        self._rng = np.random.RandomState(seed)
        self._metric, self._mode = metric, mode
        self._trial_fn = trial_fn
        self._alg = _make_search_alg(search_alg or self.search_alg,
                                     search_space, mode)
        self._sched = _make_scheduler(scheduler or self.scheduler, mode)
        if self._alg is None:
            self._configs = _expand_configs(search_space, n_sampling,
                                            self._rng)
        else:
            # model-based: ask/tell loop; budget = n_sampling trials
            self._configs = None
            self._n_trials = max(1, int(n_sampling))
        return self

    def _run_one(self, i: int, cfg: Dict, total: int) -> Trial:
        import inspect

        kwargs = {}
        sig = None
        try:
            sig = inspect.signature(self._trial_fn)
        except (TypeError, ValueError):
            pass
        # only inject a reporter when something actually consumes the
        # per-epoch reports — trial_fns switch to epoch-at-a-time
        # training when given one, which costs an evaluate() per epoch
        if sig is not None and "reporter" in sig.parameters \
                and (self.stopper is not None or self._sched is not None):
            stopper, sched = self.stopper, self._sched

            def reporter(step: int, metric: float) -> bool:
                """Trial calls this per epoch; True means stop early."""
                stop = stopper(step, metric) if stopper is not None \
                    else False
                if sched is not None:
                    stop = sched.on_result(i, step, metric) or stop
                return stop

            kwargs["reporter"] = reporter
        result = self._trial_fn(dict(cfg), **kwargs)
        metric = float(result[self._metric])
        logger.info("trial %d/%d %s=%.5f cfg=%s", i + 1, total,
                    self._metric, metric, cfg)
        return Trial(i, cfg, metric, artifacts=result)

    def run(self) -> List[Trial]:
        if self._alg is not None:
            # sequential ask/tell: each suggestion conditions on every
            # completed trial (the model-based point)
            if self.n_parallel > 1:
                logger.warning(
                    "n_parallel=%d is ignored with a model-based "
                    "search_alg: ask/tell suggestions condition on every "
                    "completed trial, so trials run sequentially",
                    self.n_parallel)
            history: List = []
            self._trials = []
            for i in range(self._n_trials):
                cfg = self._alg.suggest(self._rng, history)
                t = self._run_one(i, cfg, self._n_trials)
                history.append((dict(cfg), t.metric))
                self._trials.append(t)
            return self._trials
        if self.n_parallel == 1:
            self._trials = [self._run_one(i, cfg, len(self._configs))
                            for i, cfg in enumerate(self._configs)]
            return self._trials
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.n_parallel) as pool:
            futures = [pool.submit(self._run_one, i, cfg,
                                   len(self._configs))
                       for i, cfg in enumerate(self._configs)]
            self._trials = [f.result() for f in futures]
        return self._trials

    def get_best_trial(self) -> Trial:
        if not self._trials:
            raise RuntimeError("run() first")
        key = (min if self._mode == "min" else max)
        return key(self._trials, key=lambda t: t.metric)


class RayTuneSearchEngine(SearchEngine):  # pragma: no cover - needs ray
    """ray.tune-backed engine (reference:
    ``ray_tune_search_engine.py:29``); selected automatically when ray is
    installed.

    **Untested integration**: ray is not bundled in the dev image, so
    this class has never executed here (docs/chronos.md carries the same
    caveat). The thread-pool ``LocalSearchEngine`` is the tested path."""

    def __init__(self):
        import ray  # noqa: F401  (raises if absent)
        self._engine = LocalSearchEngine()  # trial bookkeeping reuse

    def compile(self, trial_fn, search_space, n_sampling=1, metric="mse",
                mode="min", seed=0):
        import ray  # noqa: F401
        from ray import tune

        space = {}
        for k, v in search_space.items():
            if isinstance(v, Sampler):
                if v.is_grid():
                    space[k] = tune.grid_search(v.grid())
                else:
                    # distinct stream per key — one shared seed would make
                    # every sampled dim draw identical values per trial
                    kseed = (seed + zlib.crc32(k.encode())) % (2 ** 31)
                    space[k] = tune.sample_from(
                        lambda spec, s=v, r=np.random.RandomState(kseed):
                        s.sample(r))
            else:
                space[k] = v
        self._tune_kwargs = dict(config=space, num_samples=n_sampling,
                                 metric=metric, mode=mode)
        self._trial_fn = trial_fn
        self._metric, self._mode = metric, mode
        return self

    def run(self):
        from ray import tune

        def runnable(config):
            out = self._trial_fn(dict(config))
            # only scalars travel through ray metrics; artifacts (live
            # models) are re-materialized in get_best_trial
            tune.report(**{k: v for k, v in out.items()
                           if isinstance(v, (int, float))})

        self._analysis = tune.run(runnable, **self._tune_kwargs)
        return self._analysis

    def get_best_trial(self) -> Trial:
        best = self._analysis.get_best_trial(self._metric, self._mode)
        # re-run the winning config in-process to materialize artifacts
        # (the trained model object cannot ride ray's metric channel)
        result = self._trial_fn(dict(best.config))
        return Trial(0, best.config, float(result[self._metric]),
                     artifacts=result)


def make_search_engine(search_alg=None, scheduler=None,
                       n_parallel: int = 1,
                       partition_devices: Optional[bool] = None
                       ) -> SearchEngine:
    """``n_parallel > 1`` runs that many trials concurrently, sharing
    the one card (``partition_devices`` is kept for the JAX signature;
    the port's context has one device, :meth:`LocalSearchEngine.
    _sub_contexts`)."""
    if partition_devices is None:
        partition_devices = n_parallel > 1
    if search_alg is None and scheduler is None and n_parallel == 1:
        try:
            return RayTuneSearchEngine()
        except Exception:
            return LocalSearchEngine()
    # model-based search, ASHA and concurrency are local-engine
    # features; the ray engine would accept tune-native searchers instead
    return LocalSearchEngine(n_parallel=n_parallel,
                             search_alg=search_alg, scheduler=scheduler,
                             partition_devices=partition_devices)
