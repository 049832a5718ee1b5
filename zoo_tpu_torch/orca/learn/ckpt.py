"""Versioned training checkpoints, crash-safe (counterpart of
``zoo_tpu/orca/learn/ckpt.py``).

A checkpoint is one step directory holding the whole train state: the
state pytree in ``state.pkl`` and an optional side pytree (the
optimizer state) in ``aux.pkl``. The pickle codec only: the JAX
package's orbax codec has no counterpart here.

Crash-safety contract: a worker may be ``kill -9``'d at ANY instant
during :meth:`CheckpointManager.save` and :meth:`~CheckpointManager.
restore` still returns the newest *verified* step.

* every save is staged into a dot-prefixed temp dir on the same
  filesystem, each file fsynced, then atomically renamed into place —
  readers never observe a half-written step directory;
* ``manifest.json`` records per-file size + sha256 (the port's
  ``util/manifest.py``, the JAX package's format); restore verifies it,
  renames corrupt/incomplete steps to ``<step>.corrupt`` (quarantine,
  kept for forensics) and falls back to the next-newest verified step;
* stale temp dirs left by killed savers are garbage-collected once their
  owning pid is gone.

Tensors are saved as host numpy (a device tensor is copied to the host
first); :func:`restore` hands back numpy, and the estimator places it on
the model's device.

Deliberately stricter than the JAX package, whose manager unpickles
with plain ``pickle.load``: restore reads through :class:`_StateUnpickler`,
which resolves numpy's array and scalar parts and nothing else (dicts,
lists, tuples, strings and numbers need no lookup). A JAX ``aux.pkl``,
whose optimizer state is optax NamedTuples, is refused by name, as is
any file naming another callable (``os.system``); a JAX pickle-codec
``state.pkl`` (a dict of numpy arrays) loads, and the port's
``state.pkl`` loads in the JAX manager.
"""

from __future__ import annotations

import io
import os
import pickle
import re
import shutil
from typing import Any, List, Optional

import numpy as np

from zoo_tpu_torch.common.knobs import value as knob_value
from zoo_tpu_torch.obs.metrics import counter, histogram
from zoo_tpu_torch.obs.tracing import span
from zoo_tpu_torch.util.manifest import (
    MANIFEST,  # noqa: F401 — re-exported, as the JAX module does
    fsync_dir as _fsync_dir,
    prune_corrupt,
    prune_dirs,
    quarantine_dir,
    reap_stale_staging,
    verify_manifest,
    write_durable as _write_durable,
    write_manifest,
)
from zoo_tpu_torch.util.resilience import fault_point


_save_seconds = histogram(
    "zoo_ckpt_save_seconds", "Checkpoint save wall time (stage + fsync + "
    "manifest + atomic rename)")
_restore_seconds = histogram(
    "zoo_ckpt_restore_seconds", "Checkpoint restore wall time (verify + load)")
_verify_seconds = histogram(
    "zoo_ckpt_verify_seconds", "Manifest verification wall time")
_quarantined = counter(
    "zoo_ckpt_quarantined_total",
    "Corrupt/incomplete checkpoint steps moved to <step>.corrupt")

_STEP_RE = re.compile(r"^(\d+)$")
_TMP_RE = re.compile(r"^\.tmp-(\d+)-(\d+)$")  # .tmp-<step>-<pid>
_STALE_RE = re.compile(r"^(\d+)\.stale-(\d+)$")  # <step>.stale-<pid>

# what a checkpoint may name: numpy's array and scalar parts, under
# numpy's 1.x and 2.x module names (protocols 2-5 pickle arrays through
# _reconstruct, _frombuffer or scalar), and the latin-1 encoder through
# which protocol 2 spells bytes
_SAFE_GLOBALS = {("numpy", "ndarray"), ("numpy", "dtype"),
                 ("_codecs", "encode")} | {
    (f"numpy.{core}.{mod}", fn) for core in ("core", "_core")
    for mod, fn in (("multiarray", "_reconstruct"),
                    ("multiarray", "scalar"),
                    ("numeric", "_frombuffer"))}


class CheckpointCorruptError(RuntimeError):
    """An explicitly requested step failed manifest verification."""


class CheckpointRefused(pickle.UnpicklingError):
    """A checkpoint file names something other than numpy's array and
    scalar parts (a JAX ``aux.pkl``'s optax state, a callable)."""


class _StateUnpickler(pickle.Unpickler):
    """Resolves numpy's array and scalar parts, numpy's scalar and dtype
    classes, and nothing else."""

    def find_class(self, module, name):
        if (module, name) in _SAFE_GLOBALS or (
                module.split(".")[0] == "numpy" and "." not in name
                and _numpy_type(module, name)):
            return super().find_class(module, name)
        raise CheckpointRefused(
            f"a checkpoint of the port holds numpy arrays, dicts, lists "
            f"and numbers only; this file names {module}.{name}")


def _numpy_type(module: str, name: str) -> bool:
    """Whether ``module.name`` is one of numpy's scalar or dtype classes
    (``numpy.float32``, ``numpy.dtypes.Float32DType``)."""
    if module not in ("numpy", "numpy.dtypes"):
        return False
    obj = getattr(np.dtypes if module == "numpy.dtypes" else np, name, None)
    return isinstance(obj, type) and (issubclass(obj, np.generic)
                                      or issubclass(obj, np.dtype))


def load_state(data: bytes) -> Any:
    """Unpickle one checkpoint file through :class:`_StateUnpickler`."""
    return _StateUnpickler(io.BytesIO(data)).load()


def to_host(tree: Any) -> Any:
    """``tree`` with every tensor as CPU numpy (dicts, lists and tuples
    walked; other leaves kept)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if hasattr(tree, "detach") and hasattr(tree, "cpu"):   # a tensor
        return tree.detach().cpu().numpy()
    return tree


class CheckpointManager:
    """Crash-safe checkpoint directory of pickle-codec steps."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None,
                 keep: Optional[int] = None):
        """``keep`` (alias ``max_to_keep``; default ``$ZOO_CKPT_KEEP`` or
        5) is the retention bound: :meth:`gc` keeps the newest ``keep``
        committed steps AND at most ``keep`` quarantined
        ``<step>.corrupt`` dirs. The newest hash-VERIFIED step is never
        a GC victim, so the newest-verified fallback chain survives even
        when every younger step is corrupt."""
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        if keep is None:
            keep = max_to_keep if max_to_keep is not None else \
                knob_value("ZOO_CKPT_KEEP")
        self.max_to_keep = int(keep)
        # steps this process already hash-verified: restore(None) then
        # restore_aux(None) must not sha256 a large snapshot twice
        self._verified_ok: set = set()

    # -- write ------------------------------------------------------------
    def save(self, step: int, state: Any, aux: Any = None):
        """``aux`` is an optional side pytree (the optimizer state)
        stored next to the main state. The step is staged under
        ``.tmp-<step>-<pid>`` (same filesystem), fsynced, manifested,
        then renamed into place in one atomic step — a crash at any
        point leaves either the previous verified state or the complete
        new one, never a torn directory."""
        with span("ckpt.save", step=int(step)), _save_seconds.time():
            self._save(step, state, aux)

    def _save(self, step: int, state: Any, aux: Any = None):
        final = os.path.join(self.directory, str(step))
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        host_state = to_host(state)
        fault_point("ckpt.pre_write", step=step, dir=tmp)
        _write_durable(
            os.path.join(tmp, "state.pkl"),
            pickle.dumps(host_state, protocol=pickle.HIGHEST_PROTOCOL))
        if aux is not None:
            _write_durable(
                os.path.join(tmp, "aux.pkl"),
                pickle.dumps(to_host(aux), protocol=pickle.HIGHEST_PROTOCOL))
        fault_point("ckpt.pre_manifest", step=step, dir=tmp)
        write_manifest(tmp, extra={"step": int(step)})
        fault_point("ckpt.pre_rename", step=step, dir=tmp)
        stale = None
        if os.path.isdir(final):
            # re-save of an existing step: move the old copy aside (not
            # delete) so that at every instant either the old verified
            # step or the new one is in place
            stale = final + f".stale-{os.getpid()}"
            shutil.rmtree(stale, ignore_errors=True)
            os.rename(final, stale)
        os.rename(tmp, final)  # the atomic commit point
        if stale is not None:
            shutil.rmtree(stale, ignore_errors=True)
        self._verified_ok.discard(step)  # content changed: re-verify
        _fsync_dir(self.directory)
        fault_point("ckpt.post_rename", step=step, dir=final)
        self._gc()

    # -- read -------------------------------------------------------------
    def all_steps(self) -> List[int]:
        """Committed step numbers (temp ``.tmp-*`` and quarantined
        ``*.corrupt`` directories never match)."""
        steps = []
        if not os.path.isdir(self.directory):
            return steps
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.isdir(os.path.join(self.directory, name)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def latest_verified_step(self) -> Optional[int]:
        """Newest step that passes manifest verification; corrupt steps
        found on the way are quarantined."""
        for s in reversed(self.all_steps()):
            if self._verify_or_quarantine(s):
                return s
        return None

    def verify(self, step: int) -> bool:
        """Does ``step`` pass its manifest (sizes + checksums)? Steps
        without ``manifest.json`` (written before the manifest era) are
        accepted when a payload file is present."""
        with _verify_seconds.time():
            return verify_manifest(os.path.join(self.directory, str(step)),
                                   what=f"checkpoint step {step}",
                                   legacy_ok=True)

    def _verify_or_quarantine(self, step: int) -> bool:
        if step in self._verified_ok and \
                os.path.isdir(os.path.join(self.directory, str(step))):
            return True
        if self.verify(step):
            self._verified_ok.add(step)
            return True
        self._verified_ok.discard(step)
        if quarantine_dir(os.path.join(self.directory, str(step)),
                          what=f"checkpoint step {step}") is not None:
            _quarantined.inc()
        return False

    def restore(self, step: Optional[int] = None) -> Any:
        """Load checkpoint ``step`` as host numpy. ``step=None`` picks
        the newest VERIFIED step — corrupt or torn steps are quarantined
        to ``<step>.corrupt`` and skipped. An explicit ``step`` that
        fails verification raises :class:`CheckpointCorruptError` after
        quarantining it."""
        with span("ckpt.restore", step=step), _restore_seconds.time():
            return self._restore(step)

    def _restore(self, step: Optional[int] = None) -> Any:
        if step is not None:
            if not os.path.isdir(os.path.join(self.directory, str(step))):
                raise FileNotFoundError(
                    f"no checkpoint step {step} under {self.directory}")
            if not self._verify_or_quarantine(step):
                raise CheckpointCorruptError(
                    f"checkpoint step {step} under {self.directory} is "
                    "corrupt or incomplete (quarantined to "
                    f"{step}.corrupt)")
            return self._load(step)
        for s in reversed(self.all_steps()):
            if self._verify_or_quarantine(s):
                return self._load(s)
        raise FileNotFoundError(
            f"no verified checkpoints under {self.directory}")

    def _load(self, step: int) -> Any:
        path = os.path.join(self.directory, str(step), "state.pkl")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"{path}: the port reads the pickle codec only (an orbax "
                "step of the JAX package has no state.pkl)")
        with open(path, "rb") as f:
            return load_state(f.read())

    def restore_with_aux(self, step: Optional[int] = None):
        """``(step, state, aux)`` from one verified snapshot — the
        resume/rollback primitive: params and optimizer state come from
        the SAME step. ``step=None`` picks the newest verified step;
        raises ``FileNotFoundError`` when none exists."""
        if step is None:
            step = self.latest_verified_step()
            if step is None:
                raise FileNotFoundError(
                    f"no verified checkpoints under {self.directory}")
        return step, self.restore(step), self.restore_aux(step)

    def restore_aux(self, step: Optional[int] = None) -> Any:
        """Load the side pytree written with ``save(..., aux=...)``;
        None if the step has none. ``step=None`` follows the same
        newest-VERIFIED-step rule as :meth:`restore`."""
        if step is None:
            step = self.latest_verified_step()
        if step is None:
            return None
        path = os.path.join(self.directory, str(step), "aux.pkl")
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return load_state(f.read())

    # -- housekeeping ------------------------------------------------------
    @property
    def keep(self) -> int:
        """Retention bound (``keep=`` / ``max_to_keep=`` ctor alias)."""
        return self.max_to_keep

    def gc(self):
        """Keep the newest ``keep`` committed steps — but NEVER the
        newest step this process has hash-verified — age out
        ``<step>.corrupt`` quarantine dirs past the same bound, and reap
        staging/stale dirs whose owning pid is gone (also runs after
        every :meth:`save`)."""
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        verified = [s for s in steps if s in self._verified_ok]
        protect = {str(verified[-1])} if verified else set()
        prune_dirs(self.directory, [str(s) for s in steps],
                   self.max_to_keep, protect=protect)
        prune_corrupt(self.directory, self.max_to_keep)
        reap_stale_staging(self.directory, _TMP_RE, _STALE_RE)
