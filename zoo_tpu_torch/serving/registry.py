"""Versioned model registry: the append-only store the serving
lifecycle promotes through (counterpart of
``zoo_tpu/serving/registry.py``; the on-disk layout is the same byte for
byte, so a registry one package publishes, the other resolves).

* ``publish()`` stages a version into a dot-prefixed temp dir on the
  same filesystem, fsyncs every file, writes a ``manifest.json`` with
  per-file size + sha256, re-verifies the staged bytes, then commits
  with ONE atomic rename — readers never observe a half-written
  version, and a publisher killed at any instant leaves only a staging
  dir that the next :meth:`gc` reaps;
* ``resolve()`` returns a version only after its manifest verifies;
  a corrupt version is quarantined to ``v<N>.corrupt`` and can never be
  served;
* aliases (``prod``, ``canary``, ...) are atomic pointer files — an
  alias move is a tmp-write + ``os.replace``, so every reader sees
  either the old target or the new one, never a torn pointer;
* retention (:meth:`gc`, bound ``keep`` / ``$ZOO_REGISTRY_KEEP``)
  deletes old versions oldest-first but NEVER an aliased version or one
  pinned by a live loader (:meth:`pin`), and ages quarantined
  ``.corrupt`` dirs past the same bound.

A version directory holds either real model payload (a model file of
the port, :meth:`~zoo_tpu_torch.pipeline.api.keras.engine.topology.KerasNet.save`)
or a one-line ``MODEL`` spec file naming a nested serving spec
(``synthetic:double:2``, ``llama:tiny``). ``registry:<root>:<ref>`` is
the serving model spec replicas boot from: a respawned replica
re-resolves its alias at boot, so a supervisor respawn mid-rolling-update
comes up on the *currently aliased* version.
"""

from __future__ import annotations

import contextlib
import logging
import os
import re
import shutil
import time
from typing import Dict, List, Optional, Tuple

from zoo_tpu_torch.obs.metrics import counter, gauge
from zoo_tpu_torch.util.manifest import (
    fsync_dir,
    prune_corrupt,
    prune_dirs,
    quarantine_dir,
    reap_stale_staging,
    verify_manifest,
    write_durable,
    write_manifest,
)
from zoo_tpu_torch.util.resilience import env_int

logger = logging.getLogger(__name__)

__all__ = ["ModelRegistry", "RegistryCorruptError", "REGISTRY_PREFIX",
           "is_registry_spec", "parse_registry_spec"]

_published = counter(
    "zoo_registry_publish_total",
    "Model versions committed to the registry, by outcome "
    "(ok / rejected — rejected = staged bytes failed verification and "
    "were never committed)", labels=("outcome",))
_quarantined = counter(
    "zoo_registry_quarantined_total",
    "Registry versions that failed manifest verification and were "
    "quarantined to v<N>.corrupt")
_gc_removed = counter(
    "zoo_registry_gc_removed_total",
    "Version directories deleted by registry retention GC")
_versions_gauge = gauge(
    "zoo_registry_versions", "Committed (non-quarantined) versions "
    "currently in the registry")

REGISTRY_PREFIX = "registry:"
MODEL_SPEC_FILE = "MODEL"

_VERSION_RE = re.compile(r"^v(\d+)$")
_TMP_RE = re.compile(r"^\.tmp-v(\d+)-(\d+)$")  # .tmp-v<N>-<pid>
_PIN_RE = re.compile(r"^v(\d+)\.pin-(\d+)$")  # v<N>.pin-<pid>
_ALIAS_RE = re.compile(r"^[A-Za-z][\w.-]*$")


class RegistryCorruptError(RuntimeError):
    """A requested version failed manifest verification (it has been
    quarantined and will never be served), or a publish staged bytes
    that did not verify (nothing was committed)."""


def is_registry_spec(spec) -> bool:
    return isinstance(spec, str) and spec.startswith(REGISTRY_PREFIX)


def parse_registry_spec(spec: str) -> Tuple[str, str]:
    """``registry:<root>[:<ref>]`` → ``(root, ref)``; ``ref`` defaults
    to ``prod``. The ref is split off the END so registry roots with
    drive/scheme colons keep working."""
    body = spec[len(REGISTRY_PREFIX):]
    if not body:
        raise ValueError(f"empty registry spec {spec!r}")
    root, sep, ref = body.rpartition(":")
    if not sep or os.sep in ref or not ref:
        return body, "prod"
    return root, ref


class ModelRegistry:
    """``ModelRegistry(root).publish(my_model_dir, alias="canary")`` —
    see the module docstring for the layout and guarantees."""

    def __init__(self, root: str, keep: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.versions_dir = os.path.join(self.root, "versions")
        self.aliases_dir = os.path.join(self.root, "aliases")
        self.pins_dir = os.path.join(self.root, "pins")
        for d in (self.versions_dir, self.aliases_dir, self.pins_dir):
            os.makedirs(d, exist_ok=True)
        self.keep = keep if keep is not None else \
            env_int("ZOO_REGISTRY_KEEP", 8)
        # versions this process already hash-verified (same read-once
        # economy as CheckpointManager: resolve() on a hot path must not
        # re-sha256 a multi-GB model per request)
        self._verified_ok: set = set()

    # -- refs --------------------------------------------------------------
    @staticmethod
    def _as_version(ref) -> Optional[int]:
        """``"v3"`` / ``"3"`` / ``3`` → 3; None when ``ref`` is not a
        version literal (i.e. an alias name or ``latest``)."""
        if isinstance(ref, int):
            return ref
        m = _VERSION_RE.match(ref)
        if m:
            return int(m.group(1))
        return int(ref) if ref.isdigit() else None

    def _path(self, v: int) -> str:
        return os.path.join(self.versions_dir, f"v{v}")

    def versions(self) -> List[int]:
        """Committed version numbers (staging and ``.corrupt`` never
        match)."""
        out = []
        for name in os.listdir(self.versions_dir):
            m = _VERSION_RE.match(name)
            if m and os.path.isdir(os.path.join(self.versions_dir, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def _next_version(self) -> int:
        """Version numbers are append-only: quarantined (``.corrupt``)
        and GC'd numbers are never reused — ``vN`` must mean the same
        bytes forever, and a recycled number would make the quarantine
        forensics ambiguous."""
        highest = 0
        for name in os.listdir(self.versions_dir):
            m = re.match(r"^v(\d+)", name)
            if m:
                highest = max(highest, int(m.group(1)))
        # GC'd committed versions leave no dir behind; the aliases and
        # this process's memory still know the numbers were used
        for vname in self.aliases().values():
            highest = max(highest, int(vname[1:]))
        for v in self._verified_ok:
            highest = max(highest, v)
        return highest + 1

    # -- publish -----------------------------------------------------------
    def publish(self, source: Optional[str] = None, *,
                spec: Optional[str] = None,
                version: Optional[int] = None,
                alias: Optional[str] = None,
                metadata: Optional[Dict] = None) -> str:
        """Commit one immutable version; returns its ``"vN"`` name.

        ``source``: a model file (copied in under its basename) or a
        directory (its contents copied). ``spec``: instead of payload,
        a one-line nested serving spec (``synthetic:double:2``) written
        to the ``MODEL`` file. The staged bytes are fsynced, manifested,
        and RE-VERIFIED before the atomic commit — a torn copy is
        rejected (staging removed, :class:`RegistryCorruptError`) and
        never becomes a servable version. ``alias`` atomically points
        that alias at the new version after the commit."""
        if (source is None) == (spec is None):
            raise ValueError("publish needs exactly one of source= "
                             "(file/dir) or spec= (nested model spec)")
        if source is not None and not os.path.exists(source):
            raise FileNotFoundError(source)
        v = int(version) if version is not None else \
            self._next_version()
        while True:
            tmp = os.path.join(self.root, f".tmp-v{v}-{os.getpid()}")
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            try:
                if spec is not None:
                    write_durable(os.path.join(tmp, MODEL_SPEC_FILE),
                                  (spec.strip() + "\n").encode())
                elif os.path.isdir(source):
                    shutil.copytree(source, tmp, dirs_exist_ok=True)
                else:
                    shutil.copy2(source, os.path.join(
                        tmp, os.path.basename(source)))
                extra = {"version": v, "published_unix": time.time()}
                if metadata:
                    extra["metadata"] = dict(metadata)
                write_manifest(tmp, extra=extra)
                if not verify_manifest(tmp, what=f"staged version v{v}"):
                    raise RegistryCorruptError(
                        f"publish of v{v} rejected: staged bytes failed "
                        "manifest verification (torn copy?)")
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                _published.labels(outcome="rejected").inc()
                raise
            try:
                os.rename(tmp, self._path(v))  # the atomic commit point
                break
            except OSError:
                if version is not None or not os.path.exists(
                        self._path(v)):
                    shutil.rmtree(tmp, ignore_errors=True)
                    _published.labels(outcome="rejected").inc()
                    raise
                # auto-numbered publish lost the race: renumber, restage
                shutil.rmtree(tmp, ignore_errors=True)
                v += 1
        fsync_dir(self.versions_dir)
        self._verified_ok.add(v)
        _published.labels(outcome="ok").inc()
        _versions_gauge.set(len(self.versions()))
        logger.info("registry %s: published v%d%s", self.root, v,
                    f" (alias {alias})" if alias else "")
        if alias:
            self.set_alias(alias, v)
        self.gc()
        return f"v{v}"

    # -- resolve -----------------------------------------------------------
    def _verify_or_quarantine(self, v: int) -> bool:
        path = self._path(v)
        if v in self._verified_ok and os.path.isdir(path):
            return True
        if verify_manifest(path, what=f"registry version v{v}"):
            self._verified_ok.add(v)
            return True
        self._verified_ok.discard(v)
        if os.path.isdir(path) and \
                quarantine_dir(path, what=f"registry version v{v}") \
                is not None:
            _quarantined.inc()
            _versions_gauge.set(len(self.versions()))
        return False

    def latest_verified(self) -> Optional[int]:
        for v in reversed(self.versions()):
            if self._verify_or_quarantine(v):
                return v
        return None

    def resolve(self, ref) -> Tuple[str, str]:
        """``("vN", /abs/path/to/versions/vN)`` for a ref that VERIFIES
        — ``"prod"``/any alias, ``"vN"``/``N``, or ``"latest"`` (newest
        verified). A corrupt target is quarantined and raises
        :class:`RegistryCorruptError`; it is never returned."""
        if ref == "latest":
            v = self.latest_verified()
            if v is None:
                raise FileNotFoundError(
                    f"no verified versions under {self.root}")
            return f"v{v}", self._path(v)
        v = self._as_version(ref)
        if v is None:
            v = self._alias_target(ref)
            if v is None:
                raise KeyError(
                    f"unknown alias {ref!r} under {self.root} "
                    f"(have: {sorted(self.aliases())})")
        if not os.path.isdir(self._path(v)):
            raise FileNotFoundError(
                f"no version v{v} under {self.root}")
        if not self._verify_or_quarantine(v):
            raise RegistryCorruptError(
                f"registry version v{v} under {self.root} is corrupt "
                f"or incomplete (quarantined to v{v}.corrupt)")
        return f"v{v}", self._path(v)

    def model_spec(self, ref) -> Tuple[str, str]:
        """``(version, inner_spec)`` — what a replica actually loads:
        the one-line ``MODEL`` spec when present, else the single
        payload file, else the version directory itself (SavedModel
        layout)."""
        version, path = self.resolve(ref)
        mfile = os.path.join(path, MODEL_SPEC_FILE)
        if os.path.exists(mfile):
            with open(mfile) as f:
                return version, f.read().strip()
        entries = [n for n in os.listdir(path) if n != "manifest.json"]
        # a single-FILE payload (model.zoo) loads as that file; any
        # subdirectory means a tree payload (canonical SavedModel:
        # saved_model.pb + variables/) that must load as the whole dir
        if len(entries) == 1 and os.path.isfile(
                os.path.join(path, entries[0])):
            return version, os.path.join(path, entries[0])
        return version, path

    # -- aliases -----------------------------------------------------------
    def _alias_path(self, name: str) -> str:
        if not _ALIAS_RE.match(name) or name == "latest" or \
                self._as_version(name) is not None:
            # version literals and "latest" are resolve() refs already;
            # an alias named "v2" could never be reached
            raise ValueError(f"invalid alias name {name!r}")
        return os.path.join(self.aliases_dir, name)

    def _alias_target(self, name: str) -> Optional[int]:
        try:
            with open(self._alias_path(name)) as f:
                return int(f.read().strip())
        except (OSError, ValueError):
            return None

    def set_alias(self, name: str, version) -> str:
        """Atomically point ``name`` at ``version`` (which must verify
        first — an alias can never be moved onto a corrupt version).
        Readers see the old target or the new one, never a torn
        pointer. Returns the ``"vN"`` now aliased."""
        v = self._as_version(version)
        if v is None:
            raise ValueError(f"set_alias needs a version, got {version!r}")
        if not self._verify_or_quarantine(v):
            raise RegistryCorruptError(
                f"refusing to alias {name!r} -> v{v}: version is "
                "missing or corrupt")
        path = self._alias_path(name)
        tmp = f"{path}.tmp-{os.getpid()}"
        write_durable(tmp, f"{v}\n".encode())
        os.replace(tmp, path)  # atomic pointer move
        fsync_dir(self.aliases_dir)
        logger.info("registry %s: alias %s -> v%d", self.root, name, v)
        return f"v{v}"

    def alias_version(self, name: str) -> Optional[str]:
        v = self._alias_target(name)
        return None if v is None else f"v{v}"

    def aliases(self) -> Dict[str, str]:
        out = {}
        for name in os.listdir(self.aliases_dir):
            if ".tmp-" in name:  # a mover's staging file, not an alias
                continue
            v = self._alias_target(name)
            if v is not None:
                out[name] = f"v{v}"
        return out

    def drop_alias(self, name: str):
        with contextlib.suppress(FileNotFoundError):
            os.unlink(self._alias_path(name))

    # -- pins (in-flight protection) ---------------------------------------
    @contextlib.contextmanager
    def pin(self, ref):
        """Protect a version from retention GC while a loader is
        reading it (cross-process: the pin is a file keyed by pid, so a
        pin leaked by a killed loader is reaped once its pid is gone)."""
        version, _ = self.resolve(ref)
        pin = os.path.join(self.pins_dir,
                           f"{version}.pin-{os.getpid()}")
        write_durable(pin, b"")
        try:
            yield version
        finally:
            with contextlib.suppress(OSError):
                os.unlink(pin)

    def _pinned(self) -> set:
        """Versions pinned by a LIVE pid (dead-pid pins are reaped)."""
        out = set()
        for name in os.listdir(self.pins_dir):
            m = _PIN_RE.match(name)
            if not m:
                continue
            v, pid = int(m.group(1)), int(m.group(2))
            try:
                if pid != os.getpid():
                    os.kill(pid, 0)
                out.add(v)
            except ProcessLookupError:
                with contextlib.suppress(OSError):
                    os.unlink(os.path.join(self.pins_dir, name))
            except PermissionError:
                out.add(v)  # live pid under another uid
        return out

    # -- retention ---------------------------------------------------------
    def gc(self):
        """Bounded retention (``keep`` newest versions): aliased and
        live-pinned versions are never victims — an alias or an
        in-flight load always survives, even past the bound — and
        quarantined ``.corrupt`` dirs age out at the same bound. Stale
        staging dirs from killed publishers are reaped too."""
        protect = {f"v{v}" for v in self._pinned()}
        protect.update(self.aliases().values())
        removed = prune_dirs(self.versions_dir,
                             [f"v{v}" for v in self.versions()],
                             self.keep, protect=protect)
        if removed:
            _gc_removed.inc(len(removed))
            for name in removed:
                self._verified_ok.discard(int(name[1:]))
        prune_corrupt(self.versions_dir, self.keep)
        reap_stale_staging(self.root, _TMP_RE)
        _versions_gauge.set(len(self.versions()))
