"""Verified-manifest directory format and bounded retention
(counterpart of ``zoo_tpu/util/manifest.py``, byte for byte the same
format, so a directory written by either package verifies in the other).

One directory = one immutable artifact: every payload file is fsynced,
listed in ``manifest.json`` with its size + sha256, and the directory is
committed by a single atomic rename — the protocol
:class:`zoo_tpu_torch.serving.registry.ModelRegistry` layers model
versions on. A reader verifies the manifest before trusting the
contents; a mismatch means a torn or bit-rotted artifact that must be
quarantined, never served.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
from typing import Dict, Iterable, List, Optional, Sequence

logger = logging.getLogger(__name__)

MANIFEST = "manifest.json"


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def fsync_dir(path: str):
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def write_durable(path: str, data: bytes):
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def walk_files(root: str) -> List[str]:
    """Every file under ``root``, as sorted relative paths."""
    out = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            out.append(os.path.relpath(os.path.join(dirpath, name), root))
    return sorted(out)


def write_manifest(root: str, extra: Optional[Dict] = None) -> Dict:
    """Fsync every file under ``root`` and write ``manifest.json``
    vouching for it (size + sha256 per file, plus the ``extra``
    metadata). The caller commits the directory afterwards with one
    atomic rename."""
    manifest: Dict = dict(extra or {})
    manifest["files"] = {}
    for rel in walk_files(root):
        if rel == MANIFEST:
            continue
        full = os.path.join(root, rel)
        with open(full, "rb+") as f:
            os.fsync(f.fileno())
        manifest["files"][rel] = {
            "size": os.path.getsize(full), "sha256": sha256_file(full)}
    write_durable(os.path.join(root, MANIFEST),
                  json.dumps(manifest, indent=1).encode())
    for dirpath, _, _ in os.walk(root):
        fsync_dir(dirpath)
    return manifest


def read_manifest(root: str) -> Optional[Dict]:
    """The parsed manifest, or None when unreadable/absent."""
    try:
        with open(os.path.join(root, MANIFEST)) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def verify_manifest(root: str, what: str = "artifact",
                    legacy_ok: bool = False) -> bool:
    """Does ``root`` match its manifest (sizes + checksums)?

    ``legacy_ok``: accept a directory with NO manifest as long as it
    holds any payload — the pre-manifest checkpoint era, whose presence
    implies a completed legacy save. New formats (the model registry)
    must pass ``legacy_ok=False``: a version without a manifest is
    corrupt, full stop. Extra files beyond the manifest (pins, late
    annotations) are allowed — the manifest vouches for what it lists."""
    if not os.path.isdir(root):
        return False
    mpath = os.path.join(root, MANIFEST)
    if not os.path.exists(mpath):
        if legacy_ok:
            return bool(os.listdir(root))
        logger.warning("%s %s: no manifest", what, root)
        return False
    try:
        with open(mpath) as f:
            manifest = json.load(f)
        files: Dict[str, Dict] = manifest["files"]
    except (OSError, ValueError, KeyError) as e:
        logger.warning("%s %s: unreadable manifest (%s)", what, root, e)
        return False
    present = set(walk_files(root)) - {MANIFEST}
    if set(files) - present:
        logger.warning("%s %s: missing files %s", what, root,
                       sorted(set(files) - present))
        return False
    for rel, meta in files.items():
        full = os.path.join(root, rel)
        if os.path.getsize(full) != meta["size"]:
            logger.warning("%s %s: %s size mismatch", what, root, rel)
            return False
        if sha256_file(full) != meta["sha256"]:
            logger.warning("%s %s: %s checksum mismatch", what, root, rel)
            return False
    return True


def quarantine_dir(path: str, what: str = "artifact") -> Optional[str]:
    """Rename ``path`` to ``path.corrupt`` (``.corrupt.N`` when taken) so
    a failed artifact is kept for forensics but can never be served or
    restored again. Returns the quarantine path, or None when the rename
    lost a race with a concurrent quarantiner (fine — someone moved it)."""
    dest = path + ".corrupt"
    n = 0
    while os.path.exists(dest):
        n += 1
        dest = f"{path}.corrupt.{n}"
    try:
        os.rename(path, dest)
    except OSError as e:
        logger.warning("could not quarantine %s %s: %s", what, path, e)
        return None
    logger.warning("quarantined corrupt/incomplete %s %s -> %s",
                   what, path, os.path.basename(dest))
    return dest


def prune_corrupt(parent: str, keep: int) -> List[str]:
    """Age out quarantined ``*.corrupt*`` directories beyond ``keep``,
    oldest-NUMBER-first (numeric, not lexicographic — ``10.corrupt`` is
    newer forensics than ``2.corrupt``)."""
    import re
    corrupt = sorted(
        (n for n in os.listdir(parent) if ".corrupt" in n),
        key=lambda n: int(re.search(r"\d+", n).group()
                          if re.search(r"\d+", n) else "0"))
    return prune_dirs(parent, corrupt, keep)


def reap_stale_staging(parent: str, *patterns) -> List[str]:
    """Remove staging/stale directories under ``parent`` whose owning
    pid is gone. Each compiled ``pattern`` must capture the pid as
    group 2 (the ``.tmp-<id>-<pid>`` convention). Live pids — including
    ones we cannot signal (another uid) — keep their dirs."""
    removed = []
    for name in os.listdir(parent):
        m = next((p.match(name) for p in patterns if p.match(name)),
                 None)
        if not m:
            continue
        pid = int(m.group(2))
        if pid == os.getpid():
            continue
        try:
            os.kill(pid, 0)  # owner still alive: leave its dir
        except ProcessLookupError:
            shutil.rmtree(os.path.join(parent, name),
                          ignore_errors=True)
            removed.append(name)
            logger.info("removed stale staging dir %s (owner pid %d "
                        "is gone)", name, pid)
        except PermissionError:
            pass  # pid exists under another uid: leave it
    return removed


def prune_dirs(parent: str, names_oldest_first: Sequence[str], keep: int,
               protect: Iterable[str] = ()) -> List[str]:
    """Bounded retention: delete directories oldest-first until at most
    ``keep`` remain, never touching ``protect`` members (aliased /
    pinned / newest-verified artifacts — protected entries still count
    toward the bound, they just cannot be the victim). Returns the
    deleted names."""
    protected = set(protect)
    names = list(names_oldest_first)
    removed: List[str] = []
    excess = len(names) - max(0, int(keep))
    for name in names:
        if excess <= 0:
            break
        if name in protected:
            continue
        shutil.rmtree(os.path.join(parent, name), ignore_errors=True)
        removed.append(name)
        excess -= 1
    return removed
