"""File utilities over local, http(s) and gs paths (counterpart of
``zoo_tpu/orca/data/file.py``): ``list_files``, ``open_text``,
``write_text``, ``exists``, ``makedirs``, ``rmtree`` and ``download``.
``http(s)://`` reads go through urllib into a local cache, ``gs://``
through gcsfs when it is installed (raising, naming it, otherwise);
everything else is POSIX.
"""

from __future__ import annotations

import glob as _glob
import hashlib
import os
import shutil
import tempfile
import urllib.request
from typing import List, Optional


def _strip_scheme(path: str) -> str:
    if path.startswith("file://"):
        return path[len("file://"):]
    return path


def is_local_path(path: str) -> bool:
    return "://" not in path or path.startswith("file://")


def _gcs_fs():
    try:
        import gcsfs
        return gcsfs.GCSFileSystem()
    except ImportError as e:
        raise ImportError(
            "gs:// paths need the gcsfs package (not installed in this "
            "environment); copy the data locally or install gcsfs") from e


def download(url: str, cache_dir: Optional[str] = None) -> str:
    """Fetch an http(s) resource into a content-addressed local cache
    and return the local path."""
    cache_dir = cache_dir or os.path.join(tempfile.gettempdir(),
                                          "zoo_tpu_torch_downloads")
    os.makedirs(cache_dir, exist_ok=True)
    name = hashlib.sha1(url.encode()).hexdigest()[:16] + "_" + \
        os.path.basename(url.split("?")[0])
    local = os.path.join(cache_dir, name)
    if not os.path.exists(local):
        # per-writer temp file + atomic publish: concurrent processes on
        # a shared file system must not interleave into one file
        fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".part")
        try:
            with urllib.request.urlopen(url, timeout=60) as resp, \
                    os.fdopen(fd, "wb") as f:
                shutil.copyfileobj(resp, f)
            os.replace(tmp, local)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise
    return local


def _localize(path: str) -> str:
    """Any supported path -> a local file system path."""
    if is_local_path(path):
        return _strip_scheme(path)
    if path.startswith(("http://", "https://")):
        return download(path)
    if path.startswith("gs://"):
        fs = _gcs_fs()
        cache = os.path.join(tempfile.gettempdir(), "zoo_tpu_torch_gcs")
        os.makedirs(cache, exist_ok=True)
        # keep the basename so suffix filters (read_parquet) still match
        local = os.path.join(
            cache, hashlib.sha1(path.encode()).hexdigest()[:16] + "_" +
            os.path.basename(path))
        if not os.path.exists(local):
            fd, tmp = tempfile.mkstemp(dir=cache, suffix=".part")
            os.close(fd)
            try:
                fs.get(path, tmp)
                os.replace(tmp, local)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
        return local
    raise NotImplementedError(f"unsupported path scheme: {path}")


def exists(path: str) -> bool:
    if is_local_path(path):
        return os.path.exists(_strip_scheme(path))
    if path.startswith(("http://", "https://")):
        req = urllib.request.Request(path, method="HEAD")
        try:
            with urllib.request.urlopen(req, timeout=10) as resp:
                return resp.status < 400
        except Exception:  # noqa: BLE001 — unreachable reads as absent
            return False
    if path.startswith("gs://"):
        return _gcs_fs().exists(path)
    raise NotImplementedError(f"unsupported path scheme: {path}")


def makedirs(path: str):
    if is_local_path(path):
        os.makedirs(_strip_scheme(path), exist_ok=True)
        return
    if path.startswith("gs://"):
        return  # object stores have no directories
    raise NotImplementedError(f"cannot create directories under {path}")


def open_text(path: str) -> List[str]:
    """A text file's lines (local, http(s) or gs)."""
    with open(_localize(path)) as f:
        return [line.rstrip("\n") for line in f]


def write_text(path: str, text: str):
    if path.startswith("gs://"):
        with _gcs_fs().open(path, "w") as f:
            f.write(text)
        return
    if not is_local_path(path):
        raise NotImplementedError(f"cannot write to {path}")
    with open(_strip_scheme(path), "w") as f:
        f.write(text)


def list_files(path_glob: str) -> List[str]:
    """A path or glob as a sorted file list; a directory expands to its
    files (not those starting with ``.`` or ``_``). A remote path
    localizes to one file."""
    if not is_local_path(path_glob):
        return [_localize(path_glob)]
    path_glob = _strip_scheme(path_glob)
    if os.path.isdir(path_glob):
        return sorted(
            os.path.join(path_glob, f) for f in os.listdir(path_glob)
            if not f.startswith((".", "_")))
    matches = sorted(_glob.glob(path_glob))
    if not matches and os.path.exists(path_glob):
        return [path_glob]
    return matches


def rmtree(path: str):
    path = _strip_scheme(path)
    if os.path.isdir(path):
        shutil.rmtree(path)
    elif os.path.exists(path):
        os.remove(path)
