"""Environment helpers of the cluster-launch scripts (counterpart of
``zoo_tpu/util/utils.py``; the reference's ``zoo.util.utils``)."""

from __future__ import annotations

import os


def detect_conda_env_name() -> str:
    """reference ``utils.py`` — the active conda env name (used to
    conda-pack the launching env for executors; the rebuild's equivalent is
    ``scripts/pack_env.sh``)."""
    name = os.environ.get("CONDA_DEFAULT_ENV")
    if name:
        return name
    prefix = os.environ.get("CONDA_PREFIX")
    if prefix:
        return os.path.basename(prefix)
    raise RuntimeError(
        "no active conda environment detected; the TPU rebuild packages "
        "environments with scripts/pack_env.sh (conda-pack role)")


def convert_to_safe_path(input_path: str, follow_symlinks: bool = True
                         ) -> str:
    """reference ``utils.py`` — canonicalize a path (resolving symlinks
    unless told otherwise) before handing it to native code."""
    if follow_symlinks:
        return os.path.realpath(input_path)
    return os.path.abspath(input_path)


def get_node_ip() -> str:
    """Best-effort routable IP of this host (reference ray utils role)."""
    import socket

    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("8.8.8.8", 80))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
