"""Loader of the port's native runtime (counterpart of
``zoo_tpu/native/__init__.py``).

``zoo_native.cc`` beside this file (the port's own copy of the JAX
package's source) is compiled with ``g++`` at first use into
``build/zoo_tpu_torch/native/<source digest>/zoo_native.so`` at the
repository root and loaded with ``ctypes`` (plain C interface). Nothing
builds at import time.

:func:`load` returns the library, or None where it cannot be built
(no ``g++``) or ``ZOO_TPU_DISABLE_NATIVE`` is set; :func:`available`
says which. Each caller (the TFRecord reader and writer, the tiered
cache) then takes its ``native`` or ``python`` route and records it
with :func:`record_route`; :func:`routes` reads what ran. The Python
route is never taken silently: a failed build logs a warning naming
the cause, and every Python-route call is recorded.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger("zoo_tpu_torch.native")

SRC = Path(__file__).resolve().parent / "zoo_native.cc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / \
    "zoo_tpu_torch" / "native"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_lib_tried = False
_routes: Dict[str, Dict[str, int]] = {}


def _annotate(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sigs = {
        "zoo_crc32c": (ctypes.c_uint32, [u8p, ctypes.c_uint64]),
        "zoo_tfr_reader_open": (ctypes.c_void_p,
                                [ctypes.c_char_p, ctypes.c_int]),
        "zoo_tfr_reader_next": (ctypes.c_int64,
                                [ctypes.c_void_p, ctypes.POINTER(u8p)]),
        "zoo_tfr_reader_close": (None, [ctypes.c_void_p]),
        "zoo_tfr_writer_open": (ctypes.c_void_p, [ctypes.c_char_p]),
        "zoo_tfr_writer_write": (ctypes.c_int,
                                 [ctypes.c_void_p, u8p, ctypes.c_uint64]),
        "zoo_tfr_writer_close": (ctypes.c_int, [ctypes.c_void_p]),
        "zoo_cache_create": (ctypes.c_void_p,
                             [ctypes.c_int64, ctypes.c_char_p]),
        "zoo_cache_put": (ctypes.c_int64,
                          [ctypes.c_void_p, u8p, ctypes.c_uint64]),
        "zoo_cache_len": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64]),
        "zoo_cache_get": (ctypes.c_int64, [ctypes.c_void_p, ctypes.c_int64,
                                           u8p, ctypes.c_uint64]),
        "zoo_cache_count": (ctypes.c_int64, [ctypes.c_void_p]),
        "zoo_cache_dram_used": (ctypes.c_int64, [ctypes.c_void_p]),
        "zoo_cache_destroy": (None, [ctypes.c_void_p]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args
    return lib


def library_path() -> Path:
    """Where the library for this source and these flags goes."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "zoo_native.so"


def _compile(out: Path) -> bool:
    """g++ into a temporary file beside ``out``, then renamed into
    place, so processes building at once never load a half-written
    library."""
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=str(out.parent))
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, out)
        return True
    except (subprocess.CalledProcessError, subprocess.TimeoutExpired,
            OSError) as e:
        detail = getattr(e, "stderr", b"") or b""
        logger.warning("zoo_native: the g++ build of %s failed (%s%s); "
                       "its callers take their Python routes", SRC, e,
                       (": " + detail.decode(errors="replace")[-400:])
                       if detail else "")
        try:
            os.unlink(tmp)
        except OSError:
            pass
        return False


def load() -> Optional[ctypes.CDLL]:
    """The native library, built at the first call; None where it cannot
    be built or ``ZOO_TPU_DISABLE_NATIVE`` is set."""
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        if os.environ.get("ZOO_TPU_DISABLE_NATIVE"):
            logger.warning("zoo_native: disabled by ZOO_TPU_DISABLE_NATIVE; "
                           "its callers take their Python routes")
            return None
        try:
            so = library_path()
        except OSError as e:
            logger.warning("zoo_native: cannot read %s (%s)", SRC, e)
            return None
        if not so.exists() and not _compile(so):
            return None
        try:
            _lib = _annotate(ctypes.CDLL(str(so)))
        except OSError as e:
            logger.warning("zoo_native: cannot load %s (%s); its callers "
                           "take their Python routes", so, e)
            _lib = None
        return _lib


def available() -> bool:
    return load() is not None


def record_route(caller: str, native: bool) -> str:
    """Count one call of ``caller`` on its ``native`` or ``python``
    route; returns the route's name."""
    route = "native" if native else "python"
    with _lock:
        c = _routes.setdefault(caller, {})
        c[route] = c.get(route, 0) + 1
    return route


def routes() -> Dict[str, Dict[str, int]]:
    """``{caller: {"native": n, "python": n}}`` since the last
    :func:`reset_routes`."""
    with _lock:
        return {k: dict(v) for k, v in _routes.items()}


def reset_routes() -> None:
    with _lock:
        _routes.clear()
