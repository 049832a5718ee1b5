"""Build the CUDA sources into shared libraries at first use.

Each ``zoo_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded
with ``ctypes``. The libraries go to ``build/zoo_tpu_torch/<digest>/``
at the repository root, keyed by a hash of every source and the flags,
so an edited source rebuilds and an unchanged one is reused. The
sources are compiled in parallel, one ``nvcc`` process each, all
started together. Each library is written under a temporary name and
renamed into place, so processes building at the same time never load
a half-written file.

Nothing here runs at import time: a machine without ``nvcc`` imports
this module and never builds.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "zoo_tpu_torch"

# kernel name -> its source under csrc/
SOURCES = {
    "flash_attention": "flash_attention_fwd.cu",
    "paged_decode": "paged_decode.cu",
    "paged_prefill": "paged_prefill.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: str
    seconds: float       # nvcc wall time in this process (0 if reused)
    reused: bool         # the library was already built for these sources
    ptxas: str           # nvcc's -Xptxas -v report (registers, smem)


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_results: Dict[str, BuildResult] = {}


def find_nvcc() -> str:
    """``nvcc`` from ``$CUDA_HOME``/``$CUDA_PATH``, ``$PATH``, or the
    toolkit's conventional install prefix."""
    cands = [os.path.join(os.environ[v], "bin", "nvcc")
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels of zoo_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, BuildResult]:
    """Compile the named kernels that are not built yet (in parallel)
    and return a :class:`BuildResult` for each name."""
    names = list(names)
    with _lock:
        out_dir = BUILD_ROOT / _digest()
        out_dir.mkdir(parents=True, exist_ok=True)
        todo = []
        for name in names:
            if name in _results:
                continue
            so = out_dir / f"lib{name}.so"
            log = out_dir / f"{name}.ptxas.txt"
            if so.exists():
                _results[name] = BuildResult(
                    name, str(so), 0.0, True,
                    log.read_text() if log.exists() else "")
            else:
                todo.append((name, so, log))
        if todo:
            nvcc = find_nvcc()
            t0 = time.perf_counter()
            procs = []
            for name, so, log in todo:
                tmp = so.with_name(f".{so.name}.{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / SOURCES[name])]
                procs.append((name, so, log, tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for name, so, log, tmp, proc in procs:
                report, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"--- {name} (nvcc exit "
                                  f"{proc.returncode})\n{report}")
                    continue
                log.write_text(report)
                os.replace(tmp, so)
                _results[name] = BuildResult(
                    name, str(so), time.perf_counter() - t0, False, report)
            if failed:
                raise RuntimeError("building the CUDA kernels failed:\n"
                                   + "\n".join(failed))
        return {name: _results[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built if needed)."""
    lib = _libs.get(name)
    if lib is None:
        path = build([name])[name].path
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = _libs[name] = ctypes.CDLL(path)
                lib.zt_error_string.argtypes = [ctypes.c_int]
                lib.zt_error_string.restype = ctypes.c_char_p
    return lib
