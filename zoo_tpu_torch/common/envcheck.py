"""Environment doctor of the port (counterpart of
``zoo_tpu/common/envcheck.py``).

Checks what a run of the port on a card needs: python, torch and the
CUDA it was built for, the device's name and compute capability (the
kernels are built for ``sm_90a``), ``nvcc`` to build them, the
coordinator variables a launcher hands a worker (a partial set fails),
and the live runtime context.

``python -m zoo_tpu_torch.common.envcheck`` prints the report and exits
non-zero when a required item fails.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import List, Tuple

from zoo_tpu_torch.common import knobs


def _nvcc() -> str:
    """The nvcc the kernel build uses: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else the one on the path."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return shutil.which("nvcc") or ""


def collect() -> List[Tuple[str, bool, str]]:
    """(name, ok, detail) triples; ok=False on a required item's
    failure. On a machine without a card, the device and nvcc rows
    report and pass: the CPU route needs neither."""
    out: List[Tuple[str, bool, str]] = []
    out.append(("python", True, sys.version.split()[0]))

    cuda = False
    try:
        import torch
        cuda = torch.cuda.is_available()
        out.append(("torch", True,
                    f"{torch.__version__} cuda={torch.version.cuda} "
                    f"devices={torch.cuda.device_count() if cuda else 0}"))
        if cuda:
            i = torch.cuda.current_device()
            cap = torch.cuda.get_device_capability(i)
            out.append(("device", tuple(cap) == (9, 0),
                        f"{torch.cuda.get_device_name(i)} sm_{cap[0]}{cap[1]}"
                        + ("" if tuple(cap) == (9, 0) else
                           " — the kernels are built for sm_90a (Hopper)")))
        else:
            out.append(("device", True, "no CUDA device (the CPU route "
                                        "only: devices=['cpu'])"))
    except Exception as e:  # noqa: BLE001 — the report IS the handler
        out.append(("torch", False, f"unavailable: {e!r}"))

    nvcc = _nvcc()
    out.append(("nvcc", bool(nvcc) or not cuda,
                nvcc or "not found (needed to build the kernels)"))

    coord = knobs.value("ZOO_COORDINATOR_ADDRESS")
    if coord:
        world = knobs.value("ZOO_NUM_PROCESSES")
        rank = knobs.value("ZOO_PROCESS_ID")
        # a launcher sets all three: a partial set must FAIL the
        # preflight, not pass as healthy
        ok = world is not None and rank is not None
        out.append(("coordinator", ok,
                    f"{coord} (world {world}, rank {rank})"
                    + ("" if ok else
                       " — ZOO_NUM_PROCESSES/ZOO_PROCESS_ID missing")))

    try:
        from zoo_tpu_torch.common.context import get_runtime_context
        ctx = get_runtime_context(required=False)
        if ctx is not None:
            out.append(("orca context", True,
                        f"mode={ctx.cluster_mode} platform={ctx.platform} "
                        f"mesh={dict(ctx.mesh.shape)}"))
        else:
            out.append(("orca context", True,
                        "not initialized (init_orca_context())"))
    except Exception as e:  # noqa: BLE001
        out.append(("orca context", False, repr(e)))

    for mod, required in (("numpy", True), ("pandas", False),
                          ("pyarrow", False), ("triton", False)):
        try:
            import importlib
            m = importlib.import_module(mod)
            out.append((mod, True, getattr(m, "__version__", "ok")))
        except ImportError:
            out.append((mod, not required, "not installed"
                        + (" (REQUIRED)" if required else " (optional)")))
    return out


def main(argv=None) -> int:
    rows = collect()
    width = max(len(n) for n, _, _ in rows)
    ok_all = True
    for name, ok, detail in rows:
        mark = "ok " if ok else "FAIL"
        ok_all &= ok
        print(f"[{mark}] {name:<{width}}  {detail}")
    return 0 if ok_all else 1


if __name__ == "__main__":
    sys.exit(main())
