"""Trace reader: the per-kernel device-time breakdown of a profiled
window (counterpart of ``zoo_tpu/common/xplane.py``, kept at the
mirrored path and with its public functions).

It reads ``torch.profiler``'s Chrome trace (the JSON that
:func:`zoo_tpu_torch.common.profiling.trace` and ``KerasNet.
set_profile(trace_dir)`` write), not XLA's XPlane protobuf: device
events are the complete (``"ph": "X"``) events of category ``kernel``,
and, under ``include_async``, the copies and fills (``gpu_memcpy``,
``gpu_memset``: the counterpart of XPlane's ``Async XLA Ops`` line).
Host events, step annotations (``ProfilerStep#n``, category
``gpu_user_annotation`` on the device side) and flow events are never
mixed into the breakdown, as the JAX reader leaves the ``Steps`` and
``XLA Modules`` lines out.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Tuple

__all__ = ["device_op_times", "op_breakdown", "kernel_name"]

KERNEL_CATS = ("kernel",)
ASYNC_CATS = ("gpu_memcpy", "gpu_memset")


def _events(path: str) -> List[dict]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def device_op_times(path: str, include_async: bool = False
                    ) -> Dict[str, Tuple[float, int]]:
    """``{event name: (total ms, count)}`` of the device's kernels in
    the trace at ``path`` (plus its copies and fills when
    ``include_async``). Durations are the trace's (microseconds)."""
    cats = KERNEL_CATS + (ASYNC_CATS if include_async else ())
    out: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for e in _events(path):
        if e.get("ph") != "X" or e.get("cat") not in cats:
            continue
        a = out[e.get("name", "")]
        a[0] += float(e.get("dur", 0.0))
        a[1] += 1
    return {k: (v[0] / 1e3, v[1]) for k, v in out.items()}


_OP_RE = re.compile(r"= \S+? (\w[\w.-]*?)\(")
_KIND_RE = re.compile(r"kind=(k\w+)")


def kernel_name(name: str) -> str:
    """A demangled CUDA kernel's bare name: ``void ns::conv_tc_kernel<
    128, 3>(Params)`` -> ``conv_tc_kernel``; other names unchanged."""
    n = name
    if not (n.startswith("void ") or "<" in n or "::" in n):
        return n   # a plain name, or a copy's ("Memcpy HtoD (...)")
    if n.startswith("void "):
        n = n[len("void "):]
    cut = [i for i in (n.find("<"), n.find("(")) if i >= 0]
    if cut:
        n = n[:min(cut)]
    return n.rsplit("::", 1)[-1]


def op_breakdown(path: str, top: int = 20, include_async: bool = False
                 ) -> List[Tuple[str, float, int]]:
    """:func:`device_op_times` grouped by kernel (the bare name of
    :func:`kernel_name`, then the JAX reader's grouping: the first word,
    40 characters at most, so ``Memcpy HtoD (Pinned -> Device)`` counts
    as ``Memcpy``); ``[(name, total ms, count)]``, most time first."""
    byop: Dict[str, List] = defaultdict(lambda: [0.0, 0])
    for nm, (ms, cnt) in device_op_times(
            path, include_async=include_async).items():
        nm = kernel_name(nm)
        m = _OP_RE.search(nm)
        key = m.group(1) if m else nm.split(" ")[0][:40]
        root = key.lstrip("%").split(".")[0].split("(")[0]
        if root in ("while", "call", "conditional"):
            continue
        if "fusion" in nm[:80] or "fusion" in key:
            km = _KIND_RE.search(nm)
            if km:
                key = f"fusion/{km.group(1)}"
            else:
                stem = re.sub(r"[.]\d+$", "",
                              nm.split(" ")[0].lstrip("%"))
                key = f"fusion/{stem[:48]}"
        byop[key][0] += ms
        byop[key][1] += cnt
    rows = sorted(((k, v[0], v[1]) for k, v in byop.items()),
                  key=lambda r: -r[1])
    return rows[:top]
