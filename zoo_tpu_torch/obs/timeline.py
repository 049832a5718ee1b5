"""Per-request timeline reconstruction from per-process trace files
(counterpart of ``zoo_tpu/obs/timeline.py``, whole).

Every process in the serving fleet writes its own
``trace-<host>-<pid>.jsonl`` (:mod:`zoo_tpu_torch.obs.tracing`); a request's
trace id rides the wire (``trace`` field on the ZSXN frames,
``X-Zoo-Trace`` on the HTTP front end) and every hop stamps its spans
with it — client attempts, hedged duplicates, admission, prefill
chunks, engine lifecycle, sheds. This module joins those files back
into ONE timeline per request:

* :func:`load_events` — all trace events under a directory (or an
  explicit file list), torn/truncated lines skipped (a SIGKILLed
  replica tears its last line by design);
* :func:`group_traces` — events bucketed by trace id;
* :func:`build_timeline` — one trace's events folded into spans:
  ``B``/``E`` pairs matched by span id (a ``B`` whose ``E`` never came
  — the killed replica's in-flight work — survives as an OPEN span),
  ``X`` complete spans and ``I`` instants pass through;
* :func:`to_chrome_trace` — the same timeline as Chrome
  ``chrome://tracing`` / Perfetto JSON (one ``pid`` row per process,
  so a failover reads as the request hopping rows);
* :func:`render_text` — a terminal tree for quick triage.

``zoo_tpu_torch/scripts/trace_timeline.py`` is the CLI over these.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

from zoo_tpu_torch.obs.tracing import iter_jsonl

__all__ = [
    "load_events", "group_traces", "build_timeline", "merge_timeline",
    "to_chrome_trace", "render_text",
]


def load_events(path: str, files: Optional[Sequence[str]] = None
                ) -> List[dict]:
    """Every trace event under directory ``path`` (or just ``files``),
    each annotated with its source ``file`` — the per-process identity
    that distinguishes a killed replica's spans from its successor's
    when the pid was recycled. Torn lines are skipped, never raised."""
    if files is None:
        if not os.path.isdir(path):
            return []
        files = sorted(
            os.path.join(path, f) for f in os.listdir(path)
            if f.startswith("trace-") and f.endswith(".jsonl"))
    events: List[dict] = []
    for fpath in files:
        fname = os.path.basename(fpath)
        for ev in iter_jsonl(fpath):
            ev.setdefault("file", fname)
            events.append(ev)
    events.sort(key=lambda e: e.get("ts", 0.0))
    return events


def group_traces(events: Iterable[dict]) -> Dict[str, List[dict]]:
    """Events bucketed by trace id (events without one are dropped —
    they belong to no request)."""
    out: Dict[str, List[dict]] = {}
    for ev in events:
        tid = ev.get("trace")
        if tid:
            out.setdefault(tid, []).append(ev)
    return out


def build_timeline(events: Iterable[dict]) -> List[dict]:
    """Fold one trace's raw events into timeline entries, sorted by
    start time. Each entry::

        {"name", "ts", "dur_s" | None, "span", "parent", "pid",
         "file", "kind": "span" | "instant", "open": bool,
         "ok": bool, "attrs": {...}}

    ``open=True`` marks a ``B`` whose ``E`` never arrived — exactly
    what a mid-stream SIGKILL leaves behind; its partial work is still
    on the timeline instead of vanishing with the process."""
    begins: Dict[str, dict] = {}
    out: List[dict] = []
    for ev in events:
        kind = ev.get("ev")
        if kind == "B":
            sid = ev.get("span")
            entry = {"name": ev.get("name"), "ts": ev.get("ts", 0.0),
                     "dur_s": None, "span": sid,
                     "parent": ev.get("parent"), "pid": ev.get("pid"),
                     "file": ev.get("file"), "kind": "span",
                     "open": True, "ok": True,
                     "attrs": ev.get("attrs") or {}}
            out.append(entry)
            if sid:
                begins[sid] = entry
        elif kind == "E":
            entry = begins.pop(ev.get("span"), None)
            if entry is None:
                # E without its B (the B was the torn line): synthesize
                # a zero-width closed span so the end is still visible
                out.append({"name": ev.get("name"),
                            "ts": ev.get("ts", 0.0),
                            "dur_s": ev.get("dur_s", 0.0),
                            "span": ev.get("span"), "parent": None,
                            "pid": ev.get("pid"), "file": ev.get("file"),
                            "kind": "span", "open": False,
                            "ok": bool(ev.get("ok", True)), "attrs": {}})
            else:
                entry["dur_s"] = ev.get("dur_s")
                entry["open"] = False
                entry["ok"] = bool(ev.get("ok", True))
        elif kind == "X":
            out.append({"name": ev.get("name"), "ts": ev.get("ts", 0.0),
                        "dur_s": ev.get("dur_s", 0.0),
                        "span": ev.get("span"),
                        "parent": ev.get("parent"),
                        "pid": ev.get("pid"), "file": ev.get("file"),
                        "kind": "span", "open": False,
                        "ok": bool(ev.get("ok", True)),
                        "attrs": ev.get("attrs") or {}})
        elif kind == "I":
            out.append({"name": ev.get("name"), "ts": ev.get("ts", 0.0),
                        "dur_s": None, "span": ev.get("span"),
                        "parent": ev.get("parent"),
                        "pid": ev.get("pid"), "file": ev.get("file"),
                        "kind": "instant", "open": False, "ok": True,
                        "attrs": ev.get("attrs") or {}})
    out.sort(key=lambda e: e.get("ts", 0.0))
    return out


def merge_timeline(path: str, trace_id: str,
                   files: Optional[Sequence[str]] = None) -> List[dict]:
    """The one-call join: all processes' trace files under ``path`` →
    the single request timeline for ``trace_id``."""
    return build_timeline(
        group_traces(load_events(path, files=files)).get(trace_id, []))


def to_chrome_trace(timeline: List[dict],
                    trace_id: Optional[str] = None) -> dict:
    """A timeline as Chrome trace-event JSON (``chrome://tracing`` /
    Perfetto). Processes map to trace rows, so a failover mid-request
    reads as the request hopping from one row to another; OPEN spans
    (killed mid-work) render with an ``[open]`` suffix and whatever
    duration was observed before the process died (0 if unknown)."""
    events = []
    pids = {}
    for e in timeline:
        key = e.get("file") or e.get("pid") or 0
        pid = pids.setdefault(key, len(pids) + 1)
        ts_us = float(e.get("ts", 0.0)) * 1e6
        args = dict(e.get("attrs") or {})
        if e.get("span"):
            args["span"] = e["span"]
        if e.get("parent"):
            args["parent"] = e["parent"]
        if e["kind"] == "instant":
            events.append({"name": e["name"], "ph": "i", "s": "p",
                           "ts": ts_us, "pid": pid, "tid": 1,
                           "args": args})
            continue
        name = e["name"] + (" [open]" if e.get("open") else "")
        dur = e.get("dur_s")
        events.append({"name": name, "ph": "X", "ts": ts_us,
                       "dur": float(dur) * 1e6 if dur else 0.0,
                       "pid": pid, "tid": 1, "args": args})
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "args":
             {"name": str(key)}} for key, pid in pids.items()]
    out = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    if trace_id:
        out["otherData"] = {"trace_id": trace_id}
    return out


def render_text(timeline: List[dict]) -> str:
    """A flat, time-ordered terminal rendering (one line per entry,
    offset from the first event, duration, source process)."""
    if not timeline:
        return "(no events)"
    t0 = timeline[0].get("ts", 0.0)
    lines = []
    for e in timeline:
        off = (e.get("ts", 0.0) - t0) * 1e3
        if e["kind"] == "instant":
            dur = "      --  "
        elif e.get("open"):
            dur = "    OPEN  "
        else:
            dur = f"{(e.get('dur_s') or 0.0) * 1e3:8.2f}ms"
        src = str(e.get("file") or e.get("pid") or "?")
        attrs = ""
        if e.get("attrs"):
            attrs = "  " + json.dumps(e["attrs"], sort_keys=True,
                                      default=str)
        flag = "" if e.get("ok", True) else "  !err"
        lines.append(f"+{off:10.2f}ms  {dur}  {e['name']:<28s} "
                     f"[{src}]{flag}{attrs}")
    return "\n".join(lines)
