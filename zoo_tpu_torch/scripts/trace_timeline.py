#!/usr/bin/env python
"""Join the fleet's per-process trace files into per-request timelines
(copy of ``scripts/trace_timeline.py`` on ``zoo_tpu_torch``).

Every serving process writes ``trace-<host>-<pid>.jsonl`` under
``$ZOO_TRACE_DIR``; a request's trace id rides
the wire, so its spans are scattered across the client's file, every
replica it touched (hedges and failovers included), and — after a
mid-stream SIGKILL — a dead process's torn file. This CLI reassembles
them:

    # which requests are in this trace dir?
    python -m zoo_tpu_torch.scripts.trace_timeline /tmp/trace --list

    # one request's merged timeline, as a terminal tree
    python -m zoo_tpu_torch.scripts.trace_timeline /tmp/trace --trace <id>

    # the same, as Chrome/Perfetto trace JSON
    python -m zoo_tpu_torch.scripts.trace_timeline /tmp/trace --trace <id> \\
        --chrome request.json
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zoo_tpu_torch.scripts.trace_timeline",
        description="merge per-process trace JSONL into per-request "
                    "timelines")
    ap.add_argument("trace_dir", help="directory of trace-*.jsonl files "
                                      "($ZOO_TRACE_DIR)")
    ap.add_argument("--trace", help="trace id to reconstruct")
    ap.add_argument("--list", action="store_true",
                    help="list trace ids with event/process counts")
    ap.add_argument("--chrome", metavar="OUT.json",
                    help="write the timeline as Chrome trace-event JSON")
    ns = ap.parse_args(argv)

    from zoo_tpu_torch.obs.timeline import (
        build_timeline,
        group_traces,
        load_events,
        render_text,
        to_chrome_trace,
    )

    events = load_events(ns.trace_dir)
    if not events:
        print(f"no trace events under {ns.trace_dir}", file=sys.stderr)
        return 1
    traces = group_traces(events)

    if ns.list or not ns.trace:
        print(f"{len(traces)} trace(s) across "
              f"{len({e.get('file') for e in events})} process file(s):")
        for tid, evs in sorted(traces.items(),
                               key=lambda kv: kv[1][0].get("ts", 0.0)):
            names = [e.get("name") for e in evs]
            roots = [n for n in names
                     if n in ("client.generate", "client.rpc",
                              "http.predict")]
            procs = len({e.get("file") for e in evs})
            print(f"  {tid}  {len(evs):4d} events  {procs} process(es)"
                  + (f"  [{roots[0]}]" if roots else ""))
        return 0

    timeline = build_timeline(traces.get(ns.trace, []))
    if not timeline:
        print(f"trace {ns.trace} not found (use --list)",
              file=sys.stderr)
        return 1
    if ns.chrome:
        with open(ns.chrome, "w", encoding="utf-8") as f:
            json.dump(to_chrome_trace(timeline, trace_id=ns.trace), f)
        print(f"wrote {len(timeline)} events to {ns.chrome} "
              "(open in chrome://tracing or ui.perfetto.dev)")
        return 0
    print(f"trace {ns.trace}: {len(timeline)} events across "
          f"{len({e.get('file') for e in timeline})} process(es)")
    print(render_text(timeline))
    return 0


if __name__ == "__main__":
    sys.exit(main())
