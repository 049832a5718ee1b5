#!/usr/bin/env python
"""End-to-end trace-propagation chaos smoke over the port (copy of
``scripts/check_trace_e2e.py`` on ``zoo_tpu_torch``): a REAL 3-replica
``llama:tiny`` :class:`ReplicaGroup` on ``--device`` (separate
supervised processes,
all tracing into one ``ZOO_TRACE_DIR``), hedged ``generate`` traffic
through :class:`HAServingClient`, one replica SIGKILLed mid-stream —
and the observability contract holds:

* ZERO client-visible failures (failover-resume absorbs the kill);
* for a stream that crossed the kill, the timeline merger reconstructs
  — from the per-process JSONL files alone — ONE trace containing the
  client's attempt spans (>= 2: the original plus the failover resume)
  AND engine/server spans from BOTH replicas (the killed one's partial
  spans survive in its torn file);
* a postmortem bundle for the killed replica is harvested into the
  group dir (the SIGKILL left no chance to dump — the bundle is
  rebuilt from the continuously-flushed flight spill);
* every shed/error reply carries the request's trace id (probed via a
  deliberately unserved model-version predict).

Run directly (``python -m zoo_tpu_torch.scripts.check_trace_e2e
--device cpu``; no ``--device`` = the current CUDA device) or from the
suite (``tests/test_torch_obs.py`` runs it under the ``obs`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# small pool + small buckets bound each replica's boot, as in
# check_llm_serving
SPEC = "llama:tiny:slots=4,block=8,blocks=96,tables=8,buckets=16/32"


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    import zoo_tpu_torch.obs as obs
    from zoo_tpu_torch.obs.timeline import group_traces, load_events
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient

    work = tempfile.mkdtemp(prefix="zoo-trace-e2e-")
    trace_dir = os.path.join(work, "trace")
    log_dir = os.path.join(work, "logs")
    # the CLIENT traces too — its attempt spans land beside the
    # replicas' files in the same dir
    obs.trace_to(trace_dir)

    group = ReplicaGroup(
        SPEC, num_replicas=3, max_restarts=2, log_dir=log_dir,
        env={"ZOO_TRACE_DIR": trace_dir, "ZOO_OBS_FLIGHT_CAP": "512"},
        device=device)
    group.start(timeout=240)
    client = HAServingClient(group.endpoints(), deadline_ms=240_000,
                             hedge=True, hedge_delay_ms=500)

    rs = np.random.RandomState(0)
    n_streams = 8
    prompts = [rs.randint(0, 256, (int(rs.randint(3, 15)),)).astype(
        np.int32) for _ in range(n_streams)]
    max_new = [24 if i % 2 == 0 else 8 for i in range(n_streams)]
    trace_ids = [f"{i:02d}" + os.urandom(15).hex() for i in
                 range(n_streams)]

    # warm both executables on every replica off the chaos clock
    from zoo_tpu_torch.serving.tcp_client import _Connection
    for host, port in group.endpoints():
        conn = _Connection(host, port)
        for _ in conn.stream({"op": "generate", "prompt": prompts[0],
                              "max_new_tokens": 2}):
            pass
        conn.close()

    errors, done_ok = [], [0]
    lock = threading.Lock()
    first_tokens = threading.Event()
    killed = threading.Event()

    def stream_worker(i):
        try:
            got = []
            for tok in client.generate(prompts[i], max_new[i],
                                       trace_id=trace_ids[i]):
                got.append(tok)
                first_tokens.set()
            if len(got) != max_new[i]:
                raise AssertionError(
                    f"stream {i}: {len(got)} tokens, wanted "
                    f"{max_new[i]}")
            with lock:
                done_ok[0] += 1
        except Exception as e:  # noqa: BLE001 — every failure counts
            with lock:
                errors.append(f"stream {i}: {e!r}")

    def chaos():
        first_tokens.wait(timeout=180)
        group.kill_replica(0)
        killed.set()

    try:
        threads = [threading.Thread(target=stream_worker, args=(i,))
                   for i in range(n_streams)]
        threads.append(threading.Thread(target=chaos))
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert killed.is_set(), "the chaos kill never fired"
        assert not errors, (
            f"{len(errors)} client-visible failure(s):\n"
            + "\n".join(errors[:10]))
        assert done_ok[0] == n_streams, done_ok

        # ---- the timeline acceptance: SOME stream crossed the kill and
        # reconstructs into one trace with >= 2 client attempts and
        # engine/server spans from >= 2 distinct replica processes
        obs.stop_tracing()  # flush the client's file
        events = load_events(trace_dir)
        traces = group_traces(events)
        crossed = None
        for tid in trace_ids:
            evs = traces.get(tid, [])
            attempts = [e for e in evs
                        if e.get("name") == "client.attempt"]
            server_files = {e.get("file") for e in evs
                            if str(e.get("name", "")).startswith(
                                ("server.", "llm."))}
            if len(attempts) >= 2 and len(server_files) >= 2:
                crossed = (tid, len(attempts), len(server_files), evs)
                break
        assert crossed is not None, (
            "no stream reconstructs with >=2 client attempts and "
            ">=2 replicas' spans under one trace id; the kill was "
            "absorbed without failover?")
        tid, n_att, n_files, evs = crossed
        # one trace id throughout, engine lifecycle present
        assert all(e.get("trace") == tid for e in evs)
        names = {e.get("name") for e in evs}
        assert "llm.admit" in names, names
        assert "client.generate" in names, names

        # ---- postmortem: the killed replica left a flight spill; the
        # harvest packages it into the group dir
        deadline = time.monotonic() + 30
        bundles = []
        while time.monotonic() < deadline:
            bundles = group.harvest_postmortems()
            if bundles:
                break
            time.sleep(0.3)
        existing = []
        pm_dir = group.postmortem_dir()
        if pm_dir and os.path.isdir(pm_dir):
            existing = [f for f in os.listdir(pm_dir)
                        if f.endswith(".json")]
        assert bundles or existing, (
            "no postmortem bundle harvested from the killed replica")
        import json as _json
        bpath = bundles[0] if bundles else os.path.join(pm_dir,
                                                        existing[0])
        with open(bpath, encoding="utf-8") as f:
            bundle = _json.load(f)
        assert bundle.get("ring"), "harvested bundle has an empty ring"

        # ---- shed/error replies echo the trace id: a version-pinned
        # predict against llm-only replicas errors (llm replicas serve
        # generate only), and the reply must still carry the trace
        conn = _Connection(*group.endpoints()[1])
        probe_tid = "ee" * 16
        resp = conn.rpc({"op": "predict", "uri": "u",
                         "data": np.zeros((1, 2), np.float32),
                         "trace": probe_tid})
        conn.close()
        assert "error" in resp and resp.get("trace") == probe_tid, resp
    finally:
        obs.stop_tracing()
        group.stop()

    if verbose:
        print(f"TRACE E2E OK: {done_ok[0]}/{n_streams} hedged streams "
              f"across a replica SIGKILL, 0 failures; trace {tid[:8]}… "
              f"reconstructed with {n_att} client attempts over "
              f"{n_files} replica processes; postmortem bundle "
              f"harvested with {len(bundle['ring'])} ring event(s); "
              "shed/error replies echo trace ids")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
