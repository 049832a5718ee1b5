#!/usr/bin/env python
"""Prefix-cache chaos smoke END TO END over the port (copy of
``scripts/check_prefix_cache.py`` on ``zoo_tpu_torch``): a REAL
2-replica :class:`ReplicaGroup` on ``--device`` serving a ``llama:`` spec with **prefix caching
ON** (``prefix_cache=1``) and chunked prefill, many concurrent streams
sharing one 400-token system prefix, one replica SIGKILLed mid-storm —
and the bytes-per-token contracts of this PR hold:

* **byte-identical to the no-cache reference** — every stream through
  the cached group matches a local engine built from the same spec
  WITHOUT prefix caching (same seed-0 weights), greedy and seeded
  sampling both, across the kill/failover;
* **the shared prefix is actually shared** — the per-replica
  ``llm_stats`` prefix hit counters account for at least the expected
  number of full-prefix hits (cold prefills are bounded by one per
  replica boot + one per respawn);
* **zero leaked blocks** — after all frees every replica's allocator
  accounts to zero live blocks, with the remainder split between the
  free list and the parked (refcount-0, matchable) prefix-cache LRU;
* **a respawned replica re-warms** — the post-kill phase runs more
  shared-prefix streams through the fresh process without correctness
  loss (its first one re-registers the prefix, the rest hit).

The JAX script's executable census (one decode executable, at most one
chunk-prefill executable) becomes a path census: the port runs eagerly
and ``compile_counts()`` counts calls per path (ROADMAP A.1 makes it
count captured graphs), so each replica must show decode ticks and
chunk-prefill calls.

Run directly (``python -m zoo_tpu_torch.scripts.check_prefix_cache
--device cpu``) or from the suite (``tests/test_torch_ha.py`` runs it
under the ``perf`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from zoo_tpu_torch.scripts.check_llm_serving import replicas_up  # noqa: E402

PREFIX_LEN = 400
BASE = ("llama:tiny:slots=4,block=8,blocks=192,tables=64,"
        "buckets=16/512,chunk=32")
SPEC = BASE + ",prefix_cache=1"
N_STREAMS = 8           # phase 1 (warm cache) + phase 2 (chaos) halves
# hit floor: every replica's cache is warmed by ONE explicit cold
# stream before its phase, so all 8 client streams should hit the
# 400-token prefix. The SIGKILL wipes the dead replica's counters with
# its process, so the floor only counts what provably lands on the
# survivor: its phase-1 share (>= 2 of 4 round-robin streams) plus all
# 4 phase-2 streams (routed or failed-over there), minus slack for
# routing skew
EXPECTED_HIT_TOKENS = 4 * PREFIX_LEN


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.llm.spec import build_llm_engine
    from zoo_tpu_torch.serving.tcp_client import _Connection

    rs = np.random.RandomState(0)
    prefix = rs.randint(0, 256, (PREFIX_LEN,)).astype(np.int32)
    prompts = [np.concatenate([prefix, rs.randint(
        0, 256, (int(rs.randint(3, 12)),)).astype(np.int32)])
        for _ in range(N_STREAMS)]
    max_new = [8 if i % 2 else 5 for i in range(N_STREAMS)]
    sampling = [dict(temperature=0.9, top_k=24, top_p=0.95,
                     seed=2000 + i) if i % 3 == 0 else {}
                for i in range(N_STREAMS)]

    # ground truth: the SAME spec WITHOUT prefix caching, in-process —
    # bit-identical seed-0 weights, so cached remote streams must match
    # byte for byte
    ref_eng = build_llm_engine(BASE, device=device)
    try:
        handles = [ref_eng.submit(p, n, sampling=s or None,
                                  rid=f"ref-{i}")
                   for i, (p, n, s) in enumerate(
                       zip(prompts, max_new, sampling))]
        deadline = time.monotonic() + 600
        while not all(h.done for h in handles):
            assert time.monotonic() < deadline, "reference streams stuck"
            time.sleep(0.01)
        assert all(h.outcome == "ok" for h in handles), \
            [(h.outcome, h.error) for h in handles]
        refs = [list(h.tokens) for h in handles]
        assert ref_eng.stats()["prefix_hit_tokens"] == 0
    finally:
        ref_eng.stop()

    log_dir = tempfile.mkdtemp(prefix="zoo-prefix-cache-smoke-")
    group = ReplicaGroup(SPEC, num_replicas=2, max_restarts=2,
                         log_dir=log_dir, device=device)
    group.start(timeout=180)
    client = HAServingClient(group.endpoints(), deadline_ms=300_000,
                             hedge=False)
    errors, lock = [], threading.Lock()

    def stream_worker(i, notify=None):
        try:
            got = []
            for tok in client.generate(prompts[i], max_new[i],
                                       **sampling[i]):
                got.append(tok)
                if notify is not None:
                    notify.set()
            if got != refs[i]:
                raise AssertionError(
                    f"stream {i} (prefix-cached) != no-cache "
                    f"reference: {got} vs {refs[i]}")
        except Exception as e:  # noqa: BLE001 — every failure counts
            with lock:
                errors.append(f"stream {i}: {e!r}")

    def run_phase(indices):
        threads = [threading.Thread(target=stream_worker, args=(i,))
                   for i in indices]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

    def replica_stats():
        out = []
        for host, port in group.endpoints():
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                try:
                    conn = _Connection(host, port)
                    stats = conn.rpc({"op": "llm_stats"})["stats"]
                    conn.close()
                    out.append(stats)
                    break
                except OSError:
                    time.sleep(0.3)   # respawn window
            else:
                raise AssertionError(f"no llm_stats from {host}:{port}")
        return out

    def warm_replica(host, port):
        """One explicit cold stream per replica registers the shared
        prefix (executables compile on the same call), so the
        concurrent storm measures SHARING, not a thundering herd of
        simultaneous cold admissions."""
        conn = _Connection(host, port)
        for _ in conn.stream({"op": "generate",
                              "prompt": np.concatenate(
                                  [prefix, prefix[:2]]),
                              "max_new_tokens": 2}):
            pass
        conn.close()

    try:
        for host, port in group.endpoints():
            warm_replica(host, port)

        # phase 1: concurrent shared-prefix streams over the warm group
        run_phase(range(N_STREAMS // 2))
        assert not errors, "\n".join(errors[:10])

        # phase 2 + chaos: SIGKILL one replica while its streams are
        # mid-flight — failover resumes on the survivor, whose warm
        # cache turns even the resumed re-prefills into hits
        first_tokens = threading.Event()
        threads = [threading.Thread(target=stream_worker,
                                    args=(i, first_tokens))
                   for i in range(N_STREAMS // 2, N_STREAMS)]
        for t in threads:
            t.start()
        first_tokens.wait(timeout=120)   # kill lands mid-decode
        group.kill_replica(0)
        for t in threads:
            t.join()
        assert not errors, (
            f"{len(errors)} failure(s):\n" + "\n".join(errors[:10]))

        # the supervisor must respawn the dead seat; its cache died
        # with it, and ONE re-warm stream restores fleet-wide sharing
        if replicas_up(group, 90) != 2:
            raise AssertionError("killed replica never respawned")
        respawned = group.endpoints()[0]
        warm_replica(*respawned)
        conn = _Connection(*respawned)
        st = conn.rpc({"op": "llm_stats"})["stats"]
        conn.close()
        assert st.get("blocks_cached", 0) > 0, (
            f"respawned replica did not re-warm the prefix cache: {st}")

        stats = replica_stats()
        hits = sum(s.get("prefix_hit_tokens", 0) for s in stats)
        assert hits >= EXPECTED_HIT_TOKENS, (
            f"prefix hit tokens {hits} < expected "
            f"{EXPECTED_HIT_TOKENS} — the cache is not being shared "
            f"({[s.get('prefix_hit_tokens') for s in stats]})")
        for s, (host, port) in zip(stats, group.endpoints()):
            assert s["prefix_cache"] is True, s
            assert s["blocks_used"] == 0, (
                f"replica {host}:{port} leaked {s['blocks_used']} "
                "KV block(s)")
            assert s["blocks_free"] + s["blocks_cached"] == \
                s["num_blocks"] - 1, (
                f"replica {host}:{port} pool does not account: {s}")
            compiles = s.get("compiles", {})
            assert compiles.get("decode", 0) > 0, compiles
            assert compiles.get("prefill_chunk", 0) > 0, compiles
        assert group.restarts() >= 1, "no respawn recorded"
    finally:
        client.close()
        group.stop()

    if verbose:
        print(f"PREFIX CACHE OK: {N_STREAMS}/{N_STREAMS} shared-prefix "
              f"streams byte-identical to the no-cache reference "
              f"across a replica SIGKILL, {hits} prefix hit tokens "
              f"(>= {EXPECTED_HIT_TOKENS}), 0 leaked blocks, "
              f"decode and chunk-prefill paths on 2/2 replicas")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the reference engine's and the replicas' torch "
                         "device (default: the current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
