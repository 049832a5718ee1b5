#!/usr/bin/env python
"""Disaggregated-serving chaos smoke END TO END over the port (copy of
``scripts/check_disagg.py`` on ``zoo_tpu_torch``): a REAL 3-replica
:class:`ReplicaGroup` split into roles — 1 prefill + 2 decode seats of
a tiny ``llama:`` spec on ``--device`` — under a mixed storm of long
prompts (routed through the two-leg ``kv_migrate`` KV handoff) and short
prompts (plain single-leg streams on the decode seats), then a SIGKILL
of the prefill replica **mid-handoff** (a chaos delay armed on the
``serving.kv_migrate.push`` seam over the wire ``chaos`` op holds the
push open while the kill lands).

The contract this smoke asserts:

1. every stream — long and short, greedy and seeded, before, during and
   after the kill — is byte-identical to the same prompt's stream from
   an engine of the same spec in this process: ZERO client-visible
   failures, no gap, duplicate, or garbage token;
2. handoffs happened: the decode seats adopted migrated KV blocks
   (``zoo_llm_kv_migrated_blocks_total`` > 0 on their /metrics,
   ``handoffs_in`` > 0 in their ``llm_stats``);
3. zero leaked KV blocks on every seat once the storm drains (the
   killed seat respawns with a fresh, empty allocator);
4. the killed prefill replica respawned on its original port with its
   role kept — 3/3 healthy, and a long prompt hands off through it
   again.

Run directly (``python -m zoo_tpu_torch.scripts.check_disagg --device
cpu``; no ``--device`` = the current CUDA device) or from the suite
(``tests/test_torch_disagg.py`` runs it under the ``chaos`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SEED = int(os.environ.get("ZOO_CHAOS_SEED", "20817") or 20817)
SPEC = "llama:tiny:slots=2,block=4,blocks=96,tables=8,buckets=16/32"
ROLES = ["prefill", "decode", "decode"]
STORM_S = 3.5          # phase-1 mixed storm horizon
MIN_STREAMS = 5        # ... extended (up to STORM_CAP_S) until each
STORM_CAP_S = 60.0     # kind has this many streams: a loaded CPU is slow
LONG_PROMPT = 18       # >= MIGRATE_MIN -> handoff path
SHORT_PROMPT = 3       # < MIGRATE_MIN  -> plain decode-seat stream
MIGRATE_MIN = 16
POOL = 12              # distinct prompts of each length
MAX_NEW = 8
SEEDED = {"temperature": 0.9, "seed": 11}


def references(device):
    """Each pooled prompt's greedy and seeded ``MAX_NEW``-token streams
    from an engine of ``SPEC`` in this process (the replicas build the
    same seeded weights); a shorter stream is a prefix of these."""
    import numpy as np

    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(SEED)
    prompts = [[int(t) for t in rs.randint(0, 256, size=n)]
               for n in (LONG_PROMPT, SHORT_PROMPT) for _ in range(POOL)]
    eng = build_llm_engine(SPEC, device=device)
    try:
        refs = {}
        for seeded in (False, True):
            hs = [eng.submit(p, MAX_NEW, rid=f"ref{seeded}-{i}",
                             sampling=SEEDED if seeded else None)
                  for i, p in enumerate(prompts)]
            for h in hs:
                while not h.done:
                    h.wait_new(len(h.tokens), 1.0)
            for p, h in zip(prompts, hs):
                assert h.outcome == "ok", (h.outcome, h.error)
                refs[(tuple(p), seeded)] = list(h.tokens)
    finally:
        eng.stop()
    return prompts, refs


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.tcp_client import _Connection

    prompts, refs = references(device)
    long_pool = [p for p in prompts if len(p) == LONG_PROMPT]
    short_pool = [p for p in prompts if len(p) == SHORT_PROMPT]
    log_dir = tempfile.mkdtemp(prefix="zoo-disagg-chaos-")
    group = ReplicaGroup(SPEC, num_replicas=3, max_restarts=2,
                         log_dir=log_dir, roles=ROLES, device=device,
                         env={"ZOO_CHAOS_ALLOW": "1"})
    group.start(timeout=180)
    # hedge OFF: this smoke measures the handoff + failover layer, not
    # the hedging layer on top of it
    cli = HAServingClient(group.endpoints(), deadline_ms=60000,
                          hedge=False, migrate_min_tokens=MIGRATE_MIN)

    def migrated_blocks(i):
        return sum(group._metrics_counter(
            i, "zoo_llm_kv_migrated_blocks_total").values())

    def llm_stats(port):
        conn = _Connection(group.host, port)
        try:
            return conn.rpc({"op": "llm_stats"})["stats"]
        finally:
            conn.close()

    errors, lock = [], threading.Lock()
    n_long, n_short = [0], [0]

    def run_stream(rs, pool, counter):
        n = int(rs.randint(4, MAX_NEW + 1))
        prompt = pool[int(rs.randint(0, len(pool)))]
        seeded = bool(rs.randint(0, 2))
        toks = list(cli.generate(prompt, n, **(SEEDED if seeded else {})))
        exp = refs[(tuple(prompt), seeded)][:n]
        if toks != exp:
            raise AssertionError(
                f"stream diverged from reference: {toks} != {exp}")
        with lock:
            counter[0] += 1

    def worker(cid, pool, counter, more):
        rs = np.random.RandomState(SEED + cid)
        while more():
            try:
                run_stream(rs, pool, counter)
            except Exception as e:  # noqa: BLE001 — every failure counts
                with lock:
                    errors.append(f"worker[{cid}]: {e!r}")

    def storm(seconds, n_short_workers, cid0, min_streams=0):
        """Long-prompt workers (and ``n_short_workers`` short ones) for
        ``seconds``, then on until each kind has ``min_streams`` streams
        or ``STORM_CAP_S`` passed."""
        t0 = time.monotonic()

        def more():
            now = time.monotonic() - t0
            thin = n_long[0] < min_streams or \
                (n_short_workers and n_short[0] < min_streams)
            return now < seconds or (thin and now < STORM_CAP_S
                                     and not errors)

        threads = [threading.Thread(
            target=worker, args=(cid0 + c, long_pool, n_long, more))
            for c in range(2)]
        threads += [threading.Thread(
            target=worker, args=(cid0 + 10 + c, short_pool, n_short, more))
            for c in range(n_short_workers)]
        for t in threads:
            t.start()
        return threads

    try:
        # learn the role topology up front (the storm would learn it
        # passively too)
        topo = cli.update_topology()
        assert sum(1 for s in topo.values()
                   if s and s.get("role") == "prefill") == 1, topo
        assert sum(1 for s in topo.values()
                   if s and s.get("role") == "decode") == 2, topo

        # -- phase 1: mixed storm over the split pool ------------------
        for t in storm(STORM_S, 2, 0, MIN_STREAMS):
            t.join()
        assert not errors, (
            f"{len(errors)} client-visible failure(s):\n"
            + "\n".join(errors[:10]))
        assert n_long[0] >= MIN_STREAMS and n_short[0] >= MIN_STREAMS, \
            f"storm too thin: {n_long[0]} long / {n_short[0]} short"
        assert migrated_blocks(1) + migrated_blocks(2) > 0, \
            "decode seats never adopted a migrated KV block"
        assert sum(llm_stats(group.ports[i])["handoffs_in"]
                   for i in (1, 2)) > 0, "no handoff reached a decode seat"

        # -- phase 2: SIGKILL the prefill replica MID-handoff ----------
        # hold the push open on the kv_migrate seam, start a long stream,
        # and kill the prefill seat once it has parked the stream's KV
        # (the push starts right after the park, so the kill lands in it)
        group.chaos_rpc(0, "serving.kv_migrate.push", delay_ms=800.0)
        out0 = llm_stats(group.ports[0])["handoffs_out"]
        kill_done = []

        def killer():
            deadline = time.monotonic() + 60
            while llm_stats(group.ports[0])["handoffs_out"] == out0 \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            group.kill_replica(0)
            kill_done.append(True)

        kt = threading.Thread(target=killer)
        kt.start()
        try:
            # must still be byte-exact
            run_stream(np.random.RandomState(SEED + 98), long_pool, n_long)
        finally:
            kt.join()
        assert kill_done, "kill thread never fired"

        # -- the group heals: respawn recorded, 3/3 healthy, role kept
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and group.restarts() < 1:
            time.sleep(0.2)
        assert group.restarts() >= 1, "no respawn recorded"
        healthy = 0
        while time.monotonic() < deadline:
            hz = group.healthz()
            healthy = sum(1 for h in hz if h and h.get("ok"))
            if healthy == 3:
                break
            time.sleep(0.3)
        assert healthy == 3, f"only {healthy}/3 replicas healthy"
        assert llm_stats(group.ports[0])["role"] == "prefill", \
            "respawned replica lost its prefill role"

        # post-heal: the handoff path works again end to end, once the
        # client's breaker on the killed seat lets it back in
        rs = np.random.RandomState(SEED + 99)
        deadline = time.monotonic() + 30
        while True:
            run_stream(rs, long_pool, n_long)
            if llm_stats(group.ports[0])["handoffs_out"] >= 1 or \
                    time.monotonic() > deadline:
                break
            time.sleep(0.3)
        assert llm_stats(group.ports[0])["handoffs_out"] >= 1, \
            "the respawned prefill seat handed nothing off"

        # -- zero leaked KV blocks on every seat -----------------------
        deadline = time.monotonic() + 10
        leaked = None
        while time.monotonic() < deadline:
            leaked = {i: llm_stats(p)["blocks_used"]
                      for i, p in enumerate(group.ports)}
            if not any(leaked.values()):
                break
            time.sleep(0.3)
        assert not any(leaked.values()), f"leaked KV blocks: {leaked}"
        handoffs_in = sum(llm_stats(group.ports[i])["handoffs_in"]
                          for i in (1, 2))
    finally:
        cli.close()
        group.stop()

    if verbose:
        print(f"DISAGG CHAOS OK: seed {SEED}, {n_long[0]} handoff-path "
              f"+ {n_short[0]} plain byte-exact streams, 0 failures, "
              f"{handoffs_in} adoption(s) on the live decode seats, "
              f"prefill seat SIGKILLed mid-push and "
              f"respawned with its role ({group.restarts()} respawn(s)), "
              "0 leaked KV blocks")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
