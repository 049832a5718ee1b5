#!/usr/bin/env python
"""Deterministic fleet chaos storm END TO END over the port (copy of
``scripts/check_chaos_storm.py`` on ``zoo_tpu_torch``).

A REAL 3-replica :class:`ReplicaGroup` serving BOTH ops (predict via
``synthetic:double``, streaming generate via the deterministic
``synthllm`` engine; neither has a kernel, so ``--device`` only picks
the replicas' device) under sustained mixed client load, while a seeded
:class:`ChaosSchedule` composes the gray failures that dominate
production incidents:

* **slow replica** — replica 1 turns 45x slower mid-storm (a per-op
  delay armed over the wire ``chaos`` op; /healthz keeps passing);
* **frame corruption** — a seeded fraction of the client's outbound
  CRC frames get one bit flipped in transit;
* **SIGKILL** — replica 2 dies at a seeded instant and is respawned by
  the supervisor;
* **connection drops** + a **spill-dir disk-full** window on replica 0.

The contract the storm asserts:

1. every predict answers exactly ``2x`` and every generate stream is
   byte-identical to the fault-free local reference — ZERO failures,
   ZERO garbage decodes;
2. corrupt frames were DETECTED (``zoo_wire_corrupt_frames_total`` on
   the replicas' /metrics) and retried, never decoded;
3. the slow replica is EJECTED from the client rotation within seconds
   (detect-to-eject bound), tail latency recovers once it is out, and
   the seat is RE-ADMITTED after the fault clears;
4. zero leaked KV blocks on every replica after the storm;
5. the killed replica respawned — 3/3 healthy at the end;
6. the SAME ``ZOO_CHAOS_SEED`` resolves the SAME fault sequence
   (replay contract), a different seed resolves a different one.

Run directly (``python -m zoo_tpu_torch.scripts.check_chaos_storm
--device cpu``) or from the suite (``tests/test_torch_chaos.py`` runs it
under the ``chaos`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SEED = int(os.environ.get("ZOO_CHAOS_SEED", "20140") or 20140)
SLOW_REPLICA = 1
SLOW_MS = 90.0        # predict batcher delay while gray
SLOW_TICK_MS = 60.0   # per-decode-tick delay while gray
SLOW_T0, SLOW_T1 = 0.6, 4.5
SPEC = (f"slow@{SLOW_T0}-{SLOW_T1}:replica={SLOW_REPLICA},"
        f"delay_ms={SLOW_MS};"
        "corrupt@0.8-3.5:p=0.15;"
        "kill@2.0~2.6:replica=2;"
        "drop@1.2:times=2;"
        "diskfull@0.3-4.8:replica=0")
# storm horizon 4.8s + a 4.2s recovery tail: on a loaded host the slow
# seat can be ejected a fourth time before the fault clears, and its
# readmission then backs off 3.2s (readmit_base_s 0.4, doubled per
# consecutive ejection)
RUN_S = 9.0
MODEL = ("synthetic:double:2"
         "+synthllm:slots=2,block=4,blocks=96,tables=8,max_prompt=24")


def _percentile(xs, q):
    xs = sorted(xs)
    if not xs:
        return float("nan")
    return xs[min(len(xs) - 1, int(q / 100.0 * len(xs)))]


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ejection import EjectionConfig
    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.llm.synthetic import reference
    from zoo_tpu_torch.util.integrity import corrupt_action
    from zoo_tpu_torch.util.resilience import (
        ChaosSchedule,
        clear_faults,
        default_injector,
        inject,
    )

    # -- the replay contract first: same seed => same fault sequence ---
    sched = ChaosSchedule(SPEC, seed=SEED, replicas=3)
    again = ChaosSchedule(SPEC, seed=SEED, replicas=3)
    assert sched.resolved() == again.resolved(), \
        "same seed resolved a different fault sequence"
    other = ChaosSchedule(SPEC, seed=SEED + 1, replicas=3)
    assert sched.resolved() != other.resolved(), \
        "seed does not drive the schedule (no randomness resolved?)"

    log_dir = tempfile.mkdtemp(prefix="zoo-chaos-storm-")
    group = ReplicaGroup(MODEL, num_replicas=3, max_restarts=2,
                         batch_size=8, max_wait_ms=1.0, log_dir=log_dir,
                         env={"ZOO_CHAOS_ALLOW": "1"}, device=device)
    group.start(timeout=60)
    # hedge OFF: the hedge would mask the slow replica's latency before
    # ejection does — this storm measures the MEMBERSHIP layer
    cli = HAServingClient(
        group.endpoints(), deadline_ms=15000, hedge=False,
        ejection_config=EjectionConfig(
            enabled=True, min_ms=20.0, min_samples=4, probation_s=0.4,
            probe_interval_s=0.3, readmit_base_s=0.4))

    def corrupt_total():
        # label-blind sum: the counter is labelled by wire plane
        return sum(v for i in range(3)
                   for v in group._metrics_counter(
                       i, "zoo_wire_corrupt_frames_total").values())

    corrupt0 = corrupt_total()

    # -- chaos actions (the schedule's kinds -> this harness) ----------
    def act_slow(ev, phase):
        r = int(ev.params["replica"])
        if phase == "start":
            group.chaos_rpc(r, "serving.infer",
                            delay_ms=float(ev.params["delay_ms"]))
            group.chaos_rpc(r, "llm.decode", delay_ms=SLOW_TICK_MS)
        else:
            group.chaos_rpc(r, "serving.infer", clear=True)
            group.chaos_rpc(r, "llm.decode", clear=True)

    def act_corrupt(ev, phase):
        if phase == "start":
            inject("serving.wire.corrupt", action=corrupt_action,
                   p=float(ev.params["p"]))
        else:
            clear_faults("serving.wire.corrupt")

    def act_kill(ev, phase):
        group.kill_replica(int(ev.params["replica"]))

    def act_drop(ev, phase):
        inject("serving.client.recv",
               exc=ConnectionResetError("chaos drop"),
               times=int(ev.params["times"]))

    def act_diskfull(ev, phase):
        r = int(ev.params["replica"])
        if phase == "start":
            group.chaos_rpc(r, "flight.spill", error="oserror")
        else:
            group.chaos_rpc(r, "flight.spill", clear=True)

    actions = {"slow": act_slow, "corrupt": act_corrupt,
               "kill": act_kill, "drop": act_drop,
               "diskfull": act_diskfull}

    # -- mixed load ----------------------------------------------------
    errors, lats = [], []   # lats: (t_rel, seconds)
    gen_streams = [0]
    lock = threading.Lock()
    t_start = time.monotonic()
    stop_at = t_start + RUN_S

    def now_rel():
        return time.monotonic() - t_start

    def predict_worker(cid):
        rs = np.random.RandomState(1000 + cid)
        while time.monotonic() < stop_at:
            x = rs.randn(1, 8).astype(np.float32)
            t0 = time.monotonic()
            try:
                out = np.asarray(cli.predict(x))
                if not np.allclose(out, x * 2.0, atol=1e-6):
                    raise AssertionError(f"garbage decode: {out!r}")
                with lock:
                    lats.append((now_rel(), time.monotonic() - t0))
            except Exception as e:  # noqa: BLE001 — every failure counts
                with lock:
                    errors.append(f"predict[{cid}]: {e!r}")

    def generate_worker(cid):
        rs = np.random.RandomState(2000 + cid)
        while time.monotonic() < stop_at:
            n = int(rs.randint(4, 16))
            prompt = [int(t) for t in rs.randint(0, 97, size=3)]
            try:
                toks = list(cli.generate(prompt, n))
                exp = reference(prompt, n)
                if toks != exp:
                    raise AssertionError(
                        f"stream diverged from reference: {toks} != "
                        f"{exp}")
                with lock:
                    gen_streams[0] += 1
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(f"generate[{cid}]: {e!r}")

    threads = [threading.Thread(target=predict_worker, args=(c,))
               for c in range(3)]
    threads += [threading.Thread(target=generate_worker, args=(c,))
                for c in range(2)]
    try:
        sched.run(actions, injector=default_injector)
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        sched.join(timeout=10)

        # 1. zero failures, zero garbage decodes, streams byte-exact
        assert not errors, (
            f"{len(errors)} client-visible failure(s):\n"
            + "\n".join(errors[:10]))
        assert gen_streams[0] >= 10, \
            f"only {gen_streams[0]} generate streams completed"

        # 2. corruption detected and counted (on the replicas' doors),
        # and — by assertion 1 — retried, never decoded
        corrupt = corrupt_total() - corrupt0
        assert corrupt > 0, \
            "no corrupt frame was ever detected (seam dead?)"

        # 3. ejection: detect-to-eject bound, tail recovery, readmission
        events = cli.ejection_events()
        kinds = [e[1] for e in events]
        assert "ejected" in kinds, f"slow replica never ejected: {events}"
        t0_mono = t_start + SLOW_T0
        t_eject = next(ts for ts, k, _ in events if k == "ejected")
        detect_s = t_eject - t0_mono
        assert 0 < detect_s < 3.0, \
            f"detect-to-eject took {detect_s:.2f}s (bound 3s)"
        assert "readmitted" in kinds, \
            f"recovered replica never re-admitted: {events}"
        states = cli.ejection_states()
        assert all(s["state"] == "active" for s in states.values()), \
            f"seats still degraded after recovery: {states}"
        # the fault actually bit pre-ejection...
        t_eject_rel = t_eject - t_start
        pre = [dt for ts, dt in lats if SLOW_T0 <= ts <= t_eject_rel]
        assert pre and max(pre) >= SLOW_MS / 1000.0, \
            "no request ever observed the slow replica pre-ejection"
        # ...and the tail recovered once the storm ended
        tail = [dt for ts, dt in lats if ts >= RUN_S - 1.5]
        tail_p99 = _percentile(tail, 99)
        assert len(tail) >= 20 and tail_p99 < SLOW_MS / 2000.0, (
            f"tail p99 did not recover: {tail_p99 * 1e3:.1f}ms over "
            f"{len(tail)} requests (bound {SLOW_MS / 2:.0f}ms)")

        # 4. zero leaked KV blocks on every replica
        from zoo_tpu_torch.serving.tcp_client import _Connection
        for i, port in enumerate(group.ports):
            conn = _Connection(group.host, port)
            stats = conn.rpc({"op": "llm_stats"})["stats"]
            conn.close()
            assert stats["blocks_used"] == 0, (
                f"replica {i} leaked {stats['blocks_used']} KV "
                "block(s)")

        # 5. the killed replica respawned; whole group healthy
        assert group.restarts() >= 1, "no respawn recorded"
        deadline = time.monotonic() + 30
        healthy = 0
        while time.monotonic() < deadline:
            hz = group.healthz()
            healthy = sum(1 for h in hz if h and h.get("ok"))
            if healthy == 3:
                break
            time.sleep(0.3)
        assert healthy == 3, f"only {healthy}/3 replicas healthy"
    finally:
        sched.stop()
        clear_faults()
        cli.close()
        group.stop()

    if verbose:
        all_lats = [dt for _, dt in lats]
        print(f"CHAOS STORM OK: seed {SEED}, {len(lats)} predicts + "
              f"{gen_streams[0]} byte-exact streams, 0 failures, "
              f"{int(corrupt)} corrupt frame(s) caught, "
              f"detect-to-eject {detect_s * 1e3:.0f}ms, "
              f"tail p99 {tail_p99 * 1e3:.1f}ms "
              f"(storm p99 {_percentile(all_lats, 99) * 1e3:.1f}ms), "
              f"{group.restarts()} respawn(s), 0 leaked KV blocks, "
              "replay sequence verified")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
