#!/usr/bin/env python
"""Serving-HA chaos smoke END TO END over the port (copy of
``scripts/check_serving_ha.py`` on ``zoo_tpu_torch``): a REAL 3-replica
:class:`ReplicaGroup` (separate supervised processes) under sustained
client load, one replica SIGKILLed mid-run — and the
:class:`HAServingClient` contract holds: ZERO client-visible failures
beyond the hedging/retry budget (here: zero, full stop — every request
must return the verified ``2x`` answer inside its deadline), the dead
replica is respawned on its original port, and all three seats probe
healthy again on the ``/healthz`` door.

Synthetic replicas boot in well under a second each. ``--device`` is the
replicas' device (no ``--device`` = the current CUDA device, which a
replica resolves at boot and raises for without a card). Run directly
(``python -m zoo_tpu_torch.scripts.check_serving_ha --device cpu``) or
from the suite (``tests/test_torch_ha.py`` runs it under the ``chaos``
marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def check(device=None, verbose: bool = True) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient

    log_dir = tempfile.mkdtemp(prefix="zoo-serving-ha-smoke-")
    group = ReplicaGroup("synthetic:double:5", num_replicas=3,
                         max_restarts=2, batch_size=8, max_wait_ms=2.0,
                         log_dir=log_dir, device=device)
    group.start(timeout=60)
    client = HAServingClient(group.endpoints(), deadline_ms=8000)

    n_clients, per_client = 4, 40
    errors, ok = [], [0]
    lock = threading.Lock()
    killed = threading.Event()

    def worker(cid):
        for i in range(per_client):
            x = np.full((1, 4), float(cid * 1000 + i), np.float32)
            try:
                out = np.asarray(client.predict(x))
                if out.shape != x.shape or not np.allclose(out, x * 2.0):
                    raise AssertionError(
                        f"wrong answer for {x[0, 0]}: {out!r}")
                with lock:
                    ok[0] += 1
            except Exception as e:  # noqa: BLE001 — every failure counts
                with lock:
                    errors.append(f"client {cid} req {i}: {e!r}")
            # the SIGKILL lands while load is flowing, from inside the
            # traffic so it cannot race past the end of the run
            if not killed.is_set() and cid == 0 and i == per_client // 4:
                killed.set()
                group.kill_replica(1)

    try:
        threads = [threading.Thread(target=worker, args=(c,))
                   for c in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()

        assert killed.is_set(), "the chaos kill never fired"
        assert not errors, (
            f"{len(errors)} client-visible failure(s) past the "
            f"hedge/retry budget:\n" + "\n".join(errors[:10]))
        assert ok[0] == n_clients * per_client, ok

        # the supervisor must respawn the dead seat on its old port and
        # the whole group must probe healthy again
        deadline = time.monotonic() + 30
        healthy = 0
        while time.monotonic() < deadline:
            hz = group.healthz()
            healthy = sum(1 for h in hz if h is not None and h.get("ok"))
            if healthy == 3:
                break
            time.sleep(0.3)
        assert healthy == 3, f"only {healthy}/3 replicas healthy"
        assert group.restarts() >= 1, "no respawn recorded"
    finally:
        group.stop()

    if verbose:
        print(f"SERVING HA OK: {ok[0]}/{n_clients * per_client} verified "
              f"responses across a replica SIGKILL, 0 client-visible "
              f"failures, {group.restarts()} respawn(s), 3/3 healthy")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zoo_tpu_torch.scripts.check_serving_ha",
        description="3-replica SIGKILL smoke of the port's predict door")
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
