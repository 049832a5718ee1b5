#!/usr/bin/env python
"""Model-lifecycle chaos smoke END TO END over the port (copy of
``scripts/check_lifecycle.py`` on ``zoo_tpu_torch``): a REAL 3-replica
:class:`ReplicaGroup`
serving from a versioned :class:`ModelRegistry` under sustained
verified client load, driven through the full zero-downtime lifecycle:

1. **publish v2 → shadow-eval → promote** — a canary replica serves the
   candidate, a :class:`PromotionGate` mirrors traffic to it and only
   then moves the ``prod`` alias;
2. **rolling hot-swap with a SIGKILL injected mid-update** — one
   replica is killed while ``rolling_update`` walks the group; the
   supervisor respawn re-resolves the alias and boots straight onto
   v2, and the update still completes with every replica on v2;
3. **bad-candidate auto-rollback** — a published-but-broken v3 is
   pushed at the group; warm-priming fails on the first replica, the
   whole group auto-rolls-back, and the alias is returned to v2.

Throughout all three phases the client load keeps flowing and EVERY
response must be the verified ``2x`` answer: zero client-visible
failures, full stop. Final state: zero mixed-version replicas, all
three reporting v2 on the wire AND on the obs ``/metrics``
``zoo_registry_version_info`` gauge.

Synthetic models have no kernel, so ``--device`` only picks the
replicas' device, and the run fits tier-1 time. Run directly (``python
-m zoo_tpu_torch.scripts.check_lifecycle --device cpu``) or from the
suite (``tests/test_torch_continuous.py`` runs it in a subprocess under
the ``lifecycle`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.orca.learn.continuous import PromotionGate
    from zoo_tpu_torch.serving.ha import ReplicaGroup, RollingUpdateError
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.registry import ModelRegistry

    tmp = tempfile.mkdtemp(prefix="zoo-lifecycle-smoke-")
    reg = ModelRegistry(os.path.join(tmp, "registry"))
    v1 = reg.publish(spec="synthetic:double:2", alias="prod")
    group = ReplicaGroup(f"registry:{reg.root}:prod", num_replicas=3,
                         max_restarts=2, batch_size=8, max_wait_ms=2.0,
                         log_dir=os.path.join(tmp, "logs"), device=device)
    group.start(timeout=60)
    client = HAServingClient(group.endpoints(), deadline_ms=8000)

    errors, ok = [], [0]
    lock = threading.Lock()
    stop = threading.Event()

    def worker(cid):
        i = 0
        while not stop.is_set():
            i += 1
            x = np.full((1, 4), float(cid * 10000 + i), np.float32)
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
            time.sleep(0.002)

    threads = [threading.Thread(target=worker, args=(c,), daemon=True)
               for c in range(4)]
    canary_group = None
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)  # all replicas see live traffic (warm shapes)

        # -- phase 1: publish v2, shadow-eval on a canary replica, promote
        v2 = reg.publish(spec="synthetic:double:2", alias="canary")
        canary_group = ReplicaGroup(
            f"registry:{reg.root}:canary", num_replicas=1,
            max_restarts=1, batch_size=8, max_wait_ms=2.0, device=device)
        canary_group.start(timeout=60)
        canary_client = HAServingClient(canary_group.endpoints(),
                                        deadline_ms=8000)
        gate = PromotionGate(client.predict, canary_client.predict,
                             candidate=v2, registry=reg,
                             sample=1.0, window=24)
        rs = np.random.RandomState(7)

        def shadow_traffic():
            for _ in range(64):
                x = rs.randn(1, 4).astype(np.float32)
                yield x, x * 2.0

        verdict = gate.run(shadow_traffic())
        assert verdict.promoted, f"good canary rejected: {verdict}"
        assert reg.alias_version("prod") == v2, reg.aliases()
        canary_client.close()
        canary_group.stop()
        canary_group = None

        # -- phase 2: rolling hot-swap with a SIGKILL injected mid-update
        killed = threading.Event()

        def chaos_kill():
            time.sleep(0.15)  # land INSIDE the rolling walk
            killed.set()
            group.kill_replica(1)

        killer = threading.Thread(target=chaos_kill, daemon=True)
        killer.start()
        info = group.rolling_update(v2, settle=0.3)
        killer.join()
        assert killed.is_set(), "the chaos kill never fired"
        versions = [d and d.get("version")
                    for d in group.version_info(timeout=30)]
        assert versions == [v2] * 3, \
            f"mixed-version group after update: {versions}"

        # -- phase 3: broken v3 pushed at the group -> auto-rollback
        v3 = reg.publish(spec="synthetic:broken", alias="prod")
        rolled_back = False
        try:
            group.rolling_update(v3, settle=0.3)
        except RollingUpdateError:
            rolled_back = True
        assert rolled_back, "broken candidate was promoted!"
        versions = [d and d.get("version")
                    for d in group.version_info(timeout=30)]
        assert versions == [v2] * 3, \
            f"group not 100% on the incumbent after rollback: {versions}"
        assert reg.alias_version("prod") == v2, \
            f"prod alias not restored: {reg.aliases()}"

        time.sleep(0.3)  # a last verified-traffic window on v2
        stop.set()
        for t in threads:
            t.join(timeout=30)

        assert not errors, (
            f"{len(errors)} client-visible failure(s) across the "
            "lifecycle:\n" + "\n".join(errors[:10]))
        assert ok[0] > 100, f"too little verified traffic ({ok[0]})"

        # every replica advertises v2 on its /metrics door
        for mport in group.metrics_ports:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{mport}/metrics",
                    timeout=5) as resp:
                text = resp.read().decode()
            assert 'zoo_registry_version_info{version="v2"} 1' in text, \
                f"replica on :{mport} does not report v2:\n" + "\n".join(
                    ln for ln in text.splitlines()
                    if "version_info" in ln)
            assert 'zoo_registry_version_info{version="v3"} 1' \
                not in text
    finally:
        stop.set()
        if canary_group is not None:
            canary_group.stop()
        group.stop()

    if verbose:
        print(f"LIFECYCLE OK: {ok[0]} verified responses across "
              f"shadow-eval promotion ({v1}->{v2}), a rolling swap "
              f"with a mid-update SIGKILL ({group.restarts()} "
              f"respawn(s)), and a broken-candidate auto-rollback "
              f"({v3} rejected) — 0 client-visible failures, "
              f"0 mixed-version replicas")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m zoo_tpu_torch.scripts.check_lifecycle",
        description="the model-lifecycle chaos smoke over the port")
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
