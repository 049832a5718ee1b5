#!/usr/bin/env python
"""Multi-tenant QoS chaos smoke END TO END over the port (copy of
``scripts/check_tenancy.py`` on ``zoo_tpu_torch``): a REAL 3-replica
:class:`ReplicaGroup` of a tiny ``llama:`` spec on ``--device``, every
seat under ``ZOO_TENANT_CONFIG`` with the prefix cache on, serving an
**adversarial mix**: a greedy tenant flooding unpaced from several
threads against a paced, higher-class victim tenant — then a SIGKILL of
one replica mid-storm.

The contract this smoke asserts:

1. every VICTIM stream — before, during, and after both the flood and
   the kill — is byte-identical to the same prompt's stream from an
   engine of the same spec in this process: ZERO client-visible victim
   failures;
2. the victim was never shed: ``zoo_tenant_shed_total`` for the victim
   is 0 on every surviving seat;
3. the greedy tenant was visibly throttled: rate sheds recorded on its
   label, and the client paced its retries on the per-tenant backoff;
   every greedy stream that completed equals its reference too;
4. tenant KV isolation held: ZERO cross-tenant prefix-cache evictions
   (``zoo_tenant_kv_cross_evictions_total``);
5. the killed replica respawned on its original port — 3/3 healthy.

Run directly (``python -m zoo_tpu_torch.scripts.check_tenancy --device
cpu``; no ``--device`` = the current CUDA device) or from the suite
(``tests/test_torch_tenancy.py`` runs it under the ``chaos`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

SEED = int(os.environ.get("ZOO_CHAOS_SEED", "20820") or 20820)
SPEC = "llama:tiny:slots=2,block=4,blocks=96,tables=8,buckets=16/32"
# greedy: rate-limited best-effort with slot and KV quotas; victim: paid
# class, unlimited rate, 4x weight — the isolation the smoke verifies.
# The JAX script's greedy rate is 6/s a seat over its synthetic engine;
# a tiny Llama stream takes far longer on the CPU (three greedy threads
# reach about 1/s a seat), so the rate here is 0.5/s (burst 1)
TENANT_CONFIG = ("victim:class=0,weight=4,rate=0;"
                 "greedy:class=1,weight=1,rate=0.5,burst=1,slots=1,kv=32")
# a shared prefix, cache-hot; not block-aligned (13 tokens, block 4)
VICTIM_PROMPT = list(range(1, 14))
GREEDY_POOL = 32       # distinct 6-token greedy prompts
MAX_NEW = 8
MIN_VICTIM = 10        # the storm runs on (up to STORM_CAP_S) until the
STORM_CAP_S = 60.0     # victim has this many streams: a loaded CPU is slow


def references(device):
    """The victim's and each pooled greedy prompt's ``MAX_NEW``-token
    greedy stream from an engine of ``SPEC`` in this process (the
    replicas build the same seeded weights); a shorter stream is a
    prefix of these."""
    import numpy as np

    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(SEED + 100)
    greedy = [[int(t) for t in rs.randint(0, 256, size=6)]
              for _ in range(GREEDY_POOL)]
    eng = build_llm_engine(SPEC, device=device)
    try:
        prompts = [VICTIM_PROMPT] + greedy
        hs = [eng.submit(p, MAX_NEW, rid=f"ref{i}")
              for i, p in enumerate(prompts)]
        for h in hs:
            while not h.done:
                h.wait_new(len(h.tokens), 1.0)
        assert all(h.outcome == "ok" for h in hs)
        refs = {tuple(p): list(h.tokens) for p, h in zip(prompts, hs)}
    finally:
        eng.stop()
    return greedy, refs


def check(duration: float = 8.0, verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import (
        HAServingClient,
        NoReplicaAvailable,
    )

    greedy_pool, refs = references(device)
    log_dir = tempfile.mkdtemp(prefix="zoo-tenancy-chaos-")
    group = ReplicaGroup(SPEC, num_replicas=3, max_restarts=2,
                         log_dir=log_dir, device=device,
                         env={"ZOO_TENANT_CONFIG": TENANT_CONFIG,
                              "ZOO_LLM_PREFIX_CACHE": "1"})
    group.start(timeout=180)
    cli = HAServingClient(group.endpoints(), deadline_ms=60000,
                          hedge=False)

    def tenant_counter(name, tenant):
        total = 0.0
        for i in range(3):
            for sig, v in group._metrics_counter(i, name).items():
                if f'tenant="{tenant}"' in sig:
                    total += v
        return total

    lock = threading.Lock()
    victim_errors, victim_ok = [], [0]
    greedy_throttled, greedy_ok, greedy_errors = [0], [0], []

    def one_stream(rs, prompt, tenant):
        n = int(rs.randint(4, MAX_NEW + 1))
        toks = list(cli.generate(prompt, n, tenant=tenant))
        exp = refs[tuple(prompt)][:n]
        if toks != exp:
            raise AssertionError(
                f"stream diverged from reference: {toks} != {exp}")

    def victim_worker(cid, more):
        rs = np.random.RandomState(SEED + cid)
        while more():
            try:
                one_stream(rs, VICTIM_PROMPT, "victim")
                with lock:
                    victim_ok[0] += 1
            except Exception as e:  # noqa: BLE001 — every failure counts
                with lock:
                    victim_errors.append(f"victim[{cid}]: {e!r}")
            time.sleep(0.1)        # paced, well within any budget

    def greedy_worker(cid, more):
        rs = np.random.RandomState(SEED + 100 + cid)
        while more():
            prompt = greedy_pool[int(rs.randint(0, len(greedy_pool)))]
            try:
                one_stream(rs, prompt, "greedy")
                with lock:
                    greedy_ok[0] += 1
            except NoReplicaAvailable:
                # rate-shed fleet-wide: the throttle working as built
                with lock:
                    greedy_throttled[0] += 1
            except Exception as e:  # noqa: BLE001
                with lock:
                    greedy_errors.append(f"greedy[{cid}]: {e!r}")

    t0 = time.monotonic()

    def more():
        """``duration`` seconds, then on until the victim has
        ``MIN_VICTIM`` streams (or ``STORM_CAP_S`` passed)."""
        now = time.monotonic() - t0
        return now < duration or (victim_ok[0] < MIN_VICTIM
                                  and now < STORM_CAP_S
                                  and not victim_errors)

    try:
        threads = [threading.Thread(target=victim_worker, args=(c, more))
                   for c in range(2)]
        threads += [threading.Thread(target=greedy_worker, args=(c, more))
                    for c in range(3)]
        for t in threads:
            t.start()

        # -- mid-storm SIGKILL of one replica --------------------------
        time.sleep(duration * 0.4)
        group.kill_replica(1)
        for t in threads:
            t.join()

        # 1-2. victims byte-identical, never failed, never shed
        assert not victim_errors, (
            f"{len(victim_errors)} victim failure(s):\n"
            + "\n".join(victim_errors[:10]))
        assert victim_ok[0] >= MIN_VICTIM, \
            f"victim traffic too thin: {victim_ok[0]} streams"
        victim_sheds = tenant_counter("zoo_tenant_shed_total", "victim")
        assert victim_sheds == 0, \
            f"victim was shed {int(victim_sheds)} time(s)"

        # 3. the flood was real and the throttle bit it
        greedy_sheds = tenant_counter("zoo_tenant_shed_total", "greedy")
        assert greedy_sheds > 0, (
            f"greedy tenant was never throttled ({greedy_ok[0]} "
            "streams admitted)")
        assert greedy_ok[0] > 0, "no greedy stream ever admitted"
        assert not greedy_errors, (
            f"{len(greedy_errors)} non-shed greedy failure(s):\n"
            + "\n".join(greedy_errors[:10]))

        # 4. KV isolation: zero cross-tenant prefix-cache evictions
        cross = tenant_counter("zoo_tenant_kv_cross_evictions_total",
                               "greedy")
        assert cross == 0, \
            f"{int(cross)} cross-tenant KV eviction(s) by the flood"

        # 5. the killed seat respawned: 3/3 healthy again
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

        # post-heal, post-flood: the victim still byte-exact
        one_stream(np.random.RandomState(SEED + 999),
                   VICTIM_PROMPT, "victim")
    finally:
        cli.close()
        group.stop()

    if verbose:
        print(f"TENANCY OK: seed {SEED}, {victim_ok[0]} byte-exact "
              f"victim streams with 0 failures and 0 sheds through a "
              f"greedy flood ({greedy_ok[0]} admitted / "
              f"{int(greedy_sheds)} rate-shed / {greedy_throttled[0]} "
              f"client-throttled) + a mid-storm SIGKILL "
              f"({group.restarts()} respawn(s)), 0 cross-tenant KV "
              "evictions")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=8.0,
                    help="storm horizon in seconds")
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    args = ap.parse_args(argv)
    return check(duration=args.duration, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
