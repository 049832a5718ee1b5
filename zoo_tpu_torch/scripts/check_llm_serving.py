#!/usr/bin/env python
"""LLM-serving chaos smoke END TO END over the port (copy of
``scripts/check_llm_serving.py`` on ``zoo_tpu_torch``): a REAL 2-replica
:class:`ReplicaGroup` serving a tiny ``llama:`` spec on ``--device``
(separate supervised processes, bit-identical seed-0 weights), N concurrent
mixed-length token streams through :class:`HAServingClient.generate`,
one replica SIGKILLed mid-stream — and the HA streaming contract holds:

* ZERO client-visible failures — every stream completes and is
  byte-identical to its pre-chaos reference (failover-resume regenerates
  the suffix on the surviving replica; no gap, duplicate, or error);
* the dead seat is respawned on its original port and probes healthy
  (``/healthz``);
* ZERO leaked KV blocks — after the storm both engines' paged
  allocators account to zero (``llm_stats`` over the wire), so aborted
  streams returned every block to the free list;
* on a CUDA device, every replica's ``llm_stats`` reads the paged-decode
  kernel (``decode_attention_impl`` = ``flash``).

Run directly (``python -m zoo_tpu_torch.scripts.check_llm_serving
--device cpu``; no ``--device`` = the current CUDA device) or from the
suite (``tests/test_torch_ha.py`` runs it under the ``chaos`` marker).
"""

import argparse
import os
import sys
import tempfile
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

# small pool + small buckets: replica boot compiles 2 prefill buckets +
# 1 decode executable, which is what bounds this smoke's wall clock
SPEC = "llama:tiny:slots=4,block=8,blocks=96,tables=8,buckets=16/32"


def replicas_up(group, deadline_s: float) -> int:
    """How many of the group's replicas probe healthy on ``/healthz``
    before the deadline."""
    end = time.monotonic() + deadline_s
    healthy = 0
    while time.monotonic() < end:
        hz = group.healthz()
        healthy = sum(1 for h in hz if h is not None and h.get("ok"))
        if healthy == group.num_replicas:
            break
        time.sleep(0.3)
    return healthy


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.tcp_client import _Connection

    log_dir = tempfile.mkdtemp(prefix="zoo-llm-serving-smoke-")
    group = ReplicaGroup(SPEC, num_replicas=2, max_restarts=2,
                         log_dir=log_dir, device=device)
    group.start(timeout=180)
    client = HAServingClient(group.endpoints(), deadline_ms=240_000,
                             hedge=False)

    rs = np.random.RandomState(0)
    n_streams = 8
    prompts = [rs.randint(0, 256, (int(rs.randint(3, 15)),)).astype(
        np.int32) for _ in range(n_streams)]
    max_new = [20 if i % 2 == 0 else 6 for i in range(n_streams)]

    # reference pass — one stream per replica first (warms BOTH
    # replicas' executables off the chaos clock), then every prompt's
    # expected tokens; greedy decode over bit-identical weights makes
    # these the ground truth for the chaos pass on either replica
    for host, port in group.endpoints():
        conn = _Connection(host, port)
        for f in conn.stream({"op": "generate", "prompt": prompts[0],
                              "max_new_tokens": 2}):
            pass
        conn.close()
    refs = [list(client.generate(p, n))
            for p, n in zip(prompts, max_new)]
    assert all(len(r) == n for r, n in zip(refs, max_new)), \
        [len(r) for r in refs]

    errors, done_ok = [], [0]
    lock = threading.Lock()
    first_tokens = threading.Event()
    killed = threading.Event()

    def stream_worker(i):
        try:
            got = []
            for tok in client.generate(prompts[i], max_new[i]):
                got.append(tok)
                first_tokens.set()
            if got != refs[i]:
                raise AssertionError(
                    f"stream {i} diverged after failover: "
                    f"{got} vs {refs[i]}")
            with lock:
                done_ok[0] += 1
        except Exception as e:  # noqa: BLE001 — every failure counts
            with lock:
                errors.append(f"stream {i}: {e!r}")

    def chaos():
        # the SIGKILL lands while streams are decoding — after the
        # first token is on the wire, never after the storm drained
        first_tokens.wait(timeout=120)
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

        # the supervisor must respawn the dead seat on its old port
        healthy = replicas_up(group, 60)
        assert healthy == 2, f"only {healthy}/2 replicas healthy"
        assert group.restarts() >= 1, "no respawn recorded"

        # zero leaked KV blocks: every replica's paged allocator must
        # account to zero once the storm is over (cancelled/abandoned
        # streams freed their blocks; the respawned engine is fresh)
        for host, port in group.endpoints():
            deadline = time.monotonic() + 30
            used = None
            while time.monotonic() < deadline:
                try:
                    conn = _Connection(host, port)
                    stats = conn.rpc({"op": "llm_stats"})["stats"]
                    conn.close()
                    used = stats["blocks_used"]
                    if device is None or str(device).startswith("cuda"):
                        impl = stats["decode_attention_impl"]
                        assert impl == "flash", (
                            f"replica {host}:{port} decodes through "
                            f"{impl!r}, not the paged-decode kernel")
                    if used == 0:
                        break
                except OSError:
                    pass  # respawn window
                time.sleep(0.3)
            assert used == 0, (
                f"replica {host}:{port} leaked {used} KV block(s)")
    finally:
        group.stop()

    if verbose:
        print(f"LLM SERVING OK: {done_ok[0]}/{n_streams} token streams "
              f"byte-identical to reference across a replica SIGKILL, "
              f"0 client-visible failures, {group.restarts()} "
              f"respawn(s), 2/2 healthy, 0 leaked KV blocks")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the replicas' torch device (default: the "
                         "current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
