#!/usr/bin/env python
"""Speculative-decoding chaos smoke END TO END over the port (copy of
``scripts/check_spec_decode.py`` on ``zoo_tpu_torch``): a REAL
2-replica :class:`ReplicaGroup` on ``--device`` serving a ``llama:`` spec with
**speculative decoding ON** (``spec_k=4``, the n-gram prompt-lookup
drafter + the multi-token paged VERIFY executable) under a concurrent
mixed repetitive/non-repetitive stream storm, one replica SIGKILLed
mid-storm — and the classic spec-decode guarantee holds end to end:

* **byte-identical to the dense non-speculative reference** — every
  stream through the speculative group matches a local engine built
  from the same spec WITHOUT speculation (same seed-0 weights), greedy
  and seeded sampling both, across the kill and the HA client's
  failover-with-resume;
* **the drafter actually earned its keep** — the surviving replica's
  ``llm_stats`` accept counters show accepted draft tokens (the
  repetitive half of the mix is the prompt-lookup shape);
* **the verify path carried every decode** on every replica after the
  storm: the port runs eagerly and its ``compile_counts()`` counts calls
  per path (ROADMAP A.1 makes it count captured graphs), so the JAX
  script's one-verify-executable census becomes "verify passes ran,
  plain decode ticks did not" — with speculation on, every decode seat
  (spec_k=0 streams included) rides the verify pass;
* **zero leaked KV blocks** on every replica — rejected draft rows
  are rollback-by-length-reset, never allocator state.

Run directly (``python -m zoo_tpu_torch.scripts.check_spec_decode
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

BASE = "llama:tiny:slots=4,block=8,blocks=128,tables=12,buckets=16/64"
SPEC = BASE + ",spec_k=4"
N_STREAMS = 10
MIN_ACCEPTED = 8   # across replicas: the repetitive streams must have
#                    produced SOME accepted draft tokens


def check(verbose: bool = True, device=None) -> int:
    import numpy as np

    from zoo_tpu_torch.serving.ha import ReplicaGroup
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.llm.spec import build_llm_engine
    from zoo_tpu_torch.serving.tcp_client import _Connection

    rs = np.random.RandomState(0)
    prompts = []
    for i in range(N_STREAMS):
        if i % 2 == 0:
            # repetitive (prompt-lookup hits): a tiled motif
            motif = rs.randint(0, 256, (int(rs.randint(4, 8)),))
            prompts.append(np.tile(motif, 6)[:36].astype(np.int32))
        else:
            # adversarial for the drafter: pure noise
            prompts.append(rs.randint(
                0, 256, (int(rs.randint(5, 14)),)).astype(np.int32))
    max_new = [24 if i % 2 == 0 else 10 for i in range(N_STREAMS)]
    sampling = [dict(temperature=0.9, top_k=24, top_p=0.95,
                     seed=3000 + i) if i % 3 == 0 else {}
                for i in range(N_STREAMS)]
    # one stream pins spec_k=0 over the wire: the per-request knob must
    # ride the frame and stay byte-identical
    spec_caps = [0 if i == 4 else None for i in range(N_STREAMS)]

    # ground truth: the SAME spec WITHOUT speculation, in-process —
    # bit-identical seed-0 weights, so speculative remote streams must
    # match byte for byte
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
        assert ref_eng.stats()["spec_k"] == 0
    finally:
        ref_eng.stop()

    log_dir = tempfile.mkdtemp(prefix="zoo-spec-decode-smoke-")
    group = ReplicaGroup(SPEC, num_replicas=2, max_restarts=2,
                         log_dir=log_dir, device=device)
    group.start(timeout=180)
    client = HAServingClient(group.endpoints(), deadline_ms=300_000,
                             hedge=False)
    errors, lock = [], threading.Lock()

    def stream_worker(i, notify=None):
        try:
            kw = dict(sampling[i])
            if spec_caps[i] is not None:
                kw["spec_k"] = spec_caps[i]
            got = []
            for tok in client.generate(prompts[i], max_new[i], **kw):
                got.append(tok)
                if notify is not None:
                    notify.set()
            if got != refs[i]:
                raise AssertionError(
                    f"stream {i} (speculative) != non-speculative "
                    f"reference: {got} vs {refs[i]}")
        except Exception as e:  # noqa: BLE001 — every failure counts
            with lock:
                errors.append(f"stream {i}: {e!r}")

    try:
        # warm both replicas' executables off the measurement clock
        for host, port in group.endpoints():
            conn = _Connection(host, port)
            for _ in conn.stream({"op": "generate",
                                  "prompt": prompts[0][:6],
                                  "max_new_tokens": 3}):
                pass
            conn.close()

        # phase 1: half the streams over the healthy group
        threads = [threading.Thread(target=stream_worker, args=(i,))
                   for i in range(N_STREAMS // 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors, "\n".join(errors[:10])

        # phase 2 + chaos: SIGKILL one replica while streams are
        # mid-flight — failover resumes on the survivor; speculative
        # or not, the resumed stream replays byte-identically
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

        # the supervisor must respawn the dead seat
        if replicas_up(group, 90) != 2:
            raise AssertionError("killed replica never respawned")

        stats = []
        for host, port in group.endpoints():
            end = time.monotonic() + 60
            while time.monotonic() < end:
                try:
                    conn = _Connection(host, port)
                    stats.append(conn.rpc({"op": "llm_stats"})["stats"])
                    conn.close()
                    break
                except OSError:
                    time.sleep(0.3)   # respawn window
            else:
                raise AssertionError(f"no llm_stats from {host}:{port}")

        accepted = sum(s.get("spec_accepted_tokens", 0) for s in stats)
        assert accepted >= MIN_ACCEPTED, (
            f"accepted draft tokens {accepted} < {MIN_ACCEPTED} — "
            f"speculation never engaged "
            f"({[s.get('spec_accepted_tokens') for s in stats]})")
        for s, (host, port) in zip(stats, group.endpoints()):
            assert s["spec_k"] == 4, s
            assert s["blocks_used"] == 0, (
                f"replica {host}:{port} leaked {s['blocks_used']} "
                "KV block(s)")
            compiles = s.get("compiles", {})
            assert compiles.get("verify", 0) > 0 or (
                compiles.get("verify") == 0 and s["decode_steps"] == 0
            ), (f"replica {host}:{port}: verify path census "
                f"{compiles} (verify passes must carry its decode)")
            assert compiles.get("decode", 0) == 0, compiles
        assert group.restarts() >= 1, "no respawn recorded"
    finally:
        client.close()
        group.stop()

    if verbose:
        print(f"SPEC DECODE OK: {N_STREAMS}/{N_STREAMS} speculative "
              f"streams byte-identical to the non-speculative "
              f"reference across a replica SIGKILL, {accepted} "
              f"accepted draft tokens (>= {MIN_ACCEPTED}), 0 leaked "
              f"KV blocks, every decode on the verify path")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the reference engine's and the replicas' torch "
                         "device (default: the current CUDA device)")
    return check(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
