#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``zoo_tpu_torch``) on one Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports neither JAX nor the JAX package, builds the port's CUDA
kernels from ``zoo_tpu_torch/csrc`` and prints one JSON line per phase:

1. device — name, capability, count, power limit (fails off Hopper);
2. build — nvcc wall time and each kernel's ``-Xptxas -v`` report;
3. kernels — each kernel against its plain PyTorch version at the
   Llama-3-8B serving shapes, for f32, bf16 and int8 caches and the
   position edges, then timed (device time per call from
   ``torch.profiler``, and CUDA-event wall time) beside its plain
   version, its least possible time on the card, and (flash only)
   ``scaled_dot_product_attention`` as a yardstick the port never calls;
4. tiny — ``llama:tiny`` greedy streams through the engine with the
   kernels equal the streams with every plain version, token for
   token, on the bucket and ``chunk=4`` paths;
5. main path — the Llama-3-8B-width engine answers four concurrent
   greedy requests (20/100/300/480-token prompts, 32 new tokens each:
   480 + 32 fills the 512-token context of the default 32 x 16-token
   block table) on the bucket path, then with ``chunk=64`` and with an int8
   cache; kernel launch counts are reset before and read after each
   run and must show each kernel of that path. After the bucket run,
   ``tick`` lines profile decode ticks of the same model, with the
   paged-decode kernel and with its plain version.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without the ``ok`` line. Without a CUDA
device, or without the package beside this file, it exits 2.
"""

import json
import os
import subprocess
import sys
import time
import traceback

SPEC_8B = ("llama:vocab=128256,hidden=4096,n_block=32,n_head=32,"
           "n_kv_head=8,intermediate=14336")
# full depth fits the time limit; a cut, if ever needed, cuts n_block only
N_BLOCK = 32
PEAK_BYTES = 3.35e12              # H100 SXM HBM3, bytes/s
PEAK_F32_FLOPS = 67e12            # H100 SXM f32, outside the tensor cores

# tolerances of kernel vs plain version, max absolute error:
# f32 outputs 1e-4 (the same f32 math summed in another order, expf vs
# torch.exp; outputs are O(1)); bf16 outputs 3e-2 (one bf16 rounding of
# O(1) outputs is up to 2**-8 ~ 4e-3, and the plain version also rounds
# its probabilities and products to bf16 at other points)
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.stdout.strip() else \
            f"nvidia-smi gave nothing (exit {r.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e!r}"


def timed(torch, fn, iters, kernel=None, warmup=3):
    """Per call: ``device_ms``, the device time of everything ``fn``
    launches (torch.profiler's kernel, copy and memset events, summed);
    ``kernel_ms``, the part spent in kernels whose name holds
    ``kernel``; ``wall_ms``, CUDA-event time over back-to-back calls,
    which also counts the host's launch overhead when the host is the
    slower side; ``by_name``, device ms per call of each event name."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / iters
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = only = 0.0
    by_name = {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        total += us
        by_name[e.key] = by_name.get(e.key, 0.0) + us / iters / 1e3
        if kernel is not None and kernel in e.key:
            only += us
    if total <= 0:
        raise AssertionError("torch.profiler recorded no device time")
    return {"device_ms": total / iters / 1e3, "wall_ms": wall,
            "kernel_ms": only / iters / 1e3 if kernel else None,
            "by_name": by_name}


def timing(torch, kernel, fn, plain, library, iters):
    """The kernel wrapper's times beside its plain version's and, where
    one exists, the library call's (device time per call)."""
    t = timed(torch, fn, iters, kernel=kernel)
    return {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
            "wall_ms": t["wall_ms"],
            "plain_ms": timed(torch, plain, max(3, iters // 5))["device_ms"],
            "library_ms": None if library is None else
            timed(torch, library, iters)["device_ms"]}


def bound(nbytes, flops):
    """Least time (ms) for f32 work that must move ``nbytes`` and do
    ``flops``, and which of the two sets it."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / PEAK_F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def phase_kernels(torch):
    """Each kernel against its plain version at the 8B path's shapes."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    from zoo_tpu_torch.ops.kernels import paged_prefill as PP
    from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    H, HKV, D, BS, NB, W, S = 32, 8, 128, 16, 128, 32, 8
    results = {}

    def record(kernel, case, err, dtype):
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tol": TOL[dtype]})
        if not err <= TOL[dtype]:
            raise AssertionError(f"{kernel} {case}: max abs err {err} "
                                 f"> {TOL[dtype]}")
        r = results.setdefault(kernel, {"max_abs_err": 0.0})
        if dtype == "float32":
            r["max_abs_err"] = max(r["max_abs_err"], err)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    # -- A: flash forward at the 512 bucket: B=1, H=32, Hkv=8, T=512 ----
    for dtype, causal, tq, tk in ((torch.float32, True, 512, 512),
                                  (torch.bfloat16, True, 512, 512),
                                  (torch.float32, False, 100, 300),
                                  (torch.float32, True, 77, 333)):
        q = randn(1, H, tq, D, dtype=dtype)
        k = randn(1, HKV, tk, D, dtype=dtype)
        v = randn(1, HKV, tk, D, dtype=dtype)
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        record("flash_attention", f"{name} causal={causal} Tq={tq} "
               f"Tk={tk}", err(o, ro), name)
        if dtype == torch.float32:
            record("flash_attention", f"lse causal={causal} Tq={tq}",
                   err(lse, rlse), name)
    q = randn(1, H, 512, D)
    k = randn(1, HKV, 512, D)
    v = randn(1, HKV, 512, D)
    pairs = 512 * 513 // 2
    b_ms, b_by = bound(4 * (2 * q.numel() + 2 * k.numel()) + 4 * H * 512,
                       4 * D * pairs * H)
    results["flash_attention"].update(timing(
        torch, "flash_fwd_kernel",
        lambda: FA.flash_attention_fwd(q, k, v, True),
        lambda: FA.flash_attention_plain(q, k, v, True),
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=True), 50),
        bound_ms=b_ms, bound_by=b_by)

    # -- paged caches: 128 blocks of 16 rows, 8 kv heads, f32/bf16/int8 --
    def cache(kind):
        kc, vc = randn(NB, BS, HKV, D), randn(NB, BS, HKV, D)
        if kind == "int8":
            ks, vs = absmax_scale(kc, dim=-1), absmax_scale(vc, dim=-1)
            return (narrow_int8(kc, ks[..., None]),
                    narrow_int8(vc, vs[..., None]), ks, vs)
        dt = torch.bfloat16 if kind == "bf16" else torch.float32
        return kc.to(dt), vc.to(dt), None, None

    tables = torch.stack([torch.randperm(NB - 1, generator=g, device=dev)
                          [:W] + 1 for _ in range(S)]).to(torch.int32)
    # position 0, both sides of a block boundary, the last position
    positions = torch.tensor([0, 15, 16, 511, 100, 255, 256, 37],
                             dtype=torch.int32, device=dev)

    def cache_bytes(c, rows):
        item = c[0].element_size()
        return 2 * rows * HKV * D * item + \
            (2 * rows * HKV * 4 if c[2] is not None else 0)

    # -- B: paged decode, S=8 slots x 32 heads, splits=4 ----------------
    for kind in ("f32", "bf16", "int8"):
        c = cache(kind)
        for qdt in ((torch.float32, torch.bfloat16) if kind == "bf16"
                    else (torch.float32,)):
            qd = randn(S, H, D, dtype=qdt)
            o = PD.paged_flash_decode(qd, c[0], c[1], tables, positions,
                                      k_scale=c[2], v_scale=c[3])
            ro = PD.paged_decode_plain(qd, c[0], c[1], tables, positions,
                                       k_scale=c[2], v_scale=c[3])
            torch.cuda.synchronize()
            name = str(qdt).split(".")[-1]
            record("paged_decode", f"q {name} cache {kind}", err(o, ro),
                   name)
        if kind == "f32":
            live = int((positions.long() + 1).sum())
            b_ms, b_by = bound(
                cache_bytes(c, live) + 2 * qd.numel() * 4
                + tables.numel() * 4 + S * 4, 4 * live * H * D)
            results["paged_decode"].update(timing(
                torch, "paged_decode_kernel",
                lambda: PD.paged_flash_decode(qd, c[0], c[1], tables,
                                              positions),
                lambda: PD.paged_decode_plain(qd, c[0], c[1], tables,
                                              positions), None, 100),
                bound_ms=b_ms, bound_by=b_by)

    # -- C: paged prefill, one sequence x a 64-row chunk ----------------
    C = 64
    for kind in ("f32", "bf16", "int8"):
        c = cache(kind)
        for start in (0, 200, 448):      # block 0, mid-table, table end
            qp = randn(1, C, H, D)
            pos = (start + torch.arange(C, device=dev)).to(
                torch.int32)[None]
            o = PP.paged_flash_prefill(qp, c[0], c[1], tables[:1], pos,
                                       k_scale=c[2], v_scale=c[3])
            ro = PP.paged_prefill_plain(qp, c[0], c[1], tables[:1], pos,
                                        k_scale=c[2], v_scale=c[3])
            torch.cuda.synchronize()
            record("paged_prefill", f"cache {kind} start={start}",
                   err(o, ro), "float32")
        if kind == "f32":
            pos = (200 + torch.arange(C, device=dev)).to(torch.int32)[None]
            rows = int(pos.max()) + 1
            pairs = int((pos.long() + 1).sum())
            b_ms, b_by = bound(
                cache_bytes(c, rows) + 2 * qp.numel() * 4 + C * 4 + W * 4,
                4 * pairs * H * D)
            results["paged_prefill"].update(timing(
                torch, "paged_prefill_kernel",
                lambda: PP.paged_flash_prefill(qp, c[0], c[1], tables[:1],
                                               pos),
                lambda: PP.paged_prefill_plain(qp, c[0], c[1], tables[:1],
                                               pos), None, 100),
                bound_ms=b_ms, bound_by=b_by)
    for name, r in results.items():
        emit({"phase": "kernels", "kernel": name, "timing": r})
    return results


def drive(engine, prompts, n_new, budget=600.0):
    """Submit every prompt at once, wait for all streams; returns the
    handles and the wall time."""
    t0 = time.perf_counter()
    hs = [engine.submit(p, n_new, rid=f"q{i}") for i, p in
          enumerate(prompts)]
    end = time.monotonic() + budget
    for h in hs:
        while not h.done:
            if time.monotonic() > end:
                raise TimeoutError("streams did not finish in time")
            h.wait_new(len(h.tokens), 1.0)
    return hs, time.perf_counter() - t0


def phase_tiny(torch, K):
    """Kernel path == plain path, token for token, at tiny width."""
    import numpy as np
    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(5)
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 40, 200)]
    plain = dict(decode_impl="dense", prefill_impl="dense",
                 attention_impl="dense")
    for spec in ("llama:tiny", "llama:tiny:chunk=4"):
        streams, counts, params = {}, None, None
        for label, kw in (("kernels", {}), ("plain", plain)):
            eng = build_llm_engine(spec, device="cuda", params=params, **kw)
            params = eng.model.params
            K.reset_launch_counts()
            try:
                hs, _ = drive(eng, prompts, 16)
            finally:
                eng.stop()
            if label == "kernels":
                counts = K.launch_counts()
            bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
            if bad:
                raise AssertionError(f"{spec} {label}: {bad}")
            streams[label] = [h.tokens for h in hs]
        equal = streams["kernels"] == streams["plain"]
        emit({"phase": "tiny", "spec": spec, "streams_equal": equal,
              "launches": counts})
        if not equal:
            raise AssertionError(f"{spec}: kernel streams differ from "
                                 f"plain: {streams}")
        need = ("paged_prefill",) if "chunk" in spec else \
            ("flash_attention",)
        for k in need + ("paged_decode",):
            if counts[k] <= 0:
                raise AssertionError(f"{spec}: {k} never launched")


def phase_tick(torch, m, card, ticks=10):
    """Where a decode tick's time goes: every slot prefilled with a
    200-token prompt, then ticks of all slots straight through ``m`` (no
    engine threads), with the paged-decode kernel and with its plain
    version. Per tick: CUDA-event wall time back to back, device time by
    group (matrix products, the paged-decode kernel, the rest) and the
    device's busy share of the wall time."""
    import numpy as np
    S, W, n_prompt = m.num_slots, m.max_blocks_per_seq, 200
    per_slot = (n_prompt + 2 * ticks + 3) // m.block_size + 1
    tables = np.zeros((S, W), np.int32)
    for i in range(S):                       # private blocks, 0 is trash
        tables[i, :per_slot] = 1 + per_slot * i + np.arange(per_slot)
    rs = np.random.RandomState(11)
    first = np.array([m.prefill(rs.randint(0, m.cfg.vocab, (n_prompt,)),
                                tables[i]) for i in range(S)], np.int32)
    lanes = (np.zeros(S, np.float32), np.zeros(S, np.int32),
             np.ones(S, np.float32), np.zeros(S, np.uint32))
    fresh = np.ones(S, bool)

    def group(name):
        n = name.lower()
        if "paged_decode_kernel" in n:
            return "paged_decode"
        if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul")):
            return "matmul"
        return "other"

    impl0 = m.decode_attention_impl
    try:
        for impl in ("flash", "dense"):
            m.decode_attention_impl = impl
            st = {"prev": None, "t": 0}

            def tick():
                prev = st["prev"]
                st["prev"] = m.decode_step(
                    prev, first, fresh if prev is None else ~fresh, tables,
                    np.full(S, n_prompt + st["t"], np.int32), lanes)
                st["t"] += 1

            t = timed(torch, tick, ticks)
            m.read_tokens(st["prev"])
            groups = {}
            for name, ms in t["by_name"].items():
                groups[group(name)] = groups.get(group(name), 0.0) + ms
            top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:6]
            emit({"phase": "tick", "decode_impl": impl, "card": card,
                  "slots": S, "context": n_prompt, "ticks": ticks,
                  "wall_ms": t["wall_ms"], "device_ms": t["device_ms"],
                  "device_busy_share": t["device_ms"] / t["wall_ms"],
                  "device_ms_by_group": groups,
                  "top_device_ms": [[k[:80], v] for k, v in top]})
    finally:
        m.decode_attention_impl = impl0


def phase_main(torch, K, card):
    """The 8B-width engine on the bucket, chunk=64 and int8 paths."""
    import numpy as np
    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 128256, (n,)) for n in (20, 100, 300, 480)]
    spec = SPEC_8B.replace("n_block=32", f"n_block={N_BLOCK}")
    emit({"phase": "main", "spec": spec, "depth_cut": N_BLOCK != 32})
    runs = (("bucket", {}, ("flash_attention", "paged_decode")),
            ("chunk=64", {"prefill_chunk": 64},
             ("paged_prefill", "paged_decode")),
            ("kv=int8", {"kv_dtype": "int8"},
             ("flash_attention", "paged_decode")))
    params, launches, first = None, {}, None
    for label, kw, need in runs:
        t0 = time.perf_counter()
        eng = build_llm_engine(spec, device="cuda", params=params, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        params = eng.model.params
        K.reset_launch_counts()
        try:
            hs, wall = drive(eng, prompts, 32)
            torch.cuda.synchronize()
            counts = K.launch_counts()
            stats = eng.stats()
        finally:
            eng.stop()
        used = eng.allocator.used_blocks
        bad = [(h.outcome, h.error) for h in hs if h.outcome != "ok"]
        toks = [h.tokens for h in hs]
        ok_tokens = all(len(t) == 32 and all(0 <= x < 128256 for x in t)
                        for t in toks)
        t_first = min(h.first_token_at for h in hs)
        t_last = max(h.last_token_at for h in hs)
        decode_tps = sum(len(t) - 1 for t in toks) / (t_last - t_first)
        emit({"phase": "main", "run": label, "card": card,
              "setup_s": setup_s, "wall_s": wall,
              "ttft_s": [h.ttft() for h in hs],
              "decode_tokens_per_s": decode_tps,
              "launches": counts, "used_blocks_after": used,
              "compiles": stats["compiles"],
              "kv_cache_dtype": stats["kv_cache_dtype"],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if bad or not ok_tokens:
            raise AssertionError(f"{label}: outcomes {bad}, tokens "
                                 f"{toks}")
        if used != 0:
            raise AssertionError(f"{label}: {used} KV blocks leaked")
        for k in need:
            if counts[k] <= 0:
                raise AssertionError(f"{label}: {k} never launched")
        if label == "bucket":
            first = toks
            launches.update(flash_attention=counts["flash_attention"],
                            paged_decode=counts["paged_decode"])
            phase_tick(torch, eng.model, card)
        elif label == "chunk=64":
            launches["paged_prefill"] = counts["paged_prefill"]
            # information only, not asserted: the two paths sum attention
            # in another order, and random 8B weights leave near-tied
            # logits whose argmax may flip
            emit({"phase": "main", "run": label,
                  "streams_equal_bucket": toks == first})
        del eng
        torch.cuda.empty_cache()
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import zoo_tpu_torch.ops.kernels as K
        from zoo_tpu_torch.ops.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: the zoo_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 2
    # full-f32 products everywhere (TF32 keeps ~3 decimal digits)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        t_start = time.perf_counter()
        name = torch.cuda.get_device_name(0)
        cap = torch.cuda.get_device_capability(0)
        card = nvidia_smi_line()
        emit({"phase": "device", "name": name, "capability": list(cap),
              "count": torch.cuda.device_count(), "nvidia_smi": card,
              "torch": torch.__version__, "cuda": torch.version.cuda})
        if tuple(cap) != (9, 0):
            raise AssertionError(f"{name} is compute capability {cap}; the "
                                 "kernels are built for sm_90a (Hopper)")

        t0 = time.perf_counter()
        built = _build.build()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": {k: {"reused": r.reused, "ptxas": [
                  ln.split(":", 1)[-1].strip() for ln in
                  r.ptxas.splitlines() if "Used" in ln or "spill" in ln]}
                  for k, r in built.items()}})

        timing = phase_kernels(torch)
        phase_tiny(torch, K)
        launches = phase_main(torch, K, card)

        sources = {"flash_attention": (
            "zoo_tpu_torch/csrc/flash_attention_fwd.cu",
            "zoo_tpu/ops/pallas/flash_attention.py:35"),
            "paged_decode": ("zoo_tpu_torch/csrc/paged_decode.cu",
                             "zoo_tpu/ops/pallas/paged_decode.py:55"),
            "paged_prefill": ("zoo_tpu_torch/csrc/paged_prefill.cu",
                              "zoo_tpu/ops/pallas/paged_prefill.py:54")}
        kernels = []
        for k in K.KERNELS:
            t = timing[k]
            kernels.append({
                "name": k, "route": "cuda", "source": sources[k][0],
                "replaces": sources[k][1], "launches": launches[k],
                "max_abs_err": t["max_abs_err"], "ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "kernel_ms": t["kernel_ms"], "wall_ms": t["wall_ms"]})
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        emit({"kernels": kernels})
        print(card, flush=True)
        emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                     "count": torch.cuda.device_count()}})
        return 0
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        return 1


if __name__ == "__main__":
    sys.exit(main())
