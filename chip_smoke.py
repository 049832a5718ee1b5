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
4b. train-tiny — a tiny Llama ``fit`` (T=32, B=4, 2 shuffled epochs,
   f32) through the flash kernels and the fused AdamW kernel equals the
   same ``fit`` through the dense attention and the plain update;
5. main path — the Llama-3-8B-width engine answers four concurrent
   greedy requests (20/100/300/480-token prompts, 32 new tokens each:
   480 + 32 fills the 512-token context of the default 32 x 16-token
   block table) on the bucket path, then with ``chunk=64`` and with an int8
   cache; kernel launch counts are reset before and read after each
   run and must show each kernel of that path. After the bucket run,
   ``tick`` lines profile decode ticks of the same model, with the
   paged-decode kernel and with its plain version;
6. train-main — Keras ``fit`` of the repo's Llama training config
   (``bench.py`` ``bench_llama``: vocab 32000, hidden 768, 12 blocks, 12
   heads, 4 kv heads, intermediate 2048) at full width and depth, S=512,
   B=64, ``mixed_bfloat16``, ``remat="dots"``, fused AdamW: a warm-up
   fit, then a timed fit of 8 steps (per-step losses finite and
   falling, launches of flash fwd / dK-dV / dQ / AdamW counted), then
   a ``step`` line profiling train steps by kernel group.

Phase 3 also holds the flash forward (o, lse) and backward kernels
(dK/dV, dQ) against their plain versions, and the gradients against
autograd of the dense path, at B=8, H=12, Hkv=4, T=512, D=64, and the
fused AdamW and SGD kernels against theirs, then times them at the
training config's shapes beside their bounds and a library yardstick
(``scaled_dot_product_attention`` and its backward, ``torch.optim``'s
fused AdamW and SGD) the port never calls.

Then a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` reports them, and last ``{"ok": true, "device": ...}``.
Any failure exits non-zero without the ``ok`` line. Without a CUDA
device, or without the package beside this file, it exits 2.
"""

import json
import math
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
PEAK_BF16_FLOPS = 989e12          # H100 SXM bf16 tensor cores, dense
LOSS = "sparse_categorical_crossentropy_from_logits"
# the training config: bench.py bench_llama, full width and depth
TRAIN_CFG = dict(vocab=32000, hidden=768, n_block=12, n_head=12,
                 n_kv_head=4, intermediate=2048, rope_theta=10000.0)
TRAIN_S, TRAIN_B, TRAIN_STEPS = 512, 64, 8

# tolerances of kernel vs plain version, max absolute error:
# f32 outputs 1e-4 (the same f32 math summed in another order, expf vs
# torch.exp; outputs are O(1)); bf16 outputs 3e-2 (one bf16 rounding of
# O(1) outputs is up to 2**-8 ~ 4e-3, and the plain version rounds its
# probabilities and products to bf16 at the kernel's points or at others);
# optimizer updates 1e-6 (the same f32 elementwise math, on inputs drawn
# so that every output moves by more than 10x that in one step).
# The flash gradients against autograd of the dense path, which rounds
# neither p nor ds to bf16, take the bf16 tolerance times their largest
# magnitude: they reach ~9, and half a bf16 ulp in [8, 16) is 2**-5.
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "update": 1e-6}


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
    slower side; ``host_ms``, the host clock per call over the same calls
    until the last is issued (near ``wall_ms`` when the host is the
    slower side); ``by_name``, device ms per call of each event name;
    ``host_by_name``, host ms per call of each host event, its own time
    without its children's, under the profiler (which adds its own)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
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
    by_name, host_by_name = {}, {}
    for e in prof.key_averages():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            host_by_name[e.key] = e.self_cpu_time_total / iters / 1e3
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
            "host_ms": host,
            "kernel_ms": only / iters / 1e3 if kernel else None,
            "by_name": by_name, "host_by_name": host_by_name}


def timing(torch, kernel, fn, plain, library, iters):
    """The kernel wrapper's times beside its plain version's and, where
    one exists, the library call's (device time per call)."""
    t = timed(torch, fn, iters, kernel=kernel)
    return {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
            "wall_ms": t["wall_ms"],
            "plain_ms": timed(torch, plain, max(3, iters // 5))["device_ms"],
            "library_ms": None if library is None else
            timed(torch, library, iters)["device_ms"]}


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """Least time (ms) for work that must move ``nbytes`` and do
    ``flops`` at ``peak`` flop/s (f32 by default), and which of the two
    sets it."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / peak * 1e3
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

    def record(kernel, case, err, dtype, magnitude=None):
        # ``magnitude``: the largest output, given only where the witness
        # rounds elsewhere than the kernel (dense autograd, see TOL)
        tol = TOL[dtype] * (max(1.0, magnitude) if magnitude is not None
                            and dtype == "bfloat16" else 1.0)
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{kernel} {case}: max abs err {err} "
                                 f"> {tol}")
        r = results.setdefault(kernel, {"max_abs_err": 0.0})
        if dtype in ("float32", "update"):
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
    phase_training_kernels(torch, record, err, results)
    for name, r in results.items():
        emit({"phase": "kernels", "kernel": name, "timing": r})
    return results


def _train_leaf_shapes():
    """The training config's 12 parameter leaves (embed, head,
    final_norm and the nine stacked block leaves)."""
    c = TRAIN_CFG
    h, L, kv = c["hidden"], c["n_block"], c["n_kv_head"] * (
        c["hidden"] // c["n_head"])
    return [(c["vocab"], h), (h, c["vocab"]), (h,), (L, h, h), (L, h, kv),
            (L, h, kv), (L, h, h), (L, h), (L, h),
            (L, h, c["intermediate"]), (L, h, c["intermediate"]),
            (L, c["intermediate"], h)]


def phase_training_kernels(torch, record, err, results):
    """The flash backward and fused optimizer kernels against their
    plain versions, then timed at the training config's shapes (into
    ``results``, per kernel)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.attention import dense_attention
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    from zoo_tpu_torch.ops.kernels import fused_optim as FO

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4321)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(
            dtype)

    H, HKV, D = TRAIN_CFG["n_head"], TRAIN_CFG["n_kv_head"], 64

    # -- D: flash backward at B=8 of the training shapes ------------------
    for dtype, causal, tq, tk in ((torch.float32, True, 512, 512),
                                  (torch.bfloat16, True, 512, 512),
                                  (torch.float32, False, 512, 512),
                                  (torch.bfloat16, False, 512, 512),
                                  (torch.float32, True, 77, 333)):
        q, do = randn(8, H, tq, D, dtype=dtype), randn(8, H, tq, D,
                                                       dtype=dtype)
        k, v = randn(8, HKV, tk, D, dtype=dtype), randn(8, HKV, tk, D,
                                                        dtype=dtype)
        o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
        ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
        got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
        plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal)
        # third witness: autograd of the dense path, in f32 from the same
        # (possibly bf16) inputs
        leaves = [t.float().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(
            dense_attention(*leaves, causal=causal)[0], leaves, do.float())
        torch.cuda.synchronize()
        name = str(dtype).split(".")[-1]
        shape = f"{name} causal={causal} Tq={tq} Tk={tk} D={D}"
        record("flash_attention", "o " + shape, err(o, ro), name)
        record("flash_attention", "lse " + shape, err(lse, rlse), name)
        for i, part in enumerate(("dq", "dk", "dv")):
            kernel = "flash_attention_dq" if part == "dq" else \
                "flash_attention_dkdv"
            case = f"{part} {name} causal={causal} Tq={tq} Tk={tk}"
            record(kernel, case, err(got[i], plain[i]), name)
            record(kernel, case + " vs dense autograd",
                   err(got[i], dense[i]), name,
                   float(dense[i].abs().max()))
        del leaves, dense, ro, rlse

    # timed at the main path's shape: B=64, bf16, causal
    B, S = TRAIN_B, TRAIN_S
    q, do = randn(B, H, S, D, dtype=torch.bfloat16), \
        randn(B, H, S, D, dtype=torch.bfloat16)
    k, v = randn(B, HKV, S, D, dtype=torch.bfloat16), \
        randn(B, HKV, S, D, dtype=torch.bfloat16)
    pairs = B * H * S * (S + 1) // 2
    qb, kb = q.numel() * 2, k.numel() * 2          # bf16 bytes
    # the forward at the training shape, beside the serving one
    b_ms, b_by = bound(2 * qb + 2 * kb + B * H * S * 4, 4 * D * pairs,
                       PEAK_BF16_FLOPS)
    results["flash_attention"]["train_shape"] = dict(
        timing(torch, "flash_fwd_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, True),
               lambda: FA.flash_attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 10),
        bound_ms=b_ms, bound_by=b_by,
        shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} bf16 causal")
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)
    t = timed(torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                    True), 10)
    lq, lk, ls = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(lq, lk, ls, is_causal=True,
                                        enable_gqa=True)
    lib = timed(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, ls), do, retain_graph=True), 10)["device_ms"]
    stats = 2 * B * H * S * 4                      # lse + delta, f32
    for kernel, name, plain, nbytes, flops in (
            ("flash_attention_dkdv", "flash_bwd_dkdv_kernel",
             lambda: FA.flash_attention_dkdv_plain(q, k, v, do, lse, delta,
                                                   True),
             2 * qb + 2 * kb + stats + 2 * kb, 8 * D * pairs),
            ("flash_attention_dq", "flash_bwd_dq_kernel",
             lambda: FA.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                 True),
             2 * qb + 2 * kb + stats + qb, 6 * D * pairs)):
        b_ms, b_by = bound(nbytes, flops, PEAK_BF16_FLOPS)
        results[kernel].update(
            ms=sum(ms for n, ms in t["by_name"].items() if name in n),
            wall_ms=t["wall_ms"], kernel_ms=None,
            plain_ms=timed(torch, plain, 3)["device_ms"], library_ms=lib,
            bound_ms=b_ms, bound_by=b_by)
    del q, k, v, do, o, lse, delta, lq, lk, ls, lo
    torch.cuda.empty_cache()

    # -- E: fused AdamW and SGD ------------------------------------------
    # every input at a scale where one step moves each output (p, m, v,
    # the momentum buffer) by far more than the tolerance, so a store
    # that is missing or misplaced cannot pass
    for n, offset in ((768 * 2048, 0), (1_000_003, 0), (4099, 1)):
        def leaf(scale, positive=False):
            x = randn(n + offset, scale=scale)
            return (x.abs() if positive else x)[offset:]
        p, grad, buf = leaf(0.05), leaf(0.1), leaf(1e-2)
        m, v = leaf(1e-2), leaf(1e-2, positive=True)
        for step in (1, 10):
            for kernel, names, ins, want, got in (
                    ("fused_adam", ("p", "m", "v"), (p, m, v),
                     FO.reference_apply_adam(p, grad, m, v, step, 1e-4,
                                             weight_decay=0.01),
                     FO.fused_apply_adam(p.clone(), grad, m.clone(),
                                         v.clone(), step, 1e-4,
                                         weight_decay=0.01)),
                    ("fused_sgd", ("p", "momentum_buf"), (p, buf),
                     FO.reference_apply_sgd(p, grad, buf, 0.01, 0.9, 0.01),
                     FO.fused_apply_sgd(p.clone(), grad, buf.clone(), 0.01,
                                        0.9, 0.01))):
                torch.cuda.synchronize()
                for out, x, a, b in zip(names, ins, got, want):
                    case = f"{out} n={n} offset={offset} step={step}"
                    moved = err(b, x)
                    if not moved > 10 * TOL["update"]:
                        raise AssertionError(f"{kernel} {case}: the step "
                                             f"moves it by only {moved}")
                    record(kernel, case, err(a, b), "update")

    # timed over one training step's 12 leaves
    shapes = _train_leaf_shapes()
    numel = sum(math.prod(s) for s in shapes)
    ps = [randn(*s, scale=0.05) for s in shapes]
    gs = [randn(*s, scale=1e-3) for s in shapes]
    ms_ = [torch.zeros_like(x) for x in ps]
    vs_ = [torch.zeros_like(x) for x in ps]

    def adam():
        for a, b, c, d in zip(ps, gs, ms_, vs_):
            FO.fused_apply_adam(a, b, c, d, 10, 1e-4, weight_decay=0.01)

    def adam_plain():
        for a, b, c, d in zip(ps, gs, ms_, vs_):
            FO.reference_apply_adam(a, b, c, d, 10, 1e-4, weight_decay=0.01)

    def sgd():
        for a, b, c in zip(ps, gs, ms_):
            FO.fused_apply_sgd(a, b, c, 1e-4, 0.9, 0.01)

    def sgd_plain():
        for a, b, c in zip(ps, gs, ms_):
            FO.reference_apply_sgd(a, b, c, 1e-4, 0.9, 0.01)

    for x, gx in zip(ps, gs):
        x.grad = gx
    lib = {}
    for label, cls, kw in (("fused_adam", torch.optim.AdamW,
                            dict(lr=1e-4, weight_decay=0.01)),
                           ("fused_sgd", torch.optim.SGD,
                            dict(lr=1e-4, momentum=0.9, weight_decay=0.01))):
        try:   # a yardstick only: a torch without the fused op gives None
            opt = cls(ps, fused=True, **kw)
        except (RuntimeError, TypeError, ValueError) as e:
            emit({"phase": "kernels", "kernel": label,
                  "library": f"torch.optim fused unavailable: {e!r}"})
            lib[label] = None
            continue
        lib[label] = timed(torch, opt.step, 10)["device_ms"]
        del opt
    for kernel, fn, plain, per_elem in (("fused_adam", adam, adam_plain, 28),
                                        ("fused_sgd", sgd, sgd_plain, 20)):
        b_ms, b_by = bound(per_elem * numel, 0)
        t = timed(torch, fn, 10)
        results[kernel].update(
            ms=t["device_ms"], wall_ms=t["wall_ms"], kernel_ms=None,
            plain_ms=timed(torch, plain, 3)["device_ms"],
            library_ms=lib[kernel], bound_ms=b_ms, bound_by=b_by,
            leaves=len(shapes), elements=numel)
    del ps, gs, ms_, vs_
    torch.cuda.empty_cache()


def phase_train_tiny(torch, K):
    """Kernel path == plain path through a tiny Llama ``fit``."""
    import numpy as np
    from zoo_tpu_torch.models.llm.llama import (Llama, init_params,
                                                tiny_llama_config)
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    cfg = tiny_llama_config()
    rs = np.random.RandomState(3)
    ids = rs.randint(0, cfg.vocab, (32, 32)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    start = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    out = {}
    for label, impl, fused in (("kernels", "flash", True),
                               ("plain", "dense", False)):
        m = Sequential().add(Llama(cfg, attention_impl=impl,
                                   input_shape=(32,)))
        m.compile(AdamWeightDecay(lr=1e-3, fused=fused), LOSS)
        m.params = {"000_llama": tree_map(torch.clone, start)}
        K.reset_launch_counts()
        hist = m.fit(ids, labels, batch_size=4, nb_epoch=2, shuffle=True,
                     seed=0, verbose=0, device="cuda")
        torch.cuda.synchronize()
        out[label] = (hist["loss"], m.params["000_llama"],
                      K.launch_counts())
    (lk, pk, ck), (lp, pp, cp) = out["kernels"], out["plain"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    param_err = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(tree_leaves(pk), tree_leaves(pp)))
    emit({"phase": "train-tiny", "loss_kernels": lk, "loss_plain": lp,
          "loss_max_rel": loss_rel, "param_max_abs": param_err,
          "launches": ck, "launches_plain": cp})
    if not (loss_rel <= 1e-4 and param_err <= 1e-4):
        raise AssertionError(f"train-tiny: kernel path differs from plain: "
                             f"loss rel {loss_rel}, params {param_err}")
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq", "fused_adam"):
        if ck[k] <= 0 or cp[k] != 0:
            raise AssertionError(f"train-tiny: {k} launched {ck[k]} times "
                                 f"with the kernels, {cp[k]} without")


def phase_train_main(torch, K, card):
    """Keras ``fit`` of the training config at full width and depth."""
    import numpy as np
    from zoo_tpu_torch.models.llm.llama import Llama, LlamaConfig
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay

    cfg = LlamaConfig(**TRAIN_CFG)
    B, S = TRAIN_B, TRAIN_S
    m = Sequential().add(Llama(cfg, remat="dots", input_shape=(S,)))
    m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS,
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (3 * B, S)).astype(np.int32)
    labels = np.roll(ids, -1, axis=1)
    t0 = time.perf_counter()
    m.build(torch.Generator(device="cuda").manual_seed(0),
            device="cuda")
    n_params = sum(x.numel() for x in tree_leaves(m.params))
    # warm-up: two steps on two batches
    m.fit(ids[:2 * B], labels[:2 * B], batch_size=B, nb_epoch=1,
          shuffle=False, verbose=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # timed: TRAIN_STEPS steps, one per epoch on one batch, so the
    # history holds every step's loss
    batch = (ids[2 * B:], labels[2 * B:])
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = m.fit(*batch, batch_size=B, nb_epoch=TRAIN_STEPS, shuffle=False,
                 verbose=0, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    losses = hist["loss"]
    step_s = wall / TRAIN_STEPS
    h, kv = cfg.hidden, cfg.n_kv_head * cfg.head_dim
    fwd_per_token = cfg.n_block * (
        2 * (h * h * 2 + 2 * h * kv) + 2 * 3 * h * cfg.intermediate
        + 4 * S * h) + 2 * h * cfg.vocab            # bench.py:447-453
    flops_per_sample = 3 * fwd_per_token * S
    emit({"phase": "train-main", "config": TRAIN_CFG, "card": card,
          "seq_len": S, "batch": B, "steps": TRAIN_STEPS,
          "params": n_params, "setup_s": setup_s, "wall_s": wall,
          "step_ms": step_s * 1e3, "tokens_per_s": B * S / step_s,
          "mfu": flops_per_sample * B / step_s / PEAK_BF16_FLOPS,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / TRAIN_STEPS for k, v in
                                counts.items()},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "attention_impl": m.layers[0].last_attention_impl})
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"train-main: losses {losses}")
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq", "fused_adam"):
        if counts[k] <= 0:
            raise AssertionError(f"train-main: {k} never launched")

    def group(name):
        n = name.lower()
        for key, label in (("flash_fwd_kernel", "flash_fwd"),
                           ("flash_bwd_dkdv_kernel", "flash_dkdv"),
                           ("flash_bwd_dq_kernel", "flash_dq"),
                           ("adam_kernel", "fused_adam")):
            if key in n:
                return label
        if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul",
                                "xmma", "nvjet")):
            return "matmul"
        return "other"

    t = timed(torch, lambda: m.fit(*batch, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    groups = {}
    for name, ms in t["by_name"].items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:16]
    emit({"phase": "step", "card": card, "steps": 3,
          "wall_ms": t["wall_ms"], "device_ms": t["device_ms"],
          "device_busy_share": t["device_ms"] / t["wall_ms"],
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in top]})
    return {k: counts[k] for k in ("flash_attention", "flash_attention_dkdv",
                                   "flash_attention_dq", "fused_adam",
                                   "fused_sgd")}


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
            host = sorted(t["host_by_name"].items(),
                          key=lambda kv: -kv[1])[:8]
            emit({"phase": "tick", "decode_impl": impl, "card": card,
                  "slots": S, "context": n_prompt, "ticks": ticks,
                  "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
                  "device_ms": t["device_ms"],
                  "device_busy_share": t["device_ms"] / t["wall_ms"],
                  "device_ms_by_group": groups,
                  "top_device_ms": [[k[:80], v] for k, v in top],
                  "top_host_self_ms": [[k[:80], v] for k, v in host]})
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
        phase_train_tiny(torch, K)
        # each main path's launches, counted from 0 just before it runs
        by_path = {"serve": phase_main(torch, K, card),
                   "train": phase_train_main(torch, K, card)}

        src = "zoo_tpu_torch/csrc/"
        pallas = "zoo_tpu/ops/pallas/"
        sources = {
            "flash_attention": ("flash_attention_fwd.cu",
                                "flash_attention.py:35"),
            "flash_attention_dkdv": ("flash_attention_bwd.cu",
                                     "flash_attention.py:151"),
            "flash_attention_dq": ("flash_attention_bwd.cu",
                                   "flash_attention.py:213"),
            "fused_adam": ("fused_optim.cu", "fused_optim.py:87"),
            "fused_sgd": ("fused_optim.cu", "fused_optim.py:49"),
            "paged_decode": ("paged_decode.cu", "paged_decode.py:55"),
            "paged_prefill": ("paged_prefill.cu", "paged_prefill.py:54")}
        kernels = []
        for k in K.KERNELS:
            t = timing[k]
            paths = {p: c[k] for p, c in by_path.items() if k in c}
            kernels.append({
                "name": k, "route": "cuda", "source": src + sources[k][0],
                "replaces": pallas + sources[k][1],
                "launches": sum(paths.values()), "launches_by_path": paths,
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
