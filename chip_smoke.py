#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``zoo_tpu_torch``) on one Hopper card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It imports neither JAX nor the JAX package, builds the port's CUDA
kernels from ``zoo_tpu_torch/csrc`` and prints one JSON line per phase:

1. device — name, capability, count, power limit (fails off Hopper);
2. build — nvcc wall time and each kernel function's ``-Xptxas -v``
   registers, shared memory and spills (fails if an instance of the f32
   conv, the f32 flash backward or the two-pass int8 GEMM spills);
2b. sass — how each kernel multiplies, read from the built libraries'
   SASS (``cuobjdump -sass``): ``wgmma`` (HGMMA, IGMMA), ``mma.sync``
   (HMMA, IMMA) or ``simt``; fails unless the bf16 conv, the bf16
   flash forward and backward (dK/dV, dQ), the fused bottleneck and
   both int8 GEMMs run on the tensor cores, the bf16, f32 (3xTF32)
   and int8 convs and the two-pass int8 GEMM on ``wgmma``, and the
   shuffles of the paged decode, both int8 GEMMs and the f32 flash
   forward and backward (dK/dV, dQ) all on the fast path (no
   ``WARPSYNC.COLLECTIVE``);
3. kernels — each kernel against its plain PyTorch version at the
   Llama-3-8B serving shapes, for f32, bf16 and int8 caches and the
   position edges, then timed (device time per call from
   ``torch.profiler``, and CUDA-event wall time; for the paged decode
   and both int8 GEMMs also the device launches per call, which must
   be one) beside its plain
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
   paged-decode kernel and with its plain version (device time by group,
   device launches per tick);
6. train-main — Keras ``fit`` of the repo's Llama training config
   (``bench.py`` ``bench_llama``: vocab 32000, hidden 768, 12 blocks, 12
   heads, 4 kv heads, intermediate 2048) at full width and depth, S=512,
   B=64, ``mixed_bfloat16``, ``remat="dots"``, fused AdamW: a warm-up
   fit, then a timed fit of 8 steps (per-step losses finite and
   falling, launches of flash fwd / dK-dV / dQ / AdamW counted), then
   a ``step`` line profiling train steps by kernel group;
7. infer-tiny — a tiny ResNet (bottleneck, blocks (1, 1), 32x32x3, 10
   classes, BatchNorm stats drawn from a seed) predicts through the
   conv kernels within 1e-5 of the plain path in f32, and after
   ``quantize_model`` through the int8 kernels bit-equal to it;
8. infer-main — ``resnet50(1000, (224, 224, 3))`` at full width and
   depth, seed weights, ``mixed_bfloat16``, behind
   ``InferenceModel.load_keras(batch_size=128)``: 8 batches of 128
   images (``bench.py`` ``bench_resnet50_int8_infer``'s
   ``RandomState(0).randn``) in float, then after
   ``quantize_model(mode="force")`` in int8, one batch with
   ``ZOO_INT8_MATMUL=unfused``, and a ``quantize_model(mode="auto")``
   verdict; samples/s, launches per forward (49 ``conv2d``, or 49
   ``conv2d_int8`` and one head GEMM), kernel path vs plain path on one
   batch, top-1 agreement of int8 with float, peak memory, and an
   ``infer-step`` line profiling one batch per path;
8b. train-image-tiny — the tiny ResNet of phase 7 ``fit`` with
   ``SGD(0.1, 0.9)``, f32, 8 images, two shuffled epochs at B=4,
   through the conv kernel and the SGD kernel, equals the same ``fit``
   through their plain versions, and repeats itself bit for bit in
   three runs (beside three runs with the reference conv's backward
   free to take cuDNN's nondeterministic algorithms, a control);
9. bottleneck-main — ``fused_bottleneck`` at the geometries of
   ResNet-50's twelve identity blocks (four stages, B=128, bf16),
   forward and forward+backward, one kernel launch per call and no
   composition fallback, beside the port's unfused block (three
   ``conv2d`` dispatches); ms per stage;
10. train-image-main — Keras ``fit`` of ``bench.py`` ``bench_resnet50``
   (``resnet50(1000, (224, 224, 3))``, ``SGD(lr=0.1, momentum=0.9)``,
   ``mixed_bfloat16``, B=128, ``RandomState(0)`` images and labels,
   ``shuffle=False``) at full width and depth: a warm-up fit, 8 timed
   steps (step ms, samples/s, ``mfu`` against ``bench.py``'s 8.0 GFLOP
   per forward, losses finite, 49 ``conv2d`` per forward and one SGD
   launch per trainable leaf per step, running stats moved), then
   ``evaluate(metrics=["accuracy"])`` on 256 images and a
   ``train-image-step`` line profiling steps by kernel group;
11. train-f32-main — the same two training configs (``bench_llama``
   at S=512, B=64, ``remat="dots"``, fused AdamW; ``bench_resnet50`` at
   B=128, ``SGD(0.1, 0.9)``) through Keras ``fit`` with ``compile``
   given no ``dtype_policy``: the ``float32`` default a user gets, which
   runs the f32 routes (the f32 flash forward, dK/dV and dQ; the f32
   conv). Each: a warm-up step, then 4 timed steps on one batch (step
   ms, tokens/s or samples/s, losses finite and falling, peak memory;
   12 flash forward, 12 dK/dV and 12 dQ launches a step, or 49 ``conv2d``
   a forward), and a ``train-f32-step`` line profiling steps by kernel
   group.

Phase 3 also holds the flash forward (o, lse) and backward kernels
(dK/dV, dQ) against their plain versions, and the gradients against
autograd of the dense path, at B=8 and B=64, H=12, Hkv=4, T=512, D=64
(the f32 backward route timed at B=8 and B=64), checks that the reference
conv's f32 gradients do not change with cuDNN's TF32 switched on, and
holds the fused AdamW and SGD kernels against theirs, then times them at the
training config's shapes beside their bounds and a library yardstick
(``scaled_dot_product_attention`` and its backward, ``torch.optim``'s
fused AdamW and SGD) the port never calls; and the implicit-GEMM conv
kernels (bf16, f32, int8) at four ResNet-50 shapes, B=128 (int8 on the
K-major weight copy a quantized layer carries, the copy's one-time cost
printed apart), and the int8
GEMMs at the ResNet-50 head, at ``bench_int8_matmul``'s shape and (the
two-pass one, and the fused op's hand-over to it past K = 8192: one
``quantized_matmul`` launch, no fused one) at VGG-16's fc6, B=128,
beside ``F.conv2d`` and ``torch._int_mm`` as yardsticks; the reference
conv's gradients (``conv2d_plain_grads``, the float conv's backward)
repeat bit for bit on the same inputs at the four timed conv shapes,
B=128, f32 and bf16; and the
fused bottleneck at ResNet-50's four identity geometries (B=128, bf16,
and f32 at conv2_x) with its gradients at conv2_x, timed beside the
unfused cuDNN composition (three ``F.conv2d``, the ReLUs and the add),
a yardstick the port never calls.

The bf16, f32 and int8 convs (per shape and summed; the f32 conv also
beside its 3xTF32 bound), the bf16 flash forward and backward kernels at the training
shape, the f32 flash forward and the paged prefill at the serving
shape and the int8 GEMMs at their GEMM shapes also print TFLOP/s
(TOP/s for int8), the share of their bound they reach and, where there
is one, their time over the library call's; the f32 flash forward and
the int8 GEMMs also print their launch plans. The paged prefill is also
held to its plain version at a one-row and a 17-row chunk of three
sequences.

Then a ``{"kernels": [...]}`` line (each entry with its ``mma`` route;
for ``conv2d`` and the three flash kernels the numbers are the bf16
route's, the f32 route's sit under ``f32_route``), the card's name and power
limit as ``nvidia-smi`` reports them, and last ``{"ok": true, "device":
...}``.
Any failure exits non-zero without the ``ok`` line. Without a CUDA
device, or without the package beside this file, it exits 2.
"""

import contextlib
import json
import math
import os
import re
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
PEAK_TF32_FLOPS = 495e12          # H100 SXM TF32 tensor cores, dense
PEAK_INT8_OPS = 1979e12           # H100 SXM int8 tensor cores, dense
LOSS = "sparse_categorical_crossentropy_from_logits"
# the training config: bench.py bench_llama, full width and depth
TRAIN_CFG = dict(vocab=32000, hidden=768, n_block=12, n_head=12,
                 n_kv_head=4, intermediate=2048, rope_theta=10000.0)
TRAIN_S, TRAIN_B, TRAIN_STEPS = 512, 64, 8
# the image-inference path: bench.py bench_resnet50_int8_infer
INFER_B, INFER_STEPS = 128, 8
# ResNet-50 convs inside the kernels' envelope, (spatial, C, k, O, stride)
CONV_SHAPES = ((56, 256, 1, 64, 1), (28, 128, 3, 128, 1),
               (56, 256, 1, 512, 2), (7, 512, 3, 512, 1))
# (M, K, N): the ResNet-50 head at B=128, bench.py bench_int8_matmul, and
# VGG-16's fc6 at B=128 (7x7x512 = 25088 features into Dense(4096)), where
# the fused path hands over to the two-pass path (K > 8192): 103 MB of
# int8 weights, 12.8 MB of f32 x and an 822 MB float64 copy of w for the
# plain version, all freed after the shape
GEMM_SHAPES = ((128, 2048, 1000), (512, 1024, 1024), (128, 25088, 4096))
# ResNet-50's identity bottlenecks per stage: (name, spatial, Cin, Cmid)
BLOCK_STAGES = (("conv2_x", 56, 256, 64), ("conv3_x", 28, 512, 128),
                ("conv4_x", 14, 1024, 256), ("conv5_x", 7, 2048, 512))
BLOCK_B, BLOCK_GRAD_B = 128, 32
# the image-training path: bench.py bench_resnet50 (:371-384)
TRAIN_IMG_B, TRAIN_IMG_STEPS, TRAIN_IMG_N = 128, 8, 1024
RESNET50_FWD_FLOPS = 8.0e9          # bench.py:65, per image
# the f32 training path (the default policy): timed steps of each model
TRAIN_F32_STEPS = 4

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
# The conv kernel against its plain version (cuDNN in f32, TF32 off):
# f32 within 1e-5 of the largest output (the same f32 sums in another
# order over up to 9 * C = 4608 terms), bf16 within one bf16 ulp of it,
# 2**-7 (both round one f32 sum, which may fall either side of a tie).
# The int8 kernels: exact (integer sums, the same f32 epilogue).
# The tiny ResNet's probabilities through the f32 conv kernels: 1e-5.
TOL = {"float32": 1e-4, "bfloat16": 3e-2, "update": 1e-6,
       "conv_f32": 1e-5, "conv_bf16": 2.0 ** -7, "int8": 0.0,
       "block": 2.0 ** -6, "block_grad": 2e-2}
TOL_TINY_F32 = 1e-5
# The fused bottleneck against its plain version ("block"): within 2**-6
# of the largest output (both round t1, t2, z3 and y to bf16 and may land
# on either side of a tie after summing in another order); its gradients
# through the op (recompute backward) against autograd of the
# composition ("block_grad"): within 2e-2 of the largest gradient.
# Besides, at least BLOCK_BIT_EQUAL of its outputs equal the plain
# version's bit for bit (readings 0.99974 to 0.99997 at the four
# stages): a fault confined to few or small outputs, such as a skipped
# bf16 rounding of z3 or a wrong tap on a tile's border row, stays under
# the max-diff limit but not under this one.
BLOCK_BIT_EQUAL = 0.999
# the tiny ResNet fit, kernel path vs plain path, relative to each
# loss and, by norm, to each parameter and running stat: one step
# differs by the conv's summation order (~1e-7); SGD(0.1, 0.9) on random
# labels is an unstable run that amplifies it step by step (see
# phase_train_image_tiny)
TOL_TRAIN_TINY = 1e-3
# full-width ResNet-50 in bf16, kernel path vs plain path: the two round
# the conv sums to bf16 on either side of ties at other elements, and 53
# layers carry that on; the probabilities stay within this
TOL_MAIN_BF16 = 5e-2


# kernel -> (its library, the __global__ function of its main-path
# route): for conv2d and the flash forward and backward the bf16
# tensor-core bodies; their f32 routes are F32_ROUTES
MMA_FUNCTIONS = {
    "flash_attention": ("flash_attention", "flash_fwd_tc_kernel"),
    "flash_attention_dkdv": ("flash_attention_bwd",
                             "flash_bwd_dkdv_tc_kernel"),
    "flash_attention_dq": ("flash_attention_bwd", "flash_bwd_dq_tc_kernel"),
    "fused_bottleneck": ("fused_block", "fused_bottleneck_kernel"),
    "fused_adam": ("fused_optim", "adam_kernel"),
    "fused_sgd": ("fused_optim", "sgd_kernel"),
    "paged_decode": ("paged_decode", "paged_decode_kernel"),
    "paged_prefill": ("paged_prefill", "paged_prefill_kernel"),
    "conv2d": ("conv2d", "conv_tc_kernel"),
    "conv2d_int8": ("conv2d", "conv_i8_tc_kernel"),
    "quantized_matmul": ("quant_matmul", "qmm_kernel"),
    "fused_quantized_matmul": ("quant_matmul", "fqmm_kernel")}
F32_ROUTES = {"flash_attention": ("flash_attention", "flash_fwd_kernel"),
              "flash_attention_dkdv": ("flash_attention_bwd",
                                       "flash_bwd_dkdv_kernel"),
              "flash_attention_dq": ("flash_attention_bwd",
                                     "flash_bwd_dq_kernel"),
              "conv2d": ("conv2d", "conv_f32_tc_kernel")}
# kernels whose main-path route must run on the tensor cores
TENSOR_CORE_KERNELS = ("conv2d", "flash_attention", "flash_attention_dkdv",
                       "flash_attention_dq", "fused_bottleneck",
                       "quantized_matmul", "fused_quantized_matmul")
# ... and on wgmma (HGMMA for bf16, IGMMA for int8); F32_WGMMA: the same
# of F32_ROUTES (the f32 conv, as 3xTF32)
WGMMA_KERNELS = ("conv2d", "conv2d_int8", "quantized_matmul")
F32_WGMMA = ("conv2d",)
# kernels whose warp shuffles must all take the fast path (the decode
# reduces each key row's scores across the warp, the fused int8 GEMM each
# row's absmax; the two-pass int8 GEMM has none, and keeps it so);
# F32_FAST_SHUFFLE: the same of F32_ROUTES (the f32 flash forward reduces
# each row's max over 8 lanes; the backward kernels vote on their causal
# skips)
FAST_SHUFFLE_KERNELS = ("paged_decode", "quantized_matmul",
                        "fused_quantized_matmul")
F32_FAST_SHUFFLE = ("flash_attention", "flash_attention_dkdv",
                    "flash_attention_dq")
# __global__ functions whose ptxas report must show no spills: the f32
# conv, the f32 flash backward and the two-pass int8 GEMM, redesigned to
# keep their sums in registers
NO_SPILL_FUNCTIONS = ("conv_f32_tc_kernel", "f3221flash_bwd_dkdv_kernel",
                      "f3219flash_bwd_dq_kernel", "10qmm_kernel")


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


def ptxas_lines(report):
    """``function: Used ...`` and ``function: ... spill ...`` lines of an
    ``nvcc -Xptxas -v`` report, each named by its (mangled) function."""
    out, fn = [], "?"
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1] if ln.count("'") >= 2 else ln.strip()
        elif "Used" in ln:
            out.append(f"{fn}: {ln.split(':', 1)[-1].strip()}")
        elif "spill" in ln:
            out.append(f"{fn}: {ln.strip()}")
    return out


def cuobjdump():
    """``cuobjdump`` of the CUDA toolkit that builds the kernels (or of
    Triton's package, which carries one)."""
    from zoo_tpu_torch.ops.kernels._build import find_nvcc
    cands = [os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if os.access(c, os.X_OK):
            return c
    raise AssertionError(f"cuobjdump not found (looked at {cands})")


def sass_functions(path):
    """{mangled function name: its SASS} of a built kernel library."""
    out = subprocess.run([cuobjdump(), "-sass", path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if "Function : " in line:
            name = line.split("Function : ", 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return {k: "\n".join(v) for k, v in funcs.items()}


def mma_route(funcs, function):
    """How the instances of ``__global__ function`` multiply, read from
    their SASS: ``"wgmma"`` (HGMMA, or IGMMA for int8), ``"mma.sync"``
    (HMMA, IMMA) or
    ``"simt"``; with the instruction counts, the instances found and the
    ``WARPSYNC.COLLECTIVE`` count (the slow path of a warp shuffle or vote
    the compiler could not prove converged)."""
    key = f"{len(function)}{function}"          # as the name is mangled
    hit = [f for n, f in funcs.items() if key in n]
    if not hit:
        raise AssertionError(f"{function}: not in the library's SASS")
    counts = {op: sum(len(re.findall(rf"\b{op}\b", f)) for f in hit)
              for op in ("HGMMA", "IGMMA", "HMMA", "IMMA")}
    route = "wgmma" if counts["HGMMA"] or counts["IGMMA"] else \
        "mma.sync" if counts["HMMA"] or counts["IMMA"] else "simt"
    collective = sum(f.count("WARPSYNC.COLLECTIVE") for f in hit)
    return {"mma": route, "counts": counts, "instances": len(hit),
            "collective_syncs": collective}


def check_no_spills(built):
    """Raise unless each of :data:`NO_SPILL_FUNCTIONS` has instances in
    the ``-Xptxas -v`` reports and every one reports 0 bytes of spill
    stores and loads."""
    seen = set()
    for r in built.values():
        fn = None
        for ln in r.ptxas.splitlines():
            if "Compiling entry function" in ln:
                fn = ln.split("'")[1] if ln.count("'") >= 2 else ln
            elif "spill" in ln and fn:
                for k in NO_SPILL_FUNCTIONS:
                    if k not in fn:
                        continue
                    seen.add(k)
                    if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                        raise AssertionError(f"{fn} spills: {ln.strip()}")
    if seen != set(NO_SPILL_FUNCTIONS):
        raise AssertionError("no ptxas report of "
                             f"{set(NO_SPILL_FUNCTIONS) - seen}")


def phase_sass(built):
    """Each kernel's multiply route from the built libraries' SASS; fails
    unless the bf16 routes of conv2d and the flash forward and backward,
    the fused bottleneck and both int8 GEMMs run on the tensor cores,
    unless conv2d (bf16 and f32), conv2d_int8 and ``quantized_matmul``
    run on ``wgmma``, and unless the paged decode, both int8 GEMMs and
    the f32 flash forward and backward are free of
    ``WARPSYNC.COLLECTIVE`` (slow-path shuffles). The paged kernels, the
    optimizers and the f32 flash routes read ``simt``; the paged kernels
    and the f32 flash kernels by design: the f32 paths stay on f32 FMAs
    (one TF32 product would break their tolerance) and the decode does
    ~4 flops a cache element."""
    sass = {lib: sass_functions(r.path) for lib, r in built.items()}
    routes = {k: mma_route(sass[lib], fn)
              for k, (lib, fn) in MMA_FUNCTIONS.items()}
    f32 = {k: mma_route(sass[lib], fn) for k, (lib, fn) in
           F32_ROUTES.items()}
    emit({"phase": "sass", "kernels": routes, "f32_routes": f32})
    for k in TENSOR_CORE_KERNELS:
        if routes[k]["mma"] == "simt":
            raise AssertionError(f"{k}: its main-path route has no "
                                 "tensor-core instruction in its SASS")
    for k, route in [(k, routes[k]) for k in FAST_SHUFFLE_KERNELS] + \
            [(f"{k} (f32 route)", f32[k]) for k in F32_FAST_SHUFFLE]:
        if route["collective_syncs"]:
            raise AssertionError(f"{k}: {route['collective_syncs']} "
                                 "WARPSYNC.COLLECTIVE in its SASS")
    for k, route in [(k, routes[k]) for k in WGMMA_KERNELS] + \
            [(f"{k} (f32 route)", f32[k]) for k in F32_WGMMA]:
        if route["mma"] != "wgmma":
            raise AssertionError(f"{k}: reads {route['mma']}, not wgmma, in "
                                 f"its SASS ({route['counts']})")
    return routes, f32


def _profiled(torch, fn, iters, kernel):
    """One ``torch.profiler`` pass over ``iters`` calls: the device us of
    all events, of those whose name holds ``kernel``, ms per call by
    device and by host event name, device launches per call, and the
    launches per call of the events whose name holds ``kernel``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = only = 0.0
    launches = kernel_launches = 0
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
            kernel_launches += e.count
        if not e.key.startswith(("Memcpy", "Memset")):
            launches += e.count
    return (total, only, by_name, host_by_name, launches / iters,
            kernel_launches / iters)


def timed(torch, fn, iters, kernel=None, warmup=3, attempts=3):
    """Per call: ``device_ms``, the device time of everything ``fn``
    launches (torch.profiler's kernel, copy and memset events, summed);
    ``kernel_ms``, the part spent in kernels whose name holds
    ``kernel``; ``wall_ms``, CUDA-event time over back-to-back calls,
    which also counts the host's launch overhead when the host is the
    slower side; ``host_ms``, the host clock per call over the same calls
    until the last is issued (near ``wall_ms`` when the host is the
    slower side); ``by_name``, device ms per call of each event name;
    ``host_by_name``, host ms per call of each host event, its own time
    without its children's, under the profiler (which adds its own);
    ``device_busy_share``, ``device_ms`` over ``wall_ms``;
    ``device_launches``, the device kernels ``fn`` launches per call
    (copies and memsets not counted).

    The profiler now and then returns no device event at all on the
    card's machine, or drops some of a pass's kernel records (passes
    have read 0.2, 0.64 and 0.8 launches a call of a kernel that
    launches once, with device time short by as much, where the launch
    counters, the outputs and the CUDA-event times were right); a pass
    that records no device time, or, given ``kernel``, a part of a
    launch of it per call (records of it, but not a whole number a
    call), is repeated, up to ``attempts`` passes. If none passes,
    ``device_ms`` is CUDA-event time from just before to just after
    each call (an upper bound: it
    also holds the host's launch of the call when the device waits for
    it), ``device_source`` says ``cuda_events``, and ``kernel_ms``,
    ``by_name`` and ``device_busy_share`` are empty."""
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
    for attempt in range(1, attempts + 1):
        total, only, by_name, host_by_name, launches, own = _profiled(
            torch, fn, iters, kernel)
        dropped = own > 0 and abs(own - round(own)) > 1e-9
        if total > 0 and not dropped:
            device = total / iters / 1e3
            return {"device_ms": device, "wall_ms": wall, "host_ms": host,
                    "kernel_ms": only / iters / 1e3 if kernel else None,
                    "by_name": by_name, "host_by_name": host_by_name,
                    "device_busy_share": device / wall,
                    "device_launches": launches,
                    "device_source": "profiler"}
        emit({"phase": "timing", "kernel": kernel, "attempt": attempt,
              "kernel_launches_per_call": own,
              "note": "torch.profiler recorded no device time" if not total
              else "torch.profiler dropped kernel records"})
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    device = sum(a.elapsed_time(b) for a, b in pairs) / iters
    return {"device_ms": device, "wall_ms": wall, "host_ms": host,
            "kernel_ms": None, "by_name": {}, "host_by_name": host_by_name,
            "device_busy_share": None, "device_launches": None,
            "device_source": "cuda_events"}


def timing(torch, kernel, fn, plain, library, iters):
    """The kernel wrapper's times beside its plain version's and, where
    one exists, the library call's (device time per call)."""
    t = timed(torch, fn, iters, kernel=kernel)
    return {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
            "wall_ms": t["wall_ms"], "by_name": t["by_name"],
            "device_launches_per_call": t["device_launches"],
            "plain_ms": timed(torch, plain, max(3, iters // 5))["device_ms"],
            "library_ms": None if library is None else
            timed(torch, library, iters)["device_ms"]}


def timing_one_launch(torch, name, kernel, fn, plain, library, iters):
    """:func:`timing` of a wrapper that must make one device launch a
    call; fails when the profiler counts another number."""
    t = timing(torch, kernel, fn, plain, library, iters)
    n_dev = t["device_launches_per_call"]
    if n_dev not in (None, 1.0):
        raise AssertionError(f"{name}: {n_dev} device launches per call, "
                             "expected 1")
    return t


def bound(nbytes, flops, peak=PEAK_F32_FLOPS):
    """Least time (ms) for work that must move ``nbytes`` and do
    ``flops`` at ``peak`` flop/s (f32 by default), and which of the two
    sets it."""
    t_b = nbytes / PEAK_BYTES * 1e3
    t_f = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rates(ops, ms, bound_ms, library_ms):
    """A timed call's rate (TFLOP/s or TOP/s), the share of its bound it
    reaches (bound ms over ms) and how many times the library call's
    time it takes (None without one)."""
    return {"tflops": ops / ms / 1e9, "bound_ratio": bound_ms / ms,
            "library_ratio": None if library_ms is None else
            ms / library_ms}


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
        # ``magnitude``: the largest output, given where the tolerance
        # scales with it (see TOL)
        tol = TOL[dtype] * (max(1.0, magnitude) if magnitude is not None
                            and dtype in ("bfloat16", "conv_f32",
                                          "conv_bf16", "block",
                                          "block_grad") else 1.0)
        emit({"phase": "kernels", "kernel": kernel, "case": case,
              "max_abs_err": err, "tol": tol})
        if not err <= tol:
            raise AssertionError(f"{kernel} {case}: max abs err {err} "
                                 f"> {tol}")
        r = results.setdefault(kernel, {"max_abs_err": 0.0,
                                        "max_abs_err_by_dtype": {}})
        if dtype in ("float32", "update", "conv_f32", "conv_bf16", "int8",
                     "block"):
            r["max_abs_err"] = max(r["max_abs_err"], err)
        if magnitude is None or dtype != "bfloat16":   # not vs autograd
            by = r["max_abs_err_by_dtype"]
            by[dtype] = max(by.get(dtype, 0.0), err)

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
    # the f32 route (SIMT body) at the 8B serving shape; the bf16 route
    # is timed at the training shape (phase_training_kernels)
    t = timing(torch, "flash_fwd_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, True),
               lambda: FA.flash_attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 50)
    results["flash_attention"]["f32_route"] = dict(
        t, bound_ms=b_ms, bound_by=b_by,
        shape=f"B=1 H={H} Hkv={HKV} T=512 D={D} f32 causal",
        plan=FA.flash_f32_plan(D, causal=True)._asdict(),
        **rates(4 * D * pairs * H, t["ms"], b_ms, t["library_ms"]))
    emit({"phase": "kernels", "kernel": "flash_attention",
          "timing_f32": results["flash_attention"]["f32_route"]})

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
            before = PD.LAUNCHES
            o = PD.paged_flash_decode(qd, c[0], c[1], tables, positions,
                                      k_scale=c[2], v_scale=c[3])
            if PD.LAUNCHES != before + 1:
                raise AssertionError("paged_decode: one call, "
                                     f"{PD.LAUNCHES - before} launches")
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
            # the split merge runs in the kernel: one device launch a call
            t = timing_one_launch(
                torch, "paged_decode", "paged_decode_kernel",
                lambda: PD.paged_flash_decode(qd, c[0], c[1], tables,
                                              positions),
                lambda: PD.paged_decode_plain(qd, c[0], c[1], tables,
                                              positions), None, 100)
            plan = PD.decode_plan(S, HKV, H // HKV, D, BS, W, 4,
                                  PD.resolve_num_splits(W))
            results["paged_decode"].update(
                t, bound_ms=b_ms, bound_by=b_by,
                shape=f"S={S} H={H} Hkv={HKV} D={D} bs={BS} W={W} f32, "
                      f"{live} live rows",
                plan={"ctas": plan.ctas, "warps": plan.warps,
                      "stages": plan.stages, "chunk_rows": plan.chunk_rows,
                      "copy_bytes": plan.copy_bytes, "smem": plan.smem,
                      "blocks": plan.blocks},
                bound_ratio=b_ms / t["ms"])

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
            # a one-row chunk and a ragged 17-row one, three sequences
            for cs in (1, 17):
                qs = randn(3, cs, H, D)
                pos3 = (torch.tensor([0, 200, 512 - cs], device=dev)[:, None]
                        + torch.arange(cs, device=dev)[None]).to(torch.int32)
                o = PP.paged_flash_prefill(qs, c[0], c[1], tables[:3], pos3)
                ro = PP.paged_prefill_plain(qs, c[0], c[1], tables[:3], pos3)
                torch.cuda.synchronize()
                record("paged_prefill", f"cache f32 S=3 chunk={cs}",
                       err(o, ro), "float32")
            pos = (200 + torch.arange(C, device=dev)).to(torch.int32)[None]
            rows = int(pos.max()) + 1
            pairs = int((pos.long() + 1).sum())
            flops = 4 * pairs * H * D
            b_ms, b_by = bound(
                cache_bytes(c, rows) + 2 * qp.numel() * 4 + C * 4 + W * 4,
                flops)
            # "paged_prefill" names the kernel and its split merge
            t = timing(
                torch, "paged_prefill",
                lambda: PP.paged_flash_prefill(qp, c[0], c[1], tables[:1],
                                               pos),
                lambda: PP.paged_prefill_plain(qp, c[0], c[1], tables[:1],
                                               pos), None, 100)
            plan = PP.prefill_plan(1, C, HKV, H // HKV, D, BS, W, 4)
            results["paged_prefill"].update(
                t, bound_ms=b_ms, bound_by=b_by,
                shape=f"S=1 C={C} H={H} Hkv={HKV} D={D} f32 positions "
                      f"200-263",
                plan={"splits": plan.splits, "blocks": plan.blocks,
                      "smem": plan.smem},
                **rates(flops, t["ms"], b_ms, None))
    phase_training_kernels(torch, record, err, results)
    phase_inference_kernels(torch, record, err, results)
    phase_block_kernels(torch, record, err, results)
    # conv2d and the flash kernels: the line's numbers are the bf16
    # route's, the f32 route's sit under f32_route
    for k, bf, f32 in (("flash_attention", "bfloat16", "float32"),
                       ("flash_attention_dkdv", "bfloat16", "float32"),
                       ("flash_attention_dq", "bfloat16", "float32"),
                       ("conv2d", "conv_bf16", "conv_f32")):
        by = results[k]["max_abs_err_by_dtype"]
        results[k]["max_abs_err"] = by[bf]
        results[k]["f32_route"]["max_abs_err"] = by[f32]
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


def _bwd_timing(torch, FA, q, k, v, o, lse, do):
    """The two backward kernels timed in one ``flash_attention_bwd``
    call (causal), each beside its plain version, its bound (bf16 at the
    tensor cores' peak, f32 at the SIMT peak) and SDPA's backward (all
    three gradients, one call; the same for both), with its TFLOP/s,
    share of its bound and factor over SDPA's backward."""
    import torch.nn.functional as F
    B, H, S, D = q.shape
    pairs = B * H * S * (S + 1) // 2
    item = q.element_size()
    qb, kb = q.numel() * item, k.numel() * item
    stats = 2 * B * H * S * 4                      # lse + delta, f32
    peak = PEAK_BF16_FLOPS if q.dtype == torch.bfloat16 else PEAK_F32_FLOPS
    delta = (do.float() * o.float()).sum(-1)
    t = timed(torch, lambda: FA.flash_attention_bwd(q, k, v, o, lse, do,
                                                    True), 10)
    lq, lk, ls = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    lo = F.scaled_dot_product_attention(lq, lk, ls, is_causal=True,
                                        enable_gqa=True)
    lib = timed(torch, lambda: torch.autograd.grad(
        lo, (lq, lk, ls), do, retain_graph=True), 10)["device_ms"]
    tc = q.dtype == torch.bfloat16
    out = {}
    for kernel, name, plain, nbytes, flops in (
            ("flash_attention_dkdv",
             "flash_bwd_dkdv_tc_kernel" if tc else "flash_bwd_dkdv_kernel",
             lambda: FA.flash_attention_dkdv_plain(q, k, v, do, lse, delta,
                                                   True),
             2 * qb + 2 * kb + stats + 2 * kb, 8 * D * pairs),
            ("flash_attention_dq",
             "flash_bwd_dq_tc_kernel" if tc else "flash_bwd_dq_kernel",
             lambda: FA.flash_attention_dq_plain(q, k, v, do, lse, delta,
                                                 True),
             2 * qb + 2 * kb + stats + qb, 6 * D * pairs)):
        ms = sum(v_ for n, v_ in t["by_name"].items() if name in n)
        if not ms > 0:
            raise AssertionError(f"{name}: no device time recorded "
                                 f"({t['device_source']})")
        b_ms, b_by = bound(nbytes, flops, peak)
        out[kernel] = dict(
            ms=ms, wall_ms=t["wall_ms"], kernel_ms=ms,
            plain_ms=timed(torch, plain, 3)["device_ms"], library_ms=lib,
            bound_ms=b_ms, bound_by=b_by, **rates(flops, ms, b_ms, lib))
    return out


def _check_reference_conv_grads(torch, record, err):
    """The reference conv's gradients (f32, 3x3 stride 2, as ResNet-50's
    3x3/s2 convs take them) with cuDNN's TF32 switched on equal those
    with it off: its backward turns TF32 off itself. Beside them, the
    error autograd of the same ``F.conv2d`` takes under TF32 (what the
    backward was before it did), for scale only."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import conv as CV
    g = torch.Generator(device="cuda").manual_seed(99)
    x = torch.randn(32, 28, 28, 256, generator=g, device="cuda")
    w = torch.randn(3, 3, 256, 256, generator=g, device="cuda") * 0.05
    dy = torch.randn(32, 14, 14, 256, generator=g, device="cuda")
    flag = torch.backends.cudnn.allow_tf32

    def grads(tf32, plain=True):
        torch.backends.cudnn.allow_tf32 = tf32
        xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
        if plain:
            y = CV.conv2d_plain(xs, ws, (2, 2), "SAME")
        else:   # autograd of F.conv2d, as SAME pads 28 -> 14 at stride 2
            y = F.conv2d(F.pad(xs.permute(0, 3, 1, 2), (0, 1, 0, 1)),
                         ws.permute(3, 2, 0, 1), stride=2).permute(
                             0, 2, 3, 1)
        return torch.autograd.grad(y, (xs, ws), dy)

    try:
        off, on = grads(False), grads(True)
        tf32 = grads(True, plain=False)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    for name, a, b, c in zip(("dx", "dw"), on, off, tf32):
        mag = float(b.abs().max())
        emit({"phase": "kernels", "check": "reference_conv_grads",
              "grad": name, "tf32_on_vs_off": err(a, b),
              "autograd_under_tf32_vs_off": err(c, b), "magnitude": mag})
        record("conv2d_reference", f"{name} f32 3x3/s2, TF32 on vs off",
               err(a, b) / mag, "conv_f32")


@contextlib.contextmanager
def cudnn_deterministic(torch, value):
    """Every ``torch.backends.cudnn.flags`` entry made with
    ``deterministic=value``, whatever its caller asks: with False, the
    control, the reference conv's backward as it was before it asked
    cuDNN for deterministic algorithms."""
    cudnn = torch.backends.cudnn
    real = cudnn.flags

    def flags(**kw):
        return real(**dict(kw, deterministic=value))

    cudnn.flags = flags
    try:
        yield
    finally:
        cudnn.flags = real


def _check_reference_conv_determinism(torch):
    """``conv2d_plain_grads`` (the float conv's backward on both the
    kernel path and the plain path) run twice on the same inputs at the
    timed ResNet-50 shapes, B=128, f32 and bf16: as shipped, its ``dx``
    and ``dw`` must repeat bit for bit; under the control
    (:func:`cudnn_deterministic` False) whether they do is printed."""
    from zoo_tpu_torch.ops.kernels import conv as CV
    g = torch.Generator(device="cuda").manual_seed(77)
    B = INFER_B
    seen = {"reference": [], "control": []}
    for h, c, k, o, s in CONV_SHAPES:
        oh = -(-h // s)
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn(B, h, h, c, generator=g, device="cuda").to(dt)
            w = (torch.randn(k, k, c, o, generator=g, device="cuda")
                 / math.sqrt(k * k * c)).to(dt)
            dy = torch.randn(B, oh, oh, o, generator=g, device="cuda").to(dt)
            for label, ctx in (("reference", contextlib.nullcontext),
                               ("control", lambda: cudnn_deterministic(
                                   torch, False))):
                with ctx():
                    a = CV.conv2d_plain_grads(x, w, dy, (s, s))
                    b = CV.conv2d_plain_grads(x, w, dy, (s, s))
                torch.cuda.synchronize()
                same = {n: bool(torch.equal(p, q))
                        for n, p, q in zip(("dx", "dw"), a, b)}
                seen[label].append(all(same.values()))
                emit({"phase": "kernels", "check": "reference_conv_repeat",
                      "path": label, "shape": f"B={B} {shape}",
                      "dtype": str(dt).split(".")[-1], "bit_equal": same,
                      "max_abs_diff": {n: float((p.float() - q.float())
                                                .abs().max())
                                       for n, p, q in zip(("dx", "dw"),
                                                          a, b)}})
            del x, w, dy, a, b
    torch.cuda.empty_cache()
    emit({"phase": "kernels", "check": "reference_conv_repeat",
          "repeats": {k: f"{sum(v)}/{len(v)}" for k, v in seen.items()}})
    if not all(seen["reference"]):
        raise AssertionError("conv2d_plain_grads: a second run on the "
                             "same inputs gave other bits")


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
    t = timing(torch, "flash_fwd_tc_kernel",
               lambda: FA.flash_attention_fwd(q, k, v, True),
               lambda: FA.flash_attention_plain(q, k, v, True),
               lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True, enable_gqa=True), 10)
    results["flash_attention"].update(
        t, bound_ms=b_ms, bound_by=b_by,
        shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} bf16 causal",
        **rates(4 * D * pairs, t["ms"], b_ms, t["library_ms"]))
    emit({"phase": "kernels", "kernel": "flash_attention", "summed": {
        k: results["flash_attention"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "tflops",
            "bound_ratio", "library_ratio", "shape")}})
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = FA.flash_attention_plain(q, k, v, True)
    torch.cuda.synchronize()
    shape = f"bfloat16 causal=True Tq={S} Tk={S} D={D} B={B}"
    record("flash_attention", "o " + shape, err(o, ro), "bfloat16")
    record("flash_attention", "lse " + shape, err(lse, rlse), "bfloat16")
    # the backward at the training shape against its plain version and
    # autograd of the dense path, as the B=8 cases
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    plain = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, True)
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape}", err(got[i], plain[i]), "bfloat16")
    del ro, rlse, plain
    torch.cuda.empty_cache()
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    dense = torch.autograd.grad(
        dense_attention(*leaves, causal=True)[0], leaves, do.float())
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape} vs dense autograd",
               err(got[i], dense[i]), "bfloat16",
               float(dense[i].abs().max()))
    del got, leaves, dense
    torch.cuda.empty_cache()
    # the bf16 (tensor-core) route at the main path's shape
    for kernel, t in _bwd_timing(torch, FA, q, k, v, o, lse, do).items():
        results[kernel].update(
            t, shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} bf16 causal")
        emit({"phase": "kernels", "kernel": kernel, "summed": {
            key: results[kernel][key] for key in (
                "ms", "plain_ms", "library_ms", "bound_ms", "tflops",
                "bound_ratio", "library_ratio", "shape")}})
    # the f32 route at the main path's shape too (the default float32
    # policy's), on f32 inputs: forward and backward against their plain
    # versions, then timed
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    qf, dof = randn(B, H, S, D), randn(B, H, S, D)
    kf, vf = randn(B, HKV, S, D), randn(B, HKV, S, D)
    of, lsef = FA.flash_attention_fwd(qf, kf, vf, causal=True)
    ro, rlse = FA.flash_attention_plain(qf, kf, vf, True)
    torch.cuda.synchronize()
    shape = f"float32 causal=True Tq={S} Tk={S} D={D} B={B}"
    record("flash_attention", "o " + shape, err(of, ro), "float32")
    record("flash_attention", "lse " + shape, err(lsef, rlse), "float32")
    del ro, rlse
    torch.cuda.empty_cache()
    got = FA.flash_attention_bwd(qf, kf, vf, of, lsef, dof, causal=True)
    plain = FA.flash_attention_bwd_plain(qf, kf, vf, of, lsef, dof, True)
    torch.cuda.synchronize()
    for i, part in enumerate(("dq", "dk", "dv")):
        kernel = "flash_attention_dq" if part == "dq" else \
            "flash_attention_dkdv"
        record(kernel, f"{part} {shape}", err(got[i], plain[i]), "float32")
    del got, plain
    torch.cuda.empty_cache()
    b64 = _bwd_timing(torch, FA, qf, kf, vf, of, lsef, dof)
    del qf, kf, vf, dof, of, lsef
    torch.cuda.empty_cache()
    # ... and at B=8, where earlier PRs timed it: the kernels line's
    # f32_route
    B8 = 8
    q, do = randn(B8, H, S, D), randn(B8, H, S, D)
    k, v = randn(B8, HKV, S, D), randn(B8, HKV, S, D)
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
            "tflops", "bound_ratio", "library_ratio")
    for kernel, t in _bwd_timing(torch, FA, q, k, v, o, lse, do).items():
        results[kernel]["f32_route"] = dict(
            t, shape=f"B={B8} H={H} Hkv={HKV} T={S} D={D} f32 causal",
            b64=dict({key: b64[kernel][key] for key in keys},
                     shape=f"B={B} H={H} Hkv={HKV} T={S} D={D} f32 "
                           "causal"))
    for b, by in ((B8, {k_: results[k_]["f32_route"] for k_ in b64}),
                  (B, b64)):
        ms = sum(t["ms"] for t in by.values())
        lib = by["flash_attention_dq"]["library_ms"]
        emit({"phase": "kernels", "kernel": "flash_attention_bwd",
              "f32_summed": {"batch": b, "ms": ms, "library_ms": lib,
                             "library_ratio": ms / lib,
                             "bound_ms": sum(t["bound_ms"]
                                             for t in by.values()),
                             **{k_: t["ms"] for k_, t in by.items()}}})
    del q, k, v, do, o, lse
    torch.cuda.empty_cache()
    _check_reference_conv_grads(torch, record, err)
    _check_reference_conv_determinism(torch)

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


def _sum_timing(per):
    """One kernel's timings summed over the shapes it was timed at (one
    call at each); ``bound_by`` is that of the shape with the largest
    bound."""
    lib = [t["library_ms"] for t in per]
    return {"ms": sum(t["ms"] for t in per),
            "kernel_ms": sum(t["kernel_ms"] or 0.0 for t in per),
            "wall_ms": sum(t["wall_ms"] for t in per),
            "plain_ms": sum(t["plain_ms"] for t in per),
            "library_ms": None if None in lib else sum(lib),
            "bound_ms": sum(t["bound_ms"] for t in per),
            "bound_by": max(per, key=lambda t: t["bound_ms"])["bound_by"],
            "shapes": per}


def qmm_timing(torch, Q, xq, wq, xs, ws, library):
    """``quantized_matmul`` timed at the main path's output type (bf16),
    one device launch a call, beside its plain version, its bound and
    ``library`` (``torch._int_mm`` + dequant, or None)."""
    (m, k), n = xq.shape, wq.shape[1]
    ops = 2 * m * k * n
    b_ms, b_by = bound(m * k + k * n + 4 * (m + n) + 2 * m * n, ops,
                       PEAK_INT8_OPS)
    bf16 = torch.bfloat16
    t = timing_one_launch(
        torch, f"quantized_matmul M={m} K={k} N={n}", "::qmm_kernel",
        lambda: Q.quantized_matmul(xq, wq, xs, ws, bf16),
        lambda: Q.quantized_matmul_plain(xq, wq, xs, ws, bf16), library, 50)
    return dict(t, shape=f"M={m} K={k} N={n} bf16 out", bound_ms=b_ms,
                bound_by=b_by, **rates(ops, t["ms"], b_ms, t["library_ms"]))


def phase_inference_kernels(torch, record, err, results):
    """The implicit-GEMM conv kernels (f32, bf16, int8) at ResNet-50's
    shapes and the int8 GEMMs at the head's and ``bench_int8_matmul``'s,
    each against its plain version, then timed (into ``results``)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import conv as CV
    from zoo_tpu_torch.ops.kernels import quant as Q

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2468)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def int8(*shape):
        return torch.randint(-127, 128, shape, generator=g, device=dev,
                             dtype=torch.int8)

    def scales(n):
        return torch.rand(n, generator=g, device=dev) * 1e-2 + 1e-3

    B = INFER_B
    per = {k: [] for k in ("conv2d", "conv2d_f32", "conv2d_int8",
                           "quantized_matmul", "fused_quantized_matmul")}
    for h, c, k, o, s in CONV_SHAPES:
        oh = -(-h // s)
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        x32, w32 = randn(8, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y = CV.implicit_gemm_conv2d(x32, w32, (s, s))
        ref = CV.conv2d_plain(x32, w32, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"f32 B=8 {shape}", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        x, w = randn(B, h, h, c), randn(k, k, c, o)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"bf16 B={B} {shape}", err(y, ref), "conv_bf16",
               float(ref.float().abs().max()))
        del x32, w32, y, ref
        ops = 2 * B * oh * oh * k * k * c * o
        # x elements the conv reads: a 1x1 at stride s only every s-th
        # pixel (the JAX cost estimate counts its pre-sliced x), a 3x3 at
        # stride 1 all of them; either way B * oh * oh * c
        x_read = B * oh * oh * c
        b_ms, b_by = bound(2 * (x_read + w.numel() + B * oh * oh * o),
                           ops, PEAK_BF16_FLOPS)
        xn = x.permute(0, 3, 1, 2)                  # channels-last NCHW
        wn = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        t = timing(torch, "conv_tc_kernel",
                   lambda: CV.implicit_gemm_conv2d(x, w, (s, s)),
                   lambda: CV.conv2d_plain(x, w, (s, s)),
                   lambda: F.conv2d(xn, wn, stride=s, padding=(k - 1) // 2),
                   10)
        per["conv2d"].append(dict(t, shape=f"B={B} bf16 {shape}",
                                  bound_ms=b_ms, bound_by=b_by, ops=ops,
                                  **rates(ops, t["ms"], b_ms,
                                          t["library_ms"])))
        emit({"phase": "kernels", "kernel": "conv2d",
              "timing": per["conv2d"][-1]})
        # the f32 route (3xTF32 on wgmma) at B=128 on f32 inputs (not
        # bf16 ones: their TF32 split would leave no low part), against
        # its plain version, then timed beside one f32 F.conv2d (TF32 is
        # off for the whole run); its bound at the rate of the route it
        # runs, three TF32 products a term, and the f32 FMA one beside it
        del x, w, xn, wn
        torch.cuda.empty_cache()
        xf, wf = randn(B, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y = CV.implicit_gemm_conv2d(xf, wf, (s, s))
        ref = CV.conv2d_plain(xf, wf, (s, s))
        torch.cuda.synchronize()
        mag = float(ref.abs().max())
        record("conv2d", f"f32 B={B} {shape}", err(y, ref), "conv_f32", mag)
        # control: one TF32 product a term (operands rounded to TF32,
        # products exact, f32 sums) must fail the same gate
        one = CV.conv2d_plain(tf32_round(torch, xf), tf32_round(torch, wf),
                              (s, s))
        torch.cuda.synchronize()
        control = err(one, ref) / mag
        emit({"phase": "kernels", "kernel": "conv2d", "control_single_tf32":
              {"shape": f"B={B} f32 {shape}", "err_rel": control,
               "tol": TOL["conv_f32"]}})
        if not control > TOL["conv_f32"]:
            raise AssertionError(f"conv2d f32 {shape}: one TF32 product "
                                 f"({control}) passes the f32 gate")
        del y, ref, one
        xnf = xf.permute(0, 3, 1, 2)
        wnf = wf.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        nbytes = 4 * (x_read + wf.numel() + B * oh * oh * o)
        b_f = bound(nbytes, 3 * ops, PEAK_TF32_FLOPS)
        tf = timing(torch, "conv_f32_tc_kernel",
                    lambda: CV.implicit_gemm_conv2d(xf, wf, (s, s)),
                    lambda: CV.conv2d_plain(xf, wf, (s, s)),
                    lambda: F.conv2d(xnf, wnf, stride=s,
                                     padding=(k - 1) // 2), 10)
        plan = CV.conv_f32_plan(B * oh * oh, c, o)
        per["conv2d_f32"].append(dict(
            tf, shape=f"B={B} f32 {shape}", bound_ms=b_f[0],
            bound_by=b_f[1], ops=ops, bound_fma_ms=bound(nbytes, ops)[0],
            plan={"bm": plan.bm, "bn": plan.bn, "stages": plan.stages,
                  "vec": plan.vec, "smem": plan.smem,
                  "blocks": plan.blocks},
            **rates(ops, tf["ms"], b_f[0], tf["library_ms"])))
        emit({"phase": "kernels", "kernel": "conv2d",
              "timing_f32": per["conv2d_f32"][-1]})
        del xf, wf, xnf, wnf
        xq, wq, xs, ws = int8(B, h, h, c), int8(k, k, c, o), scales(B), \
            scales(o)
        # the K-major weight copy the kernel reads, made once per layer
        # (quantize_model), timed on its own
        tk = timed(torch, lambda: CV.int8_weights_kmajor(wq), 5)
        wk = CV.int8_weights_kmajor(wq)
        if not torch.equal(wk, wq.permute(3, 0, 1, 2).reshape(o, -1)):
            raise AssertionError(f"conv2d_int8 {shape}: K-major copy")
        emit({"phase": "kernels", "kernel": "conv2d_int8",
              "kmajor_copy_once": {"shape": f"{k}x{k}x{c}x{o}",
                                   "ms": tk["device_ms"]}})
        y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s),
                                         w_kmajor=wk)
        ref = CV.conv2d_int8_plain(xq, wq, xs, ws, (s, s))
        torch.cuda.synchronize()
        record("conv2d_int8", f"B={B} {shape}", err(y, ref), "int8")
        del y, ref
        b_ms, b_by = bound(x_read + wq.numel() + 4 * (B + o)
                           + 4 * B * oh * oh * o, ops, PEAK_INT8_OPS)
        # the float64 plain version is slow: one warm-up, one timed call
        t = timed(torch, lambda: CV.implicit_gemm_conv2d_int8(
            xq, wq, xs, ws, (s, s), w_kmajor=wk), 10,
            kernel="conv_i8_tc_kernel")
        plain = timed(torch, lambda: CV.conv2d_int8_plain(
            xq, wq, xs, ws, (s, s)), 1, warmup=1)
        plan = CV.conv_int8_plan(B * oh * oh, c, o)
        per["conv2d_int8"].append(dict(
            {"ms": t["device_ms"], "kernel_ms": t["kernel_ms"],
             "wall_ms": t["wall_ms"], "plain_ms": plain["device_ms"],
             "library_ms": None, "shape": f"B={B} int8 {shape}",
             "bound_ms": b_ms, "bound_by": b_by, "ops": ops,
             "kmajor_copy_ms": tk["device_ms"],
             "plan": {"bn": plan.bn, "bk": plan.bk, "stages": plan.stages,
                      "vec": plan.vec, "blocks": plan.blocks}},
            **rates(ops, t["device_ms"], b_ms, None)))
        emit({"phase": "kernels", "kernel": "conv2d_int8",
              "timing": per["conv2d_int8"][-1]})
        del xq, wq, wk
        torch.cuda.empty_cache()

    # every other in-envelope conv shape of ResNet-50, checked, not timed
    from zoo_tpu_torch.models.image import resnet50
    rest = sorted(set(envelope_convs(resnet50(1000, (224, 224, 3))))
                  - set(CONV_SHAPES))
    for h, c, k, o, s in rest:
        shape = f"{h}x{h} {c}->{o} {k}x{k} stride {s}"
        x, w = randn(B, h, h, c), randn(k, k, c, o)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"bf16 B={B} {shape}", err(y, ref), "conv_bf16",
               float(ref.float().abs().max()))
        del x, w, y, ref
        x, w = randn(B, h, h, c, dtype=torch.float32), \
            randn(k, k, c, o, dtype=torch.float32)
        y, ref = CV.implicit_gemm_conv2d(x, w, (s, s)), \
            CV.conv2d_plain(x, w, (s, s))
        torch.cuda.synchronize()
        record("conv2d", f"f32 B={B} {shape}", err(y, ref), "conv_f32",
               float(ref.abs().max()))
        xq, wq, xs, ws = int8(B, h, h, c), int8(k, k, c, o), scales(B), \
            scales(o)
        y = CV.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s))
        ref = CV.conv2d_int8_plain(xq, wq, xs, ws, (s, s))
        torch.cuda.synchronize()
        record("conv2d_int8", f"B={B} {shape}", err(y, ref), "int8")
        del x, w, xq, wq, y, ref
    emit({"phase": "kernels", "conv_shapes_checked":
          len(CONV_SHAPES) + len(rest)})
    torch.cuda.empty_cache()

    for m, k, n in GEMM_SHAPES:
        shape = f"M={m} K={k} N={n}"
        two_pass = k > Q._FUSED_MAX_K
        x, wq, ws = randn(m, k), int8(k, n), scales(n)
        x[0] = 0                                   # a zero row: scale 1
        xq, xs = Q.quantize_int8(x, axis=-1)
        for out in (torch.float32, bf16):
            y = Q.quantized_matmul(xq, wq, xs, ws, out_dtype=out)
            ref = Q.quantized_matmul_plain(xq, wq, xs, ws, out_dtype=out)
            torch.cuda.synchronize()
            record("quantized_matmul", f"{shape} out {out}", err(y, ref),
                   "int8")
            del y, ref
            for xdt in (torch.float32, bf16):
                xx = x.to(xdt)
                before = (Q.QMM_LAUNCHES, Q.FQMM_LAUNCHES)
                y = Q.fused_quantized_matmul(xx, wq, ws, out)
                torch.cuda.synchronize()
                launched = (Q.QMM_LAUNCHES - before[0],
                            Q.FQMM_LAUNCHES - before[1])
                if two_pass:
                    # past _FUSED_MAX_K the fused op takes the two-pass
                    # route: quantize_int8, then one quantized_matmul
                    q, sc = Q.quantize_int8(xx, axis=-1)
                    ref = Q.quantized_matmul_plain(q, wq, sc, ws, out)
                    want = (1, 0)
                else:
                    ref = Q.fused_quantized_matmul_plain(xx, wq, ws, out)
                    want = (0, 1)
                torch.cuda.synchronize()
                if launched != want:
                    raise AssertionError(
                        f"fused_quantized_matmul {shape}: launches "
                        f"(quantized_matmul, fused_quantized_matmul) = "
                        f"{launched}, expected {want}")
                record("fused_quantized_matmul",
                       f"{shape} x {xdt} out {out}"
                       + (" (two-pass route)" if two_pass else ""),
                       err(y, ref), "int8")
                del xx, y, ref
        torch.cuda.empty_cache()
        ops = 2 * m * k * n

        def int_mm_dequant(q, sc):
            return (torch._int_mm(q, wq).float() * sc
                    * ws.reshape(1, n)).to(bf16)

        def lib_fused():
            xf = x.float()
            amax = xf.abs().amax(dim=-1, keepdim=True)
            sc = torch.where(amax == 0, 1.0, amax / 127.0)
            q = torch.clamp(torch.round(xf / sc), -127, 127).to(torch.int8)
            return int_mm_dequant(q, sc)

        libs = {"quantized_matmul": lambda: int_mm_dequant(xq, xs),
                "fused_quantized_matmul": lib_fused}
        for name, lib in libs.items():
            try:   # a yardstick only: a torch without it gives None
                lib()
            except RuntimeError as e:
                emit({"phase": "kernels", "kernel": name,
                      "library": f"torch._int_mm unavailable: {e!r}"})
                libs[name] = None
        plan = Q.qmm_plan(m, k, n, 16, 16, clusters=Q.cluster_limits(dev))
        per["quantized_matmul"].append(dict(
            qmm_timing(torch, Q, xq, wq, xs, ws, libs["quantized_matmul"]),
            plan=plan._asdict()))
        emit({"phase": "kernels", "kernel": "quantized_matmul",
              "timing": per["quantized_matmul"][-1]})
        if not two_pass:
            b_f = bound(2 * m * k + k * n + 4 * n + 2 * m * n, ops,
                        PEAK_INT8_OPS)
            # quantize, product and epilogue in one device launch a call
            t = timing_one_launch(
                torch, f"fused_quantized_matmul {shape}", "::fqmm_kernel",
                lambda: Q.fused_quantized_matmul(x, wq, ws),
                lambda: Q.fused_quantized_matmul_plain(x, wq, ws),
                libs["fused_quantized_matmul"], 50)
            plan = Q.fqmm_plan(m, k, n, x.element_size(), 16, 16)
            per["fused_quantized_matmul"].append(dict(
                t, shape=shape + " bf16 in and out", bound_ms=b_f[0],
                bound_by=b_f[1], plan=plan._asdict(),
                **rates(ops, t["ms"], b_f[0], t["library_ms"])))
            emit({"phase": "kernels", "kernel": "fused_quantized_matmul",
                  "timing": per["fused_quantized_matmul"][-1]})
        del x, wq, ws, xq, xs, libs
        torch.cuda.empty_cache()
    for name in ("conv2d", "conv2d_int8"):
        results[name].update(_sum_timing(per[name]))
        r = results[name]
        r.update(rates(sum(t["ops"] for t in per[name]), r["ms"],
                       r["bound_ms"], r["library_ms"]))
        emit({"phase": "kernels", "kernel": name, "summed": {
            k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                              "tflops", "bound_ratio", "library_ratio")}})
    # the f32 route summed over the four shapes, bound at 3xTF32, with
    # the f32 FMA bound beside it
    f32_route = _sum_timing(per["conv2d_f32"])
    f32_route.update(
        rates(sum(t["ops"] for t in per["conv2d_f32"]), f32_route["ms"],
              f32_route["bound_ms"], f32_route["library_ms"]),
        shape=f"B={B} f32, the {len(CONV_SHAPES)} shapes summed",
        bound_fma_ms=sum(t["bound_fma_ms"] for t in per["conv2d_f32"]))
    f32_route["bound_fma_ratio"] = f32_route["bound_fma_ms"] / f32_route["ms"]
    emit({"phase": "kernels", "kernel": "conv2d", "summed_f32": {
        k: f32_route[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_fma_ms",
            "tflops", "bound_ratio", "bound_fma_ratio",
            "library_ratio", "shape")}})
    results["conv2d"]["f32_route"] = f32_route
    for name in ("quantized_matmul", "fused_quantized_matmul"):
        # the kernels line carries the head's shape, the main path's
        results[name].update(per[name][0], shapes=per[name])


def _block_weights(torch, g, cin, cmid, grad=False):
    """w1 (cin, cmid), w2 (3, 3, cmid, cmid), w3 (cmid, cin), f32, drawn
    at 1 / sqrt(fan in)."""
    return [(torch.randn(s, generator=g, device="cuda") / math.sqrt(fan))
            .requires_grad_(grad)
            for s, fan in (((cin, cmid), cin), ((3, 3, cmid, cmid),
                                                9 * cmid),
                           ((cmid, cin), cmid))]


def _block_bound(b, h, cin, cmid, x_bytes):
    """Least time of one bottleneck: x read and y written once, bf16
    weights read once, against its FLOPs at the bf16 peak."""
    pixels = b * h * h
    flops = 2 * pixels * (2 * cin * cmid + 9 * cmid * cmid)
    nbytes = 2 * pixels * cin * x_bytes + \
        2 * (2 * cin * cmid + 9 * cmid * cmid)
    return bound(nbytes, flops, PEAK_BF16_FLOPS) + (flops,)


def phase_block_kernels(torch, record, err, results):
    """The fused bottleneck kernel against its plain version at
    ResNet-50's four identity geometries (B=128 bf16, conv2_x also f32),
    its gradients through the op against autograd of the composition at
    conv2_x (B=32), then timed beside its bound, its plain version and
    the unfused cuDNN composition (into ``results``)."""
    import torch.nn.functional as F
    from zoo_tpu_torch.ops.kernels import fused_block as FB

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1357)
    bf16, cl = torch.bfloat16, torch.channels_last
    B, per = BLOCK_B, []
    for name, h, cin, cmid in BLOCK_STAGES:
        ws = _block_weights(torch, g, cin, cmid)
        plan = FB.plan(h, h, cin, cmid)
        smem = plan.smem
        shape = f"{name} {h}x{h} {cin}->{cmid}->{cin}"
        for dt in ((bf16, torch.float32) if name == "conv2_x" else (bf16,)):
            x = torch.randn(B, h, h, cin, generator=g, device=dev).to(dt)
            y = FB.fused_bottleneck(x, *ws, impl="kernel")
            ref = FB.fused_bottleneck_plain(x, *ws)
            torch.cuda.synchronize()
            case = f"{str(dt).split('.')[-1]} B={B} {shape}"
            share = float((y == ref).float().mean())
            emit({"phase": "kernels", "kernel": "fused_bottleneck",
                  "case": case, "smem_bytes": smem,
                  "bit_equal_share": share})
            if not share >= BLOCK_BIT_EQUAL:
                raise AssertionError(
                    f"fused_bottleneck {case}: {share} of the outputs equal "
                    f"the plain version's bit for bit, under "
                    f"{BLOCK_BIT_EQUAL}")
            record("fused_bottleneck", case, err(y, ref), "block",
                   float(ref.float().abs().max()))
            del y, ref
        # timed in bf16, the training path's type
        x = x.to(bf16)
        (b_ms, b_by, flops) = _block_bound(B, h, cin, cmid, 2)
        xn = x.permute(0, 3, 1, 2)                  # channels-last NCHW
        w1n = ws[0].t().reshape(cmid, cin, 1, 1).to(bf16) \
            .contiguous(memory_format=cl)
        w2n = ws[1].permute(3, 2, 0, 1).to(bf16).contiguous(memory_format=cl)
        w3n = ws[2].t().reshape(cin, cmid, 1, 1).to(bf16) \
            .contiguous(memory_format=cl)

        def composition():
            t1 = F.relu(F.conv2d(xn, w1n))
            t2 = F.relu(F.conv2d(t1, w2n, padding=1))
            return F.relu(xn + F.conv2d(t2, w3n))
        t = timing(torch, "fused_bottleneck_kernel",
                   lambda: FB.fused_bottleneck(x, *ws, impl="kernel"),
                   lambda: FB.fused_bottleneck_plain(x, *ws), None, 5)
        comp = timed(torch, composition, 5)["device_ms"]
        per.append(dict(t, shape=f"B={B} bf16 {shape}", bound_ms=b_ms,
                        bound_by=b_by, composition_ms=comp,
                        tflops=flops / t["ms"] / 1e9,
                        bound_ratio=b_ms / t["ms"],
                        composition_ratio=t["ms"] / comp,
                        plan={"tile": [plan.th, plan.tw],
                              "tiles": plan.tiles, "warps": plan.warps,
                              "wn": list(plan.wn), "stages": plan.stages,
                              "smem": plan.smem}))
        emit({"phase": "kernels", "kernel": "fused_bottleneck",
              "timing": per[-1]})
        del x, xn
        torch.cuda.empty_cache()

    # gradients through the op at conv2_x, B=32: kernel forward,
    # recompute backward, against autograd of the composition
    _, h, cin, cmid = BLOCK_STAGES[0]
    x = torch.randn(BLOCK_GRAD_B, h, h, cin, generator=g,
                    device=dev).to(bf16)
    ws = _block_weights(torch, g, cin, cmid)
    dy = torch.randn(x.shape, generator=g, device=dev).to(bf16)
    leaves = [t.clone().requires_grad_() for t in [x] + ws]
    before = FB.LAUNCHES
    got = torch.autograd.grad(FB.fused_bottleneck(*leaves), leaves, dy)
    if FB.LAUNCHES != before + 1:
        raise AssertionError("fused_bottleneck: the gradient pass did not "
                             "launch the kernel once")
    ref_leaves = [t.clone().requires_grad_() for t in [x] + ws]
    want = torch.autograd.grad(FB.bottleneck_reference(*ref_leaves),
                               ref_leaves, dy)
    torch.cuda.synchronize()
    for part, a, b in zip(("dx", "dw1", "dw2", "dw3"), got, want):
        record("fused_bottleneck", f"{part} B={BLOCK_GRAD_B} conv2_x vs "
               "composition autograd", err(a, b), "block_grad",
               float(b.float().abs().max()))
    results["fused_bottleneck"].update(_sum_timing(per))
    r = results["fused_bottleneck"]
    r["composition_ms"] = sum(t["composition_ms"] for t in per)
    r.update(tflops=sum(_block_bound(B, h, cin, cmid, 2)[2]
                        for _, h, cin, cmid in BLOCK_STAGES) / r["ms"] / 1e9,
             bound_ratio=r["bound_ms"] / r["ms"],
             composition_ratio=r["ms"] / r["composition_ms"])
    del x, dy, leaves, ref_leaves, got, want
    torch.cuda.empty_cache()


def _sgd_plain(param, grad, momentum_buf, lr, momentum=0.0,
               weight_decay=0.0):
    """``fused_apply_sgd``'s plain version, in place, on any device."""
    import torch
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    with torch.no_grad():
        for dst, src in zip((param, momentum_buf), FO.reference_apply_sgd(
                param, grad, momentum_buf, lr, momentum, weight_decay)):
            dst.copy_(src)
    return param, momentum_buf


@contextlib.contextmanager
def plain_kernels():
    """The four image-inference kernel wrappers and the SGD update
    routed to their plain versions: the yardstick path, which nothing on
    the main path takes."""
    from zoo_tpu_torch.ops.kernels import conv as CV
    from zoo_tpu_torch.ops.kernels import quant as Q
    from zoo_tpu_torch.pipeline.api.keras import optimizers as OPT
    swaps = ((CV, "implicit_gemm_conv2d", CV.conv2d_plain),
             (CV, "implicit_gemm_conv2d_int8", CV.conv2d_int8_plain),
             (Q, "quantized_matmul", Q.quantized_matmul_plain),
             (Q, "fused_quantized_matmul", Q.fused_quantized_matmul_plain),
             (OPT, "fused_apply_sgd", _sgd_plain))
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def tf32_round(torch, t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    bits = (t.contiguous().view(torch.int32) + 0x1000) & -0x2000
    return bits.view(torch.float32)


@contextlib.contextmanager
def single_tf32_plain(torch):
    """The plain path (:func:`plain_kernels`) with the float conv routed
    to a control of lower precision: one TF32 product a term (operands
    rounded to TF32, f32 sums), the plain version's gradients passed
    straight through the rounding."""
    from zoo_tpu_torch.ops.kernels import conv as CV

    def conv(x, w, strides=(1, 1), padding="SAME"):
        def rounded(t):
            return t + (tf32_round(torch, t.detach()) - t).detach()
        return CV.conv2d_plain(rounded(x), rounded(w), strides, padding)

    with plain_kernels():
        saved = CV.implicit_gemm_conv2d
        CV.implicit_gemm_conv2d = conv
        try:
            yield
        finally:
            CV.implicit_gemm_conv2d = saved


def redraw_batchnorm(torch, params, seed):
    """BatchNorm gamma, beta and running stats drawn from ``seed``, so BN
    is not the identity (gamma, var ~ U(0.5, 1.5); beta, mean ~ 0.1 N)."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict) and "stats" in val:
                d = val["gamma"].shape[0]
                u = torch.rand((4, d), generator=g, device="cuda")
                z = torch.randn((4, d), generator=g, device="cuda")
                val["gamma"], val["beta"] = u[0] + 0.5, 0.1 * z[0]
                val["stats"] = {"mean": 0.1 * z[1], "var": u[1] + 0.5}
            elif isinstance(val, dict):
                walk(val)
    walk(params)


def envelope_convs(model):
    """(spatial, C, k, O, stride) of each of a functional model's Conv2D
    nodes inside the kernels' envelope, in graph order (square NHWC
    inputs, SAME padding, as ResNet's are)."""
    from zoo_tpu_torch.ops.kernels.conv import pallas_conv_supported
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    out = []
    for node in model._topo:
        layer = node.layer
        if isinstance(layer, Convolution2D) and \
                pallas_conv_supported(layer.kernel, layer.subsample):
            h, c = node.inbound[0].shape[1], node.inbound[0].shape[3]
            out.append((h, c, layer.kernel[0], layer.nb_filter,
                        layer.subsample[0]))
    return out


INFER_KERNELS = ("conv2d", "conv2d_int8", "quantized_matmul",
                 "fused_quantized_matmul")


def _launched(counts, **want):
    """Raise unless the four inference kernels launched as ``want``
    (default 0) says."""
    got = {k: counts[k] for k in INFER_KERNELS}
    need = {k: want.get(k, 0) for k in INFER_KERNELS}
    if got != need:
        raise AssertionError(f"launches {got}, expected {need}")


def phase_infer_tiny(torch, K):
    """Kernel path == plain path through a tiny ResNet's predict, f32."""
    import numpy as np
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    n_conv = len(envelope_convs(m))
    x = np.random.RandomState(5).randn(16, 32, 32, 3).astype(np.float32)
    im = InferenceModel().load_keras(m, batch_size=8)
    for path in ("float", "int8"):
        if path == "int8":
            quantize_model(m, mode="force")
        K.reset_launch_counts()
        got = im.predict(x)
        counts = K.launch_counts()
        with plain_kernels():
            K.reset_launch_counts()
            ref = im.predict(x)
            _launched(K.launch_counts())
        diff = float(np.abs(got - ref).max())
        emit({"phase": "infer-tiny", "path": path, "max_abs_err": diff,
              "tol": TOL_TINY_F32 if path == "float" else 0.0,
              "launches": {k: counts[k] for k in INFER_KERNELS},
              "argmax": got.argmax(1).tolist()})
        if not (np.isfinite(got).all() and got.shape == (16, 10)):
            raise AssertionError(f"infer-tiny {path}: outputs {got}")
        if path == "float":
            _launched(counts, conv2d=2 * n_conv)
            if not diff <= TOL_TINY_F32:
                raise AssertionError(f"infer-tiny float: {diff}")
        else:
            _launched(counts, conv2d_int8=2 * n_conv,
                      fused_quantized_matmul=2)
            if not np.array_equal(got, ref):
                raise AssertionError(f"infer-tiny int8: kernel path "
                                     f"differs from plain by {diff}")


def phase_infer_main(torch, K, card):
    """ResNet-50 at full width and depth through InferenceModel: float,
    int8 (fused head), one unfused-head batch and the auto verdict."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)
    from zoo_tpu_torch.pipeline.inference.inference_model import _copy_tree

    B, steps = INFER_B, INFER_STEPS
    t0 = time.perf_counter()
    m = resnet50(1000, (224, 224, 3))
    m.compile("sgd", "sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    float_params = _copy_tree(m.params)
    n_conv = len(envelope_convs(m))
    if n_conv != 49:
        raise AssertionError(f"{n_conv} convs inside the envelope, not 49")
    im = InferenceModel().load_keras(m, batch_size=B)     # warm-up batch
    rs = np.random.RandomState(0)                          # bench.py:504
    x = np.concatenate([rs.randn(B, 224, 224, 3).astype(np.float32)
                        for _ in range(steps)])
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit({"phase": "infer-main", "model": "resnet50(1000, (224, 224, 3))",
          "policy": "mixed_bfloat16", "batch": B, "batches": steps,
          "params": sum(t.numel() for t in tree_leaves(m.params)),
          "setup_s": setup_s})
    launches, outs, profiles = {k: 0 for k in INFER_KERNELS}, {}, {}

    def run(path, xs, **want):
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t = time.perf_counter()
        y = im.predict(xs)
        wall = time.perf_counter() - t
        counts = K.launch_counts()
        n_fwd = xs.shape[0] // B
        emit({"phase": "infer-main", "path": path, "card": card,
              "images": xs.shape[0], "wall_s": wall,
              "samples_per_s": xs.shape[0] / wall,
              "launches": {k: counts[k] for k in INFER_KERNELS},
              "launches_per_forward": {k: counts[k] / n_fwd
                                       for k in INFER_KERNELS},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not (y.shape == (xs.shape[0], 1000) and np.isfinite(y).all()
                and np.allclose(y.sum(1), 1.0, atol=2e-2)):
            raise AssertionError(f"infer-main {path}: outputs not "
                                 "probabilities")
        _launched(counts, **{k: v * n_fwd for k, v in want.items()})
        for k in INFER_KERNELS:
            launches[k] += counts[k]
        return y

    def against_plain(path, y, exact):
        with plain_kernels():
            K.reset_launch_counts()
            ref = im.predict(x[:B])
            _launched(K.launch_counts())
        diff = float(np.abs(y[:B] - ref).max())
        top1 = float((y[:B].argmax(1) == ref.argmax(1)).mean())
        emit({"phase": "infer-main", "path": path, "vs_plain_max_abs": diff,
              "vs_plain_top1": top1,
              "tol": 0.0 if exact else TOL_MAIN_BF16})
        if not (np.array_equal(y[:B], ref) if exact
                else diff <= TOL_MAIN_BF16):
            raise AssertionError(f"infer-main {path}: kernel path differs "
                                 f"from plain by {diff}")

    def profile(path):
        xb = x[:B]
        t = timed(torch, lambda: im.predict(xb), 2, warmup=1)
        groups = {}
        for name, ms in t["by_name"].items():
            n = name.lower()
            label = ("conv2d_int8" if "conv_i8_tc_kernel" in n else
                     "conv2d" if "conv_tc_kernel" in n
                     or "conv_f32_tc_kernel" in n else
                     "int8_gemm" if "qmm_kernel" in n else
                     "cudnn_conv" if "conv" in n or "cudnn" in n
                     or "xmma" in n or "implicit" in n else
                     "copies" if "memcpy" in n.replace(" ", "") else
                     "other")
            groups[label] = groups.get(label, 0.0) + ms
        top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:10]
        profiles[path] = t
        emit({"phase": "infer-step", "path": path, "card": card,
              "batch": B, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_ms_by_group": groups,
              "top_device_ms": [[k[:80], v] for k, v in top]})

    outs["float"] = run("float", x, conv2d=n_conv)
    against_plain("float", outs["float"], exact=False)
    profile("float")
    torch.cuda.synchronize()
    t = time.perf_counter()
    quantize_model(m, mode="force")
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    # every in-envelope conv carries the K-major weights its kernel reads,
    # made here once, so no forward transposes them
    from zoo_tpu_torch.ops.kernels.conv import kmajor_of
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    attached = sum(
        kmajor_of(m.params[m._key_of(l)]["W_q"]) is not None
        for l in m.layers if isinstance(l, Convolution2D))
    emit({"phase": "infer-main", "quantize_s": quantize_s,
          "kmajor_copies_attached": attached})
    if attached != n_conv:
        raise AssertionError(f"{attached} int8 convs carry K-major "
                             f"weights, not {n_conv}")
    outs["int8"] = run("int8", x, conv2d_int8=n_conv,
                       fused_quantized_matmul=1)
    against_plain("int8", outs["int8"], exact=True)
    profile("int8")
    os.environ["ZOO_INT8_MATMUL"] = "unfused"
    try:
        y = run("int8 unfused head", x[:B], conv2d_int8=n_conv,
                quantized_matmul=1)
    finally:
        del os.environ["ZOO_INT8_MATMUL"]
    agree = float((outs["int8"].argmax(1) == outs["float"].argmax(1))
                  .mean())
    emit({"phase": "infer-main", "int8_top1_agreement_with_float": agree,
          "int8_vs_float_max_abs": float(
              np.abs(outs["int8"] - outs["float"]).max()),
          "unfused_vs_fused_head_max_abs": float(
              np.abs(y - outs["int8"][:B]).max()),
          "float_top1_classes": int(len(set(outs["float"].argmax(1))))})

    auto = resnet50(1000, (224, 224, 3))
    auto.compile("sgd", "sparse_categorical_crossentropy",
                 dtype_policy="mixed_bfloat16")
    auto.params = float_params
    t = time.perf_counter()
    quantize_model(auto, mode="auto")
    emit({"phase": "infer-main", "auto_verdict": auto._quant_path,
          "auto_speedup_int8_over_float": auto._quant_speedup,
          "sample_batch": 8, "seconds": time.perf_counter() - t})
    return launches


def phase_bottleneck_main(torch, K, card):
    """The fused op's own path at full width: the geometries of
    ResNet-50's twelve identity blocks at B=128 in bf16, each stage
    driven forward and forward+backward through ``fused_bottleneck``,
    and through the port's unfused block (three ``conv2d`` dispatches,
    the ReLUs and the add), then timed. Returns the path's launches."""
    from zoo_tpu_torch.ops.kernels import fused_block as FB
    from zoo_tpu_torch.ops.kernels.conv import conv2d

    g = torch.Generator(device="cuda").manual_seed(8642)
    bf16, B = torch.bfloat16, BLOCK_B
    launches = {"fused_bottleneck": 0, "conv2d": 0}

    def unfused(x, ws):
        cin, cmid = ws[0].shape
        w1, w2, w3 = (w.to(bf16) for w in ws)
        t1 = torch.relu(conv2d(x, w1.reshape(1, 1, cin, cmid)))
        t2 = torch.relu(conv2d(t1, w2))
        return torch.relu(x + conv2d(t2, w3.reshape(1, 1, cmid, cin)))

    for name, h, cin, cmid in BLOCK_STAGES:
        x = torch.randn(B, h, h, cin, generator=g, device="cuda").to(bf16)
        ws = _block_weights(torch, g, cin, cmid, grad=True)
        dy = torch.randn(x.shape, generator=g, device="cuda").to(bf16)
        xg = x.clone().requires_grad_()

        def fused_fwd():
            with torch.no_grad():
                return FB.fused_bottleneck(x, *ws)

        def fused_train():
            return torch.autograd.grad(FB.fused_bottleneck(xg, *ws),
                                       [xg] + ws, dy)

        def unfused_fwd():
            with torch.no_grad():
                return unfused(x, ws)

        def unfused_train():
            return torch.autograd.grad(unfused(xg, ws), [xg] + ws, dy)

        runs = (("fused forward", fused_fwd, {"fused_bottleneck": 1}),
                ("fused forward+backward", fused_train,
                 {"fused_bottleneck": 1}),
                ("unfused forward", unfused_fwd, {"conv2d": 3}),
                ("unfused forward+backward", unfused_train, {"conv2d": 3}))
        out, ms = {}, {}
        for label, fn, want in runs:
            K.reset_launch_counts()
            out[label] = fn()
            torch.cuda.synchronize()
            counts = K.launch_counts()
            got = {k: counts[k] for k in ("fused_bottleneck", "conv2d",
                                          "fused_bottleneck_reference")}
            need = {k: want.get(k, 0) for k in got}
            if got != need:
                raise AssertionError(f"bottleneck-main {name} {label}: "
                                     f"launches {got}, expected {need}")
            for k in launches:
                launches[k] += counts[k]
        for label, fn, _ in runs:
            ms[label] = timed(torch, fn, 3, warmup=1)["device_ms"]
        y, yu = out["fused forward"], out["unfused forward"]
        if not (torch.isfinite(y.float()).all() and y.shape == x.shape):
            raise AssertionError(f"bottleneck-main {name}: outputs")
        emit({"phase": "bottleneck-main", "stage": name, "card": card,
              "shape": f"B={B} {h}x{h} {cin}->{cmid}->{cin} bf16",
              "ms": ms, "fused_vs_unfused_max_abs": float(
                  (y.float() - yu.float()).abs().max()),
              "fused_forward_speedup": ms["unfused forward"]
              / ms["fused forward"],
              "fused_train_speedup": ms["unfused forward+backward"]
              / ms["fused forward+backward"]})
        del x, xg, dy, ws, out, y, yu
        torch.cuda.empty_cache()
    return launches


def phase_train_image_tiny(torch, K):
    """Kernel path == plain path through a tiny ResNet's ``fit`` with
    ``SGD(0.1, 0.9)``, f32: 8 images, two shuffled epochs at B=4.

    Only 4 steps: the run is unstable (random labels at lr 0.1 with
    momentum drive the loss from ~2.3 to ~8 within two epochs), and it
    amplifies the conv's summation-order differences (~1e-7 per step)
    step by step; after 8 such steps the CPU parity test
    (``tests/test_torch_resnet_train.py``) sees the JAX package's and the
    port's leaves 2.5e-3 apart from summation order alone."""
    import numpy as np
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile(SGD(lr=0.1, momentum=0.9), "sparse_categorical_crossentropy")
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    redraw_batchnorm(torch, m.params, 1)
    start = tree_map(torch.clone, m.params)
    n_conv = len(envelope_convs(m))
    rs = np.random.RandomState(5)
    x = rs.randn(8, 32, 32, 3).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.int32)
    out = {}
    # the control: the plain path with one TF32 product a conv term, a
    # lower precision than the f32 route's, which the gate must refuse;
    # the kernel path three times as shipped, and three times with the
    # reference conv's backward free to take cuDNN's nondeterministic
    # algorithms (the determinism control)
    repeats = ("kernels", "kernels_2", "kernels_3")
    controls = ("nondeterministic_1", "nondeterministic_2",
                "nondeterministic_3")
    for label, ctx in (*((r, contextlib.nullcontext) for r in repeats),
                       ("plain", plain_kernels),
                       ("single_tf32", lambda: single_tf32_plain(torch)),
                       *((r, lambda: cudnn_deterministic(torch, False))
                         for r in controls)):
        m.compile(SGD(lr=0.1, momentum=0.9),
                  "sparse_categorical_crossentropy")
        m.params = tree_map(torch.clone, start)
        with ctx():
            K.reset_launch_counts()
            hist = m.fit(x, y, batch_size=4, nb_epoch=2, shuffle=True,
                         seed=0, verbose=0, device="cuda")
            torch.cuda.synchronize()
            counts = K.launch_counts()
        out[label] = (hist["loss"], tree_leaves(m.params), counts)
    (lk, pk, ck), (lp, pp, cp) = out["kernels"], out["plain"]
    n_train = sum(1 for t in pk if t.requires_grad)

    def drift(losses, leaves):
        return (max(abs(a - b) / abs(b) for a, b in zip(losses, lp)),
                max(float((a.detach() - b.detach()).norm()
                          / b.detach().norm()) for a, b in zip(leaves, pp)))

    loss_rel, param_rel = drift(lk, pk)
    control = drift(*out["single_tf32"][:2])

    def repeat(labels):
        """Runs of ``labels`` whose losses and leaves equal the first's
        bit for bit, and the largest leaf difference from it."""
        first = out[labels[0]]
        same, diff = 1, 0.0
        for r in labels[1:]:
            losses, leaves = out[r][:2]
            d = max(float((a.detach() - b.detach()).abs().max())
                    for a, b in zip(leaves, first[1]))
            same += losses == first[0] and d == 0.0
            diff = max(diff, d)
        return {"bit_equal_runs": f"{same}/{len(labels)}",
                "max_leaf_diff": diff}

    determinism = {"shipped": repeat(repeats),
                   "control_nondeterministic": repeat(controls)}
    moved = min(float((a.detach() - b).abs().max())
                for a, b in zip(pk, tree_leaves(start)))
    emit({"phase": "train-image-tiny", "loss_kernels": lk, "loss_plain": lp,
          "loss_max_rel": loss_rel, "param_and_stat_max_rel": param_rel,
          "least_leaf_move": moved, "tol": TOL_TRAIN_TINY,
          "control_single_tf32": {"loss_max_rel": control[0],
                                  "param_and_stat_max_rel": control[1]},
          "repeats": determinism,
          "launches": {k: ck[k] for k in ("conv2d", "fused_sgd")},
          "launches_plain": {k: cp[k] for k in ("conv2d", "fused_sgd")}})
    if not (np.isfinite(lk).all() and loss_rel <= TOL_TRAIN_TINY
            and param_rel <= TOL_TRAIN_TINY and moved > 0):
        raise AssertionError(f"train-image-tiny: kernel path differs from "
                             f"plain: loss {loss_rel}, params {param_rel}, "
                             f"least move {moved}")
    if not max(control) > TOL_TRAIN_TINY:
        raise AssertionError(f"train-image-tiny: one TF32 product a conv "
                             f"term ({control}) passes the gate")
    if determinism["shipped"]["max_leaf_diff"] != 0.0 or \
            determinism["shipped"]["bit_equal_runs"] != "3/3":
        raise AssertionError(f"train-image-tiny: the kernel path does not "
                             f"repeat itself: {determinism['shipped']}")
    steps = 4
    if (ck["conv2d"], ck["fused_sgd"]) != (n_conv * steps,
                                           n_train * steps) \
            or cp["conv2d"] or cp["fused_sgd"]:
        raise AssertionError(f"train-image-tiny: launches {ck} with the "
                             f"kernels, {cp} without")


def phase_train_image_main(torch, K, card):
    """Keras ``fit`` of ``bench.py`` ``bench_resnet50``'s config at full
    width and depth, then ``evaluate``; returns the path's launches."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    B, steps = TRAIN_IMG_B, TRAIN_IMG_STEPS
    t0 = time.perf_counter()
    m = resnet50(1000, (224, 224, 3))
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy", metrics=["accuracy"],
              dtype_policy="mixed_bfloat16")
    rs = np.random.RandomState(0)                          # bench.py:379
    x = rs.randn(TRAIN_IMG_N, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, TRAIN_IMG_N).astype(np.int32)
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    trainable, state = _split_state(m.params)
    n_train = len(tree_leaves(trainable))
    stats0 = [t.clone() for t in tree_leaves(state)]
    n_conv = len(envelope_convs(m))
    # warm-up: two steps
    m.fit(x[:2 * B], y[:2 * B], batch_size=B, nb_epoch=1, shuffle=False,
          verbose=0, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # timed: `steps` steps, one fit per batch so every step's loss shows
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = []
    for i in range(steps):
        sl = slice(i * B, (i + 1) * B)
        losses += m.fit(x[sl], y[sl], batch_size=B, nb_epoch=1,
                        shuffle=False, verbose=0, device="cuda")["loss"]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    peak_fit = torch.cuda.max_memory_allocated() / 1e9
    step_s = wall / steps
    stats_moved = min(float((a - b).abs().max()) for a, b in
                      zip(tree_leaves(_split_state(m.params)[1]), stats0))
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    ev = m.evaluate(x[:2 * B], y[:2 * B], batch_size=B, device="cuda")
    eval_s = time.perf_counter() - t1
    emit({"phase": "train-image-main", "model": "resnet50(1000, (224, 224, "
          "3))", "optimizer": "SGD(lr=0.1, momentum=0.9)",
          "policy": "mixed_bfloat16", "card": card, "batch": B,
          "steps": steps, "trainable_leaves": n_train,
          "params": sum(t.numel() for t in tree_leaves(m.params)),
          "setup_s": setup_s, "wall_s": wall, "step_ms": step_s * 1e3,
          "samples_per_s": B / step_s,
          "mfu": 3 * RESNET50_FWD_FLOPS * B / step_s / PEAK_BF16_FLOPS,
          "losses": losses, "launches": counts,
          "launches_per_step": {k: v / steps for k, v in counts.items()},
          "running_stats_least_move": stats_moved,
          "peak_mem_gb_fit": peak_fit, "evaluate": ev,
          "evaluate_images": 2 * B, "evaluate_s": eval_s,
          "peak_mem_gb_evaluate": torch.cuda.max_memory_allocated() / 1e9})
    if not all(np.isfinite(losses)):
        raise AssertionError(f"train-image-main: losses {losses}")
    if counts["conv2d"] != n_conv * steps or \
            counts["fused_sgd"] != n_train * steps:
        raise AssertionError(f"train-image-main: launches {counts}, "
                             f"expected {n_conv} conv2d per forward and "
                             f"{n_train} fused_sgd per step")
    if not stats_moved > 0:
        raise AssertionError("train-image-main: a running stat did not "
                             "move")
    if not (set(ev) == {"loss", "accuracy"} and 0 <= ev["accuracy"] <= 1
            and np.isfinite(ev["loss"])):
        raise AssertionError(f"train-image-main: evaluate gave {ev}")

    xb, yb = x[:B], y[:B]
    t = timed(torch, lambda: m.fit(xb, yb, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    groups = _grouped(t["by_name"], _image_group)
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": "train-image-step", "card": card, "steps": 3,
          "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
          "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in top]})
    del m, x
    torch.cuda.empty_cache()
    return {k: counts[k] for k in ("conv2d", "fused_sgd")}


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

    t = timed(torch, lambda: m.fit(*batch, batch_size=B, nb_epoch=1,
                                   shuffle=False, verbose=0, device="cuda"),
              3, warmup=1)
    groups = _grouped(t["by_name"], _llama_group)
    top = sorted(t["by_name"].items(), key=lambda kv: -kv[1])[:16]
    emit({"phase": "step", "card": card, "steps": 3,
          "wall_ms": t["wall_ms"], "device_ms": t["device_ms"],
          "device_busy_share": t["device_busy_share"],
          "device_ms_by_group": groups,
          "top_device_ms": [[k[:80], v] for k, v in top]})
    return {k: counts[k] for k in ("flash_attention", "flash_attention_dkdv",
                                   "flash_attention_dq", "fused_adam",
                                   "fused_sgd")}


def _llama_group(name):
    """The kernel group of a device event of a Llama training step."""
    n = name.lower()
    for key, label in (("flash_fwd_tc_kernel", "flash_fwd"),
                       ("flash_fwd_kernel", "flash_fwd"),
                       ("flash_bwd_dkdv", "flash_dkdv"),
                       ("flash_bwd_dq", "flash_dq"),
                       ("adam_kernel", "fused_adam")):
        if key in n:
            return label
    if any(s in n for s in ("gemm", "gemv", "cutlass", "matmul",
                            "xmma", "nvjet")):
        return "matmul"
    return "other"


def _image_group(name):
    """The kernel group of a device event of a ResNet training step."""
    n = name.lower()
    if "conv_tc_kernel" in n or "conv_f32_tc_kernel" in n:
        return "conv2d_kernel"
    if "sgd_kernel" in n:
        return "fused_sgd"
    if any(k in n for k in ("conv", "cudnn", "xmma", "implicit",
                            "dgrad", "wgrad", "fprop")):
        return "cudnn_conv"
    if "memcpy" in n.replace(" ", ""):
        return "copies"
    if any(k in n for k in ("gemm", "gemv", "cutlass", "nvjet")):
        return "matmul"
    return "elementwise"


def _grouped(by_name, group):
    """Device ms per call summed by ``group(event name)``."""
    groups = {}
    for name, ms in by_name.items():
        groups[group(name)] = groups.get(group(name), 0.0) + ms
    return groups


def phase_train_f32_main(torch, K, card):
    """Keras ``fit`` under the default ``float32`` policy (``compile``
    given no ``dtype_policy``) at full width and depth: the Llama training
    config, then ResNet-50; each a warm-up step and TRAIN_F32_STEPS timed
    steps on one batch, then a profile. Returns the path's launches."""
    import numpy as np
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.models.llm.llama import Llama, LlamaConfig
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
        _split_state)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import (AdamWeightDecay,
                                                             SGD)

    steps = TRAIN_F32_STEPS
    total = {}

    def run(label, m, x, y, batch, flops_per_step, want, rate, unit,
            group):
        """Warm-up step, timed steps, checks and a profile of one model;
        ``want`` maps kernel -> launches a step."""
        t0 = time.perf_counter()
        m.build(torch.Generator(device="cuda").manual_seed(0),
                device="cuda")
        if m.dtype_policy != "float32":
            raise AssertionError(f"train-f32-main {label}: policy "
                                 f"{m.dtype_policy}, not the default")
        m.fit(x[:batch], y[:batch], batch_size=batch, nb_epoch=1,
              shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        xb, yb = x[batch:2 * batch], y[batch:2 * batch]
        K.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = m.fit(xb, yb, batch_size=batch, nb_epoch=steps,
                     shuffle=False, verbose=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        losses = hist["loss"]
        step_s = wall / steps
        emit({"phase": "train-f32-main", "model": label,
              "policy": "float32 (compile's default)", "card": card,
              "batch": batch, "steps": steps, "setup_s": setup_s,
              "wall_s": wall, "step_ms": step_s * 1e3,
              unit: rate / step_s,
              "tflops_per_s": flops_per_step / step_s / 1e12,
              "mfu_f32": flops_per_step / step_s / PEAK_F32_FLOPS,
              "losses": losses,
              "launches_per_step": {k: v / steps for k, v in
                                    counts.items() if v},
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            raise AssertionError(f"train-f32-main {label}: losses {losses}")
        got = {k: counts[k] for k in want}
        if got != {k: n * steps for k, n in want.items()}:
            raise AssertionError(f"train-f32-main {label}: launches {got}, "
                                 f"expected {want} a step")
        t = timed(torch, lambda: m.fit(xb, yb, batch_size=batch,
                                       nb_epoch=1, shuffle=False,
                                       verbose=0, device="cuda"),
                  2, warmup=0)
        emit({"phase": "train-f32-step", "model": label, "card": card,
              "steps": 2, "wall_ms": t["wall_ms"], "host_ms": t["host_ms"],
              "device_ms": t["device_ms"],
              "device_busy_share": t["device_busy_share"],
              "device_ms_by_group": _grouped(t["by_name"], group),
              "top_device_ms": [[k[:80], v] for k, v in sorted(
                  t["by_name"].items(), key=lambda kv: -kv[1])[:10]]})
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    # the Llama training config (bench.py bench_llama), f32
    cfg = LlamaConfig(**TRAIN_CFG)
    B, S = TRAIN_B, TRAIN_S
    m = Sequential().add(Llama(cfg, remat="dots", input_shape=(S,)))
    m.compile(optimizer=AdamWeightDecay(lr=1e-4, fused=True), loss=LOSS)
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (2 * B, S)).astype(np.int32)
    h, kv = cfg.hidden, cfg.n_kv_head * cfg.head_dim
    fwd_per_token = cfg.n_block * (
        2 * (h * h * 2 + 2 * h * kv) + 2 * 3 * h * cfg.intermediate
        + 4 * S * h) + 2 * h * cfg.vocab            # bench.py:447-453
    n_block = cfg.n_block
    run("llama (bench.py bench_llama, S=512, B=64, remat=dots)", m, ids,
        np.roll(ids, -1, axis=1), B, 3 * fwd_per_token * S * B,
        {"flash_attention": n_block, "flash_attention_dkdv": n_block,
         "flash_attention_dq": n_block}, B * S, "tokens_per_s",
        _llama_group)
    if m.layers[0].last_attention_impl != "flash":
        raise AssertionError("train-f32-main: the Llama layer took "
                             f"{m.layers[0].last_attention_impl}")
    del m
    torch.cuda.empty_cache()

    # ResNet-50 (bench.py bench_resnet50), f32
    B = TRAIN_IMG_B
    m = resnet50(1000, (224, 224, 3))
    m.compile(optimizer=SGD(lr=0.1, momentum=0.9),
              loss="sparse_categorical_crossentropy")
    rs = np.random.RandomState(0)                          # bench.py:379
    x = rs.randn(2 * B, 224, 224, 3).astype(np.float32)
    y = rs.randint(0, 1000, 2 * B).astype(np.int32)
    m.build(torch.Generator(device="cuda").manual_seed(0), device="cuda")
    n_conv = len(envelope_convs(m))
    n_train = len(tree_leaves(_split_state(m.params)[0]))
    run("resnet50(1000, (224, 224, 3)) (bench.py bench_resnet50, B=128, "
        "SGD(0.1, 0.9))", m, x, y, B, 3 * RESNET50_FWD_FLOPS * B,
        {"conv2d": n_conv, "fused_sgd": n_train}, B, "samples_per_s",
        _image_group)
    del m, x
    torch.cuda.empty_cache()
    return {k: total.get(k, 0) for k in (
        "conv2d", "flash_attention", "flash_attention_dkdv",
        "flash_attention_dq", "fused_adam", "fused_sgd")}


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
                  "device_busy_share": t["device_busy_share"],
                  "device_launches_per_tick": t["device_launches"],
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
              "kernels": {k: {"reused": r.reused,
                              "ptxas": ptxas_lines(r.ptxas)}
                          for k, r in built.items()}})
        check_no_spills(built)
        mma, f32_mma = phase_sass(built)

        timing = phase_kernels(torch)
        phase_tiny(torch, K)
        phase_train_tiny(torch, K)
        # each main path's launches, counted from 0 just before it runs
        phase_infer_tiny(torch, K)
        phase_train_image_tiny(torch, K)
        by_path = {"serve": phase_main(torch, K, card),
                   "train": phase_train_main(torch, K, card),
                   "infer": phase_infer_main(torch, K, card),
                   "block": phase_bottleneck_main(torch, K, card),
                   "train_image": phase_train_image_main(torch, K, card),
                   "train_f32": phase_train_f32_main(torch, K, card)}

        src = "zoo_tpu_torch/csrc/"
        pallas = "zoo_tpu/ops/pallas/"
        sources = {
            "flash_attention": ("flash_attention_fwd.cu",
                                "flash_attention.py:35"),
            "flash_attention_dkdv": ("flash_attention_bwd.cu",
                                     "flash_attention.py:151"),
            "flash_attention_dq": ("flash_attention_bwd.cu",
                                   "flash_attention.py:213"),
            "fused_bottleneck": ("fused_block.cu", "fused_block.py:80"),
            "fused_adam": ("fused_optim.cu", "fused_optim.py:87"),
            "fused_sgd": ("fused_optim.cu", "fused_optim.py:49"),
            "paged_decode": ("paged_decode.cu", "paged_decode.py:55"),
            "paged_prefill": ("paged_prefill.cu", "paged_prefill.py:54"),
            "conv2d": ("conv2d.cu", "conv.py:114"),
            "conv2d_int8": ("conv2d_int8_tc.cuh", "conv.py:128"),
            "quantized_matmul": ("quant_matmul.cu", "quant.py:42"),
            "fused_quantized_matmul": ("quant_matmul.cu", "quant.py:122")}
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
                "kernel_ms": t["kernel_ms"], "wall_ms": t["wall_ms"],
                "mma": mma[k]["mma"],
                **{key: t[key] for key in ("composition_ms", "tflops",
                                           "bound_ratio", "library_ratio",
                                           "composition_ratio", "shape",
                                           "plan", "device_launches_per_call")
                   if key in t},
                **({"f32_route": dict(
                    {key: t["f32_route"][key] for key in (
                        "ms", "plain_ms", "library_ms", "bound_ms",
                        "bound_by", "tflops", "bound_ratio",
                        "library_ratio", "shape", "max_abs_err")},
                    **{key: t["f32_route"][key] for key in (
                        "plan", "device_launches_per_call",
                        "bound_fma_ms", "bound_fma_ratio", "b64")
                       if key in t["f32_route"]},
                    mma=f32_mma[k]["mma"])}
                   if "f32_route" in t else {})})
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
