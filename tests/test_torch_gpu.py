"""The port's CUDA kernels against their plain PyTorch versions, on a
Hopper card.

Marked ``gpu``: without a Hopper card every test here skips (the
decision is made inside the ``hopper`` fixture, never at import). On the
card::

    python -m pytest --noconftest -p no:cacheprovider -m gpu \
        tests/test_torch_gpu.py

(``--noconftest``: the suite's conftest imports JAX, which the machine
with the card need not have; this file imports only torch and numpy.)

Tolerances: max absolute error 1e-4 on f32 outputs (the same f32 math
summed in another order), 3e-2 on bf16 outputs (one bf16 rounding of an
O(1) value is up to 4e-3, and the plain version rounds at other points);
1e-6 absolute on the optimizer updates (the same f32 elementwise math).
"""

import math

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

H, HKV, D, BS, NB, W = 8, 2, 64, 16, 24, 6
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2, "update": 1e-6}


@pytest.fixture(scope="module")
def hopper():
    from zoo_tpu_torch.ops.kernels import on_hopper
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    if not on_hopper():
        pytest.skip("the kernels are built for sm_90a (Hopper)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _err(a, b):
    return float((a.float() - b.float()).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,tq,tk,d", [
    (True, 100, 100, 64), (True, 33, 130, 128), (False, 70, 45, 16),
    (True, 512, 512, 32)])
def test_flash_kernel_matches_plain(hopper, dtype, causal, tq, tk, d):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper)
    q = torch.randn(2, H, tq, d, generator=g, device=hopper).to(dtype)
    k = torch.randn(2, HKV, tk, d, generator=g, device=hopper).to(dtype)
    v = torch.randn(2, HKV, tk, d, generator=g, device=hopper).to(dtype)
    before = FA.LAUNCHES
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    assert o.dtype == dtype and lse.dtype == torch.float32
    assert _err(o, ro) <= TOL[dtype]
    if dtype == torch.float32:
        assert _err(lse, rlse) <= 1e-4


def _cache(dev, kind, g, hkv=HKV, d=D):
    from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8
    kc = torch.randn(NB, BS, hkv, d, generator=g, device=dev)
    vc = torch.randn(NB, BS, hkv, d, generator=g, device=dev)
    if kind == "int8":
        ks, vs = absmax_scale(kc, dim=-1), absmax_scale(vc, dim=-1)
        return (narrow_int8(kc, ks[..., None]),
                narrow_int8(vc, vs[..., None]), ks, vs)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return kc.to(dt), vc.to(dt), None, None


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8, 12])
def test_paged_decode_kernel_matches_plain(hopper, kind, qdtype, splits):
    """Every split count (12 maps onto a cluster of 8 CTAs) on a 16-entry
    table; positions at 0, both sides of a block edge and the table's
    end. One launch per call: the split merge runs in the kernel."""
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    g = _gen(hopper, 1)
    kc, vc, ks, vs = _cache(hopper, kind, g)
    S, W16 = 7, 16
    tables = torch.randint(1, NB, (S, W16), generator=g, device=hopper,
                           dtype=torch.int32)
    pos = torch.tensor([0, 15, 16, W16 * BS - 1, 40, 63, 100],
                       dtype=torch.int32, device=hopper)
    q = torch.randn(S, H, D, generator=g, device=hopper).to(qdtype)
    before = PD.LAUNCHES
    o = PD.paged_flash_decode(q, kc, vc, tables, pos, k_scale=ks,
                              v_scale=vs, num_splits=splits)
    ro = PD.paged_decode_plain(q, kc, vc, tables, pos, k_scale=ks,
                               v_scale=vs)
    torch.cuda.synchronize()
    assert PD.LAUNCHES == before + 1
    assert PD.decode_plan(S, HKV, H // HKV, D, BS, W16, kc.element_size(),
                          PD.resolve_num_splits(W16, splits)).ctas == \
        min(PD.resolve_num_splits(W16, splits), 8)
    assert o.dtype == qdtype
    assert _err(o, ro) <= TOL[qdtype]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bs", [8, 16, 32])
def test_paged_decode_kernel_shapes(hopper, kind, group, d, bs):
    """Query heads a kv head G = 1 .. 16, head dims 64 and 128, block
    sizes 8, 16 and 32 (chunks of a whole block or of part of one);
    positions at 0, both sides of a block edge and the table's end."""
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8
    g = _gen(hopper, 2)
    hkv, nb, w8 = 2, 20, 8
    kc = torch.randn(nb, bs, hkv, d, generator=g, device=hopper)
    vc = torch.randn(nb, bs, hkv, d, generator=g, device=hopper)
    ks = vs = None
    if kind == "int8":
        ks, vs = absmax_scale(kc, dim=-1), absmax_scale(vc, dim=-1)
        kc, vc = narrow_int8(kc, ks[..., None]), narrow_int8(vc, vs[..., None])
    elif kind == "bf16":
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    tables = torch.randint(1, nb, (5, w8), generator=g, device=hopper,
                           dtype=torch.int32)
    pos = torch.tensor([0, bs - 1, bs, w8 * bs - 1, 3 * bs + 1],
                       dtype=torch.int32, device=hopper)
    q = torch.randn(5, hkv * group, d, generator=g, device=hopper)
    before = PD.LAUNCHES
    o = PD.paged_flash_decode(q, kc, vc, tables, pos, k_scale=ks, v_scale=vs)
    ro = PD.paged_decode_plain(q, kc, vc, tables, pos, k_scale=ks,
                               v_scale=vs)
    torch.cuda.synchronize()
    assert PD.LAUNCHES == before + 1
    assert _err(o, ro) <= TOL[torch.float32]


# (kv heads, query heads a kv head, head dim): the module's shape, then
# G = 1, 4 and 8 at D = 128
PREFILL_HEADS = [(HKV, H // HKV, D), (8, 1, 128), (4, 4, 128), (2, 8, 128)]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
# the last case is the speculative verify pass's shape: 8 slots of k + 1
# = 5 rows at unrelated starts, the last two slots' rows clamped to the
# table's last position (a clamped row repeats it)
@pytest.mark.parametrize("S,C,starts", [(1, 64, [20]), (3, 5, [0, 7, 91]),
                                        (2, 1, [0, 95]), (3, 17, [0, 40, 79]),
                                        (1, 64, [32]),
                                        (8, 5, [0, 13, 29, 47, 60, 77, 93,
                                                95])])
@pytest.mark.parametrize("hkv,g,d", PREFILL_HEADS)
def test_paged_prefill_kernel_matches_plain(hopper, kind, S, C, starts, hkv,
                                            g, d):
    from zoo_tpu_torch.ops.kernels import paged_prefill as PP
    gen = _gen(hopper, 2)
    kc, vc, ks, vs = _cache(hopper, kind, gen, hkv, d)
    tables = torch.randint(1, NB, (S, W), generator=gen, device=hopper,
                           dtype=torch.int32)
    pos = (torch.tensor(starts, device=hopper)[:, None]
           + torch.arange(C, device=hopper)[None]).clamp(max=W * BS - 1) \
        .to(torch.int32)
    qdtype = torch.bfloat16 if kind == "bf16" and C == 17 else torch.float32
    q = torch.randn(S, C, hkv * g, d, generator=gen, device=hopper) \
        .to(qdtype)
    # these small shapes split the key axis; test_paged_prefill_unsplit
    # takes the one-kernel route
    assert PP.prefill_plan(S, C, hkv, g, d, BS, W,
                           kc.element_size()).splits > 1
    o = PP.paged_flash_prefill(q, kc, vc, tables, pos, k_scale=ks,
                               v_scale=vs)
    ro = PP.paged_prefill_plain(q, kc, vc, tables, pos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    assert o.dtype == qdtype
    assert _err(o, ro) <= TOL[qdtype]


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_paged_prefill_unsplit(hopper, kind):
    """Enough rows that the plan does not split the key axis: the first
    kernel writes the output itself."""
    from zoo_tpu_torch.ops.kernels import paged_prefill as PP
    gen = _gen(hopper, 3)
    S, C, hkv, g, d = 9, 64, 8, 4, 128
    kc, vc, ks, vs = _cache(hopper, kind, gen, hkv, d)
    assert PP.prefill_plan(S, C, hkv, g, d, BS, W,
                           kc.element_size()).splits == 1
    tables = torch.randint(1, NB, (S, W), generator=gen, device=hopper,
                           dtype=torch.int32)
    pos = (torch.arange(S, device=hopper)[:, None] * 4
           + torch.arange(C, device=hopper)[None]).to(torch.int32)
    q = torch.randn(S, C, hkv * g, d, generator=gen, device=hopper)
    o = PP.paged_flash_prefill(q, kc, vc, tables, pos, k_scale=ks,
                               v_scale=vs)
    ro = PP.paged_prefill_plain(q, kc, vc, tables, pos, k_scale=ks,
                                v_scale=vs)
    torch.cuda.synchronize()
    assert _err(o, ro) <= TOL[torch.float32]


def test_wrappers_reject_what_the_kernels_do_not_take(hopper):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    q = torch.randn(1, 4, 16, 64, device=hopper)
    with pytest.raises(TypeError):
        FA.flash_attention_fwd(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="contiguous"):
        FA.flash_attention_fwd(q.transpose(2, 3), q, q)
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_attention_fwd(q[..., :48].contiguous(),
                               q[..., :48].contiguous(),
                               q[..., :48].contiguous())
    kc = torch.zeros(NB, BS, HKV, D, device=hopper)
    with pytest.raises(ValueError, match="on cpu"):
        PD.paged_flash_decode(torch.zeros(2, H, D, device=hopper), kc, kc,
                              torch.zeros(2, W, dtype=torch.int32),
                              torch.zeros(2, dtype=torch.int32,
                                          device=hopper))
    with pytest.raises(TypeError):
        PD.paged_flash_decode(torch.zeros(2, H, D, device=hopper), kc, kc,
                              torch.zeros(2, W, dtype=torch.int64,
                                          device=hopper),
                              torch.zeros(2, dtype=torch.int32,
                                          device=hopper))


def _streams(eng, prompts, n, sampling):
    eng.start()
    try:
        hs = [eng.submit(p, n, rid=str(i), sampling=sampling[i])
              for i, p in enumerate(prompts)]
        for h in hs:
            while not h.done:
                h.wait_new(len(h.tokens), 1.0)
        assert all(h.outcome == "ok" for h in hs), \
            [(h.outcome, h.error) for h in hs]
        assert eng.allocator.used_blocks == 0
        return [h.tokens for h in hs]
    finally:
        eng.stop()


@pytest.mark.parametrize("spec", ["llama:tiny:spec_k=4",
                                  "llama:tiny:spec_k=4,chunk=8,kv=int8"])
def test_spec_engine_streams_equal_plain_and_nospec(hopper, spec):
    """The tiny engine with speculation on motif-tiled prompts, greedy
    and seeded: the kernel streams equal the plain path's and the same
    model's with the engine at spec_k=0; every decode seat rides the
    verify pass, which launches the paged-prefill kernel."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.serving.llm import LLMEngine, build_llm_engine

    motif = np.random.RandomState(4).randint(0, 256, (16,))
    prompts = [np.tile(motif, n) for n in (1, 3, 9)]
    sampling = [None, {"temperature": 0.9, "top_k": 16, "seed": 3}, None]
    plain = dict(decode_impl="dense", prefill_impl="dense",
                 attention_impl="dense")
    eng = build_llm_engine(spec, device=hopper, start=False)
    reset_launch_counts()
    got = _streams(eng, prompts, 12, sampling)
    counts, st = launch_counts(), eng.stats()
    assert counts["paged_prefill"] > 0 and counts["paged_decode"] == 0
    assert st["compiles"]["verify"] > 0 and st["spec_accepted_tokens"] > 0
    ref = _streams(build_llm_engine(spec, device=hopper, start=False,
                                    params=eng.model.params, **plain),
                   prompts, 12, sampling)
    nospec = _streams(LLMEngine(eng.model, spec_k=0), prompts, 12, sampling)
    assert got == ref == nospec


def test_threefry_bits_on_the_card_equal_the_cpus(hopper):
    from zoo_tpu_torch.serving.llm.model import gumbel_noise, threefry_bits
    rs = np.random.RandomState(6)
    seeds = torch.from_numpy(rs.randint(0, 2 ** 32, 40, dtype=np.uint64)
                             .astype(np.int64))
    idx = torch.from_numpy(rs.randint(0, 1 << 20, 40))
    cpu = threefry_bits(seeds, idx, 128256)
    assert torch.equal(threefry_bits(seeds.to(hopper), idx.to(hopper),
                                     128256).cpu(), cpu)
    # the card's log may round to the other neighbour: 2 ulp of
    # max(|x|, 1), as against the JAX draw on the CPU
    noise = gumbel_noise(seeds.to(hopper), idx.to(hopper), 4096).cpu()
    ref = gumbel_noise(seeds, idx, 4096).numpy()
    ulp = np.spacing(np.maximum(np.abs(ref), np.float32(1.0)))
    assert (np.abs(noise.numpy() - ref) <= 2 * ulp).all()


def test_engine_streams_equal_plain_path(hopper):
    """Greedy streams through the tiny engine: kernels == plain."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.serving.llm import build_llm_engine

    rs = np.random.RandomState(3)
    prompts = [rs.randint(0, 256, (n,)) for n in (3, 30, 150)]
    plain = dict(decode_impl="dense", prefill_impl="dense",
                 attention_impl="dense")
    for spec in ("llama:tiny", "llama:tiny:chunk=8,kv=int8"):
        out, params, counts = {}, None, None
        for label, kw in (("kernels", {}), ("plain", plain)):
            eng = build_llm_engine(spec, device=hopper, params=params, **kw)
            params = eng.model.params
            reset_launch_counts()
            try:
                hs = [eng.submit(p, 10, rid=str(i))
                      for i, p in enumerate(prompts)]
                for h in hs:
                    while not h.done:
                        h.wait_new(len(h.tokens), 1.0)
                assert all(h.outcome == "ok" for h in hs)
                assert eng.allocator.used_blocks == 0
            finally:
                eng.stop()
            if label == "kernels":
                counts = launch_counts()
            out[label] = [h.tokens for h in hs]
        assert out["kernels"] == out["plain"], spec
        assert counts["paged_decode"] > 0
        assert counts["paged_prefill" if "chunk" in spec
                      else "flash_attention"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,h,hkv,tq,tk,d", [
    (True, 12, 4, 200, 200, 64), (False, 8, 2, 70, 45, 16),
    (True, 6, 6, 33, 130, 128), (True, 8, 1, 129, 129, 32)])
def test_flash_backward_kernels_match_plain(hopper, dtype, causal, h, hkv,
                                            tq, tk, d):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 5)
    q = torch.randn(2, h, tq, d, generator=g, device=hopper).to(dtype)
    k = torch.randn(2, hkv, tk, d, generator=g, device=hopper).to(dtype)
    v = torch.randn(2, hkv, tk, d, generator=g, device=hopper).to(dtype)
    do = torch.randn(2, h, tq, d, generator=g, device=hopper).to(dtype)
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
    assert _err(o, ro) <= TOL[dtype] and _err(lse, rlse) <= TOL[dtype]
    before = (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == dtype
        assert _err(a, b) <= TOL[dtype], name


def test_flash_autograd_runs_the_backward_kernels(hopper):
    """Gradients through ``flash_attention`` on the card come from the
    two backward kernels and equal autograd of the dense path."""
    from zoo_tpu_torch.ops.attention import dense_attention
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 6)
    leaves = [torch.randn(2, n, 96, 64, generator=g, device=hopper)
              .requires_grad_() for n in (H, HKV, HKV)]
    do = torch.randn(2, H, 96, 64, generator=g, device=hopper)
    before = FA.DQ_LAUNCHES
    # a non-contiguous cotangent, as a transpose after attention gives
    out = FA.flash_attention(*leaves, causal=True)
    grads = torch.autograd.grad(out.transpose(1, 2).contiguous()
                                .transpose(1, 2), leaves,
                                do.transpose(1, 2).contiguous()
                                .transpose(1, 2))
    ref = torch.autograd.grad(dense_attention(*leaves, causal=True)[0],
                              leaves, do)
    torch.cuda.synchronize()
    assert FA.DQ_LAUNCHES == before + 1
    for a, b in zip(grads, ref):
        assert _err(a, b) <= 1e-4


@pytest.mark.parametrize("n,offset", [(768 * 2048, 0), (1_000_003, 0),
                                      (4099, 1)])
@pytest.mark.parametrize("step", [1, 10])
def test_fused_optim_kernels_match_plain(hopper, n, offset, step):
    """A 16-byte-aligned leaf, a ragged one, and one that starts one
    element into its storage (the scalar path)."""
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    g = _gen(hopper, 7)

    def leaf(scale, positive=False):
        t = torch.randn(n + offset, generator=g, device=hopper) * scale
        return (t.abs() if positive else t)[offset:]
    # scales at which one step moves every output by more than 10x the
    # tolerance: a missing or misplaced store cannot pass
    p, grad = leaf(0.05), leaf(0.1)
    m, v = leaf(1e-2), leaf(1e-2, positive=True)
    t = torch.full((), step, dtype=torch.int32, device=hopper)
    want = FO.reference_apply_adam(p, grad, m, v, t, 1e-4,
                                   weight_decay=0.01)
    got = FO.fused_apply_adam(p.clone(), grad, m.clone(), v.clone(), t,
                              1e-4, weight_decay=0.01)
    torch.cuda.synchronize()
    for x, a, b in zip((p, m, v), got, want):
        assert _err(b, x) > 1e-5
        assert _err(a, b) <= 1e-6
    buf = leaf(1e-2)
    want = FO.reference_apply_sgd(p, grad, buf, 0.01, 0.9, 0.01)
    got = FO.fused_apply_sgd(p.clone(), grad, buf.clone(), 0.01, 0.9, 0.01)
    torch.cuda.synchronize()
    for x, a, b in zip((p, buf), got, want):
        assert _err(b, x) > 1e-5
        assert _err(a, b) <= 1e-6


@pytest.mark.parametrize("ok", [True, False])
def test_fused_optim_device_scalars_and_skip(hopper, ok):
    """The kernels read the step, a device learning rate and the guard's
    ``ok`` from device memory: with ``ok`` true they match their plain
    versions on the same device scalars; with ``ok`` false every operand
    is bit-unchanged though the gradient is NaN, and the launch is still
    counted."""
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    g = _gen(hopper, 9)
    n = 1_000_003
    p = torch.randn(n, generator=g, device=hopper) * 0.05
    m = torch.randn(n, generator=g, device=hopper) * 1e-2
    v = (torch.randn(n, generator=g, device=hopper) * 1e-2).abs()
    buf = torch.randn(n, generator=g, device=hopper) * 1e-2
    grad = torch.randn(n, generator=g, device=hopper) * 0.1
    if not ok:
        grad[::7] = float("nan")
    step = torch.full((), 12, dtype=torch.int32, device=hopper)
    lr = torch.full((), 3e-4, dtype=torch.float32, device=hopper)
    flag = torch.full((), ok, dtype=torch.bool, device=hopper)
    before = (FO.ADAM_LAUNCHES, FO.SGD_LAUNCHES)
    got = FO.fused_apply_adam(p.clone(), grad, m.clone(), v.clone(), step,
                              lr, weight_decay=0.01, ok=flag)
    got_sgd = FO.fused_apply_sgd(p.clone(), grad, buf.clone(), lr, 0.9,
                                 0.01, ok=flag)
    want = FO.reference_apply_adam(p, grad, m, v, step, lr,
                                   weight_decay=0.01, ok=flag)
    want_sgd = FO.reference_apply_sgd(p, grad, buf, lr, 0.9, 0.01, ok=flag)
    torch.cuda.synchronize()
    assert (FO.ADAM_LAUNCHES, FO.SGD_LAUNCHES) == (before[0] + 1,
                                                   before[1] + 1)
    for x, a, b in zip((p, m, v, p, buf), got + got_sgd, want + want_sgd):
        if ok:
            assert _err(b, x) > 1e-5
            assert _err(a, b) <= 1e-6
        else:
            assert torch.equal(a, x) and torch.equal(b, x)


def test_device_bias_corrections_equal_the_host_function(hopper):
    """The kernel's bias corrections from the device step, steps 1 to
    100000, bit-equal to ``bias_corrections`` (the power in double,
    rounded once)."""
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    steps = np.arange(1, 100001, dtype=np.int32)
    for b1, b2 in ((0.9, 0.999), (0.8, 0.98)):
        got = FO.adam_bias_corrections(
            torch.from_numpy(steps).to(hopper), b1, b2).cpu().numpy()
        want = np.array([FO.bias_corrections(int(t), b1, b2)
                         for t in steps], np.float32)
        assert np.array_equal(got, want), (b1, b2)


def test_tiny_fit_kernels_equal_plain(hopper):
    """A tiny Llama ``fit`` on the card: the flash and fused-AdamW
    kernels against the dense attention and the plain update."""
    from zoo_tpu_torch.models.llm.llama import (Llama, init_params,
                                                tiny_llama_config)
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay
    cfg = tiny_llama_config()
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab, (16, 32)).astype(np.int32)
    start = init_params(cfg, _gen(hopper, 8))
    out = {}
    for impl, fused in (("flash", True), ("dense", False)):
        m = Sequential().add(Llama(cfg, attention_impl=impl,
                                   input_shape=(32,)))
        m.compile(AdamWeightDecay(lr=1e-3, fused=fused),
                  "sparse_categorical_crossentropy_from_logits")
        m.params = {"000_llama": tree_map(torch.clone, start)}
        reset_launch_counts()
        hist = m.fit(ids, np.roll(ids, -1, 1), batch_size=4, nb_epoch=2,
                     verbose=0)
        out[impl] = (hist["loss"], m.params["000_llama"], launch_counts())
    np.testing.assert_allclose(out["flash"][0], out["dense"][0], rtol=1e-4)
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq", "fused_adam"):
        assert out["flash"][2][k] > 0 and out["dense"][2][k] == 0, k
    for k, w in out["dense"][1]["blocks"].items():
        assert _err(out["flash"][1]["blocks"][k].detach(), w.detach()) \
            <= 1e-4, k


# -- the image-inference slice: implicit-GEMM conv and int8 GEMMs --------
#
# Float conv: f32 within 1e-5 of the largest output (the same f32 sums in
# another order over up to 9 * C terms), bf16 within one bf16 ulp of it,
# 2**-7 relative (both round an f32 sum once, which may land on either
# side of a tie). Int8 kernels: bit-equal to their plain versions (exact
# integer sums, the same f32 epilogue and IEEE division).

def _rel_err(a, b):
    return _err(a, b) / max(1.0, float(b.float().abs().max()))


def _int8(shape, g, dev):
    return torch.randint(-127, 128, shape, generator=g, device=dev,
                         dtype=torch.int8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,k,o,s,padding", [
    (2, 14, 14, 64, 1, 64, 1, "SAME"), (2, 14, 14, 64, 1, 128, 2, "SAME"),
    (2, 9, 9, 16, 1, 24, 2, "VALID"), (2, 8, 8, 64, 3, 64, 1, "SAME"),
    (2, 8, 8, 16, 3, 70, 1, "VALID"), (3, 7, 7, 130, 3, 33, 1, "SAME"),
    (1, 5, 6, 3, 3, 8, 1, "SAME")])
def test_conv_kernels_match_plain(hopper, dtype, n, h, w, c, k, o, s,
                                  padding):
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 11)
    x = torch.randn(n, h, w, c, generator=g, device=hopper).to(dtype)
    wt = torch.randn(k, k, c, o, generator=g, device=hopper).to(dtype)
    before = conv.LAUNCHES
    y = conv.implicit_gemm_conv2d(x, wt, (s, s), padding)
    ref = conv.conv2d_plain(x, wt, (s, s), padding)
    torch.cuda.synchronize()
    assert conv.LAUNCHES == before + 1
    assert y.dtype == dtype and y.shape == ref.shape
    assert _rel_err(y, ref) <= (1e-5 if dtype == torch.float32 else 2 ** -7)

    xq, wq = _int8((n, h, w, c), g, hopper), _int8((k, k, c, o), g, hopper)
    xs = torch.rand(n, generator=g, device=hopper) + 0.01
    ws = torch.rand(o, generator=g, device=hopper) + 0.01
    before = conv.INT8_LAUNCHES
    y = conv.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s), padding)
    ref = conv.conv2d_int8_plain(xq, wq, xs, ws, (s, s), padding)
    torch.cuda.synchronize()
    assert conv.INT8_LAUNCHES == before + 1
    assert torch.equal(y, ref)


# -- the f32 conv on the tensor cores (3xTF32) at its edges ---------------
#
# Against the plain version (cuDNN in f32, TF32 off) within 1e-5 of the
# largest output, the f32 gate.

@pytest.mark.parametrize("n,h,w,c,k,o,s,vec", [
    (1, 5, 7, 64, 1, 64, 1, 4),      # B = 1, 35 rows: a ragged M tile
    (2, 6, 6, 64, 3, 200, 1, 4),     # O = 200: a ragged N tile
    (2, 7, 9, 40, 3, 72, 1, 4),      # C = 40: a ragged 32-channel step
    (2, 6, 6, 10, 3, 16, 1, 1),      # C % 4 == 2: 4-byte copies
    (1, 5, 6, 3, 3, 8, 1, 1),        # C = 3
    (2, 6, 6, 16, 3, 33, 1, 1),      # odd O: element stores
    (2, 9, 9, 128, 1, 130, 2, 1),    # 1x1 at stride 2; O % 4 == 2
    (3, 7, 7, 130, 3, 96, 1, 1),     # C % 32 == 2 and C % 4 == 2
    (2, 7, 7, 512, 3, 512, 1, 4)])   # ResNet-50's 7x7 512 -> 512 at B = 2
def test_f32_conv_tensor_core_edges(hopper, n, h, w, c, k, o, s, vec):
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 21)
    x = torch.randn(n, h, w, c, generator=g, device=hopper)
    wt = torch.randn(k, k, c, o, generator=g, device=hopper)
    _, _, oh, ow = conv._spatial_pads(h, w, k, k, (s, s), "SAME")
    assert conv.conv_f32_plan(n * oh * ow, c, o).vec == vec
    before = conv.LAUNCHES
    y = conv.implicit_gemm_conv2d(x, wt, (s, s))
    ref = conv.conv2d_plain(x, wt, (s, s))
    torch.cuda.synchronize()
    assert conv.LAUNCHES == before + 1
    assert y.shape == ref.shape and y.dtype == torch.float32
    assert _rel_err(y, ref) <= 1e-5


def test_f32_conv_on_an_unaligned_view(hopper):
    """A contiguous view four bytes off a 16-byte boundary takes 4-byte
    copies of the same kernel."""
    from zoo_tpu_torch.ops.kernels import _launch as L
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 22)
    base = torch.randn(1 + 2 * 8 * 8 * 64, generator=g, device=hopper)
    x = base[1:].view(2, 8, 8, 64)
    wt = torch.randn(3, 3, 64, 64, generator=g, device=hopper)
    assert L.alignment(x, wt) == 4
    assert conv.conv_f32_plan(128, 64, 64, L.alignment(x, wt)).vec == 1
    y = conv.implicit_gemm_conv2d(x, wt)
    ref = conv.conv2d_plain(x, wt)
    torch.cuda.synchronize()
    assert _rel_err(y, ref) <= 1e-5


# -- the bf16 tensor-core conv kernel at its edges ------------------------
#
# Against the plain version within 2**-7 of the largest output, as above:
# one bf16 ulp, since both round one f32 sum (taken in another order)
# that may land on either side of a tie.

@pytest.mark.parametrize("n,h,w,c,k,o,vec", [
    (1, 5, 7, 64, 1, 64, 8),      # 35 rows: not a multiple of the M tile
    (2, 6, 6, 64, 3, 200, 8),     # O = 200: a ragged N tile
    (2, 6, 6, 10, 3, 16, 2),      # C % 8 == 2: 4-byte copies
    (2, 6, 6, 11, 3, 16, 1),      # C % 8 == 3: 2-byte copies
    (2, 6, 6, 14, 1, 24, 2),      # C % 8 == 6: 4-byte copies
    (2, 6, 6, 12, 3, 40, 4),      # C % 8 == 4: 8-byte copies
    (2, 7, 7, 512, 3, 512, 8)])   # ResNet-50's 7x7 512 -> 512 at B = 2
def test_bf16_conv_tensor_core_edges(hopper, n, h, w, c, k, o, vec):
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 14)
    x = torch.randn(n, h, w, c, generator=g, device=hopper).bfloat16()
    wt = torch.randn(k, k, c, o, generator=g, device=hopper).bfloat16()
    assert conv.conv_plan(n * h * w, c, o).vec == vec
    before = conv.LAUNCHES
    y = conv.implicit_gemm_conv2d(x, wt)
    ref = conv.conv2d_plain(x, wt)
    torch.cuda.synchronize()
    assert conv.LAUNCHES == before + 1
    assert y.shape == ref.shape and y.dtype == torch.bfloat16
    assert _rel_err(y, ref) <= 2 ** -7


# -- the int8 tensor-core conv kernel at its edges ------------------------
#
# Bit-equal to the plain version: exact int32 sums, the same f32 epilogue.

@pytest.mark.parametrize("n,h,w,c,k,o,s,bk,vec", [
    (1, 5, 7, 64, 1, 64, 1, 64, 16),     # 35 rows: not a multiple of 128
    (2, 6, 6, 64, 3, 200, 1, 64, 16),    # O = 200: a ragged N tile
    (2, 7, 7, 64, 3, 64, 1, 64, 16),     # C = 64: 64-channel steps; halo
    (2, 7, 7, 256, 3, 96, 1, 128, 16),   # 128-channel steps, 3x3 halo
    (2, 9, 9, 128, 1, 130, 2, 128, 16),  # 1x1 at stride 2; O % 4 == 2
    (2, 6, 6, 24, 3, 33, 1, 64, 8),      # C % 16 == 8: 8-byte copies
    (2, 6, 6, 20, 1, 16, 1, 64, 4),      # 4-byte copies
    (2, 6, 6, 10, 3, 16, 1, 64, 2),      # 2-byte loads
    (1, 5, 6, 3, 3, 8, 1, 64, 1),        # 1-byte loads
    (2, 7, 7, 512, 3, 512, 1, 128, 16)])  # ResNet-50's 7x7 512 -> 512
def test_int8_conv_tensor_core_edges(hopper, n, h, w, c, k, o, s, bk, vec):
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 16)
    xq, wq = _int8((n, h, w, c), g, hopper), _int8((k, k, c, o), g, hopper)
    xs = torch.rand(n, generator=g, device=hopper) + 0.01
    ws = torch.rand(o, generator=g, device=hopper) + 0.01
    oh = -(-h // s)
    plan = conv.conv_int8_plan(n * oh * oh, c, o)
    assert (plan.bk, plan.vec, plan.out_vec) == (bk, vec,
                                                 4 if o % 4 == 0 else 1)
    wk = conv.int8_weights_kmajor(wq)
    before = conv.INT8_LAUNCHES
    y = conv.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s), "SAME",
                                       w_kmajor=wk)
    y2 = conv.implicit_gemm_conv2d_int8(xq, wq, xs, ws, (s, s), "SAME")
    ref = conv.conv2d_int8_plain(xq, wq, xs, ws, (s, s), "SAME")
    torch.cuda.synchronize()
    assert conv.INT8_LAUNCHES == before + 2
    assert y.dtype == torch.float32 and y.shape == ref.shape
    assert torch.equal(y, ref) and torch.equal(y2, ref)


def test_int8_conv_layer_uses_the_attached_kmajor_copy(hopper):
    """quantized_conv2d finds the copy quantize_model attached, so the
    forward makes none; the result equals the plain path."""
    from zoo_tpu_torch.ops.kernels import conv, quant
    g = _gen(hopper, 17)
    x = torch.randn(2, 8, 8, 64, generator=g, device=hopper)
    w = torch.randn(3, 3, 64, 96, generator=g, device=hopper)
    w_q, w_s = quant.quantize_conv_weights(w)
    wk = conv.attach_kmajor(w_q)
    made = []
    orig = conv.int8_weights_kmajor
    try:
        conv.int8_weights_kmajor = lambda t: made.append(t) or orig(t)
        y = quant.quantized_conv2d(x, w_q.detach(), w_s)
    finally:
        conv.int8_weights_kmajor = orig
    assert not made and conv.kmajor_of(w_q) is wk
    ref = quant.quantized_conv2d(x.cpu(), w_q.cpu(), w_s.cpu())
    torch.cuda.synchronize()
    assert torch.equal(y.cpu(), ref)


def test_bf16_conv_on_an_unaligned_view(hopper):
    """A contiguous view two bytes off a 16-byte boundary takes 2-byte
    copies of the same kernel."""
    from zoo_tpu_torch.ops.kernels import _launch as L
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 15)
    base = torch.randn(1 + 2 * 8 * 8 * 64, generator=g,
                       device=hopper).bfloat16()
    x = base[1:].view(2, 8, 8, 64)
    wt = torch.randn(3, 3, 64, 64, generator=g, device=hopper).bfloat16()
    assert L.alignment(x, wt) == 2
    y = conv.implicit_gemm_conv2d(x, wt)
    ref = conv.conv2d_plain(x, wt)
    torch.cuda.synchronize()
    assert _rel_err(y, ref) <= 2 ** -7


# -- the bf16 tensor-core flash forward at its edges ----------------------
#
# Against the plain version within 3e-2 (one bf16 rounding of an O(1)
# output is up to 4e-3, and the plain path rounds p at other points). A
# row with no live column (causal, Tq > Tk) is o = 0 and lse = -inf, as
# the Pallas kernel writes it; the plain path's finite mask gives another
# value there, so such rows are checked against that rule instead.

@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,tq,tk", [
    (True, 5, 5),         # Tq < 16
    (True, 9, 140),       # Tq < 16 against a longer, ragged K
    (False, 100, 100),    # Tk not a multiple of the 64-row K tile
    (True, 33, 130),      # causal with Tq < Tk
    (True, 130, 45)])     # causal with Tq > Tk: rows with no live column
def test_bf16_flash_forward_edges(hopper, d, causal, tq, tk):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 16)
    bf16 = torch.bfloat16
    q = torch.randn(2, H, tq, d, generator=g, device=hopper).to(bf16)
    k = torch.randn(2, HKV, tk, d, generator=g, device=hopper).to(bf16)
    v = torch.randn(2, HKV, tk, d, generator=g, device=hopper).to(bf16)
    before = FA.LAUNCHES
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    live = torch.arange(tq, device=hopper) + (tk - tq) >= 0 if causal \
        else torch.ones(tq, dtype=torch.bool, device=hopper)
    assert _err(o[:, :, live], ro[:, :, live]) <= 3e-2
    assert _err(lse[:, :, live], rlse[:, :, live]) <= 3e-2
    assert torch.all(o[:, :, ~live] == 0)
    assert torch.all(lse[:, :, ~live] == -math.inf)


def test_bf16_flash_forward_on_an_unaligned_view(hopper):
    """A contiguous q two bytes off a 16-byte boundary is copied to an
    aligned buffer and still launches the kernel."""
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 18)
    bf16 = torch.bfloat16
    base = torch.randn(1 + 2 * H * 70 * 64, generator=g,
                       device=hopper).to(bf16)
    q = base[1:].view(2, H, 70, 64)
    k = torch.randn(2, HKV, 70, 64, generator=g, device=hopper).to(bf16)
    v = torch.randn(2, HKV, 70, 64, generator=g, device=hopper).to(bf16)
    assert q.data_ptr() % 16 == 2
    before = FA.LAUNCHES
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    ro, rlse = FA.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    assert _err(o, ro) <= 3e-2 and _err(lse, rlse) <= 3e-2


@pytest.mark.parametrize("d", [16, 32, 64, 128])
def test_flash_backward_kernels_take_the_tensor_core_lse(hopper, d):
    """The backward kernels, fed the bf16 forward's o and lse, against
    autograd of the dense path in f32 from the same bf16 inputs: within
    3e-2 of the largest gradient (the dense path rounds neither p nor ds
    to bf16; half a bf16 ulp of a gradient near 8 is 2**-5)."""
    from zoo_tpu_torch.ops.attention import dense_attention
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 17)
    bf16 = torch.bfloat16
    q = torch.randn(2, H, 150, d, generator=g, device=hopper).to(bf16)
    k = torch.randn(2, HKV, 150, d, generator=g, device=hopper).to(bf16)
    v = torch.randn(2, HKV, 150, d, generator=g, device=hopper).to(bf16)
    do = torch.randn(2, H, 150, d, generator=g, device=hopper).to(bf16)
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    leaves = [t.float().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(dense_attention(*leaves, causal=True)[0],
                               leaves, do.float())
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        tol = 3e-2 * max(1.0, float(b.abs().max()))
        assert _err(a, b) <= tol, name


# -- the bf16 tensor-core flash backward at its edges ---------------------
#
# dK/dV and dQ of the bf16 route against the plain version within 3e-2,
# fed the bf16 forward's o and lse (rows with no live column have
# lse = -inf there, and get no gradient from either).

@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h,hkv,causal,tq,tk", [
    (8, 8, True, 5, 5),         # rep 1, one ragged tile of either
    (6, 2, True, 33, 130),      # rep 3, causal with Tq < Tk (end-aligned)
    (8, 1, False, 100, 100),    # rep 8, T not a multiple of the tile
    (6, 2, True, 130, 45),      # Tq > Tk: rows whose lse is -inf
    (8, 2, True, 192, 192)])    # several whole tiles, the causal skips
def test_bf16_flash_backward_edges(hopper, d, h, hkv, causal, tq, tk):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 19)
    bf16 = torch.bfloat16
    q, do = (torch.randn(2, h, tq, d, generator=g, device=hopper).to(bf16)
             for _ in "ab")
    k, v = (torch.randn(2, hkv, tk, d, generator=g, device=hopper).to(bf16)
            for _ in "ab")
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    before = (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == bf16 and torch.isfinite(a).all(), name
        assert _err(a, b) <= TOL[bf16], name
    empty = torch.isinf(lse)
    assert bool(empty.any()) == (causal and tq > tk)
    assert torch.all(got[0][empty] == 0)


def test_bf16_flash_backward_on_an_unaligned_view(hopper):
    """q and dO two bytes off a 16-byte boundary are copied to aligned
    buffers and still launch the tensor-core kernels."""
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 20)
    bf16 = torch.bfloat16
    q, do = (torch.randn(1 + 2 * H * 70 * 64, generator=g, device=hopper)
             .to(bf16)[1:].view(2, H, 70, 64) for _ in "ab")
    k, v = (torch.randn(2, HKV, 70, 64, generator=g, device=hopper).to(bf16)
            for _ in "ab")
    assert q.data_ptr() % 16 == 2 and do.data_ptr() % 16 == 2
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    before = (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, b) <= TOL[bf16], name


# -- the f32 flash backward at its edges ----------------------------------
#
# dK/dV and dQ of the f32 route against the plain version within 1e-4,
# fed the f32 forward's o and lse (rows with no live column have
# lse = -inf there and get no gradient from either), and against
# autograd of the dense path where every row has a live column.

@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("h,hkv,causal,tq,tk", [
    (8, 8, True, 5, 5),         # rep 1, one ragged tile of either
    (6, 2, True, 33, 130),      # rep 3, causal with Tq < Tk (end-aligned)
    (8, 2, False, 100, 77),     # rep 4, Tq != Tk, T not a multiple of 64
    (6, 2, True, 130, 45),      # Tq > Tk: rows whose lse is -inf
    (4, 1, True, 192, 192),     # rep 4, whole tiles: the causal pairs
    (8, 2, True, 257, 300)])    # an odd tile count: one tile unpaired
def test_f32_flash_backward_edges(hopper, d, h, hkv, causal, tq, tk):
    from zoo_tpu_torch.ops.attention import dense_attention
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 23)
    q, do = (torch.randn(2, h, tq, d, generator=g, device=hopper)
             for _ in "ab")
    k, v = (torch.randn(2, hkv, tk, d, generator=g, device=hopper)
            for _ in "ab")
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    before = (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    assert (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and torch.isfinite(a).all(), name
        assert _err(a, b) <= TOL[torch.float32], name
    empty = torch.isinf(lse)
    assert bool(empty.any()) == (causal and tq > tk)
    assert torch.all(got[0][empty] == 0)
    if not empty.any():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        dense = torch.autograd.grad(
            dense_attention(*leaves, causal=causal)[0], leaves, do)
        torch.cuda.synchronize()
        for name, a, b in zip(("dq", "dk", "dv"), got, dense):
            assert _err(a, b) <= TOL[torch.float32], name


def test_f32_flash_backward_on_an_unaligned_view(hopper):
    """q and dO four bytes off a 16-byte boundary are copied to aligned
    buffers for the f32 kernels."""
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 24)
    q, do = (torch.randn(1 + 2 * H * 70 * 64, generator=g, device=hopper)
             [1:].view(2, H, 70, 64) for _ in "ab")
    k, v = (torch.randn(2, HKV, 70, 64, generator=g, device=hopper)
            for _ in "ab")
    assert q.data_ptr() % 16 == 4 and do.data_ptr() % 16 == 4
    o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
    got = FA.flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = FA.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert _err(a, b) <= TOL[torch.float32], name


@pytest.mark.parametrize("m,k,n", [(128, 2048, 1000), (5, 33, 70),
                                   (64, 96, 64), (130, 260, 17)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_quant_gemm_kernels_equal_plain(hopper, m, k, n, out):
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 12)
    xq, wq = _int8((m, k), g, hopper), _int8((k, n), g, hopper)
    xs = torch.rand(m, 1, generator=g, device=hopper) + 0.01
    ws = torch.rand(1, n, generator=g, device=hopper) + 0.01
    y = quant.quantized_matmul(xq, wq, xs, ws, out_dtype=out)
    ref = quant.quantized_matmul_plain(xq, wq, xs, ws, out_dtype=out)
    torch.cuda.synchronize()
    assert y.dtype == out and torch.equal(y, ref)
    for xdt in (torch.float32, torch.bfloat16):
        x = torch.randn(m, k, generator=g, device=hopper).to(xdt)
        x[0] = 0                           # an all-zero row: scale 1
        before = quant.FQMM_LAUNCHES
        y = quant.fused_quantized_matmul(x, wq, ws, out_dtype=out)
        ref = quant.fused_quantized_matmul_plain(x, wq, ws, out_dtype=out)
        torch.cuda.synchronize()
        assert quant.FQMM_LAUNCHES == before + 1
        assert y.dtype == out and torch.equal(y, ref)


# the fused int8 GEMM on the tensor cores: the head (and M = 1), a ragged
# tile in every dimension with K and N off every copy width,
# bench_int8_matmul's shape, and the largest fused K
@pytest.mark.parametrize("m,k,n", [(1, 2048, 1000), (128, 2048, 1000),
                                   (130, 260, 17), (512, 1024, 1024),
                                   (3, 8192, 1000), (67, 8192, 130)])
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_fused_int8_gemm_tensor_core_edges(hopper, m, k, n, xdt, out):
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 14)
    x = torch.randn(m, k, generator=g, device=hopper).to(xdt)
    x[0] = 0                               # an all-zero row: scale 1
    if m > 1:
        # amax 127: scale exactly 1, so every other value, k + 0.5, lands
        # on a tie that rounds half to even
        x[1] = (torch.arange(k, device=hopper) % 253 - 126).float() + 0.5
        x[1, 0] = 127.0
    wq = _int8((k, n), g, hopper)
    ws = torch.rand(n, generator=g, device=hopper) + 0.01
    before = quant.FQMM_LAUNCHES
    y = quant.fused_quantized_matmul(x, wq, ws, out_dtype=out)
    ref = quant.fused_quantized_matmul_plain(x, wq, ws, out_dtype=out)
    torch.cuda.synchronize()
    assert quant.FQMM_LAUNCHES == before + 1
    assert y.dtype == out and torch.equal(y, ref)


def test_fused_int8_gemm_on_unaligned_views(hopper):
    # x and w views off every copy width take element copies
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 15)
    m, k, n = 70, 300, 200
    x = torch.randn(m * k + 1, generator=g, device=hopper)[1:].view(m, k)
    wq = _int8((k * n + 3,), g, hopper)[3:].view(k, n)
    ws = torch.rand(n, generator=g, device=hopper) + 0.01
    p = quant.fqmm_plan(m, k, n, 4, 4, 1)
    assert (p.x_vec, p.w_vec) == (4, 0)
    y = quant.fused_quantized_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(y, quant.fused_quantized_matmul_plain(x, wq, ws))


# the f32 flash forward: Tq < Tk and Tq > Tk causal (rows with no live
# column: o = 0, lse = -inf), ragged Tq and Tk, every head dim, B=2 with
# GQA 4:1 and MHA
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("causal,h,hkv,tq,tk", [
    (True, 8, 2, 5, 5), (True, 8, 2, 33, 130), (True, 8, 2, 130, 45),
    (False, 8, 2, 100, 77), (True, 4, 4, 200, 200), (False, 4, 4, 65, 191),
    (True, 8, 2, 257, 300)])
def test_f32_flash_forward_edges(hopper, d, causal, h, hkv, tq, tk):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 17)
    q = torch.randn(2, h, tq, d, generator=g, device=hopper)
    k = torch.randn(2, hkv, tk, d, generator=g, device=hopper)
    v = torch.randn(2, hkv, tk, d, generator=g, device=hopper)
    before = FA.LAUNCHES
    o, lse = FA.flash_attention_fwd(q, k, v, causal=causal)
    ro, rlse = FA.flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert FA.LAUNCHES == before + 1
    live = torch.arange(tq, device=hopper) + (tk - tq) >= 0 if causal \
        else torch.ones(tq, dtype=torch.bool, device=hopper)
    assert _err(o[:, :, live], ro[:, :, live]) <= TOL[torch.float32]
    assert _err(lse[:, :, live], rlse[:, :, live]) <= TOL[torch.float32]
    assert torch.all(o[:, :, ~live] == 0)
    assert torch.all(lse[:, :, ~live] == -math.inf)


def test_f32_flash_forward_on_an_unaligned_view(hopper):
    from zoo_tpu_torch.ops.kernels import flash_attention as FA
    g = _gen(hopper, 18)
    n = 2 * 8 * 70 * 64
    q = torch.randn(n + 1, generator=g, device=hopper)[1:].view(2, 8, 70, 64)
    k = torch.randn(2, 2, 70, 64, generator=g, device=hopper)
    assert q.data_ptr() % 16 == 4
    o, lse = FA.flash_attention_fwd(q, k, k, causal=True)
    ro, rlse = FA.flash_attention_plain(q, k, k, causal=True)
    torch.cuda.synchronize()
    assert _err(o, ro) <= TOL[torch.float32]
    assert _err(lse, rlse) <= TOL[torch.float32]


def test_fused_gemm_past_max_k_runs_the_two_pass_kernel(hopper):
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 13)
    k = quant._FUSED_MAX_K + 64
    x = torch.randn(8, k, generator=g, device=hopper)
    wq = _int8((k, 40), g, hopper)
    ws = torch.rand(40, generator=g, device=hopper) + 0.01
    before = (quant.QMM_LAUNCHES, quant.FQMM_LAUNCHES)
    y = quant.fused_quantized_matmul(x, wq, ws)
    x_q, x_s = quant.quantize_int8(x, axis=-1)
    ref = quant.quantized_matmul_plain(x_q, wq, x_s, ws)
    torch.cuda.synchronize()
    assert (quant.QMM_LAUNCHES, quant.FQMM_LAUNCHES) == \
        (before[0] + 1, before[1])
    assert torch.equal(y, ref)


# the two-pass int8 GEMM on wgmma: chip_smoke.py's three shapes (the
# head, bench_int8_matmul's, VGG-16's fc6), M = 1 (64-row tiles) at the
# head and at fc6, a ragged tile in every dimension with K and N off
# every copy width (byte copies), a ragged 128-row tile, a batch of 256
# past the fused path's K, and splits of 1, 2, 3, 5, 6 and 8 CTAs a
# cluster (5 and 6: rows shared unevenly among the cluster's CTAs)
@pytest.mark.parametrize("m,k,n", [(128, 2048, 1000), (512, 1024, 1024),
                                   (128, 25088, 4096), (1, 2048, 1000),
                                   (1, 25088, 4096), (4, 33, 17),
                                   (130, 260, 17), (65, 1000, 1003),
                                   (256, 8200, 4100), (64, 4096, 640),
                                   (128, 2560, 2560), (128, 2048, 2048)])
@pytest.mark.parametrize("out", [torch.float32, torch.bfloat16])
def test_quantized_matmul_tensor_core_edges(hopper, m, k, n, out):
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 16)
    xq, wq = _int8((m, k), g, hopper), _int8((k, n), g, hopper)
    xq[0] = 0                              # an all-zero row: scale 1
    xs = torch.rand(m, generator=g, device=hopper) + 0.01
    xs[0] = 1
    ws = torch.rand(n, generator=g, device=hopper) + 0.01
    before = quant.QMM_LAUNCHES
    y = quant.quantized_matmul(xq, wq, xs, ws, out_dtype=out)
    ref = quant.quantized_matmul_plain(xq, wq, xs, ws, out_dtype=out)
    torch.cuda.synchronize()
    assert quant.QMM_LAUNCHES == before + 1
    assert y.dtype == out and torch.equal(y, ref)


def test_quantized_matmul_on_unaligned_views(hopper):
    # x and w views off every copy width take byte copies
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 19)
    m, k, n = 70, 300, 200
    xq = _int8((m * k + 3,), g, hopper)[3:].view(m, k)
    wq = _int8((k * n + 5,), g, hopper)[5:].view(k, n)
    xs = torch.rand(m, generator=g, device=hopper) + 0.01
    ws = torch.rand(n, generator=g, device=hopper) + 0.01
    p = quant.qmm_plan(m, k, n, 1, 1, clusters=quant.cluster_limits(hopper))
    assert (p.x_vec, p.w_vec) == (0, 0)
    y = quant.quantized_matmul(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert torch.equal(y, quant.quantized_matmul_plain(xq, wq, xs, ws))


def test_quantized_matmul_cluster_limits_are_the_cards(hopper):
    # the CPU plan tests' H100 SXM table, where the card is one
    from test_torch_tc_plans import H100_CLUSTERS

    from zoo_tpu_torch.ops.kernels import quant
    limits = quant.cluster_limits(hopper)
    assert len(limits) == 8 and limits[0] >= limits[-1] >= 1
    if torch.cuda.get_device_properties(hopper).multi_processor_count == 132:
        assert limits == H100_CLUSTERS


# K past 131071, where int8 data could carry an int32 sum out of range:
# a Dense on a flattened 224 x 224 x 3 image (K = 150528) and a ragged K
# (byte copies); on random data the sums stay in range, and the kernel
# is bit-equal to its plain version, as the JAX kernel is exact there
@pytest.mark.parametrize("m,k,n", [(128, 150528, 1000), (4, 262147, 17)])
def test_quantized_matmul_past_k_131071(hopper, m, k, n):
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 22)
    xq, wq = _int8((m, k), g, hopper), _int8((k, n), g, hopper)
    xs = torch.rand(m, generator=g, device=hopper) + 0.01
    ws = torch.rand(n, generator=g, device=hopper) + 0.01
    acc = xq.double() @ wq.double()
    assert float(acc.abs().max()) < 2 ** 31        # the sums in range
    before = quant.QMM_LAUNCHES
    y = quant.quantized_matmul(xq, wq, xs, ws)
    ref = quant.quantized_matmul_plain(xq, wq, xs, ws)
    torch.cuda.synchronize()
    assert quant.QMM_LAUNCHES == before + 1
    assert torch.equal(y, ref)


# every product 127 * 127: over K = 140000 the cluster's CTAs each sum
# in range and their adds pass 2**31; over K = 1200000 each CTA's own
# s32 wgmma sums do. Both wrap (two's complement), as int32 sums do in
# the JAX kernel, and nothing saturates
@pytest.mark.parametrize("k", [140000, 1200000])
def test_quantized_matmul_int32_sums_wrap_past_their_range(hopper, k):
    from zoo_tpu_torch.ops.kernels import quant
    m, n = 2, 8
    xq = torch.full((m, k), 127, dtype=torch.int8, device=hopper)
    wq = torch.full((k, n), 127, dtype=torch.int8, device=hopper)
    ones_m = torch.ones(m, device=hopper)
    ones_n = torch.ones(n, device=hopper)
    y = quant.quantized_matmul(xq, wq, ones_m, ones_n)
    torch.cuda.synchronize()
    wrapped = (127 * 127 * k + 2 ** 31) % 2 ** 32 - 2 ** 31
    assert torch.equal(y, torch.full((m, n), float(wrapped), device=hopper))


@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
def test_fused_gemm_at_vgg16_fc6_takes_the_two_pass_kernel(hopper, xdt):
    # VGG-16's fc6 at B=128: K = 25088 > _FUSED_MAX_K, so the fused op
    # quantizes, then launches quantized_matmul once and no fused kernel
    from zoo_tpu_torch.ops.kernels import quant
    g = _gen(hopper, 20)
    m, k, n = 128, 25088, 4096
    x = torch.randn(m, k, generator=g, device=hopper).to(xdt)
    x[0] = 0
    wq = _int8((k, n), g, hopper)
    ws = torch.rand(n, generator=g, device=hopper) * 1e-2 + 1e-3
    before = (quant.QMM_LAUNCHES, quant.FQMM_LAUNCHES)
    y = quant.fused_quantized_matmul(x, wq, ws)
    x_q, x_s = quant.quantize_int8(x, axis=-1)
    ref = quant.quantized_matmul_plain(x_q, wq, x_s, ws, out_dtype=xdt)
    torch.cuda.synchronize()
    assert (quant.QMM_LAUNCHES, quant.FQMM_LAUNCHES) == \
        (before[0] + 1, before[1])
    assert y.dtype == xdt and torch.equal(y, ref)


# the reference conv's backward (the float conv kernel's backward too):
# deterministic cuDNN algorithms, so two calls on the same inputs give
# the same bits; at ResNet-50's four timed conv shapes, B=32
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,c,k,o,s", [(56, 256, 1, 64, 1),
                                       (28, 128, 3, 128, 1),
                                       (56, 256, 1, 512, 2),
                                       (7, 512, 3, 512, 1)])
def test_reference_conv_gradients_repeat_bit_for_bit(hopper, dtype, h, c, k,
                                                     o, s):
    from zoo_tpu_torch.ops.kernels import conv
    g = _gen(hopper, 21)
    oh = -(-h // s)
    x = torch.randn(32, h, h, c, generator=g, device=hopper).to(dtype)
    w = (torch.randn(k, k, c, o, generator=g, device=hopper)
         / math.sqrt(k * k * c)).to(dtype)
    dy = torch.randn(32, oh, oh, o, generator=g, device=hopper).to(dtype)
    first = conv.conv2d_plain_grads(x, w, dy, (s, s))
    second = conv.conv2d_plain_grads(x, w, dy, (s, s))
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_inference_wrappers_reject_what_the_kernels_do_not_take(hopper):
    from zoo_tpu_torch.ops.kernels import conv, quant
    x = torch.randn(1, 4, 4, 8, device=hopper)
    with pytest.raises(TypeError):
        conv.implicit_gemm_conv2d(x, x.new_zeros(1, 1, 8, 8).bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        conv.implicit_gemm_conv2d(x.transpose(1, 2), x.new_zeros(1, 1, 8, 8))
    with pytest.raises(ValueError, match="channels"):
        conv.implicit_gemm_conv2d(x, x.new_zeros(1, 1, 4, 8))
    with pytest.raises(TypeError):
        quant.quantized_matmul(torch.zeros(4, 8, device=hopper),
                               torch.zeros(8, 4, dtype=torch.int8,
                                           device=hopper),
                               torch.ones(4, device=hopper),
                               torch.ones(4, device=hopper))
    with pytest.raises(TypeError):
        quant.fused_quantized_matmul(torch.zeros(4, 8, device=hopper).half(),
                                     torch.zeros(8, 4, dtype=torch.int8,
                                                 device=hopper),
                                     torch.ones(4, device=hopper))


def _plain_kernels(monkeypatch):
    """Route the four inference kernel wrappers to their plain versions."""
    from zoo_tpu_torch.ops.kernels import conv, quant
    monkeypatch.setattr(conv, "implicit_gemm_conv2d", conv.conv2d_plain)
    monkeypatch.setattr(conv, "implicit_gemm_conv2d_int8",
                        conv.conv2d_int8_plain)
    monkeypatch.setattr(quant, "quantized_matmul",
                        quant.quantized_matmul_plain)
    monkeypatch.setattr(quant, "fused_quantized_matmul",
                        quant.fused_quantized_matmul_plain)


def test_tiny_resnet_kernels_equal_plain(hopper, monkeypatch):
    """A tiny ResNet on the card, f32: the conv kernels within 1e-5 of
    the plain path's probabilities; after quantize_model the int8 path
    bit-equal to the plain one."""
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.inference import quantize_model
    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(_gen(hopper, 14))
    x = np.random.RandomState(0).randn(6, 32, 32, 3).astype(np.float32)
    out = {}
    for path in ("float", "int8"):
        if path == "int8":
            quantize_model(m, mode="force")
        reset_launch_counts()
        got = m.predict(x, batch_size=4)
        counts = launch_counts()
        with monkeypatch.context() as mp:
            _plain_kernels(mp)
            reset_launch_counts()
            ref = m.predict(x, batch_size=4)
            assert not any(launch_counts().values())
        out[path] = (got, ref, counts)
    got, ref, counts = out["float"]
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    assert counts["conv2d"] == 2 * 7 and counts["conv2d_int8"] == 0
    got, ref, counts = out["int8"]
    np.testing.assert_array_equal(got, ref)
    assert counts["conv2d_int8"] == 2 * 7 and counts["conv2d"] == 0
    assert counts["fused_quantized_matmul"] == 2


# -- the image-training slice: conv autograd, fused bottleneck, SGD ------
#
# The fused bottleneck against its plain version: within 2**-6 of the
# largest output (both round t1, t2, z3 and y to bf16 and may land on
# either side of a tie after summing in another order; a flip in t1 or
# t2 moves y by a few bf16 steps of its largest value at most).

@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_conv_kernel_fit_trains_on_the_card(hopper, policy):
    """A ``Sequential`` of an in-envelope ``Conv2D`` and a ``Dense``:
    one ``fit`` step on the card through the conv kernel takes the
    gradient the CPU's plain path takes (SGD at lr 1, no momentum, so
    each parameter moves by minus its gradient)."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.layers import Conv2D, Dense
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD
    rs = np.random.RandomState(0)
    x = rs.randn(8, 8, 8, 4).astype(np.float32)
    y = rs.randn(8, 8, 8, 3).astype(np.float32)
    start, moved = None, {}
    for dev in ("cpu", "cuda"):
        m = Sequential()
        m.add(Conv2D(16, 3, 3, border_mode="same", dim_ordering="tf",
                     input_shape=(8, 8, 4)))
        m.add(Dense(3))
        m.compile(SGD(lr=1.0), "mse", dtype_policy=policy)
        m.build(_gen(torch.device("cpu"), 15), device="cpu")
        if start is None:
            start = tree_map(torch.clone, m.params)
        m.params = tree_map(lambda t: t.clone().to(dev), start)
        reset_launch_counts()
        m.fit(x, y, batch_size=8, nb_epoch=1, verbose=0, device=dev)
        torch.cuda.synchronize()
        counts = launch_counts()
        assert counts["conv2d"] == (1 if dev == "cuda" else 0)
        assert counts["fused_sgd"] == (4 if dev == "cuda" else 0)
        moved[dev] = tree_map(lambda a, b: (a.detach().cpu() - b),
                              m.params, start)
    tol = TOL[torch.float32 if policy == "float32" else torch.bfloat16]
    for k in ("000_convolution2d", "001_dense"):
        for leaf, a in moved["cuda"][k].items():
            b = moved["cpu"][k][leaf]
            assert float(b.abs().max()) > 1e-3, (k, leaf)
            assert _err(a, b) <= tol * max(1.0, float(b.abs().max())), \
                (k, leaf)


def test_reference_conv_fit_takes_f32_gradients(hopper):
    """A ``Conv2D`` outside the kernel's envelope (3x3, stride 2) takes
    the reference conv. With cuDNN's TF32 at PyTorch's default (on), one
    f32 ``fit`` step on the card takes the gradient the CPU takes, within
    the f32 tolerance: the reference conv's backward runs in f32 with
    TF32 off, as its forward does."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_map
    from zoo_tpu_torch.pipeline.api.keras.layers import Conv2D, Dense
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD
    rs = np.random.RandomState(1)
    x = rs.randn(8, 16, 16, 32).astype(np.float32)
    y = rs.randn(8, 8, 8, 3).astype(np.float32)
    start, moved = None, {}
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for dev in ("cpu", "cuda"):
            m = Sequential()
            m.add(Conv2D(32, 3, 3, border_mode="same", subsample=(2, 2),
                         dim_ordering="tf", input_shape=(16, 16, 32)))
            m.add(Dense(3))
            m.compile(SGD(lr=1.0), "mse")
            m.build(_gen(torch.device("cpu"), 21), device="cpu")
            if start is None:
                start = tree_map(torch.clone, m.params)
            m.params = tree_map(lambda t: t.clone().to(dev), start)
            reset_launch_counts()
            m.fit(x, y, batch_size=8, nb_epoch=1, verbose=0, device=dev)
            torch.cuda.synchronize()
            assert launch_counts()["conv2d"] == 0    # the reference conv
            moved[dev] = tree_map(lambda a, b: (a.detach().cpu() - b),
                                  m.params, start)
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    for k in ("000_convolution2d", "001_dense"):
        for leaf, a in moved["cuda"][k].items():
            b = moved["cpu"][k][leaf]
            assert float(b.abs().max()) > 1e-3, (k, leaf)
            assert _err(a, b) <= TOL[torch.float32] * max(
                1.0, float(b.abs().max())), (k, leaf)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,cin,cmid", [
    (56, 56, 256, 64), (28, 28, 512, 128), (14, 14, 1024, 256),
    (7, 7, 2048, 512),
    # Cmid 12 and 24, which the kernel pads to 16 and 32, and Cin 40 and
    # 48, not multiples of the 64-channel slice; ragged tiles (30 pixels
    # in 16-pixel tiles)
    (12, 10, 48, 12), (9, 9, 40, 24), (30, 30, 64, 64)])
def test_fused_bottleneck_kernel_matches_plain(hopper, dtype, h, w, cin,
                                               cmid):
    from zoo_tpu_torch.ops.kernels import fused_block as FB
    g = _gen(hopper, 16)
    x = torch.randn(2, h, w, cin, generator=g, device=hopper).to(dtype)
    ws = [torch.randn(s, generator=g, device=hopper) / math.sqrt(fan)
          for s, fan in (((cin, cmid), cin), ((3, 3, cmid, cmid), 9 * cmid),
                         ((cmid, cin), cmid))]
    before = FB.LAUNCHES
    y = FB.fused_bottleneck(x, *ws, impl="kernel")
    ref = FB.fused_bottleneck_plain(x, *ws)
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before + 1 and y.dtype == dtype
    scale = float(ref.float().abs().max())
    assert _err(y, ref) <= 2 ** -6 * scale
    # a fault in few or small outputs stays under the max-diff limit:
    # hold the share of outputs equal bit for bit too. At B=2 the share
    # counts few events: one t1 or t2 element rounded the other way
    # perturbs every channel of up to nine pixels, 9 of 49 at 7x7, and
    # 7x7 2048->512 read 0.99374 on an H100 (the other cases at least
    # 0.999, the limit chip_smoke.py holds B=128 to). z3 left unrounded
    # or a tap wrong on each tile's border row changes far more.
    assert float((y == ref).float().mean()) >= 0.99


def test_fused_bottleneck_kernel_b128_conv2_x(hopper):
    """conv2_x at ResNet-50's batch, 14 x 14 tiles: at least 0.999 of the
    outputs equal the plain version's bit for bit, all within 2**-6 of
    the largest."""
    from zoo_tpu_torch.ops.kernels import fused_block as FB
    g = _gen(hopper, 18)
    x = torch.randn(128, 56, 56, 256, generator=g,
                    device=hopper).to(torch.bfloat16)
    ws = [torch.randn(s, generator=g, device=hopper) / math.sqrt(fan)
          for s, fan in (((256, 64), 256), ((3, 3, 64, 64), 576),
                         ((64, 256), 64))]
    assert (FB.plan(56, 56, 256, 64).th, FB.plan(56, 56, 256, 64).tw) == \
        (14, 14)
    before = FB.LAUNCHES
    y = FB.fused_bottleneck(x, *ws, impl="kernel")
    ref = FB.fused_bottleneck_plain(x, *ws)
    torch.cuda.synchronize()
    assert FB.LAUNCHES == before + 1
    assert _err(y, ref) <= 2 ** -6 * float(ref.float().abs().max())
    assert float((y == ref).float().mean()) >= 0.999


def test_fused_bottleneck_gradients_on_the_card(hopper):
    """The op's gradients (kernel forward, recompute backward) against
    autograd of the composition, within 2e-2 of the largest gradient."""
    from zoo_tpu_torch.ops.kernels import fused_block as FB
    g = _gen(hopper, 17)
    x = torch.randn(4, 56, 56, 256, generator=g, device=hopper)
    ws = [torch.randn(s, generator=g, device=hopper) * 0.05
          for s in ((256, 64), (3, 3, 64, 64), (64, 256))]
    dy = torch.randn(x.shape, generator=g, device=hopper)
    leaves = [t.clone().requires_grad_() for t in [x] + ws]
    before = FB.LAUNCHES
    got = torch.autograd.grad(FB.fused_bottleneck(*leaves), leaves, dy)
    assert FB.LAUNCHES == before + 1
    ref_leaves = [t.clone().requires_grad_() for t in [x] + ws]
    want = torch.autograd.grad(FB.bottleneck_reference(*ref_leaves),
                               ref_leaves, dy)
    for a, b in zip(got, want):
        assert _err(a, b) <= 2e-2 * float(b.abs().max())


@pytest.mark.parametrize("kw", [dict(lr=0.1, momentum=0.9),
                                dict(lr=0.1, momentum=0.9, decay=0.5),
                                dict(lr=0.05)])
def test_sgd_through_the_kernel_matches_plain(hopper, kw):
    """``SGD`` on CUDA leaves (the kernel, one launch per leaf and step)
    against the same updates on CPU leaves (the plain version)."""
    from zoo_tpu_torch.ops.kernels import fused_optim as FO
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD
    g = _gen(torch.device("cpu"), 18)
    shapes = ((4099,), (64, 33), (3, 3, 16, 16))
    params = [torch.randn(s, generator=g) for s in shapes]
    grads = [[torch.randn(s, generator=g) for s in shapes]
             for _ in range(3)]
    out = {}
    for dev in ("cpu", "cuda"):
        opt = SGD(**kw)
        tree = {f"{i}": p.clone().to(dev) for i, p in enumerate(params)}
        state = opt.init(tree)
        before = FO.SGD_LAUNCHES
        for step in grads:
            tree, state = opt.apply(
                {f"{i}": t.to(dev) for i, t in enumerate(step)}, state, tree)
        torch.cuda.synchronize()
        assert FO.SGD_LAUNCHES - before == (9 if dev == "cuda" else 0)
        out[dev] = tree
    for k, a in out["cuda"].items():
        assert _err(out["cpu"][k], params[int(k)]) > 1e-3
        assert _err(a.cpu(), out["cpu"][k]) <= TOL["update"]


def _drain_tokens(eng, prompts, n, sampling):
    eng.start()
    try:
        hs = [eng.submit(p, n, rid=f"d{i}", sampling=sampling)
              for i, p in enumerate(prompts)]
        for h in hs:
            while not h.done:
                h.wait_new(len(h.tokens), 1.0)
        assert all(h.outcome == "ok" for h in hs)
        return [h.tokens for h in hs]
    finally:
        eng.stop()


@pytest.mark.parametrize("sampling", [None, {"temperature": 0.9,
                                             "top_k": 16, "seed": 5}],
                         ids=["greedy", "seeded"])
def test_wire_failover_streams_equal_direct_on_the_card(hopper, sampling):
    """Two ServingServers, each over an engine with its own
    PagedLlamaModel on one params tree; the HA client streams, the first
    server stops after a stream's third token, and every stream equals
    the kernel engine's direct one. No block is held afterwards."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.llm import build_llm_engine
    from zoo_tpu_torch.serving.server import ServingServer

    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 256, (n,)) for n in (5, 40, 120)]
    direct = build_llm_engine("llama:tiny", device=hopper, start=False)
    params = direct.model.params
    ref = _drain_tokens(direct, prompts, 16, sampling)
    engines = [build_llm_engine("llama:tiny", device=hopper, params=params)
               for _ in range(2)]
    servers = [ServingServer(None, llm_engine=e, port=0).start()
               for e in engines]
    reset_launch_counts()
    try:
        cli = HAServingClient([(s.host, s.port) for s in servers],
                              hedge=False, deadline_ms=120_000)
        got = []
        for i, p in enumerate(prompts):
            toks = []
            for tok in cli.generate(p, 16, **(sampling or {})):
                toks.append(tok)
                if i == 0 and len(toks) == 3:
                    servers[0].stop()
            got.append(toks)
        cli.close()
    finally:
        for s in servers:
            s.stop()
    assert got == ref
    assert launch_counts()["paged_decode"] > 0
    assert [e.allocator.used_blocks for e in engines] == [0, 0]


def test_replica_process_serves_through_the_kernels(hopper):
    """One ``--device cuda`` replica process: it streams a generate and
    its ``llm_stats`` name the kernel routes."""
    import os
    import subprocess
    import sys

    from zoo_tpu_torch.orca.bootstrap import free_port
    from zoo_tpu_torch.serving.tcp_client import _Connection

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "zoo_tpu_torch.serving.replica", "--model",
         "llama:tiny", "--device", "cuda", "--metrics-port", "-1",
         "--port", str(port)], cwd=root, stdout=subprocess.PIPE,
        text=True, env={**os.environ, "PYTHONPATH": root})
    try:
        line = proc.stdout.readline()
        assert line.startswith("REPLICA READY"), line
        conn = _Connection("127.0.0.1", port)
        frames = list(conn.stream({"op": "generate", "prompt": [1, 2, 3],
                                   "max_new_tokens": 8}))
        stats = conn.rpc({"op": "llm_stats"})["stats"]
        conn.close()
    finally:
        proc.terminate()
        proc.wait(30)
    assert frames[-1]["outcome"] == "ok" and frames[-1]["n_tokens"] == 8
    assert stats["decode_attention_impl"] == "flash"
    assert stats["prefill_attention_impl"] == "flash"
    assert stats["blocks_used"] == 0


def test_traced_failover_runs_through_the_kernels(hopper):
    """The ``check_trace_e2e`` copy on the card: three ``--device cuda``
    ``llama:tiny`` replicas, hedged traced streams across a SIGKILL, one
    trace over both replicas' files, a harvested postmortem and the
    trace echoed on an error reply."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "zoo_tpu_torch.scripts.check_trace_e2e",
         "--device", "cuda"], cwd=root, capture_output=True, text=True,
        timeout=600, env={**os.environ, "PYTHONPATH": root})
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    assert "TRACE E2E OK" in r.stdout


# -- the predict door ---------------------------------------------------------

@pytest.mark.parametrize("path", ["float", "int8"])
def test_served_tiny_resnet_kernels_equal_plain(hopper, path, monkeypatch):
    """The smoke's predict-tiny: a tiny ResNet behind ``ServingServer``
    (``batch_size=4``) and ``HAServingClient.predict`` on the card; the
    replies through the kernels equal the replies with every plain
    version (f32 within 1e-5, int8 bit for bit), one padded batch of 4
    a request."""
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model)
    from zoo_tpu_torch.serving.ha_client import HAServingClient
    from zoo_tpu_torch.serving.server import ServingServer

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(_gen(hopper, 14))
    if path == "int8":
        quantize_model(m, mode="force")
    x = np.random.RandomState(0).randn(6, 32, 32, 3).astype(np.float32)
    server = ServingServer(InferenceModel().load_keras(m, batch_size=4),
                           batch_size=4, max_wait_ms=1.0).start()
    client = HAServingClient([(server.host, server.port)], hedge=False,
                             deadline_ms=120_000)
    try:
        def serve():
            return np.concatenate([client.predict(x[i:i + 1])
                                   for i in range(len(x))])
        reset_launch_counts()
        got = serve()
        counts = launch_counts()
        with monkeypatch.context() as mp:
            _plain_kernels(mp)
            reset_launch_counts()
            ref = serve()
            assert not any(launch_counts().values())
    finally:
        client.close()
        server.stop()
    if path == "float":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
        assert counts["conv2d"] == 6 * 7 and counts["conv2d_int8"] == 0
    else:
        np.testing.assert_array_equal(got, ref)
        assert counts["conv2d_int8"] == 6 * 7 and counts["conv2d"] == 0
        assert counts["fused_quantized_matmul"] == 6


# -- Cluster Serving ----------------------------------------------------------

@pytest.mark.parametrize("path", ["float", "int8"])
def test_cluster_served_vgg_kernels_equal_plain(hopper, path, monkeypatch,
                                                tmp_path):
    """A VGG-16 at 160 x 160 x 3 (fc6: K = 12,800, the two-pass int8
    GEMM), ``mixed_bfloat16``, saved encrypted (AES-GCM), read back by
    ``InferenceModel.load_encrypted`` and served by ``ClusterServing``
    (``batch_size=4``) over an ``EmbeddedRedis`` on the card: queue and
    HTTP replies through the kernels against the same job's replies
    with every plain version (float within 4e-3 and its logits within
    2^-4 of their range, int8 bit for bit), no
    "NaN", no fallback, and per batch 13 ``conv2d``, or 13
    ``conv2d_int8`` + 1 ``quantized_matmul`` + 2
    ``fused_quantized_matmul``."""
    import json
    import time
    import urllib.request

    from zoo_tpu_torch.models.image import vgg16
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  quantize_model,
                                                  save_encrypted)
    from zoo_tpu_torch.serving import (ClusterServing, EmbeddedRedis,
                                       FrontEnd, InputQueue, OutputQueue)

    m = vgg16(10, (160, 160, 3))
    m.compile("sgd", "sparse_categorical_crossentropy",
              dtype_policy="mixed_bfloat16")
    m.build(_gen(hopper, 18))
    if path == "int8":
        quantize_model(m, mode="force")
    enc = save_encrypted(m, str(tmp_path / "vgg.enc"), "k", "s", mode="gcm")
    im = InferenceModel().load_encrypted(enc, "k", "s", mode="gcm",
                                         batch_size=4)
    x = np.random.RandomState(0).randn(6, 160, 160, 3).astype(np.float32)
    redis = EmbeddedRedis().start()
    cs = ClusterServing(im, redis_port=redis.port, batch_size=4).start()
    fe = FrontEnd(cs, InputQueue(port=redis.port)).start()

    def serve(tag):
        iq, oq = InputQueue(port=redis.port), OutputQueue(port=redis.port)
        for i in range(len(x) - 1):
            iq.enqueue(f"{tag}{i}", t=x[i])
        outs = []
        for i in range(len(x) - 1):
            deadline = time.monotonic() + 120
            while isinstance(out := oq.query_and_delete(f"{tag}{i}"), str):
                assert out == "[]" and time.monotonic() < deadline, out
                time.sleep(0.01)
            outs.append(out)
        body = json.dumps({"instances": [{"t": x[-1].tolist()}]}).encode()
        req = urllib.request.Request(f"http://{fe.host}:{fe.port}/predict",
                                     data=body)
        pred = json.loads(urllib.request.urlopen(req, timeout=120).read())
        val = json.loads(json.loads(pred["predictions"][0])["value"])
        outs.append(np.asarray(val["data"], np.float32))
        return np.stack(outs)

    try:
        b0 = cs.batches
        reset_launch_counts()
        got = serve("k")
        counts, batches = launch_counts(), cs.batches - b0
        with monkeypatch.context() as mp:
            _plain_kernels(mp)
            reset_launch_counts()
            ref = serve("p")
            assert not any(launch_counts().values())
        job = cs.metrics()
    finally:
        fe.stop()
        cs.stop()
        redis.stop()
    assert got.shape == (6, 10) and np.isfinite(got).all()
    assert job["nan_records"] == 0 and job["fallback_records"] == 0
    if path == "float":
        np.testing.assert_allclose(got, ref, rtol=0, atol=4e-3)
        assert counts["conv2d"] == 13 * batches
        assert counts["conv2d_int8"] == counts["quantized_matmul"] == 0
        # seed weights leave the probabilities near-uniform, where 4e-3
        # would pass a conv that wrote zeros: the logits (the softmax
        # set aside) within 2^-4 of their range, as chip_smoke.py holds
        head = im.model._topo[-1].layer
        act, head.activation = head.activation, None
        try:
            z = im.predict(x, batch_size=4)
            with monkeypatch.context() as mp:
                _plain_kernels(mp)
                z_ref = im.predict(x, batch_size=4)
        finally:
            head.activation = act
        assert np.abs(z - z_ref).max() <= 2.0 ** -4 * np.ptp(z_ref)
    else:
        np.testing.assert_array_equal(got, ref)
        assert (counts["conv2d_int8"], counts["quantized_matmul"],
                counts["fused_quantized_matmul"], counts["conv2d"]) == (
            13 * batches, batches, 2 * batches, 0)


# -- the NCF and BERT slice -------------------------------------------------

@pytest.mark.parametrize("policy", ["float32", "mixed_bfloat16"])
def test_tiny_bert_fit_kernels_equal_plain(hopper, policy):
    """A tiny BERT ``fit`` at S=512 on the card: ``auto`` takes the
    non-causal flash kernels, with the fused AdamW kernel, against the
    dense attention and the plain update. f32 within the tiny Llama
    fit's tolerances; bf16 losses within rtol 2e-2 (the kernel rounds p
    and dS to bf16 where the dense path keeps f32)."""
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.layers import BERT, Dense, Lambda
    from zoo_tpu_torch.pipeline.api.keras.optimizers import AdamWeightDecay
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 128, (8, 512)).astype(np.int32)
    y = rs.randint(0, 2, 8).astype(np.int32)
    start, out = None, {}
    for impl, fused in (("auto", True), ("dense", False)):
        m = Sequential()
        m.add(BERT(vocab=128, hidden_size=64, n_block=2, n_head=4,
                   seq_len=512, intermediate_size=128, hidden_p_drop=0.0,
                   attn_p_drop=0.0, attention_impl=impl,
                   input_shape=(512,)))
        m.add(Lambda(lambda h: h[:, 0], output_shape=(64,)))
        m.add(Dense(2))
        m.compile(AdamWeightDecay(lr=1e-3, fused=fused),
                  "sparse_categorical_crossentropy_from_logits",
                  dtype_policy=policy)
        if start is None:
            start = tree_map(torch.clone, m.build(_gen(hopper, 9)))
        m.params = tree_map(torch.clone, start)
        reset_launch_counts()
        hist = m.fit(ids, y, batch_size=4, nb_epoch=2, verbose=0)
        torch.cuda.synchronize()
        out[impl] = (hist["loss"], tree_leaves(m.params), launch_counts(),
                     m.layers[0].last_attention_impl)
    (lk, pk, ck, ik), (lp, pp, cp, ip) = out["auto"], out["dense"]
    assert (ik, ip) == ("flash", "dense")
    for k in ("flash_attention", "flash_attention_dkdv",
              "flash_attention_dq"):
        assert ck[k] == 2 * 4 and cp[k] == 0, k
    assert ck["fused_adam"] == len(pk) * 4 and cp["fused_adam"] == 0
    if policy == "mixed_bfloat16":
        np.testing.assert_allclose(lk, lp, rtol=2e-2)
        return
    np.testing.assert_allclose(lk, lp, rtol=1e-4)
    for a, b in zip(pk, pp):
        assert _err(a.detach(), b.detach()) <= 1e-4


def test_embedding_gradient_repeats_and_fills_past_the_table(hopper):
    """``take_rows`` on the card: its gradient over repeated ids (NCF's
    B=8192 into 6040 rows) repeats bit for bit and equals the CPU's
    within f32 summation order; an id past the table gives a NaN row,
    not a device-side assert."""
    from zoo_tpu_torch.pipeline.api.keras.layers.core import take_rows
    g = _gen(hopper, 21)
    table = torch.randn(6040, 64, generator=g, device=hopper)
    ids = torch.randint(0, 6040, (8192,), generator=g, device=hopper)
    dy = torch.randn(8192, 64, generator=g, device=hopper)

    def grad(t, i, d):
        e = t.clone().requires_grad_()
        return torch.autograd.grad(take_rows(e, i), e, d)[0]

    a, b = grad(table, ids, dy), grad(table, ids, dy)
    cpu = grad(table.cpu(), ids.cpu(), dy.cpu())
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    assert _err(a.cpu(), cpu) <= 1e-5 * max(1.0, float(cpu.abs().max()))
    out = take_rows(table, torch.tensor([0, 6040, -1, -6041],
                                        device=hopper))
    torch.cuda.synchronize()
    assert torch.equal(out[0], table[0]) and torch.equal(out[2], table[-1])
    assert bool(out[1].isnan().all()) and bool(out[3].isnan().all())


def test_ncf_fit_on_the_card_equals_the_cpu(hopper):
    """A small NCF ``fit`` with ``Adam`` on the card and on the CPU from
    one start: the losses within rtol 1e-5 and every parameter within
    1e-5 (the same f32 math; cuBLAS and the embedding backward sum in
    another order)."""
    from zoo_tpu_torch.models.recommendation import NeuralCF
    from zoo_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from zoo_tpu_torch.pipeline.api.keras.engine.base import (tree_leaves,
                                                              tree_map)
    from zoo_tpu_torch.pipeline.api.keras.optimizers import Adam
    rs = np.random.RandomState(1)
    x = np.stack([rs.randint(0, 300, 1024), rs.randint(0, 200, 1024)],
                 1).astype(np.int32)
    y = rs.randint(0, 5, 1024).astype(np.int32)
    start, out = None, {}
    for dev in ("cpu", "cuda"):
        m = NeuralCF(300, 200, 5, user_embed=16, item_embed=16,
                     hidden_layers=(32, 16), mf_embed=16)
        m.compile(Adam(lr=0.001), "sparse_categorical_crossentropy")
        if start is None:
            start = tree_map(torch.clone, m.build(device="cpu"))
        m.params = tree_map(lambda t: t.clone().to(dev), start)
        reset_launch_counts()
        hist = m.fit(x, y, batch_size=256, nb_epoch=2, verbose=0,
                     device=dev)
        out[dev] = (hist["loss"], [t.detach().cpu()
                                   for t in tree_leaves(m.params)])
        assert not any(launch_counts().values())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert _err(a, b) <= 1e-5
