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
O(1) value is up to 4e-3, and the plain version rounds at other points).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

H, HKV, D, BS, NB, W = 8, 2, 64, 16, 24, 6
TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}


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


def _cache(dev, kind, g):
    from zoo_tpu_torch.util.quantize import absmax_scale, narrow_int8
    kc = torch.randn(NB, BS, HKV, D, generator=g, device=dev)
    vc = torch.randn(NB, BS, HKV, D, generator=g, device=dev)
    if kind == "int8":
        ks, vs = absmax_scale(kc, dim=-1), absmax_scale(vc, dim=-1)
        return (narrow_int8(kc, ks[..., None]),
                narrow_int8(vc, vs[..., None]), ks, vs)
    dt = torch.bfloat16 if kind == "bf16" else torch.float32
    return kc.to(dt), vc.to(dt), None, None


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_paged_decode_kernel_matches_plain(hopper, kind, qdtype, splits):
    from zoo_tpu_torch.ops.kernels import paged_decode as PD
    g = _gen(hopper, 1)
    kc, vc, ks, vs = _cache(hopper, kind, g)
    S = 6
    tables = torch.randint(1, NB, (S, W), generator=g, device=hopper,
                           dtype=torch.int32)
    pos = torch.tensor([0, 15, 16, W * BS - 1, 40, 63], dtype=torch.int32,
                       device=hopper)
    q = torch.randn(S, H, D, generator=g, device=hopper).to(qdtype)
    o = PD.paged_flash_decode(q, kc, vc, tables, pos, k_scale=ks,
                              v_scale=vs, num_splits=splits)
    ro = PD.paged_decode_plain(q, kc, vc, tables, pos, k_scale=ks,
                               v_scale=vs)
    torch.cuda.synchronize()
    assert o.dtype == qdtype
    assert _err(o, ro) <= TOL[qdtype]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("S,C,starts", [(1, 64, [20]), (3, 5, [0, 7, 91]),
                                        (2, 1, [0, 95])])
def test_paged_prefill_kernel_matches_plain(hopper, kind, S, C, starts):
    from zoo_tpu_torch.ops.kernels import paged_prefill as PP
    g = _gen(hopper, 2)
    kc, vc, ks, vs = _cache(hopper, kind, g)
    tables = torch.randint(1, NB, (S, W), generator=g, device=hopper,
                           dtype=torch.int32)
    pos = (torch.tensor(starts, device=hopper)[:, None]
           + torch.arange(C, device=hopper)[None]).clamp(max=W * BS - 1) \
        .to(torch.int32)
    q = torch.randn(S, C, H, D, generator=g, device=hopper)
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
