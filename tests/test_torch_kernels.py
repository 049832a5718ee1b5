"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU each wrapper of ``zoo_tpu_torch.ops.kernels`` runs its plain
PyTorch version; the JAX side runs its Pallas kernel under the
interpreter, as the JAX package's own tests do. Inputs are drawn with
numpy from a seed and handed to both packages.

Tolerances: 2e-5 absolute/relative on paged attention (the JAX kernel
tests' own bound: f32 sums over at most a few dozen cache rows, in
another order) and 1e-5 absolute on flash attention outputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from zoo_tpu.ops.pallas.flash_attention import _fwd, flash_attention
from zoo_tpu.ops.pallas.paged_decode import paged_flash_decode
from zoo_tpu.ops.pallas.paged_prefill import paged_flash_prefill
from zoo_tpu.util import quantize as jq

from zoo_tpu_torch.ops.kernels import flash_attention as tflash
from zoo_tpu_torch.ops.kernels import paged_decode as tdec
from zoo_tpu_torch.ops.kernels import paged_prefill as tpre
from zoo_tpu_torch.util import quantize as tq

jax.config.update("jax_platforms", "cpu")

T = torch.from_numpy


def _decode_case(S=3, H=4, n_kv=2, D=16, n_blocks=12, bs=4, W=4, seed=0,
                 positions=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, H, D).astype(np.float32)
    kc = rs.randn(n_blocks, bs, n_kv, D).astype(np.float32)
    vc = rs.randn(n_blocks, bs, n_kv, D).astype(np.float32)
    bt = rs.randint(1, n_blocks, (S, W)).astype(np.int32)
    if positions is None:
        positions = rs.randint(0, W * bs, (S,))
    return q, kc, vc, bt, np.asarray(positions, np.int32)


def _both_decode(q, kc, vc, bt, pos, splits=None, ks=None, vs=None):
    ref = paged_flash_decode(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(pos), num_splits=splits, interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    out = tdec.paged_flash_decode(
        T(q), T(kc), T(vc), T(bt), T(pos), num_splits=splits,
        k_scale=None if ks is None else T(ks),
        v_scale=None if vs is None else T(vs))
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("splits", [1, 2, 4])
def test_paged_decode_matches_pallas(splits):
    ref, out = _both_decode(*_decode_case(), splits=splits)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_paged_decode_position_edges():
    """position 0, the last row of a block, a block start, and the last
    position of the table."""
    ref, out = _both_decode(*_decode_case(S=4, positions=[0, 3, 8, 15]),
                            splits=2)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_kv", [1, 2, 4])   # MQA, GQA, MHA
def test_paged_decode_gqa_and_mha(n_kv):
    ref, out = _both_decode(*_decode_case(H=4, n_kv=n_kv, seed=3 + n_kv))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def _int8_cache(rs, nb, bs, n_kv, D):
    """int8 K/V plus per-row scales, narrowed by the JAX quantizer; the
    port's quantizer must produce the same bytes."""
    out = []
    for _ in range(2):
        x = rs.randn(nb, bs, n_kv, D).astype(np.float32)
        s = np.asarray(jq.absmax_scale(x, axis=-1))
        qx = np.asarray(jq.narrow_int8(x, s[..., None]))
        ts = tq.absmax_scale(T(x), dim=-1)
        np.testing.assert_array_equal(ts.numpy(), s)
        np.testing.assert_array_equal(
            tq.narrow_int8(T(x), ts[..., None]).numpy(), qx)
        out += [qx, s]
    return out


def test_paged_decode_int8_dequant():
    rs = np.random.RandomState(21)
    S, H, n_kv, D, nb, bs, W = 3, 4, 2, 16, 12, 4, 4
    q = rs.randn(S, H, D).astype(np.float32)
    kq, ks, vq, vs = _int8_cache(rs, nb, bs, n_kv, D)
    bt = rs.randint(1, nb, (S, W)).astype(np.int32)
    for splits, positions in ((1, None), (2, [0, 7, 15]), (4, [3, 8, 12])):
        pos = np.asarray(positions if positions is not None
                         else rs.randint(0, W * bs, (S,)), np.int32)
        ref, out = _both_decode(q, kq, vq, bt, pos, splits, ks, vs)
        np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5,
                                   err_msg=f"splits={splits}")


def test_quantize_round_half_even_and_zero_rows():
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0], [0, 0, 0, 0, 0]],
                 np.float32)
    s = np.ones((2, 1), np.float32)
    np.testing.assert_array_equal(tq.narrow_int8(T(x), T(s)).numpy(),
                                  np.asarray(jq.narrow_int8(x, s)))
    np.testing.assert_array_equal(
        tq.absmax_scale(T(x), dim=-1).numpy(),
        np.asarray(jq.absmax_scale(x, axis=-1)))
    assert float(tq.absmax_scale(T(x[1]))) == 1.0
    np.testing.assert_array_equal(
        tq.widen_int8(T(np.array([3, -127], np.int8)), 0.5).numpy(),
        np.asarray(jq.widen_int8(np.array([3, -127], np.int8), 0.5)))


def test_resolve_num_splits_divides_table():
    assert tdec.resolve_num_splits(16, 4) == 4
    assert tdec.resolve_num_splits(6, 4) == 3
    assert tdec.resolve_num_splits(5, 4) == 1
    assert tdec.resolve_num_splits(32) == 4


def test_kernel_scales_must_travel_together():
    q, kc, vc, bt, pos = _decode_case()
    with pytest.raises(ValueError):
        tdec.paged_flash_decode(T(q), T(kc), T(vc), T(bt), T(pos),
                                k_scale=torch.zeros(12, 4, 2))


# ------------------------------------------------------------ paged prefill

def _prefill_case(S=2, C=5, H=4, n_kv=2, D=16, nb=14, bs=4, W=5, seed=0,
                  starts=None):
    rs = np.random.RandomState(seed)
    q = rs.randn(S, C, H, D).astype(np.float32)
    kc = rs.randn(nb, bs, n_kv, D).astype(np.float32)
    vc = rs.randn(nb, bs, n_kv, D).astype(np.float32)
    bt = rs.randint(1, nb, (S, W)).astype(np.int32)
    if starts is None:
        starts = rs.randint(0, W * bs - C + 1, (S,))
    pos = (np.asarray(starts)[:, None] + np.arange(C)[None, :]).astype(
        np.int32)
    return q, kc, vc, bt, pos


def _both_prefill(q, kc, vc, bt, pos, ks=None, vs=None):
    ref = paged_flash_prefill(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(bt),
        jnp.asarray(pos), interpret=True,
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs))
    out = tpre.paged_flash_prefill(
        T(q), T(kc), T(vc), T(bt), T(pos),
        k_scale=None if ks is None else T(ks),
        v_scale=None if vs is None else T(vs))
    return np.asarray(ref), out.numpy()


@pytest.mark.parametrize("starts", [None, [0, 15], [3, 8]])
def test_paged_prefill_matches_pallas(starts):
    """random starts, a chunk at position 0 and one ending on the last
    table position, and chunks crossing block boundaries."""
    ref, out = _both_prefill(*_prefill_case(starts=starts))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("n_kv", [1, 2, 4])
def test_paged_prefill_gqa_and_mha(n_kv):
    ref, out = _both_prefill(*_prefill_case(n_kv=n_kv, seed=5 + n_kv))
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_paged_prefill_int8_and_verify_shape():
    """int8 cache, and the verify shape (every slot x k+1 rows)."""
    rs = np.random.RandomState(8)
    S, C, H, n_kv, D, nb, bs, W = 3, 3, 4, 2, 16, 14, 4, 5
    q = rs.randn(S, C, H, D).astype(np.float32)
    kq, ks, vq, vs = _int8_cache(rs, nb, bs, n_kv, D)
    bt = rs.randint(1, nb, (S, W)).astype(np.int32)
    pos = (np.array([0, 6, 17])[:, None] + np.arange(C)).astype(np.int32)
    ref, out = _both_prefill(q, kq, vq, bt, pos, ks, vs)
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=2e-5)


def test_paged_prefill_rejects_bad_positions():
    q, kc, vc, bt, pos = _prefill_case()
    with pytest.raises(ValueError):
        tpre.paged_flash_prefill(T(q), T(kc), T(vc), T(bt), T(pos[:, :2]))


# ---------------------------------------------------------- flash attention

@pytest.mark.parametrize("causal,h,hkv,tq,tk", [
    (True, 4, 4, 16, 16),     # MHA, square causal
    (True, 4, 2, 24, 24),     # GQA
    (False, 4, 1, 8, 24),     # MQA, Tq != Tk, no mask
    (True, 4, 2, 8, 24),      # end-aligned causal, Tq < Tk
    (False, 2, 2, 16, 8),     # Tq > Tk, no mask
])
def test_flash_attention_matches_pallas(causal, h, hkv, tq, tk):
    rs = np.random.RandomState(tq + tk + h + hkv)
    B, D = 2, 16
    q = rs.randn(B, h, tq, D).astype(np.float32)
    k = rs.randn(B, hkv, tk, D).astype(np.float32)
    v = rs.randn(B, hkv, tk, D).astype(np.float32)
    ref = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, interpret=True)
    out, lse = tflash.flash_attention_fwd(T(q), T(k), T(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    # the saved logsumexp the backward slice will recompute from
    _, ref_lse = _fwd(jnp.asarray(q.reshape(B * h, tq, D)),
                      jnp.asarray(k.reshape(B * hkv, tk, D)),
                      jnp.asarray(v.reshape(B * hkv, tk, D)),
                      1.0 / np.sqrt(D), causal, tk, tq, tq, tk, h, hkv,
                      True)
    np.testing.assert_allclose(lse.numpy().reshape(B * h, tq),
                               np.asarray(ref_lse), atol=1e-5, rtol=1e-5)


def test_flash_attention_dispatch_contract():
    """``flash`` on CPU tensors raises; ``auto`` takes the dense path
    off a Hopper card; an arbitrary mask cannot take flash."""
    from zoo_tpu_torch.ops.attention import dot_product_attention
    q = torch.randn(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        dot_product_attention(q, q, q, causal=True, impl="flash")
    out = dot_product_attention(q, q, q, causal=True, impl="auto")
    ref = dot_product_attention(q, q, q, causal=True, impl="dense")
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="mask"):
        dot_product_attention(q, q, q, mask=torch.ones(8, 8, dtype=bool),
                              impl="flash")
