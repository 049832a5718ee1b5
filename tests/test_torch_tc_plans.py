"""Launch plans of the port's hand-written kernels, on the CPU.

``conv_plan`` (the bf16 conv kernel, ``csrc/conv2d_tc.cuh``),
``conv_f32_plan`` (the f32 conv kernel, ``csrc/conv2d_f32_tc.cuh``),
``conv_int8_plan`` (the int8 conv kernel, ``csrc/conv2d_int8_tc.cuh``),
``flash_plan`` (the bf16 flash forward, ``csrc/flash_attention_fwd.cu``),
``flash_f32_plan`` (the f32 flash forward, same file),
``flash_bwd_plan`` and ``flash_bwd_f32_plan`` (the bf16 and f32 flash
backward, ``csrc/flash_attention_bwd.cu``), ``fqmm_plan`` and
``qmm_plan`` (the fused and the two-pass int8 GEMMs,
``csrc/quant_matmul.cu``), ``prefill_plan`` (the paged
prefill, ``csrc/paged_prefill.cu``), ``decode_plan`` (the paged decode,
``csrc/paged_decode.cu``) and ``fused_block.plan`` (the fused
bottleneck, ``csrc/fused_block.cu``) are counted in Python only; the C
entries take them as given and check the shared memory only against a
block's limit. These tests hold the plans to the kernels' layouts, to
what a Hopper block can have and to the shapes the main paths give them: every
in-envelope conv of the port's own ResNet-50 (as ``chip_smoke.py``
enumerates them) at B=128, the ragged shapes of the card tests, and
every head dim. The wrappers are driven with a stand-in C entry, so the
order in which they pass the plan is checked too. The f32 conv's
3xTF32 arithmetic is modelled here too, against a float64 conv, and
the two-pass int8 GEMM's turn of w into the K-major tile ``wgmma``
reads, thread by thread.
"""

import math

import numpy as np
import pytest
import torch

from zoo_tpu_torch.ops.kernels import _launch as L
from zoo_tpu_torch.ops.kernels import conv as CV
from zoo_tpu_torch.ops.kernels import flash_attention as FA

MAX_SMEM = 232_448            # dynamic shared memory of one H100 block
NUM_SMS = 132                 # H100 SXM
# clusters of 1 .. 8 CTAs of the two-pass int8 GEMM that an H100 SXM runs
# at once (cudaOccupancyMaxActiveClusters, one CTA an SM): its GPCs' SM
# counts leave 30 clusters of 4 and 15 of 8, not 33 and 16; a card's own
# counts come from quant.cluster_limits (tests/test_torch_gpu.py holds
# this table to the card's)
H100_CLUSTERS = (132, 66, 39, 30, 22, 17, 15, 15)
B = 128                       # ResNet-50's batch on the main paths
# (n, h, w, c, k, o, stride, padding): the ragged conv cases of
# tests/test_torch_gpu.py, and C % 8 in {2, 3, 6}
RAGGED = [(2, 9, 9, 16, 1, 24, 2, "VALID"), (2, 8, 8, 16, 3, 70, 1, "VALID"),
          (3, 7, 7, 130, 3, 33, 1, "SAME"), (1, 5, 6, 3, 3, 8, 1, "SAME"),
          (2, 6, 6, 10, 3, 16, 1, "SAME"), (2, 6, 6, 11, 3, 16, 1, "SAME"),
          (2, 6, 6, 14, 1, 24, 1, "SAME")]


@pytest.fixture(scope="module")
def resnet50_convs():
    import chip_smoke
    from zoo_tpu_torch.models.image import resnet50
    return sorted(set(chip_smoke.envelope_convs(resnet50(1000,
                                                         (224, 224, 3)))))


def _check(plan, rows, c, o):
    assert plan.smem <= MAX_SMEM
    assert plan.m_tiles * plan.bm >= rows > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= o > (plan.n_tiles - 1) * plan.bn
    assert (2 * c) % plan.copy_bytes == 0 and (2 * o) % plan.copy_bytes == 0
    assert plan.threads == 2 * plan.bm         # a warpgroup per 64 rows
    # the ring (64 channels a step) and the epilogue's output tile, the
    # row origins and the slack that aligns the ring to 1024 bytes
    ring = plan.stages * (plan.bm + plan.bn) * 64 * 2
    assert plan.smem == 1024 + max(ring, plan.bm * (plan.bn + 8) * 2) \
        + 16 * plan.bm


def test_every_resnet50_conv_gets_a_16_byte_plan(resnet50_convs):
    import chip_smoke
    assert len(resnet50_convs) == 19
    assert set(chip_smoke.CONV_SHAPES) <= set(resnet50_convs)
    for h, c, k, o, s in resnet50_convs:
        oh = -(-h // s)
        rows = B * oh * oh
        plan = CV.conv_plan(rows, c, o)
        _check(plan, rows, c, o)
        assert plan.vec == 8, (h, c, k, o, s)
        # O <= 64 is one N tile: the activation is read once
        assert plan.n_tiles == 1 or o > 64


@pytest.mark.parametrize("n,h,w,c,k,o,s,padding", RAGGED)
def test_ragged_convs_get_a_narrower_copy(n, h, w, c, k, o, s, padding):
    _, _, oh, ow = CV._spatial_pads(h, w, k, k, (s, s), padding)
    rows = n * oh * ow
    plan = CV.conv_plan(rows, c, o)
    _check(plan, rows, c, o)
    want = next(v for v in (8, 4, 2, 1) if c % v == 0 and o % v == 0)
    assert plan.vec == want
    assert plan.bn == (64 if o <= 64 else 128)


def test_conv_plan_fills_the_card_at_7x7():
    # 6,272 rows x 512: 196 tiles of 128 x 128, two blocks to an SM (one
    # SM has 233,472 bytes of shared memory), so all are resident at
    # once on 132 SMs
    plan = CV.conv_plan(B * 7 * 7, 512, 512)
    assert (plan.bm, plan.bn, plan.blocks) == (128, 128, 196)
    assert 2 * plan.smem <= 233_472 and plan.blocks <= 2 * NUM_SMS
    thin = CV.conv_plan(B * 56 * 56, 256, 64)
    assert (thin.bn, thin.stages, thin.blocks) == (64, 4, 3136)


@pytest.mark.parametrize("align,vec", [(16, 8), (8, 4), (4, 2), (2, 1)])
def test_conv_plan_narrows_the_copy_to_the_pointers(align, vec):
    assert CV.conv_plan(1000, 64, 64, align=align).vec == vec


def test_conv_plan_refuses_an_empty_conv():
    with pytest.raises(ValueError, match="empty"):
        CV.conv_plan(0, 64, 64)


# -- the f32 conv as 3xTF32 (csrc/conv2d_f32_tc.cuh) -----------------------

def _check_f32(plan, rows, c, o):
    assert plan.smem <= MAX_SMEM
    assert plan.m_tiles * plan.bm >= rows > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= o > (plan.n_tiles - 1) * plan.bn
    assert c % plan.vec == 0 and o % plan.vec == 0
    assert plan.copy_bytes == 4 * plan.vec in (16, 4)
    # two warpgroups of 64 output channels x 128 pixels
    assert plan.threads == 256 and plan.bm * plan.bn == 2 * 64 * 128
    # ring slots of an activation tile and its TF32 lo part in 128-byte
    # rows and a weight tile of 32 rows of bn + 8 floats, then 16 bytes of
    # row origins a pixel and 1024 of slack to align the ring
    stage = 2 * plan.bm * 128 + 32 * (plan.bn + 8) * 4
    assert stage % 1024 == 0
    assert plan.stages == (4 if plan.bn == 128 else 3)
    assert plan.smem == 1024 + plan.stages * stage + 16 * plan.bm


def test_every_resnet50_conv_gets_an_f32_plan(resnet50_convs):
    for h, c, k, o, s in resnet50_convs:
        oh = -(-h // s)
        rows = B * oh * oh
        plan = CV.conv_f32_plan(rows, c, o)
        _check_f32(plan, rows, c, o)
        assert plan.vec == 4, (h, c, k, o, s)
        # O <= 64 is one 64-channel O tile of 256 pixels: the activation
        # is read once
        assert (plan.bm, plan.bn) == ((256, 64) if o <= 64 else (128, 128))


@pytest.mark.parametrize("n,h,w,c,k,o,s,padding", RAGGED + [
    (1, 7, 9, 40, 3, 200, 1, "SAME"), (1, 9, 9, 64, 1, 33, 2, "SAME")])
def test_ragged_convs_get_an_f32_plan(n, h, w, c, k, o, s, padding):
    _, _, oh, ow = CV._spatial_pads(h, w, k, k, (s, s), padding)
    rows = n * oh * ow
    plan = CV.conv_f32_plan(rows, c, o)
    _check_f32(plan, rows, c, o)
    # 16-byte copies only where both C and O are multiples of 4
    assert plan.vec == (4 if c % 4 == 0 and o % 4 == 0 else 1)


@pytest.mark.parametrize("align,vec", [(16, 4), (8, 1), (4, 1)])
def test_f32_plan_narrows_the_copy_to_the_pointers(align, vec):
    assert CV.conv_f32_plan(1000, 64, 64, align=align).vec == vec


def test_f32_plan_refuses_an_empty_conv():
    with pytest.raises(ValueError, match="empty"):
        CV.conv_f32_plan(10, 0, 64)


def _rna_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as the kernel rounds it (rna_tf32): half a unit
    of the 13 dropped bits added to the magnitude, then the bits
    masked."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def test_rna_tf32_rounds_to_nearest_with_ties_away():
    one = 1.0 + 2.0 ** -10                  # a TF32 number
    half = 2.0 ** -11                       # half its last unit
    x = torch.tensor([one, one + half, -(one + half), 1.0 + half,
                      one + half * 0.99], dtype=torch.float32)
    want = torch.tensor([one, one + 2 * half, -(one + 2 * half),
                         1.0 + 2 * half, one], dtype=torch.float32)
    assert torch.equal(_rna_tf32(x), want)
    # hi + lo recovers x to within 2**-22 of it
    rs = np.random.RandomState(0)
    v = torch.tensor((rs.randn(10_000) * 10.0 ** rs.randint(-8, 8, 10_000))
                     .astype(np.float32))
    hi = _rna_tf32(v)
    lo = _rna_tf32(v - hi)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max()
    assert float(rel) <= 2.0 ** -22


@pytest.mark.parametrize("shape", [(56, 256, 1, 64, 1), (28, 128, 3, 128, 1),
                                   (56, 256, 1, 512, 2),
                                   (7, 512, 3, 512, 1)])
def test_3xtf32_conv_model_holds_the_f32_gate(shape):
    """The f32 kernel's arithmetic in plain torch at chip_smoke.py's four
    timed conv shapes, B=2: each operand split into TF32 hi and lo by bit
    masks, the three products x_lo w_hi + x_hi w_lo + x_hi w_hi taken
    exactly (float64) and rounded to f32 once, against the float64 conv.
    The gate on the card is 1e-5 of the largest output; the model stays
    under a twentieth of it, the margin the kernel's own f32 sums and
    the plain version's rounding have to live in."""
    import chip_smoke
    assert shape in chip_smoke.CONV_SHAPES
    h, c, k, o, s = shape
    rs = np.random.RandomState(7)
    x = torch.tensor(rs.randn(2, h, h, c).astype(np.float32))
    w = torch.tensor(rs.randn(k, k, c, o).astype(np.float32))
    xh, wh = _rna_tf32(x), _rna_tf32(w)
    xl, wl = _rna_tf32(x - xh), _rna_tf32(w - wh)
    pads = CV._pads(x, w, (s, s), "SAME")

    def conv64(a, b):
        return CV._conv_nhwc(a, b, (s, s), pads, torch.float64)

    got = (conv64(xl, wh) + conv64(xh, wl) + conv64(xh, wh)).float()
    ref = conv64(x, w)
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    assert rel <= 1e-5 / 20, rel
    # and one TF32 product alone would not hold the gate
    one = float((conv64(xh, wh) - ref).abs().max() / ref.abs().max())
    assert one > 1e-5


def _rz_f32(x: np.ndarray) -> np.ndarray:
    """float64 -> f32 rounded toward zero."""
    f = x.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(x)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def _mma_chain(a, b, steps_per_chain):
    """3xTF32 sums of a (M, K) x (K, N) product as the kernel takes them,
    with the tensor cores modelled as exact 8-deep products added to
    their accumulator rounded toward zero: chains of ``steps_per_chain``
    8-deep steps (0: one chain over K) start from zero and are added to
    an f32 sum by a rounding add."""
    def tf32(v):
        return _rna_tf32(torch.from_numpy(v)).numpy()
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    part = np.zeros_like(acc)
    for step, k0 in enumerate(range(0, a.shape[1], 8)):
        sl = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            prod = x[:, sl].astype(np.float64) @ y[sl].astype(np.float64)
            part = _rz_f32(part.astype(np.float64) + prod)
        if steps_per_chain and (step + 1) % steps_per_chain == 0:
            acc, part = acc + part, np.zeros_like(acc)
    return acc + part


def test_3xtf32_short_chains_keep_truncation_off_the_gate():
    """Why the kernel starts each 32-deep step's 12 products from zero:
    the tensor cores' f32 accumulation truncates, and over one chain of
    4608 terms (ResNet-50's 7x7 512 -> 512) its bias reaches several
    times the steps' error; added in f32 step by step, the short chains'
    errors of either sign stay far under the 1e-5 gate."""
    rs = np.random.RandomState(3)
    a = rs.randn(24, 9 * 512).astype(np.float32)
    b = rs.randn(9 * 512, 24).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    mag = np.abs(ref).max()
    steps = float(np.abs(_mma_chain(a, b, 4) - ref).max() / mag)
    one = float(np.abs(_mma_chain(a, b, 0) - ref).max() / mag)
    assert steps <= 1e-5 / 10, steps
    assert one > 5 * steps, (one, steps)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_plan_at_every_head_dim(d):
    # the bf16 Q tile (64 rows) and a 2-slot ring of 64-row K and V tiles
    smem = FA.flash_plan(d)
    assert smem == 2 * d * (64 + 2 * 2 * 64) <= MAX_SMEM


def test_flash_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_plan(48)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_bwd_plan_at_every_head_dim(d):
    p = FA.flash_bwd_plan(d)
    # 32-row steps at D=128 keep the accumulators in registers
    step = 32 if d == 128 else 64
    assert (p.step, p.stages) == (step, 2)
    row = 2 * d
    # dK/dV: the 64-row K and V tiles, then per slot a Q and a dO tile
    # with their f32 lse and delta; dQ: the 64-row Q and dO tiles, then
    # per slot a K and a V tile
    assert p.dkdv_smem == 2 * 64 * row + 2 * step * (2 * row + 8)
    assert p.dq_smem == 2 * 64 * row + 2 * 2 * step * row
    assert max(p.dkdv_smem, p.dq_smem) <= MAX_SMEM


def test_flash_bwd_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_bwd_plan(96)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_f32_plan_at_every_head_dim(d):
    p = FA.flash_f32_plan(d, causal=True)
    assert (p.block_q, p.block_k, p.threads, p.stages) == (64, 64, 256, 2)
    # Q and a 2-slot ring of K and V tiles in rows of d + 4 floats, then
    # 8 warps' P buffers (32 keys x 20 floats); half 1's partials, 4 rows
    # x (d / 8 + 2) floats a thread, fit the drained ring
    ring = 2 * 2 * 64 * (d + 4) * 4
    assert p.smem == 64 * (d + 4) * 4 + ring + 8 * 32 * 20 * 4 <= MAX_SMEM
    assert (4 * (d // 8) + 8) * 128 * 4 <= ring
    assert p.pair == 1 and FA.flash_f32_plan(d).pair == 0


def test_flash_f32_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_f32_plan(80)


def _f32_schedule(tq, tk, causal, plan):
    """The f32 flash kernel's division of the work, as it computes it
    (csrc/flash_attention_fwd.cu, f32::flash_fwd_kernel): for each block
    of the grid's x axis, the ``(q tile, key tiles)`` it walks, in
    order. Paired, block x takes q tile n-1-x, then q tile x; a causal q
    tile walks the key tiles up to its last live column, none when no
    row of it has one."""
    n_q = -(-tq // plan.block_q)
    n_kt = -(-tk // plan.block_k)
    blocks = []
    for x in range((n_q + 1) // 2 if plan.pair else n_q):
        tiles = [n_q - 1 - x] + ([x] if plan.pair and x != n_q - 1 - x
                                 else [])
        walk = []
        for t in tiles:
            n_k = n_kt
            if causal:
                last = t * plan.block_q + plan.block_q - 1 + tk - tq
                n_k = 0 if last < 0 else min(n_kt, last // plan.block_k + 1)
            walk.append((t, n_k))
        blocks.append(walk)
    return blocks


def _live_key_tiles(qt, tq, tk, causal, bq=64, bk=64):
    """The key tiles holding at least one live column of a row of q tile
    ``qt`` (end-aligned causal), counted from the mask."""
    rows = range(qt * bq, min(tq, qt * bq + bq))
    cols = [c for c in range(tk)
            if any(not causal or c <= r + tk - tq for r in rows)]
    return {c // bk for c in cols}


# the 8B serving shape, ragged and odd tile counts, Tq > Tk (tiles with
# no live row) and Tq < Tk
@pytest.mark.parametrize("tq,tk", [(512, 512), (100, 300), (77, 333),
                                   (130, 45), (33, 130), (1, 1),
                                   (257, 300), (1024, 1024), (200, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_f32_schedule_covers_every_live_tile_once(tq, tk, causal):
    plan = FA.flash_f32_plan(128, causal)
    blocks = _f32_schedule(tq, tk, causal, plan)
    n_q = -(-tq // 64)
    # the grid the kernel launches: pairs when causal
    assert len(blocks) == ((n_q + 1) // 2 if causal else n_q)
    walked = [t for b in blocks for t in b]
    assert sorted(t for t, _ in walked) == list(range(n_q))
    for qt, n_k in walked:
        # key tiles 0 .. n_k - 1, exactly the ones with a live column
        assert set(range(n_k)) == _live_key_tiles(qt, tq, tk, causal)
    if causal and tq == tk:
        # every pair walks n_q + 1 key tiles; where n_q is odd, the middle
        # tile stands alone and walks (n_q + 1) / 2
        for b in blocks:
            assert sum(n for _, n in b) == (n_q + 1 if len(b) == 2
                                            else (n_q + 1) // 2)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_flash_bwd_f32_plan_at_every_head_dim(d):
    p = FA.flash_bwd_f32_plan(d, causal=True)
    assert (p.block_q, p.block_k, p.threads, p.stages) == (64, 64, 256, 2)
    tile = 64 * (d + 4) * 4          # a 64-row tile, rows of d + 4 floats
    stats = 2 * 64 * 4               # the tile's lse and delta
    buffers = 8 * 64 * 8 * 4         # each warp's 64 x 8 P/dS buffer
    # dK/dV: K and V, then a 2-slot ring of Q, dO, lse, delta; dQ: Q, dO,
    # lse, delta, then a 2-slot ring of K and V
    assert p.dkdv_smem == 2 * tile + 2 * (2 * tile + stats) + buffers
    assert p.dq_smem == 2 * tile + stats + 2 * 2 * tile + buffers
    assert max(p.dkdv_smem, p.dq_smem) <= MAX_SMEM
    assert p.pair == 1 and FA.flash_bwd_f32_plan(d).pair == 0


def test_flash_bwd_f32_plan_refuses_other_head_dims():
    with pytest.raises(ValueError, match="head_dim"):
        FA.flash_bwd_f32_plan(40)


def _bwd_f32_schedule(tq, tk, causal, plan):
    """The f32 backward kernels' division of the work, as they compute
    it (csrc/flash_attention_bwd.cu, f32::): for each block of each
    kernel's grid x axis, the ``(tile, tiles of the other side)`` it
    walks. dK/dV block x takes key tile x, then (paired) n-1-x, each
    over the q tiles from the first one a row of which sees the key
    tile; dQ block x takes q tile n-1-x, then (paired) x, each over the
    key tiles up to its last live column."""
    n_q, n_kt = -(-tq // plan.block_q), -(-tk // plan.block_k)
    off = tk - tq
    dkdv, dq = [], []
    for x in range((n_kt + 1) // 2 if plan.pair else n_kt):
        walk = []
        for kt in [x] + ([n_kt - 1 - x] if plan.pair and x != n_kt - 1 - x
                         else []):
            first = kt * plan.block_k - off if causal else 0
            qt0 = 0 if first <= 0 else first // plan.block_q
            walk.append((kt, list(range(qt0, n_q))))
        dkdv.append(walk)
    for x in range((n_q + 1) // 2 if plan.pair else n_q):
        walk = []
        for qt in [n_q - 1 - x] + ([x] if plan.pair and x != n_q - 1 - x
                                   else []):
            n_k = n_kt
            if causal:
                last = qt * plan.block_q + plan.block_q - 1 + off
                n_k = 0 if last < 0 else min(n_kt, last // plan.block_k + 1)
            walk.append((qt, list(range(n_k))))
        dq.append(walk)
    return dkdv, dq


def _live_q_tiles(kt, tq, tk, causal, bq=64, bk=64):
    """The q tiles holding at least one row that sees a key of key tile
    ``kt`` (end-aligned causal), counted from the mask."""
    keys = range(kt * bk, min(tk, kt * bk + bk))
    rows = [r for r in range(tq)
            if any(not causal or c <= r + tk - tq for c in keys)]
    return {r // bq for r in rows}


@pytest.mark.parametrize("tq,tk", [(512, 512), (100, 300), (77, 333),
                                   (130, 45), (33, 130), (1, 1),
                                   (257, 300), (1024, 1024), (200, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_f32_schedule_covers_every_live_tile_once(tq, tk, causal):
    plan = FA.flash_bwd_f32_plan(64, causal)
    dkdv, dq = _bwd_f32_schedule(tq, tk, causal, plan)
    n_q, n_kt = -(-tq // 64), -(-tk // 64)
    # dK/dV: every key tile once, over exactly the q tiles that see it
    walked = [t for blk in dkdv for t in blk]
    assert sorted(kt for kt, _ in walked) == list(range(n_kt))
    for kt, qts in walked:
        assert set(qts) == _live_q_tiles(kt, tq, tk, causal)
    # dQ: every q tile once, over exactly the key tiles it sees
    walked = [t for blk in dq for t in blk]
    assert sorted(qt for qt, _ in walked) == list(range(n_q))
    for qt, kts in walked:
        assert set(kts) == _live_key_tiles(qt, tq, tk, causal)
    if causal and tq == tk:
        # paired, every block walks n + 1 tiles of the other side; where n
        # is odd, the middle tile stands alone and walks (n + 1) / 2
        for sched, n in ((dkdv, n_kt), (dq, n_q)):
            for blk in sched:
                assert sum(len(t) for _, t in blk) == (
                    n + 1 if len(blk) == 2 else (n + 1) // 2)


# (m, k, n): the ResNet-50 head (bf16 and f32 x), bench_int8_matmul's,
# M = 1, the largest fused K, and a ragged tile in every dimension
FQMM_SHAPES = [(128, 2048, 1000), (512, 1024, 1024), (1, 2048, 1000),
               (1, 8192, 1000), (128, 8192, 1000), (130, 260, 17),
               (5, 33, 70), (64, 96, 64), (3, 1, 1)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m,k,n", FQMM_SHAPES)
def test_fqmm_plan_fits_and_covers_k(m, k, n, itemsize):
    from zoo_tpu_torch.ops.kernels import quant as Q
    p = Q.fqmm_plan(m, k, n, itemsize)
    # a portable cluster splits K into 64-deep chunks, each CTA >= 1
    assert p.ctas in (1, 2, 4, 8) and p.k_slice % 64 == 0
    assert p.ctas * p.k_slice >= k > (p.ctas - 1) * p.k_slice - 64 * p.ctas
    assert p.ctas == 1 or (p.ctas // 2) * 128 < -(-k // 64) * 64 * 2
    tiles = -(-m // 64) * -(-n // 128)
    assert p.blocks == tiles * p.ctas
    # grow the split only while the grid is under 128 CTAs
    assert p.ctas == 8 or p.blocks >= 128 or 2 * p.ctas > -(-k // 64)
    # a 5-slot ring of 64-deep x and w chunks, over which the int32 C
    # tile (rows of 132) goes at the end; the int8 x chunk; 3 x 64 f32
    assert p.stages == 5
    ring = 5 * (64 * 64 * itemsize + 64 * 128)
    assert p.smem == max(ring, 64 * 132 * 4) + 64 * 64 + 768 <= MAX_SMEM
    assert (k * itemsize) % max(p.x_vec, 1) == 0
    assert n % max(p.w_vec, 1) == 0


def test_fqmm_plan_at_the_head():
    from zoo_tpu_torch.ops.kernels import quant as Q
    # 2 x 8 output tiles split 8 ways: 128 CTAs of 256 columns of K;
    # 16-byte copies of x, 8-byte copies of 1000-byte w rows
    p = Q.fqmm_plan(128, 2048, 1000, 2)
    assert (p.ctas, p.k_slice, p.blocks, p.x_vec, p.w_vec) == \
        (8, 256, 128, 16, 8)
    assert Q.fqmm_plan(1, 2048, 1000, 2).blocks == 64


@pytest.mark.parametrize("align,x_vec,w_vec", [(16, 16, 8), (8, 8, 8),
                                               (4, 4, 4), (2, 0, 0),
                                               (1, 0, 0)])
def test_fqmm_plan_narrows_the_copies(align, x_vec, w_vec):
    from zoo_tpu_torch.ops.kernels import quant as Q
    p = Q.fqmm_plan(128, 2048, 1000, 4, align, align)
    assert (p.x_vec, p.w_vec) == (x_vec, w_vec)
    # bf16 rows of an odd length and odd-width w rows: element copies
    assert Q.fqmm_plan(4, 33, 17, 2).x_vec == 0
    assert Q.fqmm_plan(4, 33, 17, 2).w_vec == 0


def test_fqmm_plan_refuses_what_the_kernel_does_not_take():
    from zoo_tpu_torch.ops.kernels import quant as Q
    with pytest.raises(ValueError, match="empty"):
        Q.fqmm_plan(0, 64, 64)
    with pytest.raises(ValueError, match="bytes"):
        Q.fqmm_plan(4, 64, 64, 1)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_fqmm_wrapper_makes_one_entry_call(monkeypatch, x_dtype, out_dtype):
    from zoo_tpu_torch.ops.kernels import quant as Q
    fn = _Entry()
    monkeypatch.setattr(Q, "_entries", lambda: (None, None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    x = _meta(128, 2048, dtype=x_dtype)
    w = _meta(2048, 1000, dtype=torch.int8)
    ws = _meta(1000, dtype=torch.float32)
    before = Q.FQMM_LAUNCHES
    y = Q.fused_quantized_matmul(x, w, ws, out_dtype)
    # one entry call: the wrapper allocates only the output
    assert y.shape == (128, 1000) and y.dtype == out_dtype
    assert Q.FQMM_LAUNCHES == before + 1
    (args,) = fn.calls
    assert len(args) == 5 + 4 + 6 + 1 and args[-1] == 7
    assert args[0] == x.data_ptr() and args[4] == y.data_ptr()
    assert (args[1], args[5]) == (L.DTYPE_CODES[x_dtype],
                                  L.DTYPE_CODES[out_dtype])
    assert args[6:9] == (128, 2048, 1000)
    p = Q.fqmm_plan(128, 2048, 1000, x.element_size(), L.alignment(x),
                    L.alignment(w))
    assert args[9:15] == (p.ctas, p.k_slice, p.stages, p.x_vec, p.w_vec,
                          p.smem)


# (m, k, n): the ResNet-50 head, bench_int8_matmul's, VGG-16's fc6 at
# B=128 and at M = 1, a batch of 256 at fc6, the fused path's largest K
# and the two-pass path's first, ragged tiles in every dimension, K and N
# off every copy width, splits of 5 and 6 CTAs, a GEMM of more tiles than
# the card has SMs, and Dense layers on a flattened 224 x 224 x 3 image
# (K = 150528, past the 131071 up to which any int8 data's int32 sums
# are exact) and at a ragged K past it
QMM_SHAPES = [(128, 2048, 1000), (512, 1024, 1024), (128, 25088, 4096),
              (1, 25088, 4096), (256, 25088, 4096), (1, 2048, 1000),
              (4, 33, 17), (8, 8256, 40), (130, 260, 17), (5, 33, 70),
              (64, 96, 64), (65, 1000, 1003), (3, 1, 1), (128, 2560, 2560),
              (128, 2048, 2048), (2048, 4096, 4096), (8, 150528, 1000),
              (128, 150528, 4096), (4, 262147, 17)]


def _qmm_ok(tiles, chunks, ctas, clusters):
    """The constraints _qmm_split holds a K split to."""
    slice_ = -(-chunks // ctas)
    return ctas == 1 or (tiles * ctas <= clusters[0]
                         and tiles <= clusters[ctas - 1]
                         and (ctas - 1) * slice_ < chunks)


@pytest.mark.parametrize("m,k,n", QMM_SHAPES)
def test_qmm_plan_fits_and_covers_k(m, k, n):
    from zoo_tpu_torch.ops.kernels import quant as Q
    p = Q.qmm_plan(m, k, n, clusters=H100_CLUSTERS)
    assert p.bm == (128 if m > 64 else 64)
    chunks = -(-k // 128)
    tiles = -(-m // p.bm) * -(-n // 128)
    # 128-deep chunks split over 1 .. 8 CTAs, every CTA with one or more
    assert 1 <= p.ctas <= 8 and p.k_slice % 128 == 0
    assert p.ctas * p.k_slice >= k > (p.ctas - 1) * p.k_slice
    assert p.blocks == tiles * p.ctas
    # every cluster of the grid resident at once on an H100 SXM, and the
    # split the largest that keeps it so
    assert _qmm_ok(tiles, chunks, p.ctas, H100_CLUSTERS)
    assert not any(_qmm_ok(tiles, chunks, c, H100_CLUSTERS)
                   and tiles * c > p.blocks for c in range(1, 9))
    # the ring (x chunk + w chunk a slot), two turned w chunks, 1 KB to
    # align; the int32 C tile (rows of 132) fits over the ring
    assert p.stages == {64: 7, 128: 5}[p.bm]
    ring = p.stages * (p.bm * 128 + 128 * 128)
    assert p.smem == 1024 + ring + 2 * 128 * 128 <= MAX_SMEM
    assert p.bm * 132 * 4 <= ring
    assert k % max(p.x_vec, 1) == 0 and n % max(p.w_vec, 1) == 0


def test_qmm_plan_fills_the_card():
    from zoo_tpu_torch.ops.kernels import quant as Q
    # the head: 8 tiles split 8 ways, 256 columns of K a CTA
    p = Q.qmm_plan(128, 2048, 1000, clusters=H100_CLUSTERS)
    assert p[:3] == (128, 8, 256) and p.blocks == 64
    # fc6: one 128-row tile covers M, so w streams once; 32 tiles in
    # clusters of 3 (96 CTAs): 4 would leave 2 clusters to a second
    # wave, as an H100 runs 30 clusters of 4 at once
    p = Q.qmm_plan(128, 25088, 4096, clusters=H100_CLUSTERS)
    assert (p.bm, p.ctas, p.k_slice, p.blocks, p.x_vec, p.w_vec) == \
        (128, 3, 8448, 96, 16, 16)
    assert 32 > H100_CLUSTERS[3]
    # a card that runs 32 clusters of 4 gets 128 CTAs there
    more = (132, 66, 44, 33, 26, 22, 18, 16)
    assert Q.qmm_plan(128, 25088, 4096, clusters=more)[:2] == (128, 4)
    assert Q.qmm_plan(512, 1024, 1024, clusters=H100_CLUSTERS)[:2] == (128, 3)
    assert Q.qmm_plan(1, 25088, 4096, clusters=H100_CLUSTERS)[:2] == (64, 3)
    # 16 and 20 tiles: 8 or 6 would not all be resident
    assert Q.qmm_plan(128, 2048, 2048, clusters=H100_CLUSTERS)[:2] == (128, 6)
    assert Q.qmm_plan(128, 2560, 2560, clusters=H100_CLUSTERS)[:2] == (128, 5)


@pytest.mark.parametrize("align,x_vec,w_vec", [(16, 16, 8), (8, 8, 8),
                                               (4, 4, 4), (2, 0, 0),
                                               (1, 0, 0)])
def test_qmm_plan_narrows_the_copies(align, x_vec, w_vec):
    from zoo_tpu_torch.ops.kernels import quant as Q
    p = Q.qmm_plan(128, 2048, 1000, align, align, clusters=H100_CLUSTERS)
    assert (p.x_vec, p.w_vec) == (x_vec, w_vec)
    # odd K and N: byte copies; K of 8 bytes a row: 8-byte copies
    assert Q.qmm_plan(4, 33, 17, clusters=H100_CLUSTERS)[4:6] == (0, 0)
    assert Q.qmm_plan(4, 8, 12, clusters=H100_CLUSTERS)[4:6] == (8, 4)


def test_qmm_plan_refuses_what_the_kernel_does_not_take():
    from zoo_tpu_torch.ops.kernels import quant as Q
    with pytest.raises(ValueError, match="empty"):
        Q.qmm_plan(0, 64, 64, clusters=H100_CLUSTERS)
    with pytest.raises(ValueError, match="empty"):
        Q.qmm_plan(4, 64, 0, clusters=H100_CLUSTERS)
    # no K limit (the int32 sums wrap past their range, as the JAX
    # kernel's do): a Dense on a flattened 224 x 224 x 3 image plans
    p = Q.qmm_plan(128, 150528, 1000, clusters=H100_CLUSTERS)
    assert p.ctas * p.k_slice >= 150528 > (p.ctas - 1) * p.k_slice
    # the card's cluster counts are an argument, never a default
    with pytest.raises(TypeError):
        Q.qmm_plan(128, 2048, 1000)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(128, 2048, 1000), (128, 25088, 4096),
                                   (4, 33, 17)])
def test_qmm_wrapper_makes_one_entry_call(monkeypatch, out_dtype, m, k, n):
    from zoo_tpu_torch.ops.kernels import quant as Q
    fn = _Entry()
    monkeypatch.setattr(Q, "_entries", lambda: (None, fn, None))
    monkeypatch.setattr(Q, "cluster_limits", lambda dev: H100_CLUSTERS)
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    x = _meta(m, k, dtype=torch.int8)
    w = _meta(k, n, dtype=torch.int8)
    xs, ws = _meta(m, 1, dtype=torch.float32), _meta(1, n,
                                                      dtype=torch.float32)
    before = Q.QMM_LAUNCHES
    y = Q.quantized_matmul(x, w, xs, ws, out_dtype)
    # one entry call: the wrapper allocates only the output
    assert y.shape == (m, n) and y.dtype == out_dtype
    assert Q.QMM_LAUNCHES == before + 1
    (args,) = fn.calls
    assert len(args) == 5 + 4 + 5 + 1 and args[-1] == 7
    assert args[0] == x.data_ptr() and args[4] == y.data_ptr()
    assert args[5] == L.DTYPE_CODES[out_dtype]
    assert args[6:9] == (m, k, n)
    # the kernel derives its ring slots and shared memory from bm
    p = Q.qmm_plan(m, k, n, L.alignment(x), L.alignment(w),
                   clusters=H100_CLUSTERS)
    assert args[9:14] == (p.bm, p.ctas, p.k_slice, p.x_vec, p.w_vec)


def _turn_model(w):
    """csrc/quant_matmul.cu's qm::turn_w on a 128 x 128 int8 chunk ``w``
    (k rows, as it lies), thread by thread: the chunk as load_w places
    it (RawUnit), each thread's 16 4-byte reads, its transpose4 and its
    4 16-byte writes; returns the turned tile and, per warp, the banks of
    each read instruction and the (row, unit) of each quarter-warp's
    16-byte stores."""
    raw = np.zeros(128 * 128, np.uint8)
    for k in range(128):
        for u in range(8):
            dst = k * 128 + (u ^ ((k >> 4) & 7)) * 16
            raw[dst:dst + 16] = w[k, 16 * u:16 * u + 16]
    bt = np.full(128 * 128, 255, np.uint8)
    reads, writes = {}, {}
    for warp in range(8):
        for lane in range(32):
            kg, word = lane & 7, lane >> 3
            ng = 4 * warp + word
            v = np.zeros((4, 4, 4), np.uint8)     # [q][i] 4 bytes
            for q in range(4):
                for i in range(4):
                    k = 16 * kg + 4 * q + i
                    a = k * 128 + (warp ^ ((k >> 4) & 7)) * 16 + word * 4
                    v[q, i] = raw[a:a + 4]
                    reads.setdefault((warp, q, i), []).append(a // 4 % 32)
            for j in range(4):
                n = 4 * ng + j
                # transpose4: byte j of rows 4q .. 4q+3, lowest k first
                unit = np.concatenate([v[q, :, j] for q in range(4)])
                a = n * 128 + (kg ^ (n & 7)) * 16
                bt[a:a + 16] = unit
                writes.setdefault((warp, j, word), []).append(
                    (n, a // 16 % 8))
    return bt.reshape(128, 128), reads, writes


def test_qmm_turn_gives_the_k_major_tile_wgmma_reads():
    rs = np.random.RandomState(3)
    w = rs.randint(0, 256, (128, 128)).astype(np.uint8)
    bt, reads, writes = _turn_model(w)
    # row n holds column n of w over the chunk's 128 k, its 16-byte unit
    # j at j ^ (n % 8): the 128-byte swizzle of a K-major wgmma operand
    want = np.zeros((128, 128), np.uint8)
    for n in range(128):
        for j in range(8):
            p = j ^ (n & 7)
            want[n, 16 * p:16 * p + 16] = w[16 * j:16 * j + 16, n]
    assert np.array_equal(bt, want)
    # each read instruction of a warp touches 32 different banks; each
    # quarter-warp's 16-byte stores fill one row's 8 units
    assert all(sorted(b) == list(range(32)) for b in reads.values())
    for stores in writes.values():
        assert len({n for n, _ in stores}) == 1
        assert sorted(u for _, u in stores) == list(range(8))


def _round_quotient(v, s):
    """The fused int8 kernel's rounding (``near_tie`` in
    csrc/quant_matmul.cu) in f32 numpy: rint(v * (1 / s)) unless that
    product lies within 1e-4 of a tie or is not finite, else rint of
    the IEEE quotient."""
    with np.errstate(all="ignore"):
        t = v * (np.float32(1) / s)
        r = np.rint(t)
        return np.where(np.abs(t - r) < np.float32(0.4999), r, np.rint(v / s))


def test_fqmm_fast_rounding_equals_the_division():
    # rows' scales from absmax over 60 decades, values anywhere up to
    # the absmax, the absmax itself, exact ties (scale 1, k + 0.5) and
    # their neighbours one ulp away, zeros, subnormal scales
    rs = np.random.RandomState(9)
    n = 400_000
    amax = (10.0 ** rs.uniform(-30, 30, n)).astype(np.float32)
    scale = np.where(amax == 0, 1, amax / np.float32(127)).astype(np.float32)
    v = (amax * rs.uniform(-1, 1, n).astype(np.float32)).astype(np.float32)
    v[::7] = amax[::7]
    ties = (np.arange(-127, 127) + 0.5).astype(np.float32)
    v = np.concatenate([v, ties, np.nextafter(ties, np.float32(200)),
                        np.nextafter(ties, np.float32(-200)),
                        np.zeros(4, np.float32),
                        np.float32([1e-44, -3e-44, 5e-45, 1e-45])])
    s = np.concatenate([scale, np.ones(3 * len(ties) + 4, np.float32),
                        np.float32([1e-45, 3e-45, 1e-44, 1e-45])])
    want = np.rint(v / s)
    assert np.array_equal(_round_quotient(v, s), want)


class _Entry:
    """Stands in for a C entry: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_conv_wrapper_passes_the_plan(monkeypatch, dtype):
    fl = _Entry()
    monkeypatch.setattr(CV, "_entries", lambda: (None, fl, None))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    before = CV.LAUNCHES
    x, w = _meta(128, 7, 7, 512, dtype=dtype), _meta(3, 3, 512, 512,
                                                      dtype=dtype)
    y = CV._launch_conv2d(x, w, (1, 1), "SAME")
    assert y.shape == (128, 7, 7, 512) and CV.LAUNCHES == before + 1
    (args,) = fl.calls
    assert len(args) == 3 + 18 + 1 and args[-1] == 7
    assert args[3] == L.DTYPE_CODES[dtype]
    assert args[4:17] == (128, 7, 7, 512, 3, 3, 512, 1, 1, 1, 1, 7, 7)
    planner = CV.conv_plan if dtype == torch.bfloat16 else CV.conv_f32_plan
    p = planner(128 * 49, 512, 512)
    assert args[17:21] == (p.bn, p.stages, p.vec, p.smem)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wrapper_passes_the_plan(monkeypatch, dtype, causal):
    fn = _Entry()
    monkeypatch.setattr(FA, "_entry", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    q = _meta(2, 12, 100, 64, dtype=dtype)
    kv = _meta(2, 4, 100, 64, dtype=dtype)
    o, lse = FA.flash_attention_fwd(q, kv, kv, causal=causal)
    assert o.shape == q.shape and lse.dtype == torch.float32
    (args,) = fn.calls
    assert args[5:11] == (2, 12, 4, 100, 100, 64)
    assert args[12:14] == (int(causal), L.DTYPE_CODES[dtype])
    # the plan's bytes and pairing (the bf16 kernel takes no pairing)
    assert len(args) == 17 and args[16] == 7
    if dtype == torch.bfloat16:
        assert args[14:16] == (FA.flash_plan(64), 0)
    else:
        p = FA.flash_f32_plan(64, causal)
        assert args[14:16] == (p.smem, p.pair) == (p.smem, int(causal))


def test_flash_wrapper_copies_an_unaligned_input(monkeypatch):
    # the bf16 kernel copies 16 bytes at a time: a view two bytes off a
    # boundary reaches it as an aligned copy, aligned inputs as they are
    fn = _Entry()
    monkeypatch.setattr(FA, "_entry", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    q = _meta(1 + 2 * 12 * 100 * 64)[1:].view(2, 12, 100, 64)
    kv = _meta(2, 4, 100, 64)
    assert q.data_ptr() % 16 == 2
    FA.flash_attention_fwd(q, kv, kv, causal=True)
    (args,) = fn.calls
    assert args[0] % 16 == 0 and args[1:3] == (kv.data_ptr(),) * 2


def _bwd_inputs(dtype, q_off=0):
    q = _meta(q_off + 2 * 12 * 100 * 64, dtype=dtype)[q_off:].view(
        2, 12, 100, 64)
    kv = _meta(2, 4, 100, 64, dtype=dtype)
    lse = _meta(2, 12, 100, dtype=torch.float32)
    return q, kv, lse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_wrapper_passes_the_plan(monkeypatch, dtype):
    dkdv, dq = _Entry(), _Entry()
    monkeypatch.setattr(FA, "_bwd_entries", lambda: (None, dkdv, dq))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    q, kv, lse = _bwd_inputs(dtype)
    before = (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES)
    grads = FA.flash_attention_bwd(q, kv, kv, q, lse, q, causal=True)
    assert [g.shape for g in grads] == [q.shape, kv.shape, kv.shape]
    assert (FA.DKDV_LAUNCHES, FA.DQ_LAUNCHES) == (before[0] + 1,
                                                  before[1] + 1)
    (a,), (b,) = dkdv.calls, dq.calls
    # 8 (dK/dV) or 7 (dQ) pointers, the shapes, scale, causal, dtype,
    # the plan (step, stages, smem) and the stream
    assert len(a) == 8 + 6 + 1 + 2 + 3 + 1 and len(b) == len(a) - 1
    for args, n in ((a, 8), (b, 7)):
        assert args[n:n + 6] == (2, 12, 4, 100, 100, 64)
        assert args[n + 7:n + 9] == (1, L.DTYPE_CODES[dtype])
        assert args[-1] == 7
    if dtype == torch.bfloat16:
        p = FA.flash_bwd_plan(64)
        assert a[-4:-1] == (p.step, p.stages, p.dkdv_smem)
        assert b[-4:-1] == (p.step, p.stages, p.dq_smem)
    else:
        p = FA.flash_bwd_f32_plan(64, causal=True)
        assert a[-4:-1] == (64, 2, p.dkdv_smem)
        assert b[-4:-1] == (64, 2, p.dq_smem)


def test_flash_bwd_wrapper_copies_an_unaligned_input(monkeypatch):
    # the kernels copy 16 bytes at a time: a q and a dO off a boundary
    # (two bytes in bf16, four in f32) reach them as aligned copies,
    # aligned inputs as they are
    dkdv, dq = _Entry(), _Entry()
    monkeypatch.setattr(FA, "_bwd_entries", lambda: (None, dkdv, dq))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    q, kv, lse = _bwd_inputs(torch.bfloat16, q_off=1)
    do = _bwd_inputs(torch.bfloat16, q_off=1)[0]
    assert q.data_ptr() % 16 == 2 and do.data_ptr() % 16 == 2
    FA.flash_attention_bwd(q, kv, kv, q, lse, do, causal=True)
    for args in (dkdv.calls[0], dq.calls[0]):
        assert args[0] % 16 == 0 and args[3] % 16 == 0
        assert args[0] != q.data_ptr() and args[3] != do.data_ptr()
        assert args[1:3] == (kv.data_ptr(),) * 2
    # an aligned f32 input reaches the kernels as it is, an unaligned one
    # as an aligned copy
    q32, kv32, lse32 = _bwd_inputs(torch.float32)
    FA.flash_attention_bwd(q32, kv32, kv32, q32, lse32, q32, causal=True)
    assert dkdv.calls[1][0] == q32.data_ptr()
    u32 = _bwd_inputs(torch.float32, q_off=1)[0]
    assert u32.data_ptr() % 16 == 4
    FA.flash_attention_bwd(u32, kv32, kv32, u32, lse32, u32, causal=True)
    for args in (dkdv.calls[2], dq.calls[2]):
        assert args[0] % 16 == 0 and args[0] != u32.data_ptr()


# -- the int8 conv on the int8 tensor cores (csrc/conv2d_int8_tc.cuh) -----

def _check_int8(plan, rows, c, o):
    assert plan.smem <= MAX_SMEM
    assert plan.m_tiles * plan.bm >= rows > (plan.m_tiles - 1) * plan.bm
    assert plan.n_tiles * plan.bn >= o > (plan.n_tiles - 1) * plan.bn
    assert c % plan.copy_bytes == 0             # int8: a byte a channel
    assert plan.threads == 2 * plan.bm          # a warpgroup per 64 rows
    assert (plan.bk, plan.stages) in ((64, 6), (128, 3))
    assert plan.bk == 64 or (c % 128 == 0 and plan.vec == 16)
    assert plan.out_vec == (4 if o % 4 == 0 else 1)
    # the ring, or the int32 epilogue tile, the row origins and the
    # slack that aligns the ring to 1024 bytes
    ring = plan.stages * (plan.bm + plan.bn) * plan.bk
    assert plan.smem == 1024 + max(ring, plan.bm * (plan.bn + 8) * 4) \
        + 16 * plan.bm
    # two blocks share an SM (233,472 bytes of shared memory an SM)
    assert 2 * plan.smem <= 233_472


def test_every_resnet50_conv_gets_an_int8_plan(resnet50_convs):
    steps = set()
    for h, c, k, o, s in resnet50_convs:
        oh = -(-h // s)
        rows = B * oh * oh
        plan = CV.conv_int8_plan(rows, c, o)
        _check_int8(plan, rows, c, o)
        assert plan.vec == 16 and plan.out_vec == 4, (h, c, k, o, s)
        assert plan.bk == (128 if c % 128 == 0 else 64)
        assert plan.n_tiles == 1 or o > 64
        steps.add(plan.bk)
    # C = 64 convs take 64-channel steps, the rest 128
    assert steps == {64, 128}


@pytest.mark.parametrize("n,h,w,c,k,o,s,padding", RAGGED + [
    (1, 5, 7, 64, 1, 64, 1, "SAME"), (2, 6, 6, 64, 3, 200, 1, "SAME"),
    (2, 7, 7, 24, 3, 30, 1, "SAME"), (2, 5, 5, 20, 1, 13, 1, "SAME")])
def test_ragged_int8_convs_get_narrower_copies(n, h, w, c, k, o, s,
                                               padding):
    _, _, oh, ow = CV._spatial_pads(h, w, k, k, (s, s), padding)
    rows = n * oh * ow
    plan = CV.conv_int8_plan(rows, c, o)
    _check_int8(plan, rows, c, o)
    assert plan.vec == next(v for v in (16, 8, 4, 2, 1) if c % v == 0)
    assert plan.vec < 16 or c % 16 == 0
    assert plan.bn == (64 if o <= 64 else 128)


@pytest.mark.parametrize("align,vec", [(16, 16), (8, 8), (4, 4), (2, 2),
                                       (1, 1)])
def test_int8_plan_narrows_the_copy_to_the_pointers(align, vec):
    plan = CV.conv_int8_plan(1000, 256, 64, align=align)
    assert plan.vec == vec
    assert plan.bk == (128 if vec == 16 else 64)
    assert CV.conv_int8_plan(1000, 256, 64, out_align=4).out_vec == 1


def test_int8_plan_refuses_an_empty_conv():
    with pytest.raises(ValueError, match="empty"):
        CV.conv_int8_plan(10, 0, 64)


def test_int8_plan_fills_the_card_at_7x7():
    # 6,272 rows x 512: 196 tiles of 128 x 128, 128-channel steps, two
    # blocks to an SM: resident at once on 132 SMs
    plan = CV.conv_int8_plan(B * 7 * 7, 512, 512)
    assert (plan.bm, plan.bn, plan.bk, plan.blocks) == (128, 128, 128, 196)
    assert plan.blocks <= 2 * NUM_SMS


@pytest.mark.parametrize("k,c,o", [(1, 64, 256), (3, 64, 64),
                                   (3, 11, 17)])
def test_kmajor_copy_is_the_transposed_weights(k, c, o):
    g = torch.Generator().manual_seed(k * 100 + c)
    w = torch.randint(-127, 128, (k, k, c, o), generator=g,
                      dtype=torch.int8)
    wk = CV.int8_weights_kmajor(w)
    assert wk.shape == (o, k * k * c) and wk.is_contiguous()
    assert torch.equal(wk, w.permute(3, 0, 1, 2).reshape(o, -1))
    # row o, column tap * C + c is w[dy, dx, c, o]
    assert int(wk[o - 1, (k * k - 1) * c + c - 1]) == int(w[k - 1, k - 1,
                                                           c - 1, o - 1])


def test_attached_kmajor_copy_follows_its_weight():
    w = torch.randint(-127, 128, (3, 3, 8, 16), dtype=torch.int8)
    assert CV.kmajor_of(w) is None
    wk = CV.attach_kmajor(w)
    # made once: found again for the weight and for views of its storage
    assert CV.attach_kmajor(w) is wk
    assert CV.kmajor_of(w.detach()) is wk and CV.kmajor_of(w.to("cpu")) is wk
    assert torch.equal(wk, CV.int8_weights_kmajor(w))
    # another tensor with the same values is not the same weight
    assert CV.kmajor_of(w.clone()) is None
    # a weight written in place no longer matches its copy
    w.add_(1)
    assert CV.kmajor_of(w) is None
    fresh = CV.attach_kmajor(w)
    assert torch.equal(fresh, CV.int8_weights_kmajor(w))
    # a weight that dies takes its copy along
    n = len(CV._KMAJOR)
    del w
    assert len(CV._KMAJOR) == n - 1


def test_quantize_model_attaches_the_kmajor_copies():
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.api.keras.layers import Convolution2D
    from zoo_tpu_torch.pipeline.inference import quantize_model
    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    m.build(torch.Generator().manual_seed(0), device="cpu")
    quantize_model(m, mode="force")
    inside = 0
    for layer in m.layers:
        if not isinstance(layer, Convolution2D):
            continue
        w_q = m.params[m._key_of(layer)]["W_q"]
        wk = CV.kmajor_of(w_q)
        if CV.pallas_conv_supported(layer.kernel, layer.subsample):
            inside += 1
            assert torch.equal(wk, CV.int8_weights_kmajor(w_q))
        else:   # the reference conv takes the HWIO weights
            assert wk is None
    assert inside > 0


def test_carried_int8_conv_leaves_get_the_kmajor_copy():
    import numpy as np
    from zoo_tpu_torch.convert import keras_params_from_jax
    rs = np.random.RandomState(0)
    tree = {"001_convolution2d": {
                "W_q": rs.randint(-127, 128, (3, 3, 4, 6)).astype(np.int8),
                "W_scale": rs.rand(6).astype(np.float32)},
            "002_dense": {
                "W_q": rs.randint(-127, 128, (6, 5)).astype(np.int8),
                "W_scale": rs.rand(5).astype(np.float32)}}
    got = keras_params_from_jax(tree, "cpu")
    w_q = got["001_convolution2d"]["W_q"]
    assert torch.equal(CV.kmajor_of(w_q), CV.int8_weights_kmajor(w_q))
    assert CV.kmajor_of(got["002_dense"]["W_q"]) is None
    assert set(got["001_convolution2d"]) == {"W_q", "W_scale"}


@pytest.mark.parametrize("passed", [True, False])
def test_int8_conv_wrapper_passes_the_plan(monkeypatch, passed):
    q = _Entry()
    monkeypatch.setattr(CV, "_entries", lambda: (None, None, q))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    before = CV.INT8_LAUNCHES
    x = _meta(128, 7, 7, 512, dtype=torch.int8)
    w = _meta(3, 3, 512, 512, dtype=torch.int8)
    xs, ws = _meta(128, dtype=torch.float32), _meta(512, dtype=torch.float32)
    wk = _meta(512, 9 * 512, dtype=torch.int8)
    y = CV.implicit_gemm_conv2d_int8(x, w, xs, ws, (1, 1), "SAME",
                                     w_kmajor=wk if passed else None)
    assert y.shape == (128, 7, 7, 512) and y.dtype == torch.float32
    assert CV.INT8_LAUNCHES == before + 1
    (args,) = q.calls
    assert len(args) == 5 + 13 + 6 + 1 and args[-1] == 7
    if passed:   # the kernel reads the K-major copy it was given
        assert args[1] == wk.data_ptr()
    assert args[5:18] == (128, 7, 7, 512, 3, 3, 512, 1, 1, 1, 1, 7, 7)
    p = CV.conv_int8_plan(128 * 49, 512, 512)
    assert args[18:24] == (p.bn, p.bk, p.stages, p.vec, p.out_vec, p.smem)


def test_int8_conv_wrapper_refuses_a_wrong_kmajor_copy(monkeypatch):
    monkeypatch.setattr(CV, "_entries", lambda: (None, None, _Entry()))
    x = _meta(2, 7, 7, 64, dtype=torch.int8)
    w = _meta(3, 3, 64, 32, dtype=torch.int8)
    s = _meta(2, dtype=torch.float32)
    with pytest.raises(ValueError, match="w_kmajor"):
        CV.implicit_gemm_conv2d_int8(x, w, s, _meta(32, dtype=torch.float32),
                                     w_kmajor=_meta(32, 64,
                                                    dtype=torch.int8))


# -- the paged-prefill kernel (csrc/paged_prefill.cu) ---------------------

from zoo_tpu_torch.ops.kernels import paged_prefill as PP  # noqa: E402

# the serving shape: one sequence, a 64-row chunk, 32 query heads over 8
# kv heads, D = 128, a 32-block table of 16 rows
SERVE = dict(S=1, C=64, n_kv=8, G=4, D=128, block_size=16, W=32)


@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_prefill_plan_fills_the_card_at_the_serving_shape(itemsize):
    plan = PP.prefill_plan(**SERVE, cache_itemsize=itemsize)
    assert plan.blocks >= NUM_SMS
    # 256 rows of a kv head in 4 tiles of 64, the key axis split 8 ways
    assert plan.row_tiles == 4 and plan.splits == 8
    assert plan.blocks == 1 * 8 * plan.row_tiles * plan.splits == 256
    assert 2 * plan.smem <= 233_472          # two blocks an SM


@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("itemsize", [4, 2, 1])
def test_prefill_plan_within_the_block_limit(d, itemsize):
    plan = PP.prefill_plan(1, 64, 8, 4, d, 16, 32, itemsize)
    row = d * itemsize + 16
    # the f32 q and p tiles (64 rows), two K and V tiles of 32 rows and,
    # for int8, their scales
    want = 4 * 64 * (d + 4) + 4 * 64 * 36 + 2 * 2 * 32 * row + \
        (2 * 2 * 32 * 4 if itemsize == 1 else 0)
    assert plan.smem == want <= MAX_SMEM
    assert 2 * plan.smem <= 233_472
    assert (plan.row_tile, plan.key_tile) == (64, 32)


def test_prefill_plan_splits_only_where_rows_are_too_few():
    # 9 sequences x 8 kv heads x 4 row tiles: 288 blocks, two an SM,
    # no split; 8 sequences: 256 blocks, split in 2
    assert PP.prefill_plan(9, 64, 8, 4, 128, 16, 32, 4).splits == 1
    assert PP.prefill_plan(8, 64, 8, 4, 128, 16, 32, 4).splits == 2
    # a one-row chunk: as many splits as allowed, but no more than the
    # table has key tiles
    assert PP.prefill_plan(1, 1, 8, 4, 128, 16, 32, 4).splits == 8
    assert PP.prefill_plan(1, 1, 8, 4, 128, 16, 2, 4).splits == 1
    # 3 x 8 x 2 = 48 blocks: 6 splits reach 264
    assert PP.prefill_plan(3, 17, 8, 4, 128, 16, 32, 4).splits == 6


def test_prefill_plan_refuses_other_head_dims():
    for d in (130, 62, 0):
        with pytest.raises(ValueError, match="head_dim"):
            PP.prefill_plan(1, 4, 2, 2, d, 16, 4, 4)


@pytest.mark.parametrize("s,c,cache_dtype", [
    (1, 64, torch.float32), (8, 64, torch.bfloat16), (3, 5, torch.int8)])
def test_prefill_wrapper_passes_the_plan(monkeypatch, s, c, cache_dtype):
    fn = _Entry()
    monkeypatch.setattr(PP, "_entry", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    H, n_kv, D, bs, W, nb = 32, 8, 128, 16, 32, 40
    q = _meta(s, c, H, D, dtype=torch.float32)
    kc = _meta(nb, bs, n_kv, D, dtype=cache_dtype)
    sc = _meta(nb, bs, n_kv, dtype=torch.float32) \
        if cache_dtype == torch.int8 else None
    tables = _meta(s, W, dtype=torch.int32)
    pos = _meta(s, c, dtype=torch.int32)
    before = PP.LAUNCHES
    out = PP.paged_flash_prefill(q, kc, kc, tables, pos, k_scale=sc,
                                 v_scale=sc)
    assert out.shape == q.shape and PP.LAUNCHES == before + 1
    (args,) = fn.calls
    assert len(args) == 10 + 7 + 1 + 6 + 1 and args[-1] == 7
    assert args[10:17] == (s, c, n_kv, H // n_kv, D, bs, W)
    assert args[18:20] == (0, L.DTYPE_CODES[cache_dtype])
    plan = PP.prefill_plan(s, c, n_kv, H // n_kv, D, bs, W,
                           kc.element_size())
    assert args[20:24] == (plan.row_tile, plan.key_tile, plan.splits,
                           plan.smem)
    # split partials only where the key axis is split
    assert (args[8] is None) == (plan.splits == 1)
    assert (args[9] is None) == (plan.splits == 1)


# -- the paged-decode kernel (csrc/paged_decode.cu) -----------------------

from zoo_tpu_torch.ops.kernels import fused_block as FB  # noqa: E402
from zoo_tpu_torch.ops.kernels import paged_decode as PD  # noqa: E402

def _decode_smem(plan, G, D, itemsize):
    """The kernel's layout: the warps' rings of 16-byte rows (and int8
    scales), overwritten by the partials, then the p buffers."""
    row = -(-D * itemsize // 16) * 16
    slot = 2 * plan.chunk_rows * row + (8 * plan.chunk_rows
                                        if itemsize == 1 else 0)
    slot = -(-slot // 16) * 16
    ring = plan.warps * plan.stages * slot
    partials = (plan.warps * G * (D + 2) + 2 * G) * 4
    heads = 4 if G <= 4 else 16
    return -(-max(ring, partials) // 16) * 16 + \
        plan.warps * plan.chunk_rows * heads * 4


# (S, n_kv, G, D, block_size, W): chip_smoke.py phase 3's shape, which is
# also the 8B engine's tick (8 slots, 32 query heads over 8 kv heads, a
# 32-entry table of 16-row blocks), G = 16 with 32-row blocks, and MQA
@pytest.mark.parametrize("itemsize", [4, 2, 1])
@pytest.mark.parametrize("shape", [(8, 8, 4, 128, 16, 32),
                                   (8, 8, 16, 128, 32, 16),
                                   (5, 2, 1, 64, 8, 8)])
def test_decode_plan_fits_and_clusters(shape, itemsize):
    S, n_kv, G, D, bs, W = shape
    for splits in range(1, W + 1):
        plan = PD.decode_plan(S, n_kv, G, D, bs, W, itemsize,
                              PD.resolve_num_splits(W, splits))
        # every knob value maps onto a portable cluster of at most 8 CTAs
        assert 1 <= plan.ctas <= 8
        assert plan.ctas == min(PD.resolve_num_splits(W, splits), 8)
        assert plan.blocks == S * n_kv * plan.ctas
        assert plan.stages >= 2 and plan.warps == 4
        assert plan.smem == _decode_smem(plan, G, D, itemsize) <= MAX_SMEM
        # a chunk is at most 4 KB of K and of V, within one cache block
        assert 1 <= plan.chunk_rows <= bs
        assert plan.chunk_rows * D * itemsize <= 4096 or plan.chunk_rows == 1
        assert plan.copy_bytes in (16, 8, 4, 0)


def test_decode_plan_at_the_serving_shape():
    # f32 rows of 512 bytes: 8-row chunks, 16-byte copies, three CTAs an
    # SM (233,472 bytes of shared memory an SM); 4 CTAs per (slot, kv
    # head) by default, 256 CTAs for the 132 SMs
    plan = PD.decode_plan(8, 8, 4, 128, 16, 32, 4, 4)
    assert (plan.ctas, plan.chunk_rows, plan.copy_bytes) == (4, 8, 16)
    assert plan.blocks == 256 and 3 * plan.smem <= 233_472
    # bf16 and int8 rows: a chunk is the whole 16-row block
    assert PD.decode_plan(8, 8, 4, 128, 16, 32, 2, 4).chunk_rows == 16
    assert PD.decode_plan(8, 8, 4, 128, 16, 32, 1, 4).chunk_rows == 16


@pytest.mark.parametrize("d,itemsize,align,want", [
    (128, 4, 16, 16), (128, 1, 8, 8), (6, 2, 16, 4), (6, 1, 16, 0),
    (2, 4, 16, 8), (3, 1, 16, 0)])
def test_decode_plan_narrows_the_copy(d, itemsize, align, want):
    assert PD.decode_plan(1, 1, 1, d, 4, 2, itemsize, 1,
                          align).copy_bytes == want


def test_decode_plan_refuses_outside_the_envelope():
    for bs, d, g in ((33, 64, 4), (16, 130, 4), (16, 64, 17)):
        with pytest.raises(ValueError, match="paged decode kernel"):
            PD.decode_plan(2, 2, g, d, bs, 4, 4, 1)


@pytest.mark.parametrize("cache_dtype,splits", [
    (torch.float32, None), (torch.bfloat16, 3), (torch.int8, 12)])
def test_decode_wrapper_makes_one_entry_call(monkeypatch, cache_dtype,
                                             splits):
    fn = _Entry()
    monkeypatch.setattr(PD, "_entry", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    S, H, n_kv, D, bs, W, nb = 8, 32, 8, 128, 16, 32, 40
    q = _meta(S, H, D, dtype=torch.float32)
    kc = _meta(nb, bs, n_kv, D, dtype=cache_dtype)
    sc = _meta(nb, bs, n_kv, dtype=torch.float32) \
        if cache_dtype == torch.int8 else None
    before = PD.LAUNCHES
    out = PD.paged_flash_decode(q, kc, kc, _meta(S, W, dtype=torch.int32),
                                _meta(S, dtype=torch.int32), k_scale=sc,
                                v_scale=sc, num_splits=splits)
    # one entry call, one launch: the split merge runs in the kernel and
    # the wrapper allocates only the output
    assert out.shape == q.shape and out.dtype == q.dtype
    assert PD.LAUNCHES == before + 1
    (args,) = fn.calls
    assert len(args) == 8 + 6 + 1 + 2 + 6 + 1 and args[-1] == 7
    assert args[7] == out.data_ptr()
    assert args[8:14] == (S, n_kv, H // n_kv, D, bs, W)
    assert args[15:17] == (0, L.DTYPE_CODES[cache_dtype])
    plan = PD.decode_plan(S, n_kv, H // n_kv, D, bs, W, kc.element_size(),
                          PD.resolve_num_splits(W, splits))
    assert args[17:23] == (plan.ctas, plan.warps, plan.stages,
                           plan.chunk_rows, plan.copy_bytes, plan.smem)


def _kernel_partials(q, kc, vc, bt, pos, plan, bs, scale):
    """The kernel's division of the work, in plain PyTorch: the slot's
    live rows cut into chunks of ``plan.chunk_rows`` rows of one block,
    equal runs of chunks for the cluster's CTAs, every ``warps``-th chunk
    of a run for a warp, each warp's online softmax as a partial
    (acc, m, l) in (CTA, warp) order."""
    S, H, D = q.shape
    n_kv = kc.shape[2]
    G, W = H // n_kv, bt.shape[1]
    cpb = -(-bs // plan.chunk_rows)
    parts = plan.ctas * plan.warps
    acc = torch.zeros(S, n_kv, parts, G, D, dtype=torch.float64)
    m = torch.full((S, n_kv, parts, G), -math.inf, dtype=torch.float64)
    l = torch.zeros(S, n_kv, parts, G, dtype=torch.float64)
    for s in range(S):
        p = int(pos[s])
        last = min(p, W * bs - 1)
        n_units = (last // bs) * cpb + (last % bs) // plan.chunk_rows + 1
        for c in range(plan.ctas):
            u0, u1 = c * n_units // plan.ctas, (c + 1) * n_units // plan.ctas
            for u in range(u0, u1):
                w = (u - u0) % plan.warps
                j, row0 = u // cpb, (u % cpb) * plan.chunk_rows
                rows = range(row0, min(row0 + plan.chunk_rows, bs))
                rows = [r for r in rows if j * bs + r <= p]
                blk = int(bt[s, j])
                for h in range(n_kv):
                    k = kc[blk, rows, h].double()
                    v = vc[blk, rows, h].double()
                    qs = q[s, h * G:(h + 1) * G].double()
                    sc = qs @ k.T * scale                       # (G, rows)
                    pi = c * plan.warps + w
                    m_new = torch.maximum(m[s, h, pi], sc.amax(-1))
                    corr = torch.exp(m[s, h, pi] - m_new)
                    pe = torch.exp(sc - m_new[:, None])
                    l[s, h, pi] = corr * l[s, h, pi] + pe.sum(-1)
                    acc[s, h, pi] = corr[:, None] * acc[s, h, pi] + pe @ v
                    m[s, h, pi] = m_new
    return acc, m, l


@pytest.mark.parametrize("splits", [1, 3, 4, 8])
def test_merged_partials_equal_the_plain_version(splits):
    """merge_splits, the plain model of the kernel's in-cluster merge, over
    partials divided as the kernel divides the live rows (dead warps and
    CTAs included), equals paged_decode_plain."""
    g = torch.Generator().manual_seed(splits)
    S, H, n_kv, D, bs, W, nb = 5, 8, 2, 16, 8, 8, 20
    q = torch.randn(S, H, D, generator=g)
    kc = torch.randn(nb, bs, n_kv, D, generator=g)
    vc = torch.randn(nb, bs, n_kv, D, generator=g)
    bt = torch.randint(1, nb, (S, W), generator=g, dtype=torch.int32)
    pos = torch.tensor([0, 7, 8, W * bs - 1, 21], dtype=torch.int32)
    scale = 1.0 / math.sqrt(D)
    plan = PD.decode_plan(S, n_kv, H // n_kv, D, bs, W, 4,
                          PD.resolve_num_splits(W, splits))
    acc, m, l = _kernel_partials(q, kc, vc, bt, pos, plan, bs, scale)
    assert bool((m == -math.inf).any())          # some partials are dead
    got = PD.merge_splits(acc, m, l).reshape(S, H, D)
    want = PD.paged_decode_plain(q, kc, vc, bt, pos, scale=scale)
    assert float((got - want.double()).abs().max()) <= 1e-6


# -- the fused bottleneck (csrc/fused_block.cu) ---------------------------

RESNET50_BLOCKS = [(56, 56, 256, 64), (28, 28, 512, 128),
                   (14, 14, 1024, 256), (7, 7, 2048, 512)]
# the ragged cases of tests/test_torch_gpu.py's fused bottleneck test
RAGGED_BLOCKS = [(12, 10, 48, 12), (9, 9, 40, 24), (30, 30, 64, 64)]


def _block_smem(plan, h, w, cin):
    """The kernel's layout: the ring of the largest item (a band of x
    rows and a w1 slice, or a w2 / w3 slice), t1 on the halo or the
    expand's staging tile, t2 in 32-row steps or the reduce's near-tie
    fix-up state before it (a count, the halo rows' norms, 256 ties),
    the pixel tables."""
    th, tw, cp = plan.th, plan.tw, plan.cmid
    p, p1 = th * tw, (th + 2) * (tw + 2)
    kb = min(64, cp)
    stage, items = 0, 0
    for ph, (m, n, k) in enumerate(((p1, cp, -(-cin // 64)),
                                    (p, cp, 9 * cp // kb),
                                    (p, cin, cp // kb))):
        band, chunk = 32 * (8 // plan.wn[ph]), 64 * plan.wn[ph]
        stage = max(stage, band * 128 + 64 * chunk * 2 if ph == 0
                    else kb * chunk * 2)
        items += -(-m // band) * -(-n // chunk) * k
    staging = 32 * (8 // plan.wn[2]) * (64 * plan.wn[2] * 2 + 16)
    t1 = p1 * cp * 2
    t2 = max(-(-p // 32) * 32 * cp * 2, 16 + -(-4 * p1 // 16) * 16 + 1024)
    tables = -(-4 * (p1 + 2 * p) // 16) * 16
    return plan.stages * stage + max(t1, staging) + t2 + tables, items


@pytest.mark.parametrize("h,w,cin,cmid", RESNET50_BLOCKS + RAGGED_BLOCKS)
def test_block_plan_fits_and_covers_the_image(h, w, cin, cmid):
    assert FB.fused_bottleneck_supported(h, w, cin, cmid)
    plan = FB.plan(h, w, cin, cmid)
    smem, items = _block_smem(plan, h, w, cin)
    assert (plan.smem, plan.items) == (smem, items)
    assert plan.smem <= MAX_SMEM and plan.stages in (2, 3)
    assert plan.warps == 8 and all(n in (1, 2, 4, 8) for n in plan.wn)
    # the tiles cover the image, none wholly outside it
    ty, tx = -(-h // plan.th), -(-w // plan.tw)
    assert plan.tiles == ty * tx
    assert (ty - 1) * plan.th < h <= ty * plan.th
    assert (tx - 1) * plan.tw < w <= tx * plan.tw
    # Cmid padded to 16, 32 or a multiple of 64 (2, 4 or 8k swizzled
    # 16-byte units a t1 / t2 row)
    assert plan.cmid >= cmid and (plan.cmid in (16, 32)
                                  or plan.cmid % 64 == 0)


def test_block_plan_takes_large_tiles_at_resnet50():
    # the halo recompute falls from 1.56x (8x8) to 1.31x (14x14) at
    # conv2_x and conv3_x; conv4_x takes 7x14, conv5_x the whole image
    tiles = [(FB.plan(*g).th, FB.plan(*g).tw) for g in RESNET50_BLOCKS]
    assert tiles == [(14, 14), (14, 14), (7, 14), (7, 7)]
    # one block an SM at most: 8 warps and over 116 KB each
    assert all(FB.plan(*g).smem > 233_472 // 2 for g in RESNET50_BLOCKS)


@pytest.mark.parametrize("x_dtype", [torch.bfloat16, torch.float32])
def test_block_wrapper_passes_the_plan(monkeypatch, x_dtype):
    fn = _Entry()
    monkeypatch.setattr(FB, "_entries", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    x = _meta(4, 9, 9, 40, dtype=x_dtype)
    ws = (_meta(40, 24, dtype=torch.float32),
          _meta(3, 3, 24, 24, dtype=torch.float32),
          _meta(24, 40, dtype=torch.float32))
    before = FB.LAUNCHES
    y = FB._launch(x, *ws)
    assert y.shape == x.shape and y.dtype == x_dtype
    assert FB.LAUNCHES == before + 1
    (args,) = fn.calls
    # x, w1, w2, w3, w1 transposed, its column norms, y; then the shapes
    # and the plan; the stream
    assert len(args) == 7 + 13 + 1 and args[-1] == 7
    assert args[6] == y.data_ptr() and args[7] == L.DTYPE_CODES[x_dtype]
    p = FB.plan(9, 9, 40, 24)
    # Cmid 24 reaches the kernel padded to 32
    assert args[8:20] == (4, 9, 9, 40, 32, p.th, p.tw, *p.wn, p.stages,
                          p.smem)


def test_block_weights_are_padded_with_zeros():
    g = torch.Generator().manual_seed(3)
    w1, w2, w3 = (torch.randn(s, generator=g)
                  for s in ((40, 24), (3, 3, 24, 24), (24, 40)))
    p1, p2, p3, p1t, norms = FB._kernel_weights(w1, w2, w3, 32)
    assert p1.shape == (40, 32) and p2.shape == (3, 3, 32, 32)
    assert p3.shape == (32, 40)
    assert all(t.dtype == torch.bfloat16 and t.is_contiguous()
               for t in (p1, p2, p3, p1t))
    # the reduce's fix-up reads w1 by columns, with their f32 norms
    assert p1t.shape == (32, 40) and torch.equal(p1t, p1.t())
    assert norms.dtype == torch.float32 and norms.shape == (32,)
    torch.testing.assert_close(norms, p1.float().norm(dim=0))
    assert torch.equal(p1[:, :24], w1.to(torch.bfloat16))
    assert torch.equal(p2[:, :, :24, :24], w2.to(torch.bfloat16))
    assert torch.equal(p3[:24], w3.to(torch.bfloat16))
    assert not p1[:, 24:].any() and not p3[24:].any()
    assert not p2[:, :, 24:].any() and not p2[:, :, :, 24:].any()
