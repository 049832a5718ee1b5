"""Launch plans of the port's tensor-core kernels, on the CPU.

``conv_plan`` (the bf16 conv kernel, ``csrc/conv2d_tc.cuh``),
``flash_plan`` (the bf16 flash forward, ``csrc/flash_attention_fwd.cu``)
and ``flash_bwd_plan`` (the bf16 flash backward,
``csrc/flash_attention_bwd.cu``) are counted in Python only; the C entries take them as given and check
the shared memory only against a block's limit. These tests hold the
plans to the kernels' layouts, to what a Hopper
block can have and to the shapes the main paths give them: every
in-envelope conv of the port's own ResNet-50 (as ``chip_smoke.py``
enumerates them) at B=128, the ragged shapes of the card tests, and
every head dim. The wrappers are driven with a stand-in C entry, so the
order in which they pass the plan is checked too.
"""

import pytest
import torch

from zoo_tpu_torch.ops.kernels import _launch as L
from zoo_tpu_torch.ops.kernels import conv as CV
from zoo_tpu_torch.ops.kernels import flash_attention as FA

MAX_SMEM = 232_448            # dynamic shared memory of one H100 block
NUM_SMS = 132                 # H100 SXM
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
    p = CV.conv_plan(128 * 49, 512, 512)
    want = (p.bn, p.stages, p.vec, p.smem) \
        if dtype == torch.bfloat16 else (0,) * 4
    assert args[17:21] == want


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_wrapper_passes_the_plan(monkeypatch, dtype):
    fn = _Entry()
    monkeypatch.setattr(FA, "_entry", lambda: (None, fn))
    monkeypatch.setattr(L, "stream", lambda dev: 7)
    q = _meta(2, 12, 100, 64, dtype=dtype)
    kv = _meta(2, 4, 100, 64, dtype=dtype)
    o, lse = FA.flash_attention_fwd(q, kv, kv, causal=True)
    assert o.shape == q.shape and lse.dtype == torch.float32
    (args,) = fn.calls
    assert args[5:11] == (2, 12, 4, 100, 100, 64)
    assert args[12:14] == (1, L.DTYPE_CODES[dtype])
    assert len(args) == 16 and args[15] == 7
    assert args[14] == (FA.flash_plan(64) if dtype == torch.bfloat16
                        else 0)



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
    # the plan and the stream
    assert len(a) == 8 + 6 + 1 + 2 + 3 + 1 and len(b) == len(a) - 1
    for args, n in ((a, 8), (b, 7)):
        assert args[n:n + 6] == (2, 12, 4, 100, 100, 64)
        assert args[n + 7:n + 9] == (1, L.DTYPE_CODES[dtype])
        assert args[-1] == 7
    p = FA.flash_bwd_plan(64)
    bf16 = dtype == torch.bfloat16
    assert a[-4:-1] == ((p.step, p.stages, p.dkdv_smem) if bf16
                        else (0, 0, 0))
    assert b[-4:-1] == ((p.step, p.stages, p.dq_smem) if bf16
                        else (0, 0, 0))


def test_flash_bwd_wrapper_copies_an_unaligned_input(monkeypatch):
    # the bf16 kernels copy 16 bytes at a time: a q and a dO two bytes off
    # a boundary reach them as aligned copies, aligned inputs as they are
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
    # the f32 route takes no copy
    q32, kv32, lse32 = _bwd_inputs(torch.float32)
    FA.flash_attention_bwd(q32, kv32, kv32, q32, lse32, q32, causal=True)
    assert dkdv.calls[1][0] == q32.data_ptr()
