"""The port's torch.export bridge against the JAX package's: the op
tables hold the same 135 keys; five modules (an MLP, a conv net with
eval BatchNorm, a two-tower multi-input module, int64 ids through
embeddings, a small attention encoder) give the same forward through
both bridges and through torch itself; an op outside the table is
refused naming it (the port at conversion, JAX at the first call); no
op of a converted forward creates on the trace's device once the
weights sit elsewhere (the ``meta`` device stands in for the card);
a traced model's weights persist, its whole-model file is refused.

Tolerances: the port against torch 1e-6 (both run torch's own ops on
the CPU; 1e-5 with a convolution), the port against JAX 1e-5 (1e-4 for
the conv net: a 3x3 reduction of 32 terms in another order).
"""

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.utils._python_dispatch import TorchDispatchMode

from zoo_tpu.bridges import fx_bridge as jfx
from zoo_tpu.common import context as jax_context

from zoo_tpu_torch.bridges import fx_bridge as tfx

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


class _TwoTower(nn.Module):
    def __init__(self):
        super().__init__()
        self.a = nn.Linear(4, 8)
        self.b = nn.Linear(3, 8)
        self.head = nn.Linear(8, 2)

    def forward(self, xa, xb):
        return self.head(torch.tanh(self.a(xa)) * torch.sigmoid(self.b(xb)))


class _Ids(nn.Module):
    def __init__(self):
        super().__init__()
        self.tok = nn.Embedding(50, 16)
        self.pos = nn.Embedding(12, 16)
        self.out = nn.Linear(16, 3)

    def forward(self, ids):
        pos = torch.arange(ids.shape[1], device=ids.device)
        h = self.tok(ids) + self.pos(pos)[None]
        mask = (ids != 0).float()[..., None]
        return self.out((h * mask).sum(1) / mask.sum(1).clamp(min=1.0))


class _Encoder(nn.Module):
    def __init__(self, d=16, heads=2):
        super().__init__()
        self.emb = nn.Embedding(40, d)
        self.layer = nn.TransformerEncoderLayer(
            d, heads, dim_feedforward=32, dropout=0.1, batch_first=True,
            activation="gelu")
        self.norm = nn.LayerNorm(d)
        self.cls = nn.Linear(d, 2)

    def forward(self, ids):
        h = self.layer(self.emb(ids))
        return self.cls(self.norm(h[:, 0]))


def _conv_bn():
    net = nn.Sequential(nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8),
                        nn.ReLU(), nn.MaxPool2d(2), nn.Conv2d(8, 4, 1),
                        nn.AdaptiveAvgPool2d(1), nn.Flatten(),
                        nn.Linear(4, 2))
    bn = net[1]
    rs = np.random.RandomState(3)
    bn.running_mean.copy_(torch.from_numpy(rs.randn(8).astype(np.float32)))
    bn.running_var.copy_(torch.from_numpy(
        rs.uniform(0.5, 2.0, 8).astype(np.float32)))
    return net


def _case(name):
    rs = np.random.RandomState(0)
    torch.manual_seed(0)
    if name == "mlp":
        return (nn.Sequential(nn.Linear(6, 16), nn.GELU(), nn.Linear(16, 3),
                              nn.Softmax(-1)),
                [rs.randn(10, 6).astype(np.float32)], 1e-6, 1e-5)
    if name == "conv_bn":
        return (_conv_bn(), [rs.randn(4, 3, 8, 8).astype(np.float32)],
                1e-5, 1e-4)
    if name == "two_tower":
        return (_TwoTower(), [rs.randn(9, 4).astype(np.float32),
                              rs.randn(9, 3).astype(np.float32)], 1e-6, 1e-5)
    if name == "ids":
        ids = rs.randint(0, 50, (7, 12)).astype(np.int64)
        ids[:, -3:] = 0
        return _Ids(), [ids], 1e-6, 1e-5
    if name == "encoder":
        return (_Encoder(), [rs.randint(0, 40, (5, 9)).astype(np.int64)],
                1e-6, 1e-5)
    raise KeyError(name)


def test_op_table_keys_equal_jax():
    assert len(tfx._OPS) == 135
    assert set(tfx._OPS) == set(jfx._OPS)


@pytest.mark.parametrize("name", ["mlp", "conv_bn", "two_tower", "ids",
                                  "encoder"])
def test_forward_equals_jax_and_torch(name):
    module, xs, tol_torch, tol_jax = _case(name)
    module.eval()
    with torch.no_grad():
        want = module(*[torch.from_numpy(a) for a in xs]).numpy()
    ex = [a[:2] for a in xs]
    jcm = jfx.convert_torch_export(module, ex)
    jax_out = np.asarray(jcm(jcm.params, jcm.buffers, *xs))
    tcm = tfx.convert_torch_export(module, ex)
    with torch.no_grad():
        got = tcm(tcm.params, tcm.buffers,
                  *[torch.from_numpy(a) for a in xs]).numpy()
    assert got.shape == want.shape == jax_out.shape
    np.testing.assert_allclose(got, want, atol=tol_torch)
    np.testing.assert_allclose(got, jax_out, atol=tol_jax)
    # the weights are the module's, as the JAX bridge keys them
    assert sorted(tcm.params) == sorted(jcm.params)
    assert sorted(tcm.buffers) == sorted(jcm.buffers)
    for k, v in jcm.params.items():
        np.testing.assert_array_equal(tcm.params[k].numpy(), np.asarray(v))
        assert tcm.params[k].dtype == torch.float32
    # int64 state comes across as int32, as JAX makes it
    for k, v in tcm.buffers.items():
        assert v.dtype != torch.int64, k


def test_graph_net_fit_step_equals_jax():
    """Two epochs of ``fit`` of the traced encoder (int64 ids, eval-mode
    dropout, LayerNorm, GELU) from the same weights: losses and params.
    SGD, not Adam: the key projection's bias has a zero gradient (the
    softmax cancels it), which Adam would normalize from rounding noise
    into a full step."""
    from zoo_tpu.pipeline.api.keras.optimizers import SGD as JSGD

    from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
    from zoo_tpu_torch.pipeline.api.keras.optimizers import SGD

    module, xs, _, _ = _case("encoder")
    y = np.random.RandomState(1).randint(0, 2, len(xs[0])).astype(np.int32)
    jn = jfx.torch_to_graph_net(module, [xs[0][:2]])
    jn.compile(optimizer=JSGD(lr=0.1, momentum=0.9),
               loss="sparse_categorical_crossentropy_from_logits")
    tn = tfx.torch_to_graph_net(module, [xs[0][:2]])
    tn.compile(optimizer=SGD(lr=0.1, momentum=0.9),
               loss="sparse_categorical_crossentropy_from_logits")
    want = jn.fit(xs[0], y, batch_size=5, nb_epoch=2, verbose=0)
    got = tn.fit(xs[0], y, batch_size=5, nb_epoch=2, verbose=0,
                 device="cpu")
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    jw = jn.params["torch_graph"]["w"]
    for k, t in tn.params["torch_graph"]["w"].items():
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jw[k]),
                                   atol=1e-5, err_msg=k)
    assert len(tree_leaves(tn.params["torch_graph"]["w"])) == \
        len(list(module.parameters()))


def test_unsupported_op_is_refused_naming_it():
    class Bessel(nn.Module):
        def forward(self, x):
            return torch.special.i0(x)

    net = nn.Sequential(nn.Linear(4, 4), Bessel())
    x = np.ones((3, 4), np.float32)
    jcm = jfx.convert_torch_export(net, [x])
    with pytest.raises(NotImplementedError) as jerr:
        jcm(jcm.params, jcm.buffers, x)
    with pytest.raises(NotImplementedError) as terr:
        tfx.convert_torch_export(net, [x])
    op = str(jerr.value).split()[2]
    assert op.startswith("aten.") and "i0" in op
    assert f"ATen op {op} has no mapping" in str(terr.value)


class _Devices(TorchDispatchMode):
    """The device of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (list, tuple)) else [out]):
            if isinstance(t, torch.Tensor):
                self.seen.add((t.device.type, str(func)))
        return out


class _Factories(nn.Module):
    """A forward whose decomposed graph creates tensors: ``arange``,
    ``zeros``, ``ones``, ``full`` and a lifted constant."""

    def __init__(self):
        super().__init__()
        self.lin = nn.Linear(6, 6)
        self.register_buffer("scale", torch.full((6,), 0.5))

    def forward(self, x):
        pos = torch.arange(x.shape[1]).float()
        bias = torch.zeros(6) + torch.ones(6) + torch.full((6,), 2.0)
        return self.lin(x * self.scale) + pos + bias


def test_factory_ops_create_on_the_weights_device():
    x = np.random.RandomState(0).randn(4, 6).astype(np.float32)
    module = _Factories().eval()
    tcm = tfx.convert_torch_export(module, [x[:2]])
    with torch.no_grad():
        want = module(torch.from_numpy(x)).numpy()
        got = tcm(tcm.params, tcm.buffers, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    assert any("arange" in op for op in tcm.ops)
    assert any("full" in op or "zeros" in op for op in tcm.ops)
    meta = {k: v.to("meta") for k, v in tcm.params.items()}
    metab = {k: v.to("meta") for k, v in tcm.buffers.items()}
    xm = torch.from_numpy(x).to("meta")
    mode = _Devices()
    with torch.no_grad(), mode:
        out = tcm(meta, metab, xm)
    assert out.device.type == "meta"
    off = sorted(op for dev, op in mode.seen if dev != "meta")
    assert not off, off


def test_graph_net_weights_persist_and_model_file_is_refused(tmp_path):
    module, xs, _, _ = _case("two_tower")
    net = tfx.torch_to_graph_net(module, [a[:2] for a in xs])
    net.compile(optimizer="adam", loss="mse")
    before = net.predict(xs, device="cpu")
    path = str(tmp_path / "w.pkl")
    net.save_weights(path)
    other = tfx.torch_to_graph_net(_TwoTower(), [a[:2] for a in xs])
    other.load_weights(path, device="cpu")
    np.testing.assert_array_equal(other.predict(xs, device="cpu"), before)
    with pytest.raises(NotImplementedError, match="whole-model file"):
        net.save(str(tmp_path / "m.zoo"))


def test_batch_size_stays_symbolic():
    module, xs, _, _ = _case("ids")
    tcm = tfx.convert_torch_export(module.eval(), [xs[0][:2]])
    for n in (1, 3, 7):
        with torch.no_grad():
            got = tcm(tcm.params, tcm.buffers,
                      torch.from_numpy(xs[0][:n])).numpy()
            want = module(torch.from_numpy(xs[0][:n])).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6)
