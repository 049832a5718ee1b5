"""The port's ``Estimator.from_torch`` against the JAX package's: the same
torch module (two copies of one seeded module) fitted through both
estimators gives the same per-epoch losses, predictions, ``evaluate``
and weights written back into the module, for each optimizer and loss
of the conversion tables; creators, XShards, a ``DataLoader`` and
``model_dir`` checkpoints behave as in JAX. The tables are held class by
class, with the AdamW repair: a torch ``AdamW`` becomes the port's
``AdamWeightDecay`` and is held against the JAX estimator given
``AdamWeightDecay`` directly, while a pinning test records that the JAX
table maps it to ``Adam`` on this torch (``AdamW`` subclasses ``Adam``).
A tiny HuggingFace BERT fine-tunes through both.

Tolerances: losses and ``evaluate`` rtol 1e-4, predictions and weights
1e-5 absolute (``test_torch_estimator.py``'s bar for f32 fits of a few
epochs), the BERT logits 1e-4 against torch.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn
from torch.utils.data import DataLoader, TensorDataset

from zoo_tpu.common import context as jax_context
from zoo_tpu.orca.data.shard import LocalXShards as JaxShards
from zoo_tpu.orca.learn.pytorch import Estimator as JaxEstimator
from zoo_tpu.orca.learn.pytorch import estimator as jest
from zoo_tpu.pipeline.api.keras import optimizers as jopt

from zoo_tpu_torch.orca.data import XShards
from zoo_tpu_torch.orca.learn.pytorch import Estimator
from zoo_tpu_torch.orca.learn.pytorch import estimator as test_
from zoo_tpu_torch.pipeline.api.keras import optimizers as topt

jax.config.update("jax_platforms", "cpu")


@pytest.fixture(autouse=True)
def _no_mesh(monkeypatch):
    """The JAX fit shards over an orca mesh left by another test on the
    same worker."""
    monkeypatch.setattr(jax_context, "_runtime_context", None)


def _net(n_out=1, seed=0):
    torch.manual_seed(seed)
    return nn.Sequential(nn.Linear(4, 16), nn.Tanh(), nn.Linear(16, n_out))


def _data(kind, n=96, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(n, 4).astype(np.float32)
    if kind in ("mse", "l1"):
        return x, (x @ rs.randn(4, 1)).astype(np.float32), 1
    if kind in ("ce", "nll"):
        return x, (rs.rand(n) * 3).astype(np.int32), 3
    return x, (x[:, :1] > 0).astype(np.float32), 1   # bce_logits


_LOSSES = {"mse": nn.MSELoss, "l1": nn.L1Loss, "ce": nn.CrossEntropyLoss,
           "bce_logits": nn.BCEWithLogitsLoss, "nll": nn.NLLLoss}


def _torch_opt(name, params):
    return {"adam": lambda: torch.optim.Adam(params, lr=0.01,
                                             betas=(0.8, 0.99), eps=1e-7),
            "sgd": lambda: torch.optim.SGD(params, lr=0.05, momentum=0.9),
            "rmsprop": lambda: torch.optim.RMSprop(params, lr=0.005,
                                                   alpha=0.95),
            "adagrad": lambda: torch.optim.Adagrad(params, lr=0.05),
            "adamw": lambda: torch.optim.AdamW(params, lr=0.01,
                                               weight_decay=0.05)}[name]()


def _pair(net):
    """Two independent copies of ``net`` (the JAX estimator writes back
    into its own)."""
    return copy.deepcopy(net), copy.deepcopy(net)


def _close_weights(a, b, atol=1e-5):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb)
    for k in pa:
        np.testing.assert_allclose(pa[k].detach().numpy(),
                                   pb[k].detach().numpy(), atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("loss,opt", [("mse", "adam"), ("ce", "sgd"),
                                      ("bce_logits", "rmsprop"),
                                      ("l1", "adagrad"), ("nll", "adamw")])
def test_fit_predict_evaluate_equal_jax(loss, opt):
    x, y, n_out = _data(loss)
    net = _net(n_out)
    if loss == "nll":
        net.append(nn.LogSoftmax(-1))
    jnet, tnet = _pair(net)
    if opt == "adamw":
        # the JAX table mis-maps a torch AdamW (see the pinning test):
        # give the JAX estimator the intended optimizer directly
        jopt_arg = jopt.AdamWeightDecay(lr=0.01, weight_decay=0.05)
    else:
        jopt_arg = _torch_opt(opt, jnet.parameters())
    je = JaxEstimator.from_torch(model=jnet, optimizer=jopt_arg,
                                 loss=_LOSSES[loss]())
    te = Estimator.from_torch(model=tnet,
                              optimizer=_torch_opt(opt, tnet.parameters()),
                              loss=_LOSSES[loss](), device="cpu")
    data = {"x": x, "y": y}
    np.testing.assert_allclose(te.predict(x[:10]),
                               np.asarray(je.predict(x[:10])), atol=1e-6)
    want = je.fit(data, epochs=3, batch_size=16)
    got = te.fit(data, epochs=3, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(te.predict(x, batch_size=40),
                               np.asarray(je.predict(x, batch_size=40)),
                               atol=1e-5)
    ev_t, ev_j = te.evaluate(data, batch_size=32), je.evaluate(
        data, batch_size=32)
    assert set(ev_t) == set(ev_j)
    for k in ev_j:
        np.testing.assert_allclose(ev_t[k], ev_j[k], rtol=1e-4)
    _close_weights(te.get_model(), je.get_model())
    assert te.get_model() is tnet
    with torch.no_grad():
        np.testing.assert_allclose(tnet(torch.from_numpy(x[:8])).numpy(),
                                   te.predict(x[:8]), atol=1e-6)


def test_creators_xshards_dataloader_and_checkpoints(tmp_path):
    x, y, _ = _data("mse", n=128)

    def creators(est_cls, **kw):
        return est_cls.from_torch(
            model_creator=lambda cfg: _net(seed=cfg["seed"]),
            optimizer_creator=lambda m, cfg: torch.optim.SGD(
                m.parameters(), lr=cfg["lr"]),
            loss_creator=lambda cfg: nn.MSELoss(),
            config={"seed": 3, "lr": 0.05}, **kw)

    je = creators(JaxEstimator, model_dir=str(tmp_path / "jax"))
    te = creators(Estimator, model_dir=str(tmp_path / "port"),
                  device="cpu")
    jshards = JaxShards.partition({"x": x, "y": y}, num_shards=4)
    tshards = XShards.partition({"x": x, "y": y}, num_shards=4)
    want = je.fit(jshards, epochs=2, batch_size=32)
    je._ckpt._ckptr = None
    got = te.fit(tshards, epochs=2, batch_size=32)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    assert te._ckpt.all_steps() == je._ckpt.all_steps() == [0, 1, 2]

    def loader():
        return DataLoader(TensorDataset(torch.from_numpy(x),
                                        torch.from_numpy(y)), batch_size=32)

    want = je.fit(loader(), epochs=1, batch_size=32)
    got = te.fit(loader(), epochs=1, batch_size=32)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    jout = je.predict(jshards, batch_size=32)
    tout = te.predict(tshards, batch_size=32)
    np.testing.assert_allclose(tout, np.asarray(jout), atol=1e-5)
    # a checkpointed step restores bit-equal onto the traced model
    te.load_orca_checkpoint(str(tmp_path / "port"), version=2)
    from zoo_tpu_torch.orca.learn.ckpt import CheckpointManager
    saved = CheckpointManager(str(tmp_path / "port" / "ckpts")).restore(2)
    for k, v in saved["params"]["torch_graph"]["w"].items():
        np.testing.assert_array_equal(
            te.model.params["torch_graph"]["w"][k].detach().numpy(),
            np.asarray(v))


def test_dataloader_of_two_inputs_and_dict_batches():
    rs = np.random.RandomState(0)
    xa, xb = rs.randn(64, 4).astype(np.float32), rs.randn(64, 3).astype(
        np.float32)
    y = rs.randn(64, 1).astype(np.float32)

    class TwoTower(nn.Module):
        def __init__(self):
            super().__init__()
            self.a, self.b = nn.Linear(4, 8), nn.Linear(3, 8)
            self.head = nn.Linear(8, 1)

        def forward(self, a, b):
            return self.head(torch.tanh(self.a(a)) * torch.sigmoid(self.b(b)))

    torch.manual_seed(0)
    jnet, tnet = _pair(TwoTower())
    je = JaxEstimator.from_torch(
        model=jnet, optimizer=torch.optim.Adam(jnet.parameters(), lr=0.01),
        loss=nn.MSELoss())
    te = Estimator.from_torch(
        model=tnet, optimizer=torch.optim.Adam(tnet.parameters(), lr=0.01),
        loss=nn.MSELoss(), device="cpu")
    ds = TensorDataset(*(torch.from_numpy(a) for a in (xa, xb, y)))
    want = je.fit(DataLoader(ds, batch_size=16), epochs=2, batch_size=16)
    got = te.fit(DataLoader(ds, batch_size=16), epochs=2, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)

    def as_dict(batch):
        return {"x": [torch.stack([b[0] for b in batch]),
                      torch.stack([b[1] for b in batch])],
                "y": torch.stack([b[2] for b in batch])}

    got = te.predict(DataLoader(ds, batch_size=16, collate_fn=as_dict))
    want = je.predict({"x": [xa, xb]})
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("opt", ["adam", "sgd", "sgd_nesterov", "rmsprop",
                                 "adagrad", "adamw"])
def test_optimizer_table_equals_jax(opt):
    params = _net().parameters()
    if opt == "sgd_nesterov":
        t = torch.optim.SGD(params, lr=0.05, momentum=0.9, nesterov=True)
    else:
        t = _torch_opt(opt, params)
    got = test_._convert_optimizer(t)
    want = jest._convert_optimizer(t)
    g = t.param_groups[0]
    assert got.lr == g["lr"]
    if opt == "adamw":
        assert isinstance(got, topt.AdamWeightDecay)
        b1, b2, eps, wd = got._args
        assert (b1, b2) == tuple(g["betas"]) and wd == g["weight_decay"]
        # the JAX class's own epsilon, not torch's 1e-8
        assert eps == 1e-6
        return
    assert type(got).__name__ == type(want).__name__
    if opt == "adam":
        assert (got.beta_1, got.beta_2, got.epsilon) == (0.8, 0.99, 1e-7)
    elif opt.startswith("sgd"):
        assert (got.momentum, got.nesterov) == (0.9, opt == "sgd_nesterov")
        assert got.fused is (opt == "sgd")
    elif opt == "rmsprop":
        assert (got.rho, got.epsilon) == (0.95, g["eps"])


def test_jax_table_maps_torch_adamw_to_adam_on_this_torch():
    """The fault of the reference the port repairs: ``AdamW`` subclasses
    ``Adam`` here, and the JAX table tests ``Adam`` first, so a torch
    AdamW loses its weight decay there. A torch or a JAX table that
    changes this fails here first."""
    t = torch.optim.AdamW(_net().parameters(), lr=0.01, weight_decay=0.05)
    assert issubclass(torch.optim.AdamW, torch.optim.Adam)
    assert type(jest._convert_optimizer(t)) is jopt.Adam
    assert type(test_._convert_optimizer(t)) is topt.AdamWeightDecay
    assert test_._convert_optimizer(None) == jest._convert_optimizer(None)
    sgd = topt.SGD(lr=0.1)
    assert test_._convert_optimizer(sgd) is sgd
    with pytest.raises(ValueError, match="unsupported optimizer"):
        test_._convert_optimizer(object())


def test_loss_table_equals_jax():
    for cls in (nn.MSELoss, nn.L1Loss, nn.CrossEntropyLoss, nn.BCELoss,
                nn.BCEWithLogitsLoss, nn.NLLLoss):
        assert test_._convert_loss(cls()) == jest._convert_loss(cls())
    assert test_._convert_loss("mse") == "mse"
    for fn in (test_._convert_loss, jest._convert_loss):
        with pytest.raises(ValueError, match="unsupported torch loss"):
            fn(nn.HuberLoss())


def test_tiny_hf_bert_fine_tunes_as_jax():
    transformers = pytest.importorskip("transformers")
    cfg = transformers.BertConfig(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=64, num_labels=2, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0)
    torch.manual_seed(0)

    class Logits(nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = transformers.BertForSequenceClassification(
                cfg).eval()

        def forward(self, ids):
            return self.bert(ids).logits

    jnet, tnet = _pair(Logits())
    rs = np.random.RandomState(0)
    ids = rs.randint(1, 96, (32, 12)).astype(np.int64)
    y = (ids[:, 0] % 2).astype(np.int32)
    je = JaxEstimator.from_torch(
        model=jnet, loss=nn.CrossEntropyLoss(),
        optimizer=jopt.AdamWeightDecay(lr=5e-3))
    te = Estimator.from_torch(
        model=tnet, loss=nn.CrossEntropyLoss(),
        optimizer=torch.optim.AdamW(tnet.parameters(), lr=5e-3,
                                    weight_decay=0.01), device="cpu")
    with torch.no_grad():
        pt = tnet(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(te.predict({"x": ids}), pt, atol=1e-4)
    np.testing.assert_allclose(te.predict({"x": ids}),
                               np.asarray(je.predict({"x": ids})), atol=1e-5)
    want = je.fit({"x": ids, "y": y}, epochs=1, batch_size=16)
    got = te.fit({"x": ids, "y": y}, epochs=1, batch_size=16)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    with torch.no_grad():
        post = te.get_model()(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(te.predict({"x": ids}), post, atol=1e-4)
