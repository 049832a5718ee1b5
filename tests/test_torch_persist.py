"""The port's model files against the JAX package's.

* The weight file is shared: a JAX ``save_weights`` file read by the
  port's ``load_weights`` predicts as the JAX model does, and the port's
  ``save_weights`` file read by the JAX package's does too (the tiny
  ResNet of ``tests/test_torch_resnet.py``, f32, within its 1e-6).
  Either side refuses a file of another structure.
* The whole-model file is the port's own: ``save``/``load`` (and
  ``InferenceModel.load``) round trip bit for bit, float and int8 (the
  int8 convs' K-major copies rebuilt at load); a ``Lambda`` around a
  ``lambda`` fails at ``save`` naming the layer; a JAX ``.zoo`` file is
  refused before anything in it is unpickled, so neither ``jax`` nor
  ``zoo_tpu`` is imported by the attempt (checked in a subprocess).
"""

import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from zoo_tpu.models.image import resnet as jresnet
from zoo_tpu.pipeline.api.keras.engine.topology import KerasNet as JaxNet

from zoo_tpu_torch.convert import keras_params_from_jax
from zoo_tpu_torch.models.image import resnet as tresnet
from zoo_tpu_torch.ops.kernels.conv import kmajor_of, pallas_conv_supported
from zoo_tpu_torch.pipeline.api.keras import Sequential
from zoo_tpu_torch.pipeline.api.keras.engine.base import tree_leaves
from zoo_tpu_torch.pipeline.api.keras.engine.topology import (
    MODEL_MAGIC,
    KerasNet,
)
from zoo_tpu_torch.pipeline.api.keras.layers import (
    Convolution2D,
    Dense,
    Lambda,
)
from zoo_tpu_torch.pipeline.inference import InferenceModel, quantize_model

from test_torch_resnet import _images, _no_mesh, _pair  # noqa: F401

jax.config.update("jax_platforms", "cpu")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


def _port_resnet():
    m = tresnet.ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.compile("adamw", "sparse_categorical_crossentropy")
    return m


def _double(h):
    return h * 2.0


# ------------------------------------------------------- the weight file

def test_jax_weight_file_loads_into_the_port(tmp_path):
    jm, _ = _pair()
    path = str(tmp_path / "w.pkl")
    jm.save_weights(path)
    tm = _port_resnet()
    tm.load_weights(path, device="cpu")
    x = _images()
    np.testing.assert_allclose(tm.predict(x, batch_size=4, device="cpu"),
                               jm.predict(x, batch_size=4), rtol=0,
                               atol=TOL)


def test_port_weight_file_loads_into_jax(tmp_path):
    jm, tm = _pair()
    path = str(tmp_path / "w.pkl")
    tm._step = 5
    tm.save_weights(path)
    fresh = jresnet.ResNet(10, (1, 1), bottleneck=True,
                           input_shape=(32, 32, 3))
    fresh.compile("adam", "sparse_categorical_crossentropy")
    fresh.build(jax.random.PRNGKey(3))
    fresh.load_weights(path)
    assert fresh._step == 5
    x = _images()
    np.testing.assert_allclose(fresh.predict(x, batch_size=4),
                               tm.predict(x, batch_size=4, device="cpu"),
                               rtol=0, atol=TOL)


def test_a_weight_file_of_another_structure_is_refused(tmp_path):
    jm, tm = _pair()
    path = str(tmp_path / "w.pkl")
    jm.save_weights(path)
    other = tresnet.ResNet(10, (1, 1), bottleneck=False,
                           input_shape=(32, 32, 3))
    other.compile("adamw", "sparse_categorical_crossentropy")
    with pytest.raises(ValueError, match="does not match"):
        other.load_weights(path, device="cpu")
    tm.save_weights(path)
    jother = jresnet.ResNet(10, (1, 1), bottleneck=False,
                            input_shape=(32, 32, 3))
    jother.compile("adam", "sparse_categorical_crossentropy")
    with pytest.raises(ValueError, match="does not match"):
        jother.load_weights(path)


# --------------------------------------------------- the whole-model file

@pytest.mark.parametrize("path", ["float", "int8"])
def test_save_load_round_trip_is_bit_equal(path, tmp_path):
    _, tm = _pair()
    if path == "int8":
        quantize_model(tm, mode="force")
    x = _images()
    ref = tm.predict(x, batch_size=4, device="cpu")
    f = tm.save(str(tmp_path / "m.zoo"))
    with open(f, "rb") as fh:
        assert fh.read(len(MODEL_MAGIC)) == MODEL_MAGIC
    back = KerasNet.load(f, device="cpu")
    assert type(back) is type(tm) and back._quantized == (path == "int8")
    np.testing.assert_array_equal(back.predict(x, batch_size=4,
                                               device="cpu"), ref)
    # a model is saved whole but not what only a live one holds
    assert back._opt_state is None
    convs = [l for l in back.layers if isinstance(l, Convolution2D)
             and pallas_conv_supported(l.kernel, l.subsample)]
    if path == "int8":
        assert convs and all(
            kmajor_of(back.params[back._key_of(l)]["W_q"]) is not None
            for l in convs)
    # the live model is untouched by its save
    assert all(isinstance(t, torch.Tensor) for t in tree_leaves(tm.params))


@pytest.mark.parametrize("mode,quantized", [("force", True),
                                            ("off", False)])
def test_inference_model_load(mode, quantized, tmp_path, monkeypatch):
    _, tm = _pair()
    x = _images()
    f = tm.save(str(tmp_path / "m.zoo"))
    monkeypatch.setenv("ZOO_INT8_MODE", mode)
    im = InferenceModel().load(f, batch_size=4, quantize=True,
                               device="cpu")
    assert im.model._quantized is quantized
    ref = tm.predict(x, batch_size=4, device="cpu")
    got = im.predict(x)
    if quantized:
        quantize_model(tm, mode="force")
        ref = tm.predict(x, batch_size=4, device="cpu")
    np.testing.assert_array_equal(got, ref)


def test_other_loaders_name_their_roadmap_items(tmp_path):
    """``load_tf`` and ``load_onnx`` name ROADMAP A.16; ``load_caffe``
    (ROADMAP A.12) is ported and reads a file
    (``tests/test_torch_caffe_loader.py`` holds it to the JAX loader)."""
    im = InferenceModel()
    for call, item in ((im.load_tf, "A.16"), (im.load_onnx, "A.16")):
        with pytest.raises(NotImplementedError, match=item):
            call("x")
    with pytest.raises(FileNotFoundError):
        im.load_caffe(None, str(tmp_path / "missing.caffemodel"),
                      device="cpu")


@pytest.mark.parametrize("fn", [lambda h: h * 2.0, _double, torch.sin],
                         ids=["lambda", "foreign-module", "torch-function"])
def test_unpicklable_layer_fails_at_save_naming_it(fn, tmp_path):
    """A function the model file cannot hold (a lambda), or one that
    ``load`` would refuse to resolve (not a part of a model that the
    port registers), fails at ``save``; a registered activation saves
    and loads."""
    bad = Sequential().add(Dense(4, input_shape=(3,))).add(
        Lambda(fn, name="doubler"))
    bad.build(device="cpu")
    with pytest.raises(ValueError, match="'doubler'"):
        bad.save(str(tmp_path / "bad.zoo"))
    good = Sequential().add(Dense(4, input_shape=(3,),
                                  activation="gelu")).add(
        Lambda(torch.tanh))
    good.build(device="cpu")
    x = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    back = KerasNet.load(good.save(str(tmp_path / "good.zoo")),
                         device="cpu")
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  good.predict(x, device="cpu"))


def test_a_jax_zoo_file_is_refused_without_importing_jax(tmp_path):
    jm, _ = _pair()
    path = str(tmp_path / "jax_model.zoo")
    jm.save(path)
    assert isinstance(JaxNet.load(path), JaxNet)   # a real JAX model file
    code = f"""
import sys
sys.path.insert(0, {ROOT!r})
from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet
from zoo_tpu_torch.pipeline.inference import InferenceModel
from zoo_tpu_torch.serving.ha import resolve_model_spec
refused = 0
for call in (lambda: KerasNet.load({path!r}, device="cpu"),
             lambda: InferenceModel().load({path!r}, device="cpu"),
             lambda: resolve_model_spec({path!r}, device="cpu")):
    try:
        call()
    except ValueError as e:
        refused += "load_weights" in str(e)
print("REFUSED", refused)
print("IMPORTED", sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "zoo_tpu")))
"""
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "REFUSED 3" in r.stdout and "IMPORTED []" in r.stdout, r.stdout


def test_a_model_file_naming_a_foreign_class_is_refused(tmp_path):
    import pickle
    f = tmp_path / "evil.zoo"
    f.write_bytes(MODEL_MAGIC + pickle.dumps(os.getcwd, protocol=4))
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd"):
        KerasNet.load(str(f), device="cpu")


def _naming(module, name):
    """A protocol-4 stream that looks ``module`` / ``name`` up
    (STACK_GLOBAL) and stops."""
    def text(s):
        b = s.encode()
        return b"\x8c" + bytes([len(b)]) + b
    return b"\x80\x04" + text(module) + text(name) + b"\x93."


@pytest.mark.parametrize("module,name", [
    ("torch", "os.system"),                        # dotted: followed out
    ("zoo_tpu_torch.serving.ha", "subprocess.Popen"),
    ("torch", "load"),                             # a function of torch
    ("numpy", "memmap"),                           # a class of numpy
    ("zoo_tpu_torch.util.manifest", "write_durable"),   # of the port
    ("zoo_tpu_torch.serving.registry", "ModelRegistry"),
    ("zoo_tpu_torch.pipeline.api.keras.engine.topology", "pickle"),
    ("zoo_tpu_torch.models.recommendation.neuralcf", "Dense"),  # imported
    ("builtins", "eval"),
], ids=lambda v: v)
def test_a_model_file_naming_what_is_not_a_model_part_is_refused(
        module, name, tmp_path):
    """``load`` resolves only undotted names of the parts of a model
    (:func:`model_file_part`) where the port defines them, numpy's array
    parts and torch's dtypes: the module attributes a dotted name would
    reach, other functions and classes of the port, numpy and torch,
    and the port's re-exports are refused before anything is called."""
    f = tmp_path / "evil.zoo"
    f.write_bytes(MODEL_MAGIC + _naming(module, name))
    import pickle
    with pytest.raises(pickle.UnpicklingError,
                       match=re.escape(f"{module}.{name}")):
        KerasNet.load(str(f), device="cpu")
    # the same stream naming a part of a model resolves it
    f.write_bytes(MODEL_MAGIC + _naming(
        "zoo_tpu_torch.pipeline.api.keras.layers.core", "Dense"))
    with pytest.raises(ValueError, match="holds a type"):
        KerasNet.load(str(f), device="cpu")


def test_the_ncf_flagship_saves_and_loads(tmp_path):
    """NCF's id-splitting Lambdas are module-level functions, so the
    flagship saves to a model file and loads bit for bit."""
    from zoo_tpu_torch.models.recommendation import NeuralCF
    m = NeuralCF(16, 12, 5, user_embed=4, item_embed=4, hidden_layers=(8,),
                 mf_embed=4)
    m.compile("adam", "sparse_categorical_crossentropy")
    m.build(device="cpu")
    rs = np.random.RandomState(0)
    x = np.stack([rs.randint(0, 16, 32), rs.randint(0, 12, 32)],
                 1).astype(np.int32)
    back = KerasNet.load(m.save(str(tmp_path / "ncf.zoo")), device="cpu")
    np.testing.assert_array_equal(back.predict(x, device="cpu"),
                                  m.predict(x, device="cpu"))
