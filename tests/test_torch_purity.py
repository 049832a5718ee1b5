"""The port imports neither ``jax`` nor any ``zoo_tpu`` module (its own
name, ``zoo_tpu_torch``, shares the prefix and is allowed), nor
``pyarrow`` (the serving wire's Arrow codec is its own), nor ``optax``,
``orbax``, ``pandas`` or ``tensorboard`` (the training seam keeps its
own optimizers, checkpoint codec, duck-typed tables and event writer);
the guard's controller imports without ``torch``; and its entry points
refuse to run quietly on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zoo_tpu_torch")


def _modules():
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


FORBIDDEN = ("jax", "zoo_tpu", "pyarrow", "optax", "orbax", "pandas",
             "tensorboard")


def _forbidden(name: str) -> bool:
    return any(name == root or name.startswith(root + ".")
               for root in FORBIDDEN)


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    for m in ("serving.llm.engine", "serving.cluster_serving",
              "serving.client", "serving.arrow_ipc", "serving.resp",
              "serving.redis_embedded", "serving.run", "ppml.crypto",
              "models.image.imageclassification", "orca.learn.ckpt",
              "orca.learn.guard", "orca.learn.trigger",
              "orca.learn.keras.estimator", "orca.learn.optimizers.schedule",
              "tensorboard", "tensorboard.proto", "scripts.check_guard"):
        assert "zoo_tpu_torch." + m in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if any(m == r or "
        f"m.startswith(r + '.') for r in {FORBIDDEN!r}))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", [
    os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_zoo_tpu_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_without_device_raise_without_a_card(monkeypatch):
    """No GPU and no ``device=``: every entry point raises instead of
    carrying on on the CPU."""
    from zoo_tpu_torch.common.device import resolve_device
    from zoo_tpu_torch.convert import keras_params_from_jax, params_from_jax
    from zoo_tpu_torch.models.llm.llama import Llama, tiny_llama_config
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.serving.llm import PagedLlamaModel, build_llm_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_llama_config()
    tree = {"embed": np.zeros((4, 2), np.float32)}
    model = Sequential().add(Llama(cfg, input_shape=(8,)))
    model.compile("adamw", "sparse_categorical_crossentropy_from_logits")
    ids = np.zeros((4, 8), np.int32)
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Llama.from_seed(cfg),
                 lambda: PagedLlamaModel(cfg),
                 lambda: build_llm_engine("llama:tiny"),
                 lambda: params_from_jax(tree),
                 lambda: keras_params_from_jax({"000_llama": tree}),
                 lambda: model.build(),
                 lambda: model.fit(ids, ids, batch_size=4, verbose=0)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_inference_entry_points_raise_without_a_card(monkeypatch):
    """The image-inference slice: no GPU and no ``device=`` raises."""
    from zoo_tpu_torch.models.image import resnet50
    from zoo_tpu_torch.pipeline.inference import InferenceModel

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = resnet50(10, (32, 32, 3))
    x = np.zeros((2, 32, 32, 3), np.float32)
    for call in (lambda: model.build(),
                 lambda: model.predict(x),
                 lambda: InferenceModel().load_keras(model),
                 lambda: InferenceModel().load_keras(model, batch_size=2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model.build(device="cpu")
    assert InferenceModel().load_keras(model, device="cpu").predict(
        x).shape == (2, 10)


def test_flash_paths_refuse_cpu_tensors():
    from zoo_tpu_torch.models.llm.llama import tiny_llama_config
    from zoo_tpu_torch.serving.llm import PagedLlamaModel
    for kw in ({"decode_impl": "flash"}, {"prefill_impl": "flash"},
               {"attention_impl": "flash"}):
        with pytest.raises(ValueError, match="CUDA"):
            PagedLlamaModel(tiny_llama_config(), device="cpu",
                            num_blocks=8, max_blocks_per_seq=4,
                            block_size=4, prefill_buckets=(8,), **kw)


def test_ncf_and_bert_entry_points_raise_without_a_card(monkeypatch):
    """The NCF and BERT slice: no GPU and no ``device=`` raises."""
    from zoo_tpu_torch.models.recommendation import (NeuralCF,
                                                     UserItemFeature)
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import BERT

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ncf = NeuralCF(8, 8, 2, user_embed=4, item_embed=4, hidden_layers=(4,),
                   mf_embed=4)
    ncf.compile("adam", "sparse_categorical_crossentropy")
    bert = Sequential().add(BERT(vocab=16, hidden_size=8, n_block=1,
                                 n_head=2, seq_len=4, intermediate_size=8,
                                 hidden_p_drop=0.0, attn_p_drop=0.0,
                                 input_shape=(4,)))
    bert.compile("adamw", "mse")
    pairs = np.zeros((4, 2), np.int32)
    ids = np.zeros((4, 4), np.int32)
    for call in (lambda: ncf.build(),
                 lambda: ncf.fit(pairs, np.zeros(4, np.int32), batch_size=4,
                                 verbose=0),
                 lambda: ncf.predict(pairs),
                 lambda: ncf.recommend_for_user([UserItemFeature(1, 2)], 1),
                 lambda: bert.build(),
                 lambda: bert.predict(ids)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert ncf.predict(pairs, device="cpu").shape == (4, 2)
    assert bert.predict(ids, device="cpu").shape == (4, 4, 8)


def test_predict_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The predict-door slice: no GPU and no ``device=`` raises at every
    loader of a model file; ``device="cpu"`` serves."""
    from zoo_tpu_torch.models.image import ResNet
    from zoo_tpu_torch.pipeline.api.keras.engine.topology import KerasNet
    from zoo_tpu_torch.pipeline.inference import InferenceModel
    from zoo_tpu_torch.serving.ha import resolve_model_spec
    from zoo_tpu_torch.serving.registry import ModelRegistry

    m = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    m.build(device="cpu")
    path = m.save(str(tmp_path / "m.zoo"))
    m.save_weights(str(tmp_path / "w.pkl"))
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish(path, alias="prod")
    spec = f"registry:{reg.root}:prod"
    fresh = ResNet(10, (1, 1), bottleneck=True, input_shape=(32, 32, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: KerasNet.load(path),
                 lambda: InferenceModel().load(path),
                 lambda: resolve_model_spec(path),
                 lambda: resolve_model_spec(spec),
                 lambda: fresh.load_weights(str(tmp_path / "w.pkl"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    model, version = resolve_model_spec(spec, batch_size=2, device="cpu")
    assert version == "v1" and model.predict(
        np.zeros((2, 32, 32, 3), np.float32)).shape == (2, 10)


def test_cluster_serving_entry_points_raise_without_a_card(monkeypatch,
                                                           tmp_path):
    """Cluster Serving's slice: no GPU and no ``device=`` (``--device``)
    raises at the encrypted loader, the CLI's model load and VGG."""
    from zoo_tpu_torch.models.image import vgg16
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from zoo_tpu_torch.pipeline.inference import (InferenceModel,
                                                  save_encrypted)
    from zoo_tpu_torch.serving import run

    m = Sequential().add(Dense(2, input_shape=(3,)))
    m.build(device="cpu")
    enc = save_encrypted(m, str(tmp_path / "m.enc"), "k", "s")
    plain = m.save(str(tmp_path / "m.zoo"))
    vgg = vgg16(10, (32, 32, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ap = run._parser()
    for call in (lambda: InferenceModel().load_encrypted(enc, "k", "s"),
                 lambda: run._load_model(ap, ap.parse_args(
                     ["--model", plain])),
                 lambda: vgg.build()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert InferenceModel().load_encrypted(enc, "k", "s", device="cpu") \
        .predict(np.zeros((1, 3), np.float32)).shape == (1, 2)


def test_guard_controller_imports_without_torch():
    """The guard's host controller, the triggers and the ``check_guard``
    copy import without ``torch``, as the JAX package's import without
    ``jax``."""
    code = (
        "import sys\n"
        "import zoo_tpu_torch.orca.learn.guard\n"
        "import zoo_tpu_torch.orca.learn.trigger\n"
        "import zoo_tpu_torch.scripts.check_guard\n"
        "bad = sorted(m for m in sys.modules if m == 'torch' or "
        "m.startswith('torch.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_estimator_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The estimator's slice: no GPU and no ``device=`` raises at fit,
    predict, evaluate and ``load_orca_checkpoint``; ``device="cpu"``
    trains."""
    from zoo_tpu_torch.orca.learn.keras import Estimator
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense

    def model():
        m = Sequential().add(Dense(1, input_shape=(3,)))
        return m.compile("adam", "mse")

    data = {"x": np.zeros((8, 3), np.float32),
            "y": np.zeros((8, 1), np.float32)}
    Estimator.from_keras(model(), model_dir=str(tmp_path), device="cpu") \
        .fit(data, epochs=1, batch_size=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est = Estimator.from_keras(model(), guard=False)
    for call in (lambda: est.fit(data, epochs=1, batch_size=4),
                 lambda: est.predict(data["x"]),
                 lambda: est.evaluate(data),
                 lambda: est.load_orca_checkpoint(str(tmp_path))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
