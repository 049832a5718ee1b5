"""The port imports neither ``jax`` nor any ``zoo_tpu`` module (its own
name, ``zoo_tpu_torch``, shares the prefix and is allowed), nor
``pyarrow`` (the serving wire's Arrow codec is its own), nor ``optax``,
``orbax``, ``pandas`` or ``tensorboard`` (the training seam keeps its
own optimizers, checkpoint codec, duck-typed tables and event writer;
Chronos's TSDataset, which takes users' frames, imports pandas inside
the functions that need it, and importing it pulls in none);
the guard's controller imports without ``torch``; importing any of its
modules pulls in neither ``cv2`` nor ``PIL`` (the machine with the card
has neither: only image decoding imports cv2, when it runs); and its
entry points refuse to run quietly on the CPU."""

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


# the modules that take users' pandas frames (TSDataset's from_pandas,
# resample, rolling features; XShards of DataFrames): they may import
# pandas inside a function, never at module level (test_importing_every_
# module_... holds that importing them pulls in no pandas); the readers
# import pandas and pyarrow through importlib when they run
LAZY_PANDAS = (os.path.join("zoo_tpu_torch", "chronos", "data",
                            "tsdataset.py"),
               os.path.join("zoo_tpu_torch", "orca", "data", "shard.py"))


def _lazy_imports(tree) -> set:
    """The import nodes inside a function body."""
    return {id(n) for f in ast.walk(tree)
            if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
            for n in ast.walk(f) if isinstance(n, (ast.Import,
                                                   ast.ImportFrom))}


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    for m in ("serving.llm.engine", "serving.cluster_serving",
              "serving.client", "serving.arrow_ipc", "serving.resp",
              "serving.redis_embedded", "serving.run", "ppml.crypto",
              "models.image.imageclassification", "orca.learn.ckpt",
              "orca.learn.guard", "orca.learn.trigger",
              "orca.learn.keras.estimator", "orca.learn.optimizers.schedule",
              "tensorboard", "tensorboard.proto", "scripts.check_guard",
              "ops.random", "ops.kernels.dropout", "feature.text",
              "pipeline.api.keras.layers.recurrent",
              "models.textclassification",
              "models.textclassification.text_classifier",
              "models.anomalydetection",
              "models.anomalydetection.anomaly_detector",
              "models.recommendation.session_recommender",
              "models.seq2seq", "chronos.data.tsdataset",
              "chronos.forecaster", "chronos.detector.anomaly",
              "chronos.autots.autotsestimator", "automl.search",
              "automl.tpe", "automl.common.metrics",
              "pipeline.api.keras.layers.advanced",
              "pipeline.api.keras.layers.extras",
              "pipeline.api.keras.layers.conv_extras",
              "pipeline.api.keras.layers.compat_extras",
              "feature.common", "feature.image", "feature.image3d",
              "feature.image3d.transformation", "ops.moe",
              "models.llm.moe_llama", "models.recommendation.wide_and_deep",
              "models.ranking", "models.ranking.knrm", "models.text",
              "models.text.crf", "pipeline.api.keras2",
              "pipeline.api.keras2.layers", "common.context",
              "common.nncontext", "common.envcheck", "parallel",
              "parallel.mesh", "orca", "orca.common", "orca.data",
              "orca.data.shard", "orca.data.file", "orca.data.pandas",
              "orca.data.pandas.preprocessing", "ray",
              "models.image.objectdetection", "models.caffe_loader",
              "bridges", "bridges.fx_bridge", "orca.learn.pytorch",
              "orca.learn.pytorch.estimator", "pipeline.api.torch",
              "pipeline.api.net", "orca.automl", "orca.automl.auto_estimator",
              "orca.automl.pytorch_utils", "orca.learn.gan",
              "orca.learn.inference", "orca.learn.inference.estimator",
              "orca.learn.continuous", "scripts.check_lifecycle",
              "orca.learn.horovod", "orca.learn.mxnet", "orca.learn.mpi",
              "orca.data.ingest", "orca.data.cache", "orca.data.tfrecord",
              "orca.data.parquet_dataset", "orca.data.spark",
              "orca.data.elastic_search", "pipeline.nnframes",
              "pipeline.nnframes.nn_classifier",
              "pipeline.nnframes.nn_image_reader", "common.profiling",
              "common.xplane", "native", "util.utils"):
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
    lazy = _lazy_imports(tree) if os.path.relpath(path, ROOT) in \
        LAZY_PANDAS else set()
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names if not (
                id(node) in lazy and a.name == "pandas")]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_pulls_in_no_cv2_or_pil():
    """The image pipeline resizes and converts colours itself; no module
    of the port imports OpenCV or Pillow when it is imported (decoding
    imports cv2 inside the function that decodes)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cv2', 'PIL'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_the_text_pipeline_imports_no_torch():
    """``feature.text`` is the port's own copy and plain numpy: a
    data-preparation process imports neither torch nor jax for it."""
    code = ("import sys; import zoo_tpu_torch.feature.text as t; "
            "t.TextSet([]).tokenize(); "
            "bad = [m for m in ('torch', 'jax', 'zoo_tpu') "
            "if m in sys.modules]; print(bad); assert not bad, bad")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_sequence_entry_points_raise_without_a_card(monkeypatch):
    """The sequence slice: no GPU and no ``device=`` raises; the CPU
    runs the plain versions."""
    from zoo_tpu_torch.models.anomalydetection import AnomalyDetector
    from zoo_tpu_torch.models.textclassification import TextClassifier

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tc = TextClassifier(3, token_length=4, sequence_length=6, vocab=10,
                        encoder="gru", encoder_output_dim=4)
    tc.compile("adam", "sparse_categorical_crossentropy")
    ad = AnomalyDetector((5, 1), hidden_layers=(2, 2), dropouts=(0.2, 0.2))
    ad.compile("adam", "mse")
    ids = np.zeros((4, 6), np.int32)
    for call in (lambda: tc.build(),
                 lambda: tc.fit(ids, np.zeros(4, np.int32), batch_size=4,
                                verbose=0),
                 lambda: ad.predict(np.zeros((4, 5, 1), np.float32))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert tc.predict(ids, device="cpu").shape == (4, 3)


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


def test_seam_model_entry_points_raise_without_a_card(monkeypatch,
                                                      tmp_path):
    """MoELlama, Wide & Deep, KNRM and the tagging models: no GPU and no
    ``device=`` raises (``from_seed``, ``fit``, ``predict``, ``load``,
    ``predict_tags``); the CPU runs the plain versions."""
    from zoo_tpu_torch.models.llm import MoELlama, tiny_llama_config
    from zoo_tpu_torch.models.ranking import KNRM
    from zoo_tpu_torch.models.recommendation import (ColumnFeatureInfo,
                                                     WideAndDeep)
    from zoo_tpu_torch.models.text import NER

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_llama_config(vocab=16)
    wnd = WideAndDeep(2, ColumnFeatureInfo(wide_base_cols=["a"],
                                           wide_base_dims=[3],
                                           continuous_cols=["b"]))
    wnd.compile("adam", "sparse_categorical_crossentropy")
    knrm = KNRM(2, 3, vocab_size=8, embed_size=4, kernel_num=5)
    ner = NER(3, word_vocab_size=8, char_vocab_size=5, sequence_length=4,
              word_length=3, word_emb_dim=4, char_emb_dim=3,
              tagger_lstm_dim=2)
    ner.build(device="cpu")
    path = str(tmp_path / "ner.model")
    ner.save(path)
    rows = np.zeros((4, 2), np.float32)
    words, chars = np.zeros((2, 4), np.int32), np.zeros((2, 4, 3), np.int32)
    for call in (lambda: MoELlama.from_seed(cfg, n_experts=2),
                 lambda: wnd.fit(rows, np.zeros(4, np.int32), batch_size=4,
                                 verbose=0),
                 lambda: knrm.predict(np.zeros((2, 5), np.int32)),
                 lambda: NER.load_model(path),
                 lambda: ner.predict_tags(words, chars)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert MoELlama.from_seed(cfg, device="cpu", n_experts=2)(
        torch.zeros((1, 4), dtype=torch.int64)).shape == (1, 4, 16)
    assert NER.load_model(path, device="cpu").predict_tags(
        words, chars, device="cpu").shape == (2, 4)


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


def test_chronos_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    """The Chronos slice: no GPU and no ``device=`` raises at the
    forecasters' fit and predict, the Seq2seq model's, the AE detector's
    fit, TCMF's fit, AutoTS's fit and a pipeline's load; the host-only
    ARIMA runs; ``device="cpu"`` forecasts."""
    from zoo_tpu_torch.automl import hp
    from zoo_tpu_torch.chronos.autots import AutoTSEstimator, TSPipeline
    from zoo_tpu_torch.chronos.data import TSDataset
    from zoo_tpu_torch.chronos.detector import AEDetector
    from zoo_tpu_torch.chronos.forecaster import (
        ARIMAForecaster,
        LSTMForecaster,
        MTNetForecaster,
        Seq2SeqForecaster,
        TCMFForecaster,
        TCNForecaster,
    )
    from zoo_tpu_torch.models.seq2seq import Seq2seq

    x = np.zeros((8, 4, 1), np.float32)
    y = np.zeros((8, 1, 1), np.float32)
    ts = TSDataset.from_numpy({"v": np.sin(np.arange(30.0))}, None, "v")
    pipe = AutoTSEstimator("lstm", {"hidden_dim": 2}, past_seq_len=4).fit(
        ts, epochs=1, batch_size=8, device="cpu")
    pipe.save(str(tmp_path / "p"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fcs = (LSTMForecaster(4, 1, 1, hidden_dim=2),
           TCNForecaster(4, 1, 1, 1, num_channels=[2]),
           Seq2SeqForecaster(4, 1, 1, 1, lstm_hidden_dim=2),
           MTNetForecaster(series_length=2, cnn_hid_size=2, rnn_hid_size=2))
    calls = [lambda f=f: f.fit((x, y), epochs=1, batch_size=8) for f in fcs]
    calls += [lambda f=f: f.predict(x) for f in fcs]
    calls += [
        lambda: Seq2seq(input_length=4, input_dim=1, target_length=1,
                        output_dim=1, hidden_size=2).predict(x),
        lambda: AEDetector(roll_len=4, epochs=1).fit(np.zeros(20)),
        lambda: TCMFForecaster(rank=2).fit(np.zeros((4, 20), np.float32)),
        lambda: AutoTSEstimator("lstm", {"hidden_dim": hp.choice([2])},
                                past_seq_len=4).fit(ts),
        lambda: TSPipeline.load(str(tmp_path / "p"))]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    a = ARIMAForecaster(1, 0, 0)
    a.fit(np.sin(np.arange(30.0)))
    assert a.predict(3).shape == (3,)
    assert TSPipeline.load(str(tmp_path / "p"), device="cpu").predict(
        ts).shape == (26, 1, 1)


def test_image_zoo_entry_points_raise_without_a_card(monkeypatch,
                                                     tmp_path):
    """The image-classification slice: no GPU and no ``device=`` raises
    at ``ImageClassifier.predict_image_set`` and ``load_model``, and at a
    zoo model's ``predict`` and ``fit``; ``device="cpu"`` predicts."""
    from zoo_tpu_torch.feature.image import ImageSet
    from zoo_tpu_torch.models.image import ImageClassifier, mobilenet_v1

    images = ImageSet.from_arrays(
        [np.zeros((240, 250, 3), np.uint8) for _ in range(2)])
    clf = ImageClassifier.create("squeezenet", 3)
    path = str(tmp_path / "m.model")
    small = mobilenet_v1(3, alpha=0.25, input_shape=(32, 32, 3))
    small.compile("sgd", "sparse_categorical_crossentropy")
    small.build(torch.Generator().manual_seed(0), device="cpu")
    small.save(path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 32, 32, 3), np.float32)
    for call in (lambda: clf.predict_image_set(images),
                 lambda: ImageClassifier.load_model(path),
                 lambda: small.predict(x),
                 lambda: small.fit(x, np.zeros(2, np.int64), batch_size=2,
                                   nb_epoch=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    out = clf.predict_image_set(images, top_k=2, device="cpu")
    assert len(out.features[0]["classes"]) == 2


def test_orca_detection_and_caffe_entry_points_raise_without_a_card(
        monkeypatch, tmp_path):
    """The Orca entry path and A.12's rest: with no GPU, no ``devices=``
    and no ``device=``, ``init_orca_context``, ``init_nncontext``, SSD's
    ``fit_detection``/``predict_detections``, ``ObjectDetector.
    load_model`` and ``load_caffe`` raise; a CPU context lets a fit from
    XShards run without ``device=``."""
    from zoo_tpu_torch.common import init_nncontext
    from zoo_tpu_torch.models.caffe_loader import load_caffe
    from zoo_tpu_torch.models.image import SSD, ObjectDetector
    from zoo_tpu_torch.orca import init_orca_context, stop_orca_context
    from zoo_tpu_torch.orca.data import XShards
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense
    from zoo_tpu_torch.tensorboard import proto as wire

    ssd = SSD(3, input_size=32, feature_channels=(8,))
    ssd.build(torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "ssd.model")
    ssd.save(path)
    caffe = tmp_path / "net.caffemodel"
    caffe.write_bytes(wire.field_bytes(3, b"data") + b"".join(
        wire.field_varint(4, d) for d in (1, 1, 2, 2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((1, 32, 32, 3), np.float32)
    for call in (init_orca_context, init_nncontext,
                 lambda: ssd.predict_detections(x),
                 lambda: ssd.fit_detection(x, [np.zeros((0, 4))],
                                           [np.zeros(0)], epochs=1),
                 lambda: ObjectDetector.load_model(path),
                 lambda: load_caffe(None, str(caffe))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    init_orca_context(devices=["cpu"])
    try:
        m = Sequential().add(Dense(1, input_shape=(2,)))
        m.compile("sgd", "mse")
        shards = XShards.partition({"x": np.ones((8, 2), np.float32),
                                    "y": np.ones((8, 1), np.float32)}, 2)
        assert len(m.fit(shards, batch_size=4, nb_epoch=1,
                         verbose=0)["loss"]) == 1
    finally:
        stop_orca_context()


def test_orca_estimator_entry_points_raise_without_a_card(monkeypatch,
                                                         tmp_path):
    """The Orca estimators of the torch bridge: with no GPU and no
    ``device=``, ``Estimator.from_torch``'s fit and predict, a GAN's fit,
    ``from_model`` and an AutoEstimator trial raise; ``device="cpu"``
    runs."""
    import torch.nn as nn

    from zoo_tpu_torch.orca.automl import AutoEstimator, hp
    from zoo_tpu_torch.orca.learn.gan import GANEstimator
    from zoo_tpu_torch.orca.learn.inference import Estimator as InfEst
    from zoo_tpu_torch.orca.learn.pytorch import Estimator
    from zoo_tpu_torch.pipeline.api.keras import Sequential
    from zoo_tpu_torch.pipeline.api.keras.layers import Dense

    data = {"x": np.zeros((8, 3), np.float32),
            "y": np.zeros((8, 1), np.float32)}
    Estimator.from_torch(model=nn.Linear(3, 1), loss=nn.MSELoss(),
                         device="cpu").fit(data, epochs=1, batch_size=4)
    m = Sequential().add(Dense(1, input_shape=(3,)))
    m.build(torch.Generator().manual_seed(0), device="cpu")
    path = str(tmp_path / "m.zoo")
    m.save(path)

    def gan():
        g = Sequential().add(Dense(3, input_shape=(2,)))
        d = Sequential().add(Dense(1, input_shape=(3,)))
        return GANEstimator(g, d, noise_dim=2, guard=False)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    est = Estimator.from_torch(model=nn.Linear(3, 1), loss=nn.MSELoss(),
                               guard=False)
    auto = AutoEstimator.from_torch(
        model_creator=lambda cfg: nn.Linear(3, cfg["o"]), loss=nn.MSELoss())
    for call in (lambda: est.fit(data, epochs=1, batch_size=4),
                 lambda: est.predict(data["x"]),
                 lambda: gan().fit(data["x"], batch_size=4),
                 lambda: InfEst.from_model(path),
                 lambda: auto.fit(data, batch_size=4, search_space={
                     "o": hp.grid_search([1])})):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
