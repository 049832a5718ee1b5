"""NNFrames: Spark-ML-pipeline-style estimator and transformer wrappers
(counterpart of ``zoo_tpu/pipeline/nnframes/nn_classifier.py``).

``NNEstimator(model, criterion).setBatchSize(n).setMaxEpoch(e).fit(df)``
returns an ``NNModel`` whose ``transform(df)`` appends a ``prediction``
column. The reference rides Spark DataFrames; here the same contract runs
over pandas DataFrames (and XShards of them), and a Spark DataFrame
enters through :mod:`zoo_tpu_torch.orca.data.spark`. pandas is imported
inside the functions that build frames, never at import time. ``fit``
and ``transform`` run on the estimator's ``device`` (default: the
context's device, else the current CUDA device), as every entry point of
the port does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import numpy as np


def _need(module: str):
    import importlib

    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"NNFrames builds pandas DataFrames and needs the "
                          f"{module} package") from e


def _pandas():
    """pandas, imported when a frame is built."""
    return _need("pandas")


def _to_matrix(df, cols: Sequence[str]) -> np.ndarray:
    """Feature columns → (n, d) float matrix; array-valued cells (the
    Spark Vector role) flatten in order."""
    parts = []
    for c in cols:
        v = df[c].to_numpy()
        if v.dtype == object:  # column of arrays/lists
            v = np.stack([np.asarray(e, np.float32).reshape(-1)
                          for e in v])
        else:
            v = v.astype(np.float32).reshape(len(v), -1)
        parts.append(v)
    return parts[0] if len(parts) == 1 else np.concatenate(parts, axis=1)


def _featurize(df, cols: Sequence[str], preprocessing) -> np.ndarray:
    """Feature columns → model input. Without a chain: flat numeric
    matrix (the Spark Vector role). With a ``sample_preprocessing``
    chain: the chain maps each cell of the single feature column to a
    feature carrying ``tensor`` (or a transformed ``image``), preserving
    tensor shape for conv models."""
    if preprocessing is None:
        return _to_matrix(df, cols)
    if len(cols) != 1:
        raise ValueError(
            "sample_preprocessing requires a single feature column; got "
            f"{list(cols)}")
    xs = []
    for cell in df[cols[0]]:
        f = preprocessing(cell)
        if isinstance(f, dict):
            t = f.get("tensor", f.get("image"))
        else:
            t = f
        xs.append(np.asarray(t, np.float32))
    return np.stack(xs)


class NNEstimator:
    """An estimator of chained setters (set* mirror the Spark-ML params)."""

    def __init__(self, model, criterion: str = "mse",
                 features_col: str = "features", label_col: str = "label",
                 sample_preprocessing=None, device=None):
        self.model = model
        self.criterion = criterion
        self.device = device
        self.features_col = [features_col] if isinstance(features_col, str) \
            else list(features_col)
        self.label_col = label_col
        self.batch_size = 32
        self.max_epoch = 1
        self.learning_rate: Optional[float] = None
        self.optim_method = "adam"
        self.caching_sample = True
        self.sample_preprocessing = sample_preprocessing

    # -- Spark-ML style setters -------------------------------------------
    def setFeaturesCol(self, col: Union[str, Sequence[str]]):
        self.features_col = [col] if isinstance(col, str) else list(col)
        return self

    def setLabelCol(self, col: str):
        self.label_col = col
        return self

    def setBatchSize(self, n: int):
        self.batch_size = int(n)
        return self

    def setMaxEpoch(self, n: int):
        self.max_epoch = int(n)
        return self

    def setLearningRate(self, lr: float):
        self.learning_rate = float(lr)
        return self

    def setOptimMethod(self, name: str):
        self.optim_method = name
        return self

    def setCachingSample(self, flag: bool):
        self.caching_sample = bool(flag)
        return self

    def setSamplePreprocessing(self, chain):
        """Per-cell transform chain applied to the (single) feature
        column before stacking — the reference's image-pipeline entry
        (``NNEstimator(..., sample_preprocessing=ChainedPreprocessing(
        [RowToImageFeature(), ImageResize(...), ..., ImageMatToTensor()
        ]))``). The chain's output feature must carry ``tensor`` (or
        leave ``image`` as the tensor)."""
        self.sample_preprocessing = chain
        return self

    # -- fit ---------------------------------------------------------------
    def _compile(self):
        if self.model.loss_fn is None:
            from zoo_tpu_torch.pipeline.api.keras import optimizers as zopt

            opt = {"adam": zopt.Adam, "sgd": zopt.SGD,
                   "rmsprop": zopt.RMSprop}[self.optim_method.lower()]
            kwargs = {} if self.learning_rate is None \
                else {"lr": self.learning_rate}
            self.model.compile(optimizer=opt(**kwargs),
                               loss=self.criterion)

    def _unpack(self, df):
        from zoo_tpu_torch.orca.data.shard import LocalXShards
        from zoo_tpu_torch.orca.data.spark import (
            is_spark_dataframe,
            spark_dataframe_to_shards,
        )

        if is_spark_dataframe(df):
            # Spark ML contract (reference nn_classifier.py:139): the
            # executors write shard files; this process loads its slice
            # and proceeds over pandas (no collect of rows)
            pd = _pandas()

            label = ([self.label_col]
                     if self.label_col in df.columns else [])
            shards = spark_dataframe_to_shards(
                df, self.features_col, label)
            frames = []
            for s in shards.collect():
                x = np.asarray(s["x"])
                if len(self.features_col) == 1:
                    d = {self.features_col[0]: list(x)}
                else:
                    d = {c: x[:, i]
                         for i, c in enumerate(self.features_col)}
                if "y" in s:
                    d[self.label_col] = np.asarray(s["y"])
                frames.append(pd.DataFrame(d))
            if not frames:
                raise ValueError(
                    "this process received no rows from the Spark "
                    "DataFrame (empty partitions, or more processes "
                    "than non-empty partitions — repartition the "
                    "DataFrame to at least process_count parts)")
            df = pd.concat(frames, ignore_index=True)
        if isinstance(df, LocalXShards):
            pd = _pandas()

            df = pd.concat(df.collect(), ignore_index=True)
        x = _featurize(df, self.features_col, self.sample_preprocessing)
        y = df[self.label_col].to_numpy() if self.label_col in df else None
        return df, x, y

    def fit(self, df) -> "NNModel":
        df, x, y = self._unpack(df)
        if y is None:
            raise ValueError(f"label column {self.label_col!r} not in df")
        self._compile()
        y = self._prepare_labels(y)
        self.model.fit(x, y, batch_size=self.batch_size,
                       nb_epoch=self.max_epoch, verbose=0, device=self.device)
        return self._make_model()

    def _prepare_labels(self, y):
        return y.astype(np.float32).reshape(len(y), -1)

    def _make_model(self) -> "NNModel":
        return NNModel(self.model, features_col=self.features_col,
                       sample_preprocessing=self.sample_preprocessing,
                       device=self.device)


class NNModel:
    """Transformer: appends ``prediction`` to the DataFrame (reference
    ``NNModel.transform``)."""

    prediction_col = "prediction"

    def __init__(self, model, features_col: Sequence[str] = ("features",),
                 sample_preprocessing=None, device=None):
        self.model = model
        self.device = device
        self.features_col = list(features_col)
        self.batch_size = 256
        self.sample_preprocessing = sample_preprocessing

    def setFeaturesCol(self, col: Union[str, Sequence[str]]):
        self.features_col = [col] if isinstance(col, str) else list(col)
        return self

    def setBatchSize(self, n: int):
        self.batch_size = int(n)
        return self

    def setPredictionCol(self, col: str):
        self.prediction_col = col
        return self

    def setSamplePreprocessing(self, chain):
        self.sample_preprocessing = chain
        return self

    def _predict(self, df) -> np.ndarray:
        x = _featurize(df, self.features_col, self.sample_preprocessing)
        return self.model.predict(x, batch_size=self.batch_size,
                                  device=self.device)

    def transform(self, df):
        from zoo_tpu_torch.orca.data.shard import LocalXShards

        if isinstance(df, LocalXShards):
            return df.transform_shard(self.transform)
        out = df.copy()
        preds = self._predict(df)
        out[self.prediction_col] = (preds[:, 0] if preds.ndim == 2
                                    and preds.shape[1] == 1
                                    else list(preds))
        return out


class NNClassifier(NNEstimator):
    """Classifier flavor: integer labels, argmax prediction (reference
    ``NNClassifier`` — labels are 1-based there via Spark-ML convention;
    0-based here, documented)."""

    def __init__(self, model, criterion: str =
                 "sparse_categorical_crossentropy",
                 features_col: str = "features", label_col: str = "label",
                 sample_preprocessing=None, device=None):
        super().__init__(model, criterion, features_col, label_col,
                         sample_preprocessing=sample_preprocessing,
                         device=device)

    def _prepare_labels(self, y):
        return y.astype(np.int32)

    def _make_model(self) -> "NNClassifierModel":
        return NNClassifierModel(
            self.model, features_col=self.features_col,
            sample_preprocessing=self.sample_preprocessing,
            device=self.device)


class NNClassifierModel(NNModel):
    def transform(self, df):
        from zoo_tpu_torch.orca.data.shard import LocalXShards

        if isinstance(df, LocalXShards):
            return df.transform_shard(self.transform)
        out = df.copy()
        probs = self._predict(df)
        out[self.prediction_col] = np.argmax(probs, axis=-1) \
            if probs.ndim > 1 and probs.shape[-1] > 1 \
            else (probs.reshape(-1) > 0.5).astype(np.int32)
        return out
