"""TSDataset, a time-series table with roll, impute, scale and resample
(counterpart of ``zoo_tpu/chronos/data/tsdataset.py``, the port's own
copy).

The table is either a pandas frame (``from_pandas``) or a dict of numpy
columns (``from_numpy``). This module is the one of the port that
imports pandas, inside the functions that need it: ``roll``,
``to_numpy``, ``gen_dt_feature``, ``scale``/``unscale``/
``unscale_numpy`` and the split work on both without pandas;
``impute``, ``deduplicate``, ``resample``, ``gen_rolling_feature``,
``gen_global_feature`` and ``to_pandas`` import pandas when they run (a
numpy table becomes a frame there). So the forecasters, which only read
rolled arrays, never need pandas.

Rows of a multi-id table are grouped by id in the order each id first
appears, as ``groupby(sort=False)`` groups them; windows are cut inside
each group (:func:`roll_windows`) and never cross an id.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

_DT_FEATURES = ("HOUR", "DAY", "MONTH", "WEEKDAY", "WEEKOFYEAR", "MINUTE",
                "DAYOFYEAR", "IS_WEEKEND")


def roll_windows(values: np.ndarray, targets: Optional[np.ndarray],
                 lookback: int, horizon: Union[int, Sequence[int]]
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Sliding windows over one series: ``x`` (n, lookback, features)
    from ``values`` (t, features) and ``y`` (n, len(horizons),
    targets) from ``targets`` (t, targets), window ``i`` covering rows
    ``i .. i + lookback - 1`` and its targets rows ``i + lookback + h -
    1`` for each horizon ``h`` (``1..horizon`` for an int, the list as
    given otherwise; ``0``, or no ``targets``, for no ``y``). ``n = t -
    lookback - max(h) + 1``, at least 0."""
    horizons = _horizons(horizon)
    max_h = max(horizons) if horizons else 0
    n = max(len(values) - lookback - max_h + 1, 0)
    start = np.arange(n)[:, None]
    x = values[start + np.arange(lookback)]
    if not horizons or targets is None:
        return x, None
    return x, targets[start + lookback - 1 + np.asarray(horizons)]


def _horizons(horizon) -> List[int]:
    if isinstance(horizon, (int, np.integer)):
        return list(range(1, int(horizon) + 1)) if horizon > 0 else []
    return [int(h) for h in horizon]


def dt_features(dt: np.ndarray, features: Sequence[str] = _DT_FEATURES
                ) -> Dict[str, np.ndarray]:
    """Calendar features of ``datetime64`` stamps, as pandas' ``.dt``
    gives them (``WEEKDAY`` 0 = Monday, ``WEEKOFYEAR`` the ISO week), in
    numpy alone: int32 for the fields pandas 2 gives as int32, int64
    for ``WEEKOFYEAR`` and ``IS_WEEKEND`` (the JAX package's casts)."""
    t = np.asarray(dt).astype("datetime64[ns]")
    day = t.astype("datetime64[D]")
    days = day.astype(np.int64)
    weekday = (days + 3) % 7           # 1970-01-01 was a Thursday
    year = day.astype("datetime64[Y]")
    month = day.astype("datetime64[M]")
    # the ISO week: the week of the Thursday of this stamp's week, in
    # the year that Thursday falls in
    thursday = (days - weekday + 3).astype("datetime64[D]")
    iso_start = thursday.astype("datetime64[Y]").astype("datetime64[D]")
    table = {
        "HOUR": (t.astype("datetime64[h]") - day).astype(np.int64),
        "MINUTE": (t.astype("datetime64[m]")
                   - t.astype("datetime64[h]")).astype(np.int64),
        "DAY": (day - month.astype("datetime64[D]")).astype(np.int64) + 1,
        "MONTH": (month - year.astype("datetime64[M]")).astype(np.int64)
        + 1,
        "WEEKDAY": weekday,
        "DAYOFYEAR": (day - year.astype("datetime64[D]")).astype(np.int64)
        + 1,
        "WEEKOFYEAR": (thursday - iso_start).astype(np.int64) // 7 + 1,
        "IS_WEEKEND": (weekday >= 5).astype(np.int64),
    }
    out = {}
    for f in features:
        f = f.upper()
        if f not in table:
            raise ValueError(f"unknown dt feature: {f}")
        out[f] = table[f] if f in ("WEEKOFYEAR", "IS_WEEKEND") else \
            table[f].astype(np.int32)
    return out


def pandas_frame(columns: Dict[str, np.ndarray]):
    """A pandas frame of ``columns`` (pandas imported here, when it is
    needed: prophet's ``ds``/``y`` frames)."""
    import pandas as pd
    return pd.DataFrame(columns)


class TSDataset:
    def __init__(self, df, dt_col: str, target_col: List[str],
                 id_col: Optional[str], extra_feature_col: List[str]):
        self.df = df
        self.dt_col = dt_col
        self.target_col = list(target_col)
        self.id_col = id_col
        self.feature_col = list(extra_feature_col)
        self.scaler = None
        self.numpy_x: Optional[np.ndarray] = None
        self.numpy_y: Optional[np.ndarray] = None
        self.lookback: Optional[int] = None
        self.horizon: Optional[Union[int, List[int]]] = None

    # -- construction ------------------------------------------------------
    @staticmethod
    def _cols(target_col, extra_feature_col):
        target_col = [target_col] if isinstance(target_col, str) \
            else list(target_col)
        extra = [] if extra_feature_col is None else (
            [extra_feature_col] if isinstance(extra_feature_col, str)
            else list(extra_feature_col))
        return target_col, extra

    @staticmethod
    def _split(n: int, with_split: bool, val_ratio: float,
               test_ratio: float):
        if not with_split:
            return None
        test_n = int(n * test_ratio)
        val_n = int(n * val_ratio)
        return (slice(0, n - val_n - test_n),
                slice(n - val_n - test_n, n - test_n),
                slice(n - test_n, n))

    @staticmethod
    def from_pandas(df, dt_col: str, target_col: Union[str, Sequence[str]],
                    id_col: Optional[str] = None,
                    extra_feature_col: Union[str, Sequence[str],
                                             None] = None,
                    with_split: bool = False, val_ratio: float = 0,
                    test_ratio: float = 0.1):
        """One dataset of a pandas frame (sorted by id, then time), or
        a (train, val, test) triple of consecutive rows with
        ``with_split``."""
        import pandas as pd

        target_col, extra = TSDataset._cols(target_col, extra_feature_col)
        work = df.copy()
        work[dt_col] = pd.to_datetime(work[dt_col])
        work = work.sort_values([c for c in (id_col, dt_col) if c]) \
            .reset_index(drop=True)
        parts = TSDataset._split(len(work), with_split, val_ratio,
                                 test_ratio)
        if parts is None:
            return TSDataset(work, dt_col, target_col, id_col, extra)
        return tuple(TSDataset(work.iloc[s].reset_index(drop=True), dt_col,
                               target_col, id_col, extra) for s in parts)

    @staticmethod
    def from_numpy(data: Dict[str, np.ndarray], dt_col: Optional[str],
                   target_col: Union[str, Sequence[str]],
                   id_col: Optional[str] = None,
                   extra_feature_col: Union[str, Sequence[str],
                                            None] = None,
                   with_split: bool = False, val_ratio: float = 0,
                   test_ratio: float = 0.1):
        """:meth:`from_pandas` of a dict of equal-length numpy columns
        (``dt_col`` ``datetime64``, or None for a table with no time
        column), sorted as it sorts (by id, then time; rows of equal keys
        keep their order), with no pandas."""
        target_col, extra = TSDataset._cols(target_col, extra_feature_col)
        cols = {k: np.asarray(v) for k, v in data.items()}
        n = len(next(iter(cols.values()))) if cols else 0
        if any(len(v) != n for v in cols.values()):
            raise ValueError("every column needs the same length")
        keys = [cols[c] for c in (dt_col, id_col) if c]
        if keys:
            order = np.lexsort(keys)   # the last key sorts first
            cols = {k: v[order] for k, v in cols.items()}
        parts = TSDataset._split(n, with_split, val_ratio, test_ratio)
        if parts is None:
            return TSDataset(cols, dt_col, target_col, id_col, extra)
        return tuple(TSDataset({k: v[s] for k, v in cols.items()}, dt_col,
                               target_col, id_col, extra) for s in parts)

    # -- the table ---------------------------------------------------------
    def _is_numpy(self) -> bool:
        return isinstance(self.df, dict)

    def _col(self, name: str) -> np.ndarray:
        return np.asarray(self.df[name])

    def _block(self, cols: Sequence[str], dtype) -> np.ndarray:
        """``cols`` as one (t, len(cols)) array of ``dtype``, converted
        from their common dtype (``frame[cols].to_numpy(dtype)``, in the
        frame's own memory layout, which scikit-learn's sums follow)."""
        if not self._is_numpy():
            return self.df[list(cols)].to_numpy(dtype=dtype)
        if not cols:
            return np.zeros((self._len(), 0), dtype)
        return np.column_stack([self._col(c) for c in cols]).astype(dtype)

    def _set(self, cols: Sequence[str], values: np.ndarray) -> None:
        if self._is_numpy():
            for i, c in enumerate(cols):
                self.df[c] = values[:, i]
        else:
            self.df[list(cols)] = values

    def _len(self) -> int:
        if self._is_numpy():
            return len(next(iter(self.df.values()))) if self.df else 0
        return len(self.df)

    def _group_rows(self) -> List[np.ndarray]:
        """Row indexes of each id, ids in order of first appearance
        (one group of every row without an id column)."""
        if self.id_col is None:
            return [np.arange(self._len())]
        ids = self._col(self.id_col)
        _, first, inverse = np.unique(ids, return_index=True,
                                      return_inverse=True)
        return [np.flatnonzero(inverse == g) for g in np.argsort(first)]

    def _pandas(self):
        """The table as a pandas frame (a numpy table is turned into one
        here, for the methods pandas computes)."""
        if self._is_numpy():
            self.df = pandas_frame(self.df)
        return self.df

    # -- cleaning ----------------------------------------------------------
    def impute(self, mode: str = "last", const_num: float = 0.0):
        """Modes: last | const | linear."""
        df = self._pandas()
        cols = self.target_col + self.feature_col
        if mode == "last":
            df[cols] = df[cols].ffill().bfill()
        elif mode == "const":
            df[cols] = df[cols].fillna(const_num)
        elif mode == "linear":
            df[cols] = df[cols].interpolate(method="linear",
                                            limit_direction="both")
        else:
            raise ValueError(f"unknown impute mode: {mode}")
        return self

    def deduplicate(self):
        keys = [c for c in (self.id_col, self.dt_col) if c]
        self.df = self._pandas().drop_duplicates(subset=keys) \
            .reset_index(drop=True)
        return self

    def resample(self, interval: str, merge_mode: str = "mean"):
        """Resample each id's rows to a fixed interval."""
        import pandas as pd

        df = self._pandas()

        def _one(g):
            g = g.set_index(self.dt_col)
            num = g[self.target_col + self.feature_col]
            agg = getattr(num.resample(interval), merge_mode)()
            if self.id_col:
                agg[self.id_col] = g[self.id_col].iloc[0]
            return agg.reset_index()

        self.df = pd.concat([_one(df.iloc[rows]) for rows in
                             self._group_rows()], ignore_index=True)
        return self

    # -- feature generation ------------------------------------------------
    def gen_dt_feature(self, features: Sequence[str] = _DT_FEATURES):
        """Calendar feature columns of the time column
        (:func:`dt_features`), appended to the features."""
        for f, values in dt_features(self._col(self.dt_col),
                                     features).items():
            self.df[f] = values
            if f not in self.feature_col:
                self.feature_col.append(f)
        return self

    def gen_rolling_feature(self, window_size: int,
                            settings: str = "minimal",
                            cols: Optional[Sequence[str]] = None):
        """Rolling statistics per target column over the trailing
        ``window_size`` steps of each id: mean/std/min/max/median
        (``minimal``), and quantiles, absolute energy, mean absolute
        change and linear-trend slope (``comprehensive``); columns
        ``<col>_rolling_<stat>``, leading rows without a full window
        filled within their id."""
        import pandas as pd

        if settings not in ("minimal", "comprehensive"):
            raise ValueError("settings must be minimal | comprehensive")
        df = self._pandas()
        cols = list(cols) if cols is not None else list(self.target_col)

        def _stats(roll):
            out = {"mean": roll.mean(), "std": roll.std(),
                   "min": roll.min(), "max": roll.max(),
                   "median": roll.median()}
            if settings == "comprehensive":
                out["q25"] = roll.quantile(0.25)
                out["q75"] = roll.quantile(0.75)
                out["abs_energy"] = roll.apply(
                    lambda v: float(np.sum(np.square(v))), raw=True)
                out["mean_abs_change"] = roll.apply(
                    lambda v: float(np.mean(np.abs(np.diff(v))))
                    if len(v) > 1 else 0.0, raw=True)

                def _slope(v):
                    idx = np.arange(len(v), dtype=np.float64)
                    denom = float(((idx - idx.mean()) ** 2).sum()) or 1.0
                    return float(((idx - idx.mean())
                                  * (v - v.mean())).sum() / denom)

                out["trend_slope"] = roll.apply(_slope, raw=True)
            return out

        parts = []
        for rows in self._group_rows():
            g = df.iloc[rows]
            block = {}
            for c in cols:
                roll = g[c].rolling(window_size, min_periods=1)
                for stat, series in _stats(roll).items():
                    block[f"{c}_rolling_{stat}"] = series.to_numpy()
            parts.append(pd.DataFrame(block, index=g.index)
                         .ffill().bfill().fillna(0.0))
        feats = pd.concat(parts).sort_index()
        for name in feats.columns:
            df[name] = feats[name]
            if name not in self.feature_col:
                self.feature_col.append(name)
        return self

    def gen_global_feature(self, settings: str = "minimal",
                           cols: Optional[Sequence[str]] = None):
        """Whole-series statistics per id, broadcast as constant
        columns ``<col>_global_<stat>``: mean/std/min/max (``minimal``),
        and skewness, kurtosis and lag-1 autocorrelation
        (``comprehensive``)."""
        import pandas as pd

        if settings not in ("minimal", "comprehensive"):
            raise ValueError("settings must be minimal | comprehensive")
        df = self._pandas()
        cols = list(cols) if cols is not None else list(self.target_col)

        def _stats(v: np.ndarray):
            out = {"mean": float(np.mean(v)), "std": float(np.std(v)),
                   "min": float(np.min(v)), "max": float(np.max(v))}
            if settings == "comprehensive":
                sd = np.std(v) or 1.0
                z = (v - np.mean(v)) / sd
                out["skew"] = float(np.mean(z ** 3))
                out["kurtosis"] = float(np.mean(z ** 4) - 3.0)
                out["autocorr1"] = (
                    float(np.corrcoef(v[:-1], v[1:])[0, 1])
                    if len(v) > 2 and np.std(v[:-1]) > 0
                    and np.std(v[1:]) > 0 else 0.0)
            return out

        parts = []
        for rows in self._group_rows():
            g = df.iloc[rows]
            block = {}
            for c in cols:
                v = g[c].to_numpy(dtype=np.float64)
                for stat, val in _stats(v).items():
                    block[f"{c}_global_{stat}"] = val
            parts.append(pd.DataFrame(block, index=g.index))
        feats = pd.concat(parts).sort_index()
        for name in feats.columns:
            df[name] = feats[name]
            if name not in self.feature_col:
                self.feature_col.append(name)
        return self

    # -- scaling -----------------------------------------------------------
    def scale(self, scaler, fit: bool = True):
        """A scikit-learn style scaler (``fit``/``transform``/
        ``inverse_transform``) over the target and feature columns,
        kept for :meth:`unscale_numpy`."""
        cols = self.target_col + self.feature_col
        vals = self._block(cols, np.float64)
        if fit:
            scaler.fit(vals)
        self._set(cols, scaler.transform(vals))
        self.scaler = scaler
        return self

    def unscale(self):
        if self.scaler is None:
            raise RuntimeError("scale() was never called")
        cols = self.target_col + self.feature_col
        self._set(cols, self.scaler.inverse_transform(
            self._block(cols, np.float64)))
        return self

    def unscale_numpy(self, y: np.ndarray) -> np.ndarray:
        """Invert the scaling of a rolled target array (batch, horizon,
        targets)."""
        if self.scaler is None:
            raise RuntimeError("scale() was never called")
        n_target = len(self.target_col)
        n_cols = n_target + len(self.feature_col)
        flat = y.reshape(-1, n_target)
        pad = np.zeros((flat.shape[0], n_cols))
        pad[:, :n_target] = flat
        out = self.scaler.inverse_transform(pad)[:, :n_target]
        return out.reshape(y.shape)

    # -- rolling -----------------------------------------------------------
    def roll(self, lookback: int, horizon: Union[int, List[int]],
             feature_col: Optional[Sequence[str]] = None,
             target_col: Optional[Sequence[str]] = None):
        """Sliding windows of each id (:func:`roll_windows`),
        concatenated: x (n, lookback, targets + features), y (n,
        horizons, targets); ``horizon=0`` gives inference windows and no
        y."""
        feature_col = list(feature_col if feature_col is not None
                           else self.feature_col)
        target_col = list(target_col if target_col is not None
                          else self.target_col)
        max_h = max(_horizons(horizon) or [0])
        in_cols = target_col + feature_col
        arr = self._block(in_cols, np.float32)
        tgt = self._block(target_col, np.float32)
        groups = self._group_rows()
        xs, ys = [], []
        for rows in groups:
            x, y = roll_windows(arr[rows], tgt[rows], lookback, horizon)
            xs.append(x)
            if y is not None:
                ys.append(y)
        n = sum(len(x) for x in xs)
        if not n and self._len():
            raise ValueError(
                f"lookback ({lookback}) + horizon ({max_h}) exceeds every "
                f"series length (longest: "
                f"{max(len(rows) for rows in groups)})")
        self.numpy_x = np.concatenate(xs) if n else np.zeros(
            (0, lookback, len(in_cols)), np.float32)
        self.numpy_y = np.concatenate(ys) if n and ys else None
        self.lookback, self.horizon = lookback, horizon
        return self

    def to_numpy(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if self.numpy_x is None:
            raise RuntimeError("call roll() before to_numpy()")
        return self.numpy_x, self.numpy_y

    def to_pandas(self):
        return self._pandas().copy()

    def get_feature_num(self) -> int:
        return len(self.target_col) + len(self.feature_col)

    def get_target_num(self) -> int:
        return len(self.target_col)
