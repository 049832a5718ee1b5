"""Chronos, time-series forecasting and anomaly detection (counterpart
of ``zoo_tpu/chronos``): ``data`` (TSDataset), ``forecaster``,
``detector`` and ``autots``. ``legacy`` is not ported yet (ROADMAP
A.16)."""
