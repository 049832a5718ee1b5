"""The learning-rate schedules and the keras-1 optimizers (counterpart
of ``zoo_tpu/orca/learn/optimizers/__init__.py``, the same names). The
optimizers resolve on first use: they import this package's
``schedule``."""

from zoo_tpu_torch.orca.learn.optimizers import schedule  # noqa: F401

_OPTIMIZERS = ("SGD", "Adam", "AdamWeightDecay", "RMSprop", "Adagrad",
               "Adadelta", "Adamax", "LARS")


def __getattr__(name):
    if name in _OPTIMIZERS:
        from zoo_tpu_torch.pipeline.api.keras import optimizers
        return getattr(optimizers, name)
    raise AttributeError(name)
