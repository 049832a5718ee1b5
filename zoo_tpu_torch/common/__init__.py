"""Shared plumbing of the port: the knob registry, device resolution,
the runtime context and the nncontext entry points (counterpart of
``zoo_tpu/common/__init__.py``)."""

from zoo_tpu_torch.common.context import (  # noqa: F401
    RuntimeContext,
    ZooContext,
    get_runtime_context,
)

_NNCONTEXT = ("init_nncontext", "init_spark_on_local", "init_spark_on_yarn")


def __getattr__(name):
    # the nncontext entry points import the orca package, which imports
    # this one: resolved on first use
    if name in _NNCONTEXT:
        from zoo_tpu_torch.common import nncontext
        return getattr(nncontext, name)
    raise AttributeError(name)


class Sample:
    """A (features, labels) pair of ndarrays (the original's BigDL
    sample record); the estimators take arrays and XShards directly."""

    def __init__(self, features, labels=None):
        import numpy as np
        self.features = np.asarray(features)
        self.labels = None if labels is None else np.asarray(labels)

    @classmethod
    def from_ndarray(cls, features, labels=None):
        return cls(features, labels)


__all__ = ["ZooContext", "RuntimeContext", "get_runtime_context",
           "init_nncontext", "init_spark_on_local", "init_spark_on_yarn",
           "Sample"]
