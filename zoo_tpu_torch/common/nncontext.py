"""nncontext entry points (counterpart of
``zoo_tpu/common/nncontext.py``): ``init_nncontext``,
``init_spark_on_local`` and ``init_spark_on_yarn`` returned a
SparkContext in the original. There is no Spark here; each boots the
runtime context instead (created once, carries the device and mesh,
torn down at exit). Scripts that do ``sc = init_nncontext()`` and only
pass ``sc`` on run unchanged: every API reads the process-global
context and ignores a passed ``sc``.
"""

from __future__ import annotations

import warnings
from typing import Optional

from zoo_tpu_torch.orca.common import init_orca_context


def init_nncontext(conf=None, spark_log_level: str = "WARN",
                   redirect_spark_log: bool = True, **kwargs):
    """Returns the runtime context (on the current CUDA device; pass
    ``devices=["cpu"]`` for the CPU)."""
    return init_orca_context(cluster_mode="local",
                             devices=kwargs.get("devices"))


def init_spark_on_local(cores=2, conf=None, python_location=None,
                        spark_log_level: str = "WARN", **kwargs):
    """``cores`` sizes the host input-pipeline pool."""
    return init_orca_context(cluster_mode="local",
                             cores=None if cores in ("*", None)
                             else int(cores),
                             devices=kwargs.get("devices"))


def init_spark_on_yarn(hadoop_conf=None, conda_name: Optional[str] = None,
                       num_executors: int = 1, executor_cores: int = 2,
                       executor_memory: str = "2g", **kwargs):
    """There is no YARN here: ``num_executors`` maps to ``num_nodes``,
    and above one that needs ROADMAP A.14's ``torch.distributed``."""
    warnings.warn(
        "init_spark_on_yarn: no YARN in zoo_tpu_torch; starting the "
        "runtime context instead (num_executors maps to num_nodes)",
        stacklevel=2)
    return init_orca_context(cluster_mode="yarn",
                             num_nodes=int(num_executors),
                             cores=int(executor_cores),
                             devices=kwargs.get("devices"))
