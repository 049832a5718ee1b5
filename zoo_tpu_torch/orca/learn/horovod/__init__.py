"""Horovod fabric shim (counterpart of ``zoo_tpu/orca/learn/horovod``;
the reference's ``horovod_ray_runner.py``).

The port has one data-parallel fabric, ``torch.distributed`` under
ROADMAP A.14; Horovod's ring allreduce has no place beside it. The
reference import path resolves and points at that fabric."""


class HorovodRayRunner:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "Horovod is not a fabric of the port: data parallelism is "
            "torch.distributed (ROADMAP A.14). Use orca.learn.pytorch / "
            "orca.learn.keras Estimators; init_orca_context() sets up "
            "the one fabric")


def run(*args, **kwargs):
    raise NotImplementedError(
        "Horovod is not a fabric of the port: data parallelism is "
        "torch.distributed (ROADMAP A.14); see HorovodRayRunner's "
        "message")
