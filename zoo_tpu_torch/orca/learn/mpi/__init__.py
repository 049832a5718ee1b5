"""MPI fabric shim (counterpart of ``zoo_tpu/orca/learn/mpi``; the
reference's ``mpi_estimator.py``: mpirun-launched training).

The port's launch is one supervised process per worker
(:class:`zoo_tpu_torch.orca.bootstrap.ProcessMonitor`) and its
collectives are ``torch.distributed``; the multi-process launch comes
with ROADMAP A.14. The reference import path resolves and redirects."""


class MPIEstimator:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "No MPI in the port: workers are supervised processes "
            "(zoo_tpu_torch.orca.bootstrap.ProcessMonitor) and the "
            "fabric is torch.distributed, whose multi-process launch "
            "waits for ROADMAP A.14; inside a worker, use any orca "
            "Estimator")
