"""The Orca entry points of the port: ``init_orca_context``,
``stop_orca_context`` and ``OrcaContext`` (``orca/common.py``), beside
process supervision (``orca/bootstrap.py``)."""

from zoo_tpu_torch.orca.common import (
    OrcaContext,
    init_orca_context,
    stop_orca_context,
)

__all__ = ["OrcaContext", "init_orca_context", "stop_orca_context"]
