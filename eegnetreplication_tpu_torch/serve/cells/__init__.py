"""Multi-cell serving: blast-radius isolation above the fleet tier.

The port's copy of ``eegnetreplication_tpu/serve/cells/``.  ``cells/`` runs
N independent cells — each a full serving deployment
(fleet router + supervised replicas, or a single serve process) — behind
a thin :class:`~eegnetreplication_tpu_torch.serve.cells.front.CellFront` that
routes bulk traffic least-loaded and sessions by sticky affinity, with
planned session migration (``/cell/<id>/drain``) and unplanned
cross-cell session failover from each cell's snapshot spool.  Each cell
is a port ``serve`` process (or a port fleet) on ``cuda:0`` with its own
CUDA context, bucket graphs and kernel launches: K1 for its bulk and
session windows, K2s for every push of a session homed on it.  The front,
the lease and the WAL are host code and touch no card.

``cells/ha.py`` removes the front's own SPOF: two fronts run as an
active/standby pair over a shared fencing lease + affinity WAL
(:class:`~eegnetreplication_tpu_torch.serve.cells.ha.HAController`), and the
active orchestrates rolling cell upgrades
(:class:`~eegnetreplication_tpu_torch.serve.cells.ha.RollingUpgrade`, served
as ``POST /cells/upgrade``).
"""

from eegnetreplication_tpu_torch.serve.cells.front import CellFront, MigrationError
from eegnetreplication_tpu_torch.serve.cells.ha import (
    AffinityWAL,
    FencingLease,
    HAController,
    RollingUpgrade,
    UpgradeInProgress,
)
from eegnetreplication_tpu_torch.serve.cells.membership import (
    CellMember,
    CellMembership,
    DISPATCHABLE,
    FAILED,
)

__all__ = ["AffinityWAL", "CellFront", "CellMember", "CellMembership",
           "DISPATCHABLE", "FAILED", "FencingLease", "HAController",
           "MigrationError", "RollingUpgrade", "UpgradeInProgress"]
