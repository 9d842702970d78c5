"""Fleet serving: N shared-nothing replicas behind one router.

The port's copy of ``eegnetreplication_tpu/serve/fleet/``.  One serving
process caps ``/predict`` throughput at what one process can feed the
card and makes every hot-reload a fleet-wide event.  This package turns
the single-process serving stack (``serve/engine.py`` + ``MicroBatcher`` +
``serve/service.py``) into a cluster.  Each replica is the port's own
``python -m eegnetreplication_tpu_torch.serve`` process on ``cuda:0``, with
its own CUDA context, bucket graphs and kernel launches; the router,
membership and controllers are host code:

- :mod:`~eegnetreplication_tpu_torch.serve.fleet.membership` — health-gated
  replica membership: ``/healthz`` + heartbeat-file polling drains
  degraded/stale replicas out of rotation and rejoins restarted ones
  automatically;
- :mod:`~eegnetreplication_tpu_torch.serve.fleet.router` — least-loaded
  dispatch over live queue depth, one circuit breaker per replica,
  connection-failure failover (an idempotent inference is simply retried
  on a sibling);
- :mod:`~eegnetreplication_tpu_torch.serve.fleet.canary` — rolling canary
  hot-reload: swap ONE replica, shadow-compare its outputs against an
  old-digest replica on captured live traffic, then roll the remainder —
  the single-process zero-drop reload contract extended to the cluster;
- :mod:`~eegnetreplication_tpu_torch.serve.fleet.service` — the router HTTP
  process plus the replica-spawning wiring through
  :class:`~eegnetreplication_tpu_torch.resil.supervise.MultiSupervisor`.

Every membership/dispatch/canary decision is journaled as a ``fleet_*``
event (``obs/schema.py``).
"""

from eegnetreplication_tpu_torch.serve.fleet.canary import RollingReload
from eegnetreplication_tpu_torch.serve.fleet.membership import (
    FleetMembership,
    Replica,
    ReplicaClient,
)
from eegnetreplication_tpu_torch.serve.fleet.outlier import OutlierEjector
from eegnetreplication_tpu_torch.serve.fleet.router import (
    FleetRouter,
    HedgePolicy,
    NoLiveReplicas,
)
from eegnetreplication_tpu_torch.serve.fleet.service import FleetApp

__all__ = [
    "FleetApp",
    "FleetMembership",
    "FleetRouter",
    "HedgePolicy",
    "NoLiveReplicas",
    "OutlierEjector",
    "Replica",
    "ReplicaClient",
    "RollingReload",
]
