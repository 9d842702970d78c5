"""Cells service wiring: front process + N supervised serving cells.

``python -m eegnetreplication_tpu_torch.serve.cells --checkpoint m.npz
--cells 2`` spawns N cells under one
:class:`~eegnetreplication_tpu_torch.resil.supervise.MultiSupervisor` and binds
the :class:`~eegnetreplication_tpu_torch.serve.cells.front.CellFront` over
them.  The front runs no model and touches no card; its cells inherit its
environment, so they run on ``cuda:0`` unless the caller set
``EEGTPU_PLATFORM=cpu`` (a host without CUDA stops ``main`` before any
cell starts, and a cell that cannot reach CUDA exits nonzero).  Each cell
is:

- ``--replicasPerCell 1`` (default): one ``python -m
  eegnetreplication_tpu_torch.serve`` process — the smallest full cell (model,
  batcher, sessions, snapshots);
- ``--replicasPerCell R > 1``: one ``python -m
  eegnetreplication_tpu_torch.serve.fleet`` process whose FleetApp supervises
  R replicas of its own — a full fleet as one cell.

Every cell's session snapshots land under ``--cellsDir`` (shared
storage): ``<cellsDir>/<cell>/sessions/``.  That directory IS each
cell's spool — what the front restores sessions from when the cell dies.

Note the supervisor relaunches a crashed CELL (with ``--resume``, so a
bounce of the whole cell restores its own sessions); cross-cell failover
covers the window while it is down and any session the front already
moved stays moved (a resurrected copy is shadowed by affinity and
discarded on its next drain).
"""

from __future__ import annotations

import argparse
import sys
import threading
import time
from pathlib import Path

from eegnetreplication_tpu_torch.obs import journal as obs_journal
from eegnetreplication_tpu_torch.obs import trace
from eegnetreplication_tpu_torch.resil import preempt, stackdump, supervise
from eegnetreplication_tpu_torch.serve.cells.front import CellFront
from eegnetreplication_tpu_torch.serve.cells.membership import CellMember
from eegnetreplication_tpu_torch.serve.fleet.service import free_port
from eegnetreplication_tpu_torch.utils.logging import logger


def make_spec_factory(*, run_dir: Path, cells_dir: Path,
                      host: str = "127.0.0.1", replicas_per_cell: int = 1,
                      session_snapshot_every: int = 16,
                      mirror: bool = False):
    """A ``(cell_id, port) -> (spec_fn, spool, mirror)`` closure pair.

    The returned ``factory(cell_id, port)`` yields a
    ``spec_fn(checkpoint, serve_args) -> ChildSpec`` plus the cell's
    spool/mirror paths — the relaunch seam a rolling upgrade needs: the
    SAME port/spool/heartbeat wiring a fresh spawn gets, with only
    checkpoint/args swapped."""
    run_dir = Path(run_dir)
    cells_dir = Path(cells_dir)

    def factory(cell_id: str, port: int):
        spool = cells_dir / cell_id / "sessions"
        mirror_dir = (cells_dir / cell_id / "sessions_mirror"
                      if mirror else None)
        hb_file = run_dir / f"{cell_id}.heartbeat.json"

        def spec_fn(checkpoint, serve_args) -> supervise.ChildSpec:
            if replicas_per_cell > 1:
                cmd = [sys.executable, "-m",
                       "eegnetreplication_tpu_torch.serve.fleet",
                       "--checkpoint", str(checkpoint), "--host", host,
                       "--port", str(port),
                       "--replicas", str(replicas_per_cell),
                       "--sessionsDir", str(spool),
                       "--sessionSnapshotEvery",
                       str(session_snapshot_every),
                       "--metricsDir", str(run_dir / f"{cell_id}_obs")]
            else:
                cmd = [sys.executable, "-m", "eegnetreplication_tpu_torch.serve",
                       "--checkpoint", str(checkpoint), "--host", host,
                       "--port", str(port),
                       "--sessionsDir", str(spool / "r0"),
                       "--sessionSnapshotEvery",
                       str(session_snapshot_every),
                       "--metricsDir", str(run_dir / f"{cell_id}_obs")]
                if mirror_dir is not None:
                    cmd += ["--sessionsMirror", str(mirror_dir / "r0")]
            cmd += list(serve_args or [])
            return supervise.ChildSpec(name=cell_id, cmd=cmd,
                                       heartbeat_file=hb_file)

        return spec_fn, spool, mirror_dir

    return factory


def spawn_cells(checkpoint: str, n: int, *, run_dir: Path, cells_dir: Path,
                host: str = "127.0.0.1", replicas_per_cell: int = 1,
                serve_args: list[str] | None = None,
                session_snapshot_every: int = 16,
                mirror: bool = False,
                policy: supervise.SupervisorPolicy | None = None,
                journal=None) -> tuple[supervise.MultiSupervisor,
                                       list[CellMember], dict]:
    """Child specs + supervisor + CellMember handles for ``n`` cells.

    Ports are pre-assigned so a supervisor relaunch rebinds the same
    address and the front's membership rejoins the cell automatically.
    Returns ``(supervisor, members, spec_fns)`` — ``spec_fns[cell_id]``
    rebuilds that cell's ChildSpec for a new checkpoint/args, which is
    what :class:`~eegnetreplication_tpu_torch.serve.cells.ha.RollingUpgrade`
    relaunches through.
    """
    run_dir = Path(run_dir)
    run_dir.mkdir(parents=True, exist_ok=True)
    factory = make_spec_factory(
        run_dir=run_dir, cells_dir=Path(cells_dir), host=host,
        replicas_per_cell=replicas_per_cell,
        session_snapshot_every=session_snapshot_every, mirror=mirror)
    specs, members, spec_fns = [], [], {}
    for i in range(n):
        cell_id = f"c{i}"
        port = free_port(host)
        spec_fn, spool, mirror_dir = factory(cell_id, port)
        spec_fns[cell_id] = spec_fn
        specs.append(spec_fn(checkpoint, serve_args))
        members.append(CellMember(cell_id, f"http://{host}:{port}",
                                  spool=spool, mirror=mirror_dir,
                                  journal=journal))
    policy = policy or supervise.SupervisorPolicy(
        grace_s=15.0, poll_s=0.25,
        # A bounced cell restores its OWN sessions on relaunch; the
        # front's failover covers the down window.
        resume_arg="--resume",
        thresholds={"startup": 300.0})
    sup = supervise.MultiSupervisor(specs, policy=policy, journal=journal)
    return sup, members, spec_fns


def main(argv=None) -> int:
    from eegnetreplication_tpu_torch.utils.device import platform_device

    stackdump.install()
    parser = argparse.ArgumentParser(
        prog="python -m eegnetreplication_tpu_torch.serve.cells",
        description="Multi-cell EEG serving: N independent cells behind a "
                    "front tier with session affinity, planned session "
                    "migration (drain), and cell-level failover.")
    parser.add_argument("--checkpoint", default=None,
                        help="Model checkpoint for spawned cells "
                             "(required unless --attachCells).")
    parser.add_argument("--cells", type=int, default=2,
                        help="Number of cells to spawn.")
    parser.add_argument("--attachCells", type=str, default=None,
                        help="Attach to EXISTING cells instead of "
                             "spawning: comma-separated "
                             "'id|url|spool[|mirror]' specs.  This is "
                             "how the second front of an HA pair binds "
                             "over the same cells (no supervisor, no "
                             "upgrade orchestration — the owner front "
                             "keeps those).")
    parser.add_argument("--ha", type=str, default=None,
                        help="Shared HA directory (lease file + affinity "
                             "WAL): run this front as one half of an "
                             "active/standby pair.  Both fronts must "
                             "point at the SAME directory.")
    parser.add_argument("--haOwner", type=str, default=None,
                        help="This front's identity in the HA pair "
                             "(default front-<port>).")
    parser.add_argument("--haTtlS", type=float, default=3.0,
                        help="Fencing-lease TTL: the active renews every "
                             "ttl/3; the standby may promote only after "
                             "a full TTL without a renew.")
    parser.add_argument("--replicasPerCell", type=int, default=1,
                        help="1 = each cell is one serve process; >1 = "
                             "each cell is a FleetApp supervising this "
                             "many replicas.")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8792,
                        help="Front listen port (0 = ephemeral).")
    parser.add_argument("--cellsDir", type=str, default=None,
                        help="SHARED storage root for per-cell session "
                             "spools (default checkpoints/serve_cells).  "
                             "Cross-cell failover restores from here, so "
                             "it must be reachable by the front.")
    parser.add_argument("--sessionSnapshotEvery", type=int, default=16,
                        help="Per-cell session snapshot cadence in decided "
                             "windows — the failover staleness bound.")
    parser.add_argument("--pollS", type=float, default=0.25,
                        help="Cell health-poll cadence.")
    parser.add_argument("--outlierK", type=float, default=0.0,
                        help="Cell-level latency-outlier ejection factor "
                             "(0 = off): a live cell whose rolling p95 "
                             "exceeds K x the cell median is ejected to "
                             "degraded and probe-readmitted.")
    parser.add_argument("--traceSample", type=float,
                        default=trace.DEFAULT_SAMPLE_RATE)
    parser.add_argument("--slo", type=str, default=None,
                        help="Forwarded to every cell (replica-level SLO "
                             "monitoring; breaches mirror up into the "
                             "cell's aggregate health).")
    parser.add_argument("--metricsDir", type=str, default=None)
    parser.add_argument("--startupTimeoutS", type=float, default=300.0)
    args = parser.parse_args(argv)
    if args.cells < 1:
        parser.error("--cells must be >= 1")
    if args.replicasPerCell < 1:
        parser.error("--replicasPerCell must be >= 1")
    if args.attachCells is None and not args.checkpoint:
        parser.error("--checkpoint is required unless --attachCells")
    attach_specs = []
    if args.attachCells:
        for item in args.attachCells.split(","):
            parts = item.strip().split("|")
            if len(parts) not in (3, 4) or not all(parts[:3]):
                parser.error(f"--attachCells: want 'id|url|spool[|mirror]'"
                             f", got {item!r}")
            attach_specs.append(parts)
    if args.slo:
        from eegnetreplication_tpu_torch.obs import slo as obs_slo

        try:
            obs_slo.parse_slo_spec(args.slo)
        except ValueError as exc:
            parser.error(f"--slo: {exc}")
    # The front runs no model: this only refuses a host without CUDA
    # (unless EEGTPU_PLATFORM=cpu) before any cell is spawned.
    platform_device()

    from eegnetreplication_tpu_torch.config import Paths

    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else Paths.from_here().reports / "obs")
    cells_dir = (Path(args.cellsDir) if args.cellsDir
                 else Paths.from_here().checkpoints / "serve_cells")
    serve_args = ["--traceSample", str(args.traceSample)]
    if args.slo:
        serve_args += ["--slo", args.slo]
    with obs_journal.run(metrics_dir, config=vars(args),
                         role="cells") as journal, preempt.guard():
        sup = sup_thread = None
        if attach_specs:
            # Attach mode: the cells already run (spawned by a peer
            # front or an operator) — this process is pure front tier.
            members = [CellMember(cid, url, spool=spool,
                                  mirror=(parts[3] if len(parts) == 4
                                          else None), journal=journal)
                       for parts in attach_specs
                       for cid, url, spool in [parts[:3]]]
            n_cells = len(members)
        else:
            sup, members, spec_fns = spawn_cells(
                args.checkpoint, args.cells, run_dir=journal.dir,
                cells_dir=cells_dir, host=args.host,
                replicas_per_cell=args.replicasPerCell,
                serve_args=serve_args,
                session_snapshot_every=args.sessionSnapshotEvery,
                journal=journal)
            n_cells = args.cells
            sup_thread = threading.Thread(target=sup.run,
                                          name="cells-supervisor",
                                          daemon=True)
            sup_thread.start()
        front = CellFront(members, host=args.host, port=args.port,
                          poll_s=args.pollS, outlier_k=args.outlierK,
                          trace_sample=args.traceSample, journal=journal)
        front.membership.start()
        if not front.membership.wait_live(n_cells,
                                          timeout_s=args.startupTimeoutS):
            live = len(front.membership.dispatchable())
            logger.warning("Only %d/%d cells live after %.0fs — serving "
                           "with what we have", live, n_cells,
                           args.startupTimeoutS)
        front.start()
        ha = None
        if args.ha:
            from eegnetreplication_tpu_torch.serve.cells.ha import HAController

            owner = args.haOwner or f"front-{front.address[1]}"
            ha = HAController(front, args.ha, owner=owner,
                              url=front.url, ttl_s=args.haTtlS,
                              journal=journal).start()
        if sup is not None:
            from eegnetreplication_tpu_torch.serve.cells.ha import RollingUpgrade

            front.upgrader = RollingUpgrade(
                front, sup,
                lambda cell_id, ckpt, sargs: spec_fns[cell_id](
                    ckpt or args.checkpoint,
                    sargs if sargs is not None else serve_args),
                journal=journal)
            for m in members:
                front.upgrader.set_current(m.cell_id, args.checkpoint,
                                           serve_args)
        print(f"cells serving at {front.url} "
              f"({len(front.membership.dispatchable())} live)", flush=True)
        try:
            while not preempt.requested():
                time.sleep(0.2)
        finally:
            logger.info("Cells stop requested — draining")
            if ha is not None:
                ha.close()
            front.stop()
            if sup is not None:
                sup.stop()
                sup_thread.join(timeout=60.0)
    return preempt.EX_PREEMPTED if preempt.requested() else 0


if __name__ == "__main__":
    raise SystemExit(main())
