"""Training CLI: ``python -m eegnetreplication_tpu_torch.train``.

The counterpart of ``eegnetreplication_tpu/train.py``, with the same parser,
flag names and defaults (the reference's ``train.py:491-512`` plus the JAX
package's extensions), on the card unless ``EEGTPU_PLATFORM=cpu``.

Ported: ``--trainingType`` (``Within-Subject``, ``Cross-Subject``),
``--epochs``, ``--generateReport`` (``False`` means false, quirk Q5),
``--model`` (``eegnet``, ``eegnet_wide``, ``shallow_convnet``,
``deep_convnet``), ``--seed``, ``--maxnormMode``,
``--bnMode``, ``--subjects``, ``--maxFoldsPerProgram`` (fold groups),
``--checkpointEvery`` and ``--resume`` (chunked runs with run snapshots),
``--metricsDir``, ``--chaos``, ``--profileDir``, ``--debugNans`` and the
device mesh ``--meshFold``/``--meshData``, and ``--precision`` (the four
numerics modes with their meaning on the card: ``config.py``), and
``--ckptFormat`` (``npz``, or ``orbax``: each best model as an Orbax
checkpoint directory ``<name>.orbax/``, ``training/orbax_io.py``, with
EEGNet's ``.pth`` beside it), with the JAX CLI's parse-time errors.

**The mesh.**  ``--meshFold N --meshData M`` (each >= 1; ``--meshFold``
unset means 1) trains over an ``N x M`` mesh of rank processes
(``parallel/``): the folds split into N blocks, one per fold line, and
every batch of a block splits over the M ranks of its line, with synced
BatchNorm and the gradients summed over them (``batch_size % M == 0``, the
JAX package's check).  On one card every rank runs on ``cuda:0`` and the
ranks' collectives go over gloo.  The CLI's process is the launcher
(``parallel/launch.py``): it forks the ranks before anything touches CUDA,
forwards SIGTERM/SIGINT to them, and exits with the world's code (75 when
the ranks stopped together at a chunk boundary, non-zero when any rank
failed, the others then killed).  Rank 0 alone writes the journal (its
``run_start`` carries ``mesh_shape``, its ``run_end`` the kernel launches
summed over the ranks, and ``run_start`` the slowest rank's start), the
report, the models, the run snapshots and the heartbeat; the best models equal those of a one-process run in groups of
``folds / N`` (``--maxFoldsPerProgram``) bit for bit.

Every run writes a journal, as the JAX CLI does: ``events.jsonl`` and
``metrics.json`` under ``<metricsDir>/<run_id>/`` (default
``reports/obs``), which ``scripts/obs_report.py`` reads; its ``run_end``
also holds the process's K1 and K1-stacked launches (``kernel_launches``)
and its peak device memory (``peak_memory_bytes``).  ``--chaos``
arms the port's fault-injection sites (``resil/inject.py``) for the run;
a plan naming a site the port lacks is refused here.  ``--profileDir``
writes a ``torch.profiler`` Chrome trace of the whole training call there
(and the TensorBoard scalars, where ``torch.utils.tensorboard`` imports).

``--debugNans`` has no exact twin of ``jax_debug_nans``, which stops at
the first op whose output holds a NaN.  Here each train step's backward
runs in autograd's anomaly mode with NaN checks (it names the backward
function that made a NaN), and after each step every fold's loss,
parameters and BatchNorm statistics must be finite, or the run raises
``FloatingPointError`` naming the epoch, step, fold and tensor.  It does
not look inside the forward pass (a NaN there shows up in the backward or
the loss), nor at validation, test or preprocessing, and an infinity in
the backward pass is caught only once it reaches a checked tensor.  It
waits for the device at every backward node and every step: at 8 folds on
an NVIDIA H100 80GB HBM3 at 700 W it trained 10.2 fold-epochs/s against
70.5 unchecked (``chip_smoke.py``, ``PERF.md``).

When a supervisor sets ``EEGTPU_HEARTBEAT_FILE`` (``python -m
eegnetreplication_tpu_torch.resil.supervise -- python -m
eegnetreplication_tpu_torch.train ...``), the run beats that file: phase
``compile`` before a fold group's first epoch, ``step`` after every epoch
and at every chunk boundary (``training/loop.py``), so the supervisor's
watchdog sees a hung run.  Without the variable the beats stay in memory.

SIGTERM or SIGINT stop the run at the next epoch or chunk boundary, once
the last submitted run snapshot is on disk, with exit code 75 and
``run_end`` status ``preempted``; rerun with ``--resume`` to continue.

    EEGTPU_DATA_ROOT=<tree> python -m eegnetreplication_tpu_torch.train --epochs 500
    EEGTPU_DATA_ROOT=<tree> python -m eegnetreplication_tpu_torch.train \
        --trainingType Cross-Subject --epochs 500 --resume
    EEGTPU_DATA_ROOT=<tree> python -m eegnetreplication_tpu_torch.train \
        --model shallow_convnet --epochs 500

EEGNet's conv schedule is ``EEGTPU_CONV_IMPL`` (``banded`` or ``lax``;
``models/eegnet.py::resolve_conv_impl``), as in the JAX package.
"""

from __future__ import annotations

import argparse

from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
from eegnetreplication_tpu_torch.utils.logging import logger


def str2bool(value: str | bool) -> bool:
    """``--generateReport False`` must actually mean false (quirk Q5)."""
    if isinstance(value, bool):
        return value
    if value.lower() in ("true", "1", "yes", "y"):
        return True
    if value.lower() in ("false", "0", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"Expected a boolean, got {value!r}")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train a EEGNet model.")
    parser.add_argument("--trainingType", type=str, default="Within-Subject",
                        help="Training type [Cross-Subject, Within-Subject].")
    parser.add_argument("--epochs", type=int, default=DEFAULT_TRAINING.epochs,
                        help="Number of training epochs.")
    parser.add_argument("--generateReport", type=str2bool, default=True,
                        help="Generate report after training.")
    parser.add_argument("--model", type=str, default="eegnet",
                        help="Model registry name (eegnet, eegnet_wide, "
                             "shallow_convnet, deep_convnet).")
    parser.add_argument("--seed", type=int, default=0, help="Seed.")
    parser.add_argument("--meshFold", type=int, default=None,
                        help="Fold-axis size of the device mesh: the folds "
                             "split over this many rank processes "
                             "(default 1).")
    parser.add_argument("--meshData", type=int, default=1,
                        help="Data-axis size of the device mesh: every "
                             "batch splits over this many rank processes "
                             "(synced BatchNorm, summed gradients).")
    parser.add_argument("--maxnormMode", type=str, default="reference",
                        choices=["reference", "paper"],
                        help="Max-norm behaviour: reference grad-clamp (Q1) "
                             "or true paper weight projection.")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "high", "default", "bf16"],
                        help="Model numerics on the card: 'highest' = full "
                             "f32, TF32 off (parity with the torch-f32 "
                             "reference); 'high' = TF32 matmuls and "
                             "convolutions (JAX Precision.HIGH on an "
                             "H100); 'default' = the backend default, TF32 "
                             "on this card, the same numerics as 'high'; "
                             "'bf16' = bf16 activations end to end, f32 "
                             "parameters, BatchNorm and loss.  On the CPU "
                             "'high' and 'default' compute in f32.")
    parser.add_argument("--bnMode", type=str, default="flax",
                        choices=["flax", "torch"],
                        help="BatchNorm training semantics: 'torch' masks "
                             "padded batch slots out of the statistics and "
                             "updates the running variance unbiased (the "
                             "reference's exact semantics); 'flax' is "
                             "nn.BatchNorm.  Eval is identical either way.")
    parser.add_argument("--subjects", type=str, default=None,
                        help="Comma-separated subject ids (default: 1-9).")
    parser.add_argument("--profileDir", type=str, default=None,
                        help="Write a torch.profiler Chrome trace of the "
                             "training call (CPU and CUDA activity) here.")
    parser.add_argument("--metricsDir", type=str, default=None,
                        help="Telemetry root: the run journal "
                             "(events.jsonl) and metrics.json land in "
                             "<metricsDir>/<run_id>/ (default: "
                             "reports/obs).")
    parser.add_argument("--ckptFormat", type=str, default="npz",
                        choices=["npz", "orbax"],
                        help="Native artifact format for saved models (npz, "
                             "or orbax: an Orbax checkpoint directory). The "
                             "reference-interop .pth export is always "
                             "written.")
    parser.add_argument("--maxFoldsPerProgram", type=int, default=None,
                        help="Train at most N folds at once, group after "
                             "group. Default: Cross-Subject on a card uses "
                             "the group size measured there "
                             "(CS_CARD_FOLD_BATCH); 0 forces one group.")
    parser.add_argument("--checkpointEvery", type=int, default=None,
                        help="Snapshot the run every N epochs; a stopped "
                             "run continues from the last snapshot with "
                             "--resume. Default: auto, runs over 100 "
                             "epochs chunk at ~50 epochs. 0 forces one "
                             "pass.")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the run snapshot if one exists "
                             "(needs a chunked run: the auto default over "
                             "100 epochs, or a positive --checkpointEvery).")
    parser.add_argument("--debugNans", action="store_true",
                        help="Check every train step for NaN and inf "
                             "(anomaly mode in the backward pass, every "
                             "fold's loss and state after the step); slow.")
    parser.add_argument("--chaos", type=str, default=None,
                        help="Fault injection plan: comma-separated "
                             "site[:key=value...] specs or @plan.json. "
                             "Sites: data.read, train.step "
                             "(if_folds_over=N), train.chunk, train.hang "
                             "(sleep=S), "
                             "checkpoint.write, checkpoint.write_async, "
                             "host.preempt (see resil/inject.py). Every "
                             "firing is journaled as a fault_injected "
                             "event.")
    return parser


def _card_record(mesh=None) -> dict:
    """What this process ran on the card, for ``run_end``: its launches of
    the hand kernels (0 on the CPU, where the plain versions run) and the
    peak device memory it allocated (``None`` on the CPU).  Under a mesh
    of ranks (a collective every rank makes) the launches are summed over
    the ranks, listed by rank beside, and the peak is the largest
    rank's."""
    import torch

    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_stacked,
    )

    peak = (int(torch.cuda.max_memory_allocated())
            if torch.cuda.is_initialized() else None)
    counts = {"block1": block1.launches,
              "block1_stacked": block1_stacked.launches}
    if mesh is None or mesh.size == 1:
        return {"kernel_launches": counts, "peak_memory_bytes": peak}
    import torch.distributed as dist

    rows = [None] * mesh.size
    dist.all_gather_object(rows, (counts, peak))
    peaks = [p for _, p in rows if p is not None]
    return {"kernel_launches": {k: sum(c[k] for c, _ in rows)
                                for k in counts},
            "kernel_launches_by_rank": {k: [c[k] for c, _ in rows]
                                        for k in counts},
            "peak_memory_bytes": max(peaks) if peaks else None}


def mesh_dims(args: argparse.Namespace) -> tuple[int, int]:
    """``(meshFold, meshData)`` of the parsed flags."""
    return (args.meshFold if args.meshFold is not None else 1,
            args.meshData)


def main(argv=None) -> int:
    """CLI entry point; returns the exit code."""
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.training.protocols import (
        AUTO_CHUNK_THRESHOLD,
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    try:
        # At the CLI boundary: a plan's typo fails here, not minutes in.
        chaos_specs = inject.parse_plan(args.chaos) if args.chaos else []
    except (ValueError, OSError) as exc:
        parser.error(f"--chaos: {exc}")
    if args.epochs < 1:
        parser.error("--epochs must be >= 1")
    if args.checkpointEvery is not None and args.checkpointEvery < 0:
        parser.error("--checkpointEvery must be >= 0")
    if args.resume and args.checkpointEvery == 0:
        parser.error("--resume needs a chunked run: drop --checkpointEvery 0 "
                     "(auto) or pass a positive cadence")
    if (args.resume and args.checkpointEvery is None
            and args.epochs <= AUTO_CHUNK_THRESHOLD):
        parser.error(
            f"--resume with {args.epochs} epochs: auto-chunking only "
            f"engages above {AUTO_CHUNK_THRESHOLD} epochs — pass an "
            "explicit positive --checkpointEvery")
    config = DEFAULT_TRAINING.replace(maxnorm_mode=args.maxnormMode,
                                      precision=args.precision,
                                      bn_mode=args.bnMode)
    n_fold, n_data = mesh_dims(args)
    if n_fold < 1 or n_data < 1:
        parser.error(f"--meshFold and --meshData must be >= 1; got "
                     f"{n_fold} x {n_data}")
    if config.batch_size % n_data:
        parser.error(
            f"batch_size {config.batch_size} is not divisible by the mesh "
            f"data axis ({n_data}); pick batch_size % meshData == 0")
    subjects = (tuple(int(s) for s in args.subjects.split(","))
                if args.subjects else tuple(range(1, 10)))
    cross = args.trainingType != "Within-Subject"
    if cross and len(subjects) < config.cs_train_subjects + 2:
        # Each fold needs cs_train_subjects train + >= 1 validation + 1
        # held-out test subject (train.py:199-202).
        raise SystemExit(
            f"Cross-Subject training needs at least "
            f"{config.cs_train_subjects + 2} subjects "
            f"({config.cs_train_subjects} train + 1 val + 1 test); got "
            f"{len(subjects)}.")

    # Everything the ranks run is imported before they are forked.
    from eegnetreplication_tpu_torch.training import (  # noqa: F401
        protocols,
        report,
    )

    if n_fold * n_data > 1:
        from eegnetreplication_tpu_torch.parallel import launch

        logger.info("Launching a %d x %d mesh of rank processes", n_fold,
                    n_data)
        return launch.launch(_mesh_rank, n_fold * n_data,
                             (args, config, subjects, chaos_specs))
    mesh_shape = ({"fold": 1, "data": 1, "model": 1}
                  if args.meshFold is not None else None)
    return _train(args, config, subjects, chaos_specs, None, mesh_shape)


def _mesh_rank(args, config, subjects, chaos_specs) -> int:
    """One rank of ``--meshFold x --meshData``: join the mesh, and train
    its part.  Only rank 0 beats the heartbeat file."""
    import os

    from eegnetreplication_tpu_torch.parallel.mesh import make_mesh
    from eegnetreplication_tpu_torch.resil import heartbeat

    n_fold, n_data = mesh_dims(args)
    mesh = make_mesh(n_fold=n_fold, n_data=n_data)
    if not mesh.is_lead:
        os.environ.pop(heartbeat.HEARTBEAT_FILE_ENV, None)
        heartbeat.reset_default()
    return _train(args, config, subjects, chaos_specs, mesh,
                  dict(mesh.shape))


def _train(args, config, subjects, chaos_specs, mesh, mesh_shape) -> int:
    """The run of one process: the whole run, or one rank's part of it
    under ``mesh`` (rank 0 journaling and reporting)."""
    import contextlib
    from pathlib import Path

    from eegnetreplication_tpu_torch import obs
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.obs.journal import NullJournal
    from eegnetreplication_tpu_torch.parallel import launch
    from eegnetreplication_tpu_torch.resil import inject, preempt
    from eegnetreplication_tpu_torch.training.loop import debug_nans
    from eegnetreplication_tpu_torch.training.protocols import (
        cross_subject_training,
        within_subject_training,
    )
    from eegnetreplication_tpu_torch.training.report import (
        generate_cs_report,
        generate_ws_report,
    )
    from eegnetreplication_tpu_torch.utils.device import select_device
    from eegnetreplication_tpu_torch.utils.profiling import trace

    cross = args.trainingType != "Within-Subject"
    lead = mesh is None or mesh.is_lead
    device = select_device()
    mesh_fields = {}
    info = launch.rank_info()
    if info is not None and mesh is not None:
        # The slowest rank's join and its device ready (the card's context
        # and the numerics pins), from the launch, for run_start.
        join_s, ready_s = _slowest(info.join_s, info.since_launch())
        mesh_fields = {"world_size": info.world_size,
                       "rank_join_s": round(join_s, 3),
                       "rank_start_s": round(ready_s, 3)}
        logger.info("Mesh %s: every rank joined within %.2f s of the "
                    "launch and had its device within %.2f s", mesh_shape,
                    join_s, ready_s)
    paths = Paths.from_here()
    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else paths.reports / "obs")
    train_fn = cross_subject_training if cross else within_subject_training
    if chaos_specs:
        logger.warning("Chaos plan armed: %s", args.chaos)
    if args.debugNans:
        logger.info("NaN debugging enabled (anomaly mode and a finiteness "
                    "check after every train step)")
    run = (obs.run(metrics_dir, config=config, mesh_shape=mesh_shape,
                   tb_dir=args.profileDir, training_type=args.trainingType,
                   model=args.model, epochs=args.epochs, seed=args.seed,
                   subjects=list(subjects), **mesh_fields) if lead
           else contextlib.nullcontext(NullJournal()))
    with run as journal, preempt.guard(), inject.scoped(*chaos_specs):
        logger.info("Training %s model(s) on %s...", args.trainingType,
                    device)
        try:
            with trace(args.profileDir), debug_nans(args.debugNans):
                result = train_fn(
                    epochs=args.epochs, config=config, seed=args.seed,
                    model_name=args.model, subjects=subjects, paths=paths,
                    device=device, fold_batch=args.maxFoldsPerProgram,
                    checkpoint_every=args.checkpointEvery,
                    resume=args.resume, mesh=mesh,
                    ckpt_format=args.ckptFormat)
        except preempt.Preempted as exc:
            # Raised at a safe point; the snapshot writer committed the
            # last submitted snapshot on the way out.  run_end is once
            # only, so the journal's own exit leaves it preempted.
            journal.run_end(status="preempted", error=str(exc),
                            **_card_record(mesh))
            logger.warning("Preempted: %s", exc)
            return preempt.EX_PREEMPTED
        record = _card_record(mesh)
        if not lead:
            return 0
        logger.info("Epoch throughput: %.1f fold-epochs/s",
                    result.epoch_throughput)
        journal.metrics.set("epoch_throughput", result.epoch_throughput)
        journal.metrics.set("wall_seconds_training", result.wall_seconds)
        journal.metrics.set("avg_test_acc", result.avg_test_acc)
        journal.sample_device_memory()
        if args.generateReport:
            if cross:
                generate_cs_report(result.best_states[0],
                                   result.per_subject_test_acc,
                                   result.avg_test_acc, epochs=args.epochs,
                                   subjects=result.subjects, config=config,
                                   paths=paths)
            else:
                generate_ws_report(result.per_subject_test_acc,
                                   result.avg_test_acc, result.best_states,
                                   epochs=args.epochs,
                                   subjects=result.subjects, config=config,
                                   paths=paths)
        journal.run_end(status="ok", **record)
    return 0


def _slowest(*seconds: float) -> list[float]:
    """The largest value of each over the ranks: a collective every rank
    makes."""
    import torch
    import torch.distributed as dist

    slowest = torch.tensor(seconds, dtype=torch.float64)
    dist.all_reduce(slowest, op=dist.ReduceOp.MAX)
    return [float(v) for v in slowest]


if __name__ == "__main__":
    raise SystemExit(main())
