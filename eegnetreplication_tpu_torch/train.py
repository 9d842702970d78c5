"""Training CLI: ``python -m eegnetreplication_tpu_torch.train``.

The counterpart of ``eegnetreplication_tpu/train.py``, with the same parser,
flag names and defaults (the reference's ``train.py:491-512`` plus the JAX
package's extensions), on the card unless ``EEGTPU_PLATFORM=cpu``.

Ported: ``--trainingType`` (``Within-Subject``, ``Cross-Subject``),
``--epochs``, ``--generateReport`` (``False`` means false, quirk Q5),
``--model`` (``eegnet``, ``eegnet_wide``), ``--seed``, ``--maxnormMode``,
``--bnMode``, ``--subjects``, ``--maxFoldsPerProgram`` (fold groups),
``--checkpointEvery`` and ``--resume`` (chunked runs with run snapshots),
``--metricsDir``, ``--chaos``, ``--profileDir`` and ``--debugNans``, with
the JAX CLI's parse-time errors.  A flag whose machinery is not ported
stops the CLI with a message naming ROADMAP.md instead of being ignored:
a device mesh larger than ``--meshFold 1 --meshData 1`` (one card runs a
1 x 1 mesh), ``--precision`` other than ``highest`` and ``--ckptFormat
orbax``.

Every run writes a journal, as the JAX CLI does: ``events.jsonl`` and
``metrics.json`` under ``<metricsDir>/<run_id>/`` (default
``reports/obs``), which ``scripts/obs_report.py`` reads.  ``--chaos``
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

SIGTERM or SIGINT stop the run at the next epoch or chunk boundary, once
the last submitted run snapshot is on disk, with exit code 75 and
``run_end`` status ``preempted``; rerun with ``--resume`` to continue.

    EEGTPU_DATA_ROOT=<tree> python -m eegnetreplication_tpu_torch.train --epochs 500
    EEGTPU_DATA_ROOT=<tree> python -m eegnetreplication_tpu_torch.train \
        --trainingType Cross-Subject --epochs 500 --resume
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
                        help="Model registry name (eegnet, eegnet_wide).")
    parser.add_argument("--seed", type=int, default=0, help="Seed.")
    parser.add_argument("--meshFold", type=int, default=None,
                        help="Fold-axis size of the device mesh (only 1: "
                             "one card).")
    parser.add_argument("--meshData", type=int, default=1,
                        help="Data-axis size of the device mesh (only 1).")
    parser.add_argument("--maxnormMode", type=str, default="reference",
                        choices=["reference", "paper"],
                        help="Max-norm behaviour: reference grad-clamp (Q1) "
                             "or true paper weight projection.")
    parser.add_argument("--precision", type=str, default="highest",
                        choices=["highest", "high", "default", "bf16"],
                        help="Model numerics; the port computes in full f32 "
                             "('highest') only.")
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
                        help="Native artifact format for saved models (npz; "
                             "orbax is not ported). The reference-interop "
                             ".pth export is always written.")
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
                             "Sites: train.step (if_folds_over=N), "
                             "train.chunk, train.hang (sleep=S), "
                             "checkpoint.write, checkpoint.write_async, "
                             "host.preempt (see resil/inject.py). Every "
                             "firing is journaled as a fault_injected "
                             "event.")
    return parser


def unported_flags(args: argparse.Namespace) -> list[str]:
    """The flags of ``args`` whose machinery the port does not have."""
    refused = []
    if args.meshFold not in (None, 1) or args.meshData != 1:
        refused.append("--meshFold/--meshData above 1 (a device mesh over "
                       "several cards: ROADMAP.md queue A.5; one card runs "
                       "the 1 x 1 mesh)")
    if args.precision != "highest":
        refused.append(f"--precision {args.precision} (TPU matmul modes; the "
                       "port computes in full f32)")
    if args.ckptFormat != "npz":
        refused.append("--ckptFormat orbax (ROADMAP.md queue A.1.iv: the "
                       "JAX package writes it through Orbax's "
                       "StandardCheckpointer in tensorstore's on-disk "
                       "format, which needs JAX, and the card's machine "
                       "has none; the .npz holds the same variables)")
    return refused


def main(argv=None) -> int:
    """CLI entry point; returns the exit code."""
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.training.protocols import (
        AUTO_CHUNK_THRESHOLD,
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    refused = unported_flags(args)
    if refused:
        parser.error("not ported to the torch package yet: "
                     + "; ".join(refused))
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
                                      bn_mode=args.bnMode)
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

    from pathlib import Path

    from eegnetreplication_tpu_torch import obs
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.resil import preempt
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

    device = select_device()
    paths = Paths.from_here()
    metrics_dir = (Path(args.metricsDir) if args.metricsDir
                   else paths.reports / "obs")
    train_fn = cross_subject_training if cross else within_subject_training
    if chaos_specs:
        logger.warning("Chaos plan armed: %s", args.chaos)
    if args.debugNans:
        logger.info("NaN debugging enabled (anomaly mode and a finiteness "
                    "check after every train step)")
    with obs.run(metrics_dir, config=config, mesh_shape=None,
                 tb_dir=args.profileDir, training_type=args.trainingType,
                 model=args.model, epochs=args.epochs, seed=args.seed,
                 subjects=list(subjects)) as journal, \
            preempt.guard(), inject.scoped(*chaos_specs):
        logger.info("Training %s model(s) on %s...", args.trainingType,
                    device)
        try:
            with trace(args.profileDir), debug_nans(args.debugNans):
                result = train_fn(
                    epochs=args.epochs, config=config, seed=args.seed,
                    model_name=args.model, subjects=subjects, paths=paths,
                    device=device, fold_batch=args.maxFoldsPerProgram,
                    checkpoint_every=args.checkpointEvery,
                    resume=args.resume)
        except preempt.Preempted as exc:
            # Raised at a safe point; the snapshot writer committed the
            # last submitted snapshot on the way out.  run_end is once
            # only, so the journal's own exit leaves it preempted.
            journal.run_end(status="preempted", error=str(exc))
            logger.warning("Preempted: %s", exc)
            return preempt.EX_PREEMPTED
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
