"""Training CLI: ``python -m eegnetreplication_tpu_torch.train``.

The counterpart of ``eegnetreplication_tpu/train.py``, with the same parser,
flag names and defaults (the reference's ``train.py:491-512`` plus the JAX
package's extensions), on the card unless ``EEGTPU_PLATFORM=cpu``.

Ported: ``--trainingType`` (``Within-Subject``, ``Cross-Subject``),
``--epochs``, ``--generateReport`` (``False`` means false, quirk Q5),
``--model`` (``eegnet``, ``eegnet_wide``), ``--seed``, ``--maxnormMode``,
``--bnMode``, ``--subjects``, ``--maxFoldsPerProgram`` (fold groups),
``--checkpointEvery`` and ``--resume`` (chunked runs with run snapshots),
with the JAX CLI's parse-time errors.  A flag whose machinery is not
ported stops the CLI with a message naming ROADMAP.md instead of being
ignored: ``--meshFold``, ``--meshData`` above 1, ``--precision`` other
than ``highest``, ``--ckptFormat orbax``, ``--chaos``, ``--metricsDir``,
``--profileDir`` and ``--debugNans``.  SIGTERM or SIGINT stop the run at
the next epoch or chunk boundary, once the last submitted run snapshot is
on disk, with exit code 75; rerun with ``--resume`` to continue.

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
                        help="Fold-axis size of the device mesh (not "
                             "ported).")
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
                        help="Profiler trace directory (not ported).")
    parser.add_argument("--metricsDir", type=str, default=None,
                        help="Telemetry root (not ported).")
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
                        help="Numerics sanitizer (not ported).")
    parser.add_argument("--chaos", type=str, default=None,
                        help="Fault injection plan (not ported).")
    return parser


def unported_flags(args: argparse.Namespace) -> list[str]:
    """The flags of ``args`` whose machinery the port does not have."""
    refused = []
    if args.meshFold is not None or args.meshData != 1:
        refused.append("--meshFold/--meshData (the device mesh: ROADMAP.md "
                       "queue A.5)")
    if args.precision != "highest":
        refused.append(f"--precision {args.precision} (TPU matmul modes; the "
                       "port computes in full f32)")
    if args.ckptFormat != "npz":
        refused.append("--ckptFormat orbax (Orbax checkpoints: ROADMAP.md "
                       "queue A.1)")
    for flag, value in (("--chaos", args.chaos),
                        ("--metricsDir", args.metricsDir),
                        ("--profileDir", args.profileDir),
                        ("--debugNans", args.debugNans)):
        if value:
            refused.append(f"{flag} (obs and resil tooling: ROADMAP.md "
                           "queue A.5)")
    return refused


def main(argv=None) -> int:
    """CLI entry point; returns the exit code."""
    from eegnetreplication_tpu_torch.training.protocols import (
        AUTO_CHUNK_THRESHOLD,
    )

    parser = build_parser()
    args = parser.parse_args(argv)
    refused = unported_flags(args)
    if refused:
        parser.error("not ported to the torch package yet: "
                     + "; ".join(refused))
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

    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.resil import preempt
    from eegnetreplication_tpu_torch.training.protocols import (
        cross_subject_training,
        within_subject_training,
    )
    from eegnetreplication_tpu_torch.training.report import (
        generate_cs_report,
        generate_ws_report,
    )
    from eegnetreplication_tpu_torch.utils.device import select_device

    device = select_device()
    paths = Paths.from_here()
    train_fn = cross_subject_training if cross else within_subject_training
    logger.info("Training %s model(s) on %s...", args.trainingType, device)
    with preempt.guard():
        try:
            result = train_fn(
                epochs=args.epochs, config=config, seed=args.seed,
                model_name=args.model, subjects=subjects, paths=paths,
                device=device, fold_batch=args.maxFoldsPerProgram,
                checkpoint_every=args.checkpointEvery, resume=args.resume)
        except preempt.Preempted as exc:
            # Raised at a safe point; the snapshot writer committed the
            # last submitted snapshot on the way out.
            logger.warning("Preempted: %s", exc)
            return preempt.EX_PREEMPTED
    logger.info("Epoch throughput: %.1f fold-epochs/s",
                result.epoch_throughput)
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
                               epochs=args.epochs, subjects=result.subjects,
                               config=config, paths=paths)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
