"""Inference CLI: ``python -m eegnetreplication_tpu_torch.predict``.

The counterpart of ``eegnetreplication_tpu/predict.py``: load a checkpoint
(native ``.npz``, Orbax directory or reference ``.pth``), classify trials
(a ``-trials.npz`` file, or a subject's processed session) on the card,
and report per-class counts plus accuracy, with the same stdout lines as
the JAX CLI.  It runs
the serving engine (``serve/engine.py``), so a CLI prediction and a served
one are the same computation, block-1 kernel included.  ``--zoo`` with
``--model`` resolves a tenant as ``serve --zoo`` does, and ``--precision
int8`` goes through the server's quant gate.

Examples:
    python -m eegnetreplication_tpu_torch.predict --checkpoint models/subject_01_best_model.npz --subject 1 --mode Eval
    python -m eegnetreplication_tpu_torch.predict --checkpoint models/cross_subject_best_model.pth --input data/processed/Eval/A05E-trials.npz
    python -m eegnetreplication_tpu_torch.predict --zoo models --model subject_03_best_model --subject 3 --precision int8
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.fused_eegnet import block1
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    PRECISIONS,
    bucket_ladder,
    build_gated_engine,
    load_model_from_checkpoint,
    model_digest,
)
from eegnetreplication_tpu_torch.utils.device import select_device
from eegnetreplication_tpu_torch.utils.logging import logger


def predict_trials(model, X: np.ndarray, batch_size: int = 256, *,
                   device: torch.device | str | None = None,
                   precision: str = "fp32") -> np.ndarray:
    """Class predictions for ``(n, C, T)`` trials: the serving engine's
    bucketed forward, capped at ``batch_size``.  ``precision="int8"`` goes
    through the server's gated builder, so the CLI and the server reach
    the same verdict (fp32 when the gate refuses)."""
    engine, _ = build_gated_engine(model, bucket_ladder(batch_size),
                                   precision=precision, warm=False,
                                   device=device)
    return engine.infer(np.asarray(X, np.float32))


def build_parser() -> argparse.ArgumentParser:
    """The CLI's flags (the GUI's evaluate command is held to them)."""
    parser = argparse.ArgumentParser(
        description="Classify EEG trials with a trained checkpoint.")
    parser.add_argument("--checkpoint", default=None,
                        help=".npz (native), an Orbax checkpoint directory "
                             "or .pth (reference format).  "
                             "Required unless --zoo is given.")
    parser.add_argument("--zoo", default=None,
                        help="Model-zoo spec ('id=path,...' pairs or a "
                             "checkpoint directory): the addressing the "
                             "serve --zoo flag uses, so a CLI --model and a "
                             "served X-Model resolve alike.")
    parser.add_argument("--model", default=None,
                        help="Model id to resolve through --zoo (a tenant "
                             "id, a variables-digest prefix, or 'default' "
                             "= the zoo's first entry).")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="A -trials.npz file to classify.")
    src.add_argument("--subject", type=int,
                     help="Classify this subject's processed session.")
    parser.add_argument("--mode", default="Eval", choices=["Train", "Eval"],
                        help="Session to use with --subject.")
    parser.add_argument("--batchSize", type=int, default=256)
    parser.add_argument("--precision", choices=list(PRECISIONS),
                        default="fp32",
                        help="Engine weight precision; int8 is gated by "
                             "the fp32-argmax equivalence check (falls "
                             "back to fp32 on refusal), as in the server.")
    return parser


def main(argv=None) -> int:
    device = select_device()
    parser = build_parser()
    args = parser.parse_args(argv)

    if bool(args.checkpoint) == bool(args.zoo):
        parser.error("exactly one of --checkpoint or --zoo is required")
    if args.model and not args.zoo:
        parser.error("--model requires --zoo (it names a zoo tenant)")
    if args.zoo:
        # The server's addressing (serve/zoo.py), then one load: a digest
        # prefix loads each tenant until it resolves.
        from eegnetreplication_tpu_torch.serve.zoo import (
            looks_like_digest,
            parse_zoo_spec,
            resolve_model_id,
        )

        try:
            mapping = parse_zoo_spec(args.zoo)
        except ValueError as exc:
            parser.error(f"--zoo: {exc}")
        digests: dict[str, str] = {}
        loaded: dict = {}
        if args.model and str(args.model) not in mapping \
                and looks_like_digest(str(args.model)):
            for mid, path in mapping.items():
                loaded[mid] = load_model_from_checkpoint(path, device=device)
                digests[mid] = model_digest(loaded[mid])
        try:
            model_id = resolve_model_id(list(mapping), args.model,
                                        next(iter(mapping)), digests)
        except KeyError as exc:
            parser.error(f"--model: {exc.args[0]}")
        logger.info("Zoo model %s -> %s", model_id, mapping[model_id])
        model = (loaded[model_id] if model_id in loaded
                 else load_model_from_checkpoint(mapping[model_id],
                                                 device=device))
    else:
        model = load_model_from_checkpoint(args.checkpoint, device=device)
    if args.input:
        from eegnetreplication_tpu_torch.data.io import load_trials

        ds = load_trials(args.input)
    else:
        from eegnetreplication_tpu_torch.data.io import load_subject_dataset

        ds = load_subject_dataset(subject=args.subject, mode=args.mode)

    t0 = time.perf_counter()
    pred = predict_trials(model, ds.X.astype(np.float32), args.batchSize,
                          device=device, precision=args.precision)
    wall = time.perf_counter() - t0
    logger.info("Inference: %.0f trials/s (%d trials in %.2fs), block1 "
                "kernel launches: %d", len(pred) / max(wall, 1e-9),
                len(pred), wall, block1.launches)
    counts = np.bincount(pred, minlength=len(CLASS_NAMES))
    for k, name in enumerate(CLASS_NAMES):
        logger.info("class %d (%s): %d trials", k, name, counts[k])
    if ds.y is not None and len(ds.y):
        acc = 100.0 * float(np.mean(pred == ds.y))
        logger.info("accuracy vs labels: %.2f%% (%d trials)", acc, len(pred))
        print(f"accuracy: {acc:.2f}%")
    else:
        print(f"predicted {len(pred)} trials: "
              + ", ".join(f"{n}={c}" for n, c in zip(CLASS_NAMES, counts)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
