"""Inference CLI: ``python -m eegnetreplication_tpu_torch.predict``.

The counterpart of ``eegnetreplication_tpu/predict.py``: load a checkpoint
(native ``.npz`` or reference ``.pth``), classify trials (a ``-trials.npz``
file, or a subject's processed session) on the card, and report per-class
counts plus accuracy, with the same stdout lines as the JAX CLI.  It runs
the serving engine (``serve/engine.py``), so a CLI prediction and a served
one are the same computation, block-1 kernel included.

Examples:
    python -m eegnetreplication_tpu_torch.predict --checkpoint models/subject_01_best_model.npz --subject 1 --mode Eval
    python -m eegnetreplication_tpu_torch.predict --checkpoint models/cross_subject_best_model.pth --input data/processed/Eval/A05E-trials.npz
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from eegnetreplication_tpu_torch.ops.fused_eegnet import block1
from eegnetreplication_tpu_torch.serve.engine import (
    CLASS_NAMES,
    InferenceEngine,
    bucket_ladder,
    load_model_from_checkpoint,
)
from eegnetreplication_tpu_torch.utils.device import select_device
from eegnetreplication_tpu_torch.utils.logging import logger


def predict_trials(model, X: np.ndarray, batch_size: int = 256, *,
                   device: torch.device | str | None = None) -> np.ndarray:
    """Class predictions for ``(n, C, T)`` trials: the serving engine's
    bucketed forward, capped at ``batch_size``."""
    engine = InferenceEngine(model, bucket_ladder(batch_size), device=device)
    return engine.infer(np.asarray(X, np.float32))


def main(argv=None) -> int:
    device = select_device()
    parser = argparse.ArgumentParser(
        description="Classify EEG trials with a trained checkpoint.")
    parser.add_argument("--checkpoint", required=True,
                        help=".npz (native) or .pth (reference format).")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="A -trials.npz file to classify.")
    src.add_argument("--subject", type=int,
                     help="Classify this subject's processed session.")
    parser.add_argument("--mode", default="Eval", choices=["Train", "Eval"],
                        help="Session to use with --subject.")
    parser.add_argument("--batchSize", type=int, default=256)
    args = parser.parse_args(argv)

    model = load_model_from_checkpoint(args.checkpoint, device=device)
    if args.input:
        from eegnetreplication_tpu_torch.data.io import load_trials

        ds = load_trials(args.input)
    else:
        from eegnetreplication_tpu_torch.data.io import load_subject_dataset

        ds = load_subject_dataset(subject=args.subject, mode=args.mode)

    t0 = time.perf_counter()
    pred = predict_trials(model, ds.X.astype(np.float32), args.batchSize,
                          device=device)
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
