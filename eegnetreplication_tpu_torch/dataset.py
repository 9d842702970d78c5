"""Dataset CLI: ``python -m eegnetreplication_tpu_torch.dataset``.

The counterpart of ``eegnetreplication_tpu/dataset.py``, with its flags:
``--src kaggle`` preprocesses ``data/raw/{Train,Eval}/*.gdf`` into
``data/processed/{Train,Eval}``, two plain ``.npz`` files per recording,
with the JAX package's names and keys:

- ``A01T-preprocessed.npz``: the continuous standardized 22-channel 128 Hz
  signal plus events;
- ``A01T-trials.npz``: the epoched ``(n, 22, 257)`` trials and labels.

``--src moabb`` preprocesses the per-run ``.fif`` files that ``fetch --src
moabb`` wrote under ``data/moabb/{Train,Eval}`` into
``data/moabb_processed/{Train,Eval}`` (``data/moabb.py``; reading a
``.fif`` needs MNE), with the same two files per session.

It runs on ``cuda:0`` unless ``EEGTPU_PLATFORM=cpu``; without CUDA it
raises.  ``EEGTPU_EMS_METHOD=pallas`` runs the EMS stage in the CUDA kernel
K2, one launch per recording (per run, for moabb).  ``EEGTPU_DATA_ROOT``
moves the data tree.
"""

from __future__ import annotations

import argparse

import torch

from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.utils.device import resolve_device, select_device
from eegnetreplication_tpu_torch.utils.logging import logger


def build_processed_tree(paths: Paths | None = None, *,
                         device: torch.device | str | None = None) -> None:
    """Preprocess and epoch both splits of the kaggle GDF layout on
    ``device`` (``None`` selects one through ``utils/device.py``)."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.epoching import (
        break_recording_into_epochs,
    )
    from eegnetreplication_tpu_torch.data.io import save_trials, trials_filename
    from eegnetreplication_tpu_torch.data.preprocess import preprocess_raw_data

    paths = paths or Paths.from_here()
    dev = resolve_device(device)
    for mode in ("Train", "Eval"):
        out_dir = paths.data_processed / mode
        out_dir.mkdir(parents=True, exist_ok=True)
        written = preprocess_raw_data(paths.data_raw / mode, out_dir,
                                      device=dev)
        for npz in written:
            X, y = break_recording_into_epochs(npz, mode=mode, paths=paths)
            stem = npz.name[:4]  # A01T
            subject = int(stem[1:3])
            save_trials(BCICI2ADataset(X=X, y=y),
                        out_dir / trials_filename(subject, mode))
            logger.info("Epoched %s: %d trials", stem, len(y))


def main(argv=None) -> int:
    device = select_device()
    parser = argparse.ArgumentParser(
        description="Preprocess BCI Competition IV Dataset 2a from source.")
    parser.add_argument("--src", default="kaggle",
                        help="Specify source (options: kaggle, moabb).")
    args = parser.parse_args(argv)

    if args.src not in ("kaggle", "moabb"):
        logger.error("Unknown source specified: %s", args.src)
        raise ValueError(f"Unknown source: {args.src}")

    logger.info("Preprocessing data from source: %s on %s", args.src, device)
    if args.src == "kaggle":
        build_processed_tree(device=device)
    else:
        # The reference's moabb path is broken (quirk Q3); the JAX
        # package's repair shares the kaggle path's chain and needs MNE
        # only to read the fetched .fif runs.
        from eegnetreplication_tpu_torch.data.moabb import (
            preprocess_moabb_data,
        )

        preprocess_moabb_data(device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
