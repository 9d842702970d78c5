"""Dataset CLI: ``python -m eegnetreplication_tpu_torch.dataset``.

The counterpart of ``eegnetreplication_tpu/dataset.py``, with its flags:
``--src kaggle`` preprocesses ``data/raw/{Train,Eval}/*.gdf`` into
``data/processed/{Train,Eval}``, two plain ``.npz`` files per recording,
with the JAX package's names and keys:

- ``A01T-preprocessed.npz``: the continuous standardized 22-channel 128 Hz
  signal plus events;
- ``A01T-trials.npz``: the epoched ``(n, 22, 257)`` trials and labels.

It runs on ``cuda:0`` unless ``EEGTPU_PLATFORM=cpu``; without CUDA it
raises.  ``EEGTPU_EMS_METHOD=pallas`` runs the EMS stage in the CUDA kernel
K2.  ``EEGTPU_DATA_ROOT`` moves the data tree.  ``--src moabb`` needs MNE
and the network and is not ported yet (``ROADMAP.md``).
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

    if args.src == "moabb":
        raise NotImplementedError(
            "--src moabb (MNE and a network fetch) is not ported to the "
            "torch port yet; see ROADMAP.md.  Use --src kaggle with the GDF "
            "files under data/raw/.")
    if args.src != "kaggle":
        logger.error("Unknown source specified: %s", args.src)
        raise ValueError(f"Unknown source: {args.src}")

    logger.info("Preprocessing data from source: %s on %s", args.src, device)
    build_processed_tree(device=device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
