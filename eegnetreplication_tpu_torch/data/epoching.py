"""Trial extraction: continuous recordings -> (n_trials, 22, 257) windows.

The port's copy of ``eegnetreplication_tpu/data/epoching.py`` (numpy and
scipy only, and MNE to read the reference's ``.fif`` files; its output is
byte-equal to the JAX package's).

Native counterpart of ``break_data_into_epochs`` / ``map_labels`` /
``build_dataset_from_preprocessed`` (``src/eegnet_repl/dataset.py:132-281``),
working directly on GDF event codes.

A note on the reference's subject-4 special case (``dataset.py:200-212``):
MNE renumbers annotation descriptions to dense ids alphabetically, so a file
missing the idling annotations (A04T) shifts every cue id by 2 and the
reference keeps two event-id tables.  This layer selects trials by the raw
GDF codes (769-772 cues, 783 unknown cue), which are stable across files, so
the special case dissolves — behavior is identical, by construction, for all
subjects.

Eval-session labels: the unknown-cue (783) trials get their true classes from
the competition's ``TrueLabels/A0xE.mat`` files (``dataset.py:229-234``),
1-based ``classlabel`` mapped to 0..3.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.config import (
    EPOCH_TMAX_S,
    EPOCH_TMIN_S,
    Paths,
)
from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset, concat_datasets
from eegnetreplication_tpu_torch.data.preprocess import ProcessedRecording
from eegnetreplication_tpu_torch.utils.logging import logger

# GDF event codes of the BCI Competition IV 2a paradigm.
CUE_LEFT, CUE_RIGHT, CUE_FOOT, CUE_TONGUE = 769, 770, 771, 772
CUE_UNKNOWN = 783
TRIAL_START, REJECTED_TRIAL = 768, 1023
TRAIN_CUE_TO_CLASS = {CUE_LEFT: 0, CUE_RIGHT: 1, CUE_FOOT: 2, CUE_TONGUE: 3}
TRUE_LABEL_TO_CLASS = {1: 0, 2: 1, 3: 2, 4: 3}  # dataset.py:215


def map_labels(labels: np.ndarray, map: dict) -> np.ndarray:
    """Remap label values; error on unmapped, warn on missing classes.

    Signature-and-semantics twin of ``map_labels`` (``dataset.py:132-156``):
    unmapped input values would silently collapse to 0, so any value outside
    the map raises; absent classes only warn.
    """
    labels = np.asarray(labels)
    new_labels = np.zeros_like(labels)
    for old_label, new_label in map.items():
        new_labels[labels == old_label] = new_label

    if not set(np.unique(labels).tolist()).issubset(set(map.keys())):
        raise RuntimeError("Not all labels were mapped.")
    if set(map.values()) != set(new_labels.tolist()):
        logger.warning("Some classes are missing from the labels.")
    return new_labels


def _window_bounds(sfreq: float, tmin: float = EPOCH_TMIN_S,
                   tmax: float = EPOCH_TMAX_S) -> tuple[int, int]:
    """Sample offsets of the trial window relative to cue onset.

    Inclusive endpoints like ``mne.Epochs(tmin=0.5, tmax=2.5)``
    (``dataset.py:223-224``): at 128 Hz this is samples 64..320 -> 257.
    """
    start = int(round(tmin * sfreq))
    stop = int(round(tmax * sfreq)) + 1
    return start, stop


def extract_epochs(data: np.ndarray, sfreq: float, event_pos: np.ndarray,
                   event_typ: np.ndarray, mode: str = "Train",
                   tmin: float = EPOCH_TMIN_S, tmax: float = EPOCH_TMAX_S,
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Cut cue-aligned trial windows out of a continuous recording.

    Returns ``(X, labels, kept)``: ``X (n, C, T)``; for Train, ``labels`` are
    classes 0..3 from the cue codes; for Eval they are zeros (the caller
    overlays TrueLabels); ``kept`` are the indices *within the selected cue
    events* that fit the recording (out-of-bounds windows drop with a log,
    like MNE's TOO_SHORT drops).
    """
    if mode == "Train":
        sel = np.isin(event_typ, list(TRAIN_CUE_TO_CLASS))
    elif mode == "Eval":
        sel = event_typ == CUE_UNKNOWN
    else:
        raise ValueError(f"Unknown training mode: {mode}")
    cue_pos = event_pos[sel]
    cue_typ = event_typ[sel]

    rel_start, rel_stop = _window_bounds(sfreq, tmin, tmax)
    n_times = rel_stop - rel_start
    starts = cue_pos + rel_start
    in_bounds = (starts >= 0) & (starts + n_times <= data.shape[1])
    if not np.all(in_bounds):
        logger.info("Dropping %d/%d epochs outside recording bounds",
                    int(np.sum(~in_bounds)), len(cue_pos))
    kept = np.nonzero(in_bounds)[0]

    # One vectorized gather: (n, T) index grid per channel.
    idx = starts[kept][:, None] + np.arange(n_times)[None, :]
    X = data[:, idx].transpose(1, 0, 2).astype(np.float32)

    if mode == "Train":
        labels = map_labels(cue_typ[kept], TRAIN_CUE_TO_CLASS)
    else:
        labels = np.zeros(len(kept), dtype=np.int64)
    return X, labels.astype(np.int64), kept


def load_true_labels(session_stem: str, paths: Paths | None = None) -> np.ndarray:
    """Load the competition's true Eval labels for e.g. ``A01E`` (0-based).

    ``data/raw/TrueLabels/A0xE.mat`` holds 1-based ``classlabel``
    (``dataset.py:229-234``).
    """
    from scipy import io as scipy_io

    paths = paths or Paths.from_here()
    mat_path = paths.data_raw / "TrueLabels" / f"{session_stem}.mat"
    if not mat_path.exists():
        raise FileNotFoundError(
            f"True labels not found at {mat_path}; the Eval session needs "
            f"the competition's TrueLabels .mat files under data/raw/."
        )
    mat = scipy_io.loadmat(file_name=mat_path, squeeze_me=True)
    return map_labels(np.asarray(mat["classlabel"]).astype(np.int64),
                      TRUE_LABEL_TO_CLASS)


def break_recording_into_epochs(src_path: str | Path, mode: str = "Train",
                                paths: Paths | None = None,
                                ) -> tuple[np.ndarray, np.ndarray]:
    """File-level twin of ``break_data_into_epochs`` (``dataset.py:158-237``).

    ``src_path`` is a ``*-preprocessed.npz`` continuous bundle; the session
    stem (``A01T``/``A01E``) is the first four characters of the filename,
    exactly like the reference's ``file[:4]`` (``dataset.py:169``).
    """
    src_path = Path(src_path)
    stem = src_path.name[:4]
    rec = ProcessedRecording.load(src_path)
    X, labels, kept = extract_epochs(rec.data, rec.sfreq, rec.event_pos,
                                     rec.event_typ, mode=mode)
    if mode == "Eval":
        true = load_true_labels(stem, paths)
        labels = true[kept]  # kept aligns trials with the 288 .mat entries
    return X, labels


def build_dataset_from_preprocessed(src: str = "kaggle",
                                    subject: int | str = "all",
                                    mode: str = "Train",
                                    paths: Paths | None = None) -> BCICI2ADataset:
    """Assemble a dataset from ``-preprocessed.npz`` files.

    API twin of ``build_dataset_from_preprocessed`` (``dataset.py:239-281``),
    including the per-subject filename filter ``A{ss}{T|E}``.
    """
    paths = paths or Paths.from_here()
    if src == "kaggle":
        dest_path = paths.data_processed / mode
    elif src == "moabb":
        dest_path = paths.data_moabb_processed / mode
    else:
        raise ValueError(f"Unknown source: {src}")
    logger.info("Building dataset from preprocessed data in %s", dest_path)

    if subject != "all":
        pattern = f"A{int(subject):02d}{mode[0]}-preprocessed.npz"
    else:
        pattern = "*-preprocessed.npz"
    files = sorted(dest_path.glob(pattern))
    if not files:
        raise ValueError(
            f"No preprocessed files found in {dest_path} for subject {subject}"
        )
    logger.info("Found %d preprocessed files for subject %s", len(files), subject)

    parts = []
    for file in files:
        X, y = break_recording_into_epochs(file, mode=mode, paths=paths)
        parts.append(BCICI2ADataset(X=X, y=y))
    return concat_datasets(parts)


def build_dataset_from_fif_dir(root: Path, subject: int | str = "all",
                               mode: str = "Train",
                               paths: Paths | None = None) -> BCICI2ADataset:
    """Drop-in compatibility: epoch reference-produced ``.fif`` files.

    Requires MNE (the reference's storage format is MNE-specific); reproduces
    the annotation-id selection of ``break_data_into_epochs``
    (``dataset.py:178-237``) including the subject-4 id shift, which for
    raw annotation descriptions means simply selecting by description.
    """
    try:
        import mne
    except ImportError as e:
        raise ImportError(
            "Reading the reference's .fif files requires MNE, which is not "
            "installed. Re-run preprocessing with `python -m "
            "eegnetreplication_tpu_torch.dataset --src kaggle` to build "
            "native -preprocessed.npz files instead."
        ) from e

    paths = paths or Paths.from_here()
    if subject != "all":
        files = sorted(root.glob(f"A{int(subject):02d}{mode[0]}-preprocessed.fif"))
    else:
        files = sorted(root.glob("*-preprocessed.fif"))
    if not files:
        raise ValueError(f"No .fif files found in {root} for subject {subject}")

    cue_descs = {"769": 0, "770": 1, "771": 2, "772": 3}
    parts = []
    for file in files:
        stem = file.name[:4]
        raw = mne.io.read_raw_fif(file, preload=True, verbose="ERROR")
        events, event_id = mne.events_from_annotations(raw, verbose="ERROR")
        if mode == "Train":
            wanted = {d: i for d, i in event_id.items() if d in cue_descs}
        else:
            wanted = {d: i for d, i in event_id.items() if d == "783"}
        ep = mne.Epochs(raw, events, event_id=wanted, tmin=EPOCH_TMIN_S,
                        tmax=EPOCH_TMAX_S, baseline=None, preload=True,
                        verbose="ERROR")
        X = ep.get_data().astype(np.float32)
        if mode == "Eval":
            # ep.selection indexes the surviving epochs within the original
            # event list, keeping alignment with the 288 TrueLabels entries
            # even when MNE drops a non-tail epoch.
            y = load_true_labels(stem, paths)[ep.selection]
        else:
            inv = {i: cue_descs[d] for d, i in wanted.items()}
            y = np.array([inv[e] for e in ep.events[:, -1]], dtype=np.int64)
        parts.append(BCICI2ADataset(X=X, y=y))
    return concat_datasets(parts)
