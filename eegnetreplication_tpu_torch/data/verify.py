"""Label verification: cross-check derived trial labels vs TrueLabels .mat.

The port's copy of ``eegnetreplication_tpu/data/verify.py`` (numpy only).

Runnable twin of the reference's eval-label debugging notebook
(``notebooks/06_eval_data.ipynb`` cells 3-10), which checks per subject that
the labels the annotation-derived pipeline produces agree with the
competition's published ``classlabel`` files.  The notebook exists because
label misalignment is the silent killer of this dataset (the subject-4 event
table, dropped epochs, 1-based vs 0-based classes); this module makes that
check a first-class, scriptable artifact instead of a manual notebook run:

    python -m eegnetreplication_tpu_torch.data.verify --mode both

Per session it validates three properties:

1. **Count alignment** — the number of cue events in the recording equals the
   number of entries in the ``.mat`` (a mismatch means the epoching and the
   label file index different trials);
2. **Label agreement** (Train sessions) — the classes derived from the GDF
   cue codes 769-772 match ``classlabel`` element-for-element on every
   surviving trial (Eval labels *come from* the ``.mat``, so the notebook's
   Train-session comparison is the informative one);
3. **Class coverage** — all four classes occur (notebook 06 cells 8-10's
   ``set(labels)`` check).

Exit status is the number of failing sessions, so it slots into CI.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass, field

import numpy as np

from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.data.epoching import (
    CUE_UNKNOWN,
    TRAIN_CUE_TO_CLASS,
    extract_epochs,
    load_true_labels,
)
from eegnetreplication_tpu_torch.data.preprocess import ProcessedRecording
from eegnetreplication_tpu_torch.utils.logging import logger


@dataclass
class SessionVerification:
    """Outcome of verifying one session (e.g. ``A01T``) against its .mat."""

    stem: str
    mode: str
    n_cue_events: int = 0
    n_true_labels: int = 0
    n_compared: int = 0
    n_mismatched: int = 0
    classes_seen: tuple = ()
    errors: list = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.errors


def verify_session(stem: str, mode: str,
                   paths: Paths | None = None) -> SessionVerification:
    """Verify one session's derived labels against ``TrueLabels/{stem}.mat``."""
    paths = paths or Paths.from_here()
    out = SessionVerification(stem=stem, mode=mode)

    src = paths.data_processed / mode / f"{stem}-preprocessed.npz"
    if not src.exists():
        out.errors.append(f"no preprocessed recording at {src}")
        return out
    rec = ProcessedRecording.load(src)

    if mode == "Train":
        sel = np.isin(rec.event_typ, list(TRAIN_CUE_TO_CLASS))
    else:
        sel = rec.event_typ == CUE_UNKNOWN
    out.n_cue_events = int(np.sum(sel))

    try:
        true = load_true_labels(stem, paths)
    except FileNotFoundError as e:
        out.errors.append(str(e))
        return out
    out.n_true_labels = len(true)

    if out.n_cue_events != out.n_true_labels:
        out.errors.append(
            f"{out.n_cue_events} cue events in the recording but "
            f"{out.n_true_labels} entries in TrueLabels/{stem}.mat")

    _, derived, kept = extract_epochs(rec.data, rec.sfreq, rec.event_pos,
                                      rec.event_typ, mode=mode)
    kept = kept[kept < out.n_true_labels]
    aligned_true = true[kept]
    if mode == "Train":
        # The Eval pipeline's labels ARE the .mat overlay, so only the
        # Train-session comparison tests an independent derivation.
        derived = derived[: len(kept)]
        out.n_compared = len(kept)
        out.n_mismatched = int(np.sum(derived != aligned_true))
        if out.n_mismatched:
            bad = np.nonzero(derived != aligned_true)[0][:5]
            out.errors.append(
                f"{out.n_mismatched}/{out.n_compared} labels disagree with "
                f"the .mat (first trial indices: {bad.tolist()})")
    else:
        out.n_compared = len(kept)

    out.classes_seen = tuple(sorted(np.unique(aligned_true).tolist()))
    if out.classes_seen != (0, 1, 2, 3):
        out.errors.append(
            f"expected all classes 0-3, saw {list(out.classes_seen)}")
    return out


def verify_labels(subjects=tuple(range(1, 10)), mode: str = "both",
                  paths: Paths | None = None) -> list[SessionVerification]:
    """Verify every requested (subject, session); logs a per-session line."""
    modes = ("Train", "Eval") if mode == "both" else (mode,)
    results = []
    for m in modes:
        for s in subjects:
            stem = f"A{int(s):02d}{m[0]}"
            r = verify_session(stem, m, paths)
            if r.ok:
                logger.info(
                    "%s [%s]: OK — %d trials, %d compared, classes %s",
                    stem, m, r.n_cue_events, r.n_compared,
                    list(r.classes_seen))
            else:
                logger.error("%s [%s]: FAIL — %s", stem, m,
                             "; ".join(r.errors))
            results.append(r)
    return results


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Cross-check derived trial labels against the "
                    "competition's TrueLabels .mat files (notebook 06).")
    parser.add_argument("--mode", choices=["Train", "Eval", "both"],
                        default="both")
    parser.add_argument("--subjects", type=str, default="1,2,3,4,5,6,7,8,9",
                        help="Comma-separated subject ids.")
    args = parser.parse_args(argv)
    subjects = tuple(int(s) for s in args.subjects.split(","))
    results = verify_labels(subjects, args.mode)
    n_bad = sum(not r.ok for r in results)
    logger.info("Label verification: %d/%d sessions OK",
                len(results) - n_bad, len(results))
    return n_bad


if __name__ == "__main__":
    raise SystemExit(main())
