"""JSON training reports, schema-identical to the reference.

The port of ``eegnetreplication_tpu/training/report.py``: the reference's
``generate_ws_report`` (``train.py:294-368``) and ``generate_cs_report``
(``train.py:371-468``) key for key, with the same rounding, rank
assignment and timestamped plus ``latest_{within,cross}_subject_report.json``
dual write, so the reference's GUI report viewer renders them unmodified.  As in the JAX package,
``model_parameters.epochs`` records the epochs actually trained (the
reference writes its constant 500).
"""

from __future__ import annotations

import json
from datetime import datetime
from pathlib import Path

import numpy as np

from eegnetreplication_tpu_torch.config import (
    DEFAULT_TRAINING,
    Paths,
    TrainingConfig,
)
from eegnetreplication_tpu_torch.utils.logging import logger


def _ranked_subject_results(accs: list[float], id_key: str,
                            subjects: tuple[int, ...] | None = None,
                            extra=None) -> list[dict]:
    """Per-subject entries with a 1-based rank by descending accuracy; ties
    get distinct ranks in sorted order (a stable sort keeps the lower
    subject first), as the reference's sort-then-backfill does."""
    subjects = subjects or tuple(range(1, len(accs) + 1))
    results = []
    for subject_id, acc in zip(subjects, accs):
        entry = {id_key: subject_id, "test_accuracy": round(acc, 2)}
        if extra:
            entry.update(extra(subject_id) if callable(extra) else extra)
        entry["performance_rank"] = 0
        results.append(entry)
    ranked = sorted(results, key=lambda e: e["test_accuracy"], reverse=True)
    for rank, entry in enumerate(ranked, 1):
        entry["performance_rank"] = rank
    return results


def _summary_statistics(accs: list[float], average: float) -> dict:
    return {
        "accuracy_distribution": {
            "above_average_subjects": len([a for a in accs if a > average]),
            "below_average_subjects": len([a for a in accs if a < average]),
            "at_average_subjects": len([a for a in accs if a == average]),
        },
        "accuracy_quartiles": {
            "q1": round(float(np.percentile(accs, 25)), 2),
            "q2_median": round(float(np.percentile(accs, 50)), 2),
            "q3": round(float(np.percentile(accs, 75)), 2),
        },
    }


def _write_report(report_data: dict, stem: str, paths: Paths) -> Path:
    paths.reports.mkdir(parents=True, exist_ok=True)
    timestamp_str = datetime.now().strftime("%Y%m%d_%H%M%S")
    report_path = paths.reports / f"{stem}_training_report_{timestamp_str}.json"
    for target in (report_path, paths.reports / f"latest_{stem}_report.json"):
        with open(target, "w", encoding="utf-8") as f:
            json.dump(report_data, f, indent=2, ensure_ascii=False)
    logger.info("Report saved to: %s", report_path)
    return report_path


def generate_ws_report(per_subject_test_acc, avg_test_acc_all_subjects,
                       best_model_states_all_subjects, *,
                       epochs: int | None = None,
                       subjects: tuple[int, ...] | None = None,
                       config: TrainingConfig = DEFAULT_TRAINING,
                       paths: Paths | None = None) -> Path:
    """Within-subject report (schema: the reference's ``train.py:309-368``)."""
    paths = paths or Paths.from_here()
    accs = [float(a) for a in per_subject_test_acc]
    avg = float(avg_test_acc_all_subjects)
    report_data = {
        "training_type": "Within-Subject",
        "timestamp": datetime.now().isoformat(),
        "model_parameters": {
            "batch_size": config.batch_size,
            "epochs": epochs if epochs is not None else config.epochs,
            "learning_rate": config.learning_rate,
            "dropout_probability": config.dropout_within_subject,
            "cross_validation_folds": config.kfold_splits,
        },
        "overall_results": {
            "average_test_accuracy": round(avg, 2),
            "number_of_subjects": len(accs),
            "best_subject_accuracy": round(max(accs), 2),
            "worst_subject_accuracy": round(min(accs), 2),
            "accuracy_std": round(float(np.std(accs)), 2),
        },
        "per_subject_results": _ranked_subject_results(
            accs, "subject_id", subjects,
            extra=lambda sid: {"model_saved": f"subject_{sid:02d}_best_model.pth"},
        ),
        "model_info": {
            "architecture": "EEGNet",
            "optimizer": "Adam",
            "loss_function": "CrossEntropyLoss",
            "saved_models_count": len(best_model_states_all_subjects),
        },
    }
    report_data["summary_statistics"] = _summary_statistics(accs, avg)
    return _write_report(report_data, "within_subject", paths)


def generate_cs_report(best_model_state, per_subject_test_acc,
                       avg_test_acc_all, *, epochs: int | None = None,
                       subjects: tuple[int, ...] | None = None,
                       config: TrainingConfig = DEFAULT_TRAINING,
                       paths: Paths | None = None) -> Path:
    """Cross-subject report (schema: the reference's ``train.py:406-468``);
    the standard error is over the per-subject accuracies."""
    del best_model_state   # the reference's signature; saved by the protocol
    paths = paths or Paths.from_here()
    accs = [float(a) for a in per_subject_test_acc]
    avg = float(avg_test_acc_all)
    report_data = {
        "training_type": "Cross-Subject",
        "timestamp": datetime.now().isoformat(),
        "model_parameters": {
            "batch_size": config.batch_size,
            "epochs": epochs if epochs is not None else config.epochs,
            "learning_rate": config.learning_rate,
            "dropout_probability": config.dropout_cross_subject,
            "total_folds": len(accs) * config.cs_repeats_per_subject,
            "repeats_per_subject": config.cs_repeats_per_subject,
            "train_subjects_per_fold": config.cs_train_subjects,
            "validation_subjects_per_fold": config.cs_val_subjects,
        },
        "overall_results": {
            "average_test_accuracy": round(avg, 2),
            "standard_error": round(
                float(np.std(accs) / np.sqrt(len(accs))), 2),
            "number_of_test_subjects": len(accs),
            "best_subject_accuracy": round(max(accs), 2),
            "worst_subject_accuracy": round(min(accs), 2),
            "accuracy_std": round(float(np.std(accs)), 2),
        },
        "per_subject_results": _ranked_subject_results(accs, "test_subject_id",
                                                       subjects),
        "model_info": {
            "architecture": "EEGNet",
            "optimizer": "Adam",
            "loss_function": "CrossEntropyLoss",
            "saved_model": "cross_subject_best_model.pth",
        },
    }
    report_data["summary_statistics"] = _summary_statistics(accs, avg)
    return _write_report(report_data, "cross_subject", paths)
