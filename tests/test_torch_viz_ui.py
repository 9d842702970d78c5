"""The port's ``viz`` and the GUI's headless helpers (``ui``) against the
JAX package's, on the CPU.

- ``load_model_filters`` gives a ``FilterSet`` equal to the JAX one, array
  for array, on checkpoints written by each package (``.npz`` and
  ``.pth``); ``PS`` is exact on seeded signals.
- Each figure's plotted data under Agg (every axes' title and labels,
  line x and y data, image arrays, ticks, patches) equals the JAX
  figure's; ``topomap_grid`` is the image a topomap draws.
- The ``build_*_cmd`` argv name the port's CLIs, the fetch CLI's too (and
  the port's predict parser takes its flags); ``MODEL_NAMES`` is the port
  registry's keys; the precision dropdown offers ``highest``.
- ``report_overview_lines``, ``report_table_rows``,
  ``accuracy_chart_figure``, ``get_report`` and ``get_model_path`` equal the
  JAX ones on seeded reports and model trees.
- ``performance_overview_lines`` renders a seeded GPU record beside the
  card's name and power limit, and skips TPU and CPU records, the repo
  root's included.
"""

import json
import os
from pathlib import Path

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from torch_port_cases import jax_variables  # noqa: E402

from eegnetreplication_tpu import ui as jax_ui  # noqa: E402
from eegnetreplication_tpu import viz as jax_viz  # noqa: E402
from eegnetreplication_tpu.config import Paths as JaxPaths  # noqa: E402
from eegnetreplication_tpu.training import (  # noqa: E402
    checkpoint as jax_ckpt,
)
from eegnetreplication_tpu_torch import predict, ui, viz  # noqa: E402
from eegnetreplication_tpu_torch.config import Paths  # noqa: E402
from eegnetreplication_tpu_torch.models.registry import (  # noqa: E402
    MODEL_REGISTRY,
)
from eegnetreplication_tpu_torch.training import (  # noqa: E402
    checkpoint as ckpt,
)

REPO = Path(__file__).resolve().parents[1]
C, T, F1, D = 22, 257, 8, 2


def _checkpoints(tmp: Path, writer: str, seed: int) -> dict:
    """One EEGNet's ``.npz`` and ``.pth`` written by ``writer``'s package."""
    params, bs = jax_variables(C, T, F1, D, seed=seed)
    out = {"npz": tmp / f"{writer}.npz", "pth": tmp / f"{writer}.pth"}
    meta = {"model": "eegnet", "n_channels": C, "n_times": T}
    if writer == "jax":
        jax_ckpt.save_checkpoint(out["npz"], params, bs, metadata=meta)
        jax_ckpt.save_pth(out["pth"], params, bs, f2=F1 * D,
                          t_prime=T // 32)
    else:
        sd = ckpt.from_jax_variables(params, bs)
        ckpt.save_checkpoint(out["npz"], sd, metadata=meta)
        ckpt.save_pth(out["pth"], sd)
    return out


def _same_filters(a, b):
    assert a.temporal.dtype == b.temporal.dtype == np.float32
    assert a.temporal.tobytes() == b.temporal.tobytes()
    assert a.spatial.tobytes() == b.spatial.tobytes()
    assert a.temporal.shape == (F1, 32) and a.spatial.shape == (F1 * D, C)
    assert a.channel_names == b.channel_names and a.sfreq == b.sfreq


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("fmt", ["npz", "pth"])
def test_filter_sets_equal_jax(tmp_path, writer, fmt):
    paths = _checkpoints(tmp_path, writer, seed=3)
    port = viz.load_model_filters(paths[fmt])
    _same_filters(port, jax_viz.load_model_filters(paths[fmt]))
    # both formats carry the same weights
    other = viz.load_model_filters(paths["pth" if fmt == "npz" else "npz"])
    _same_filters(port, other)


def test_unknown_format_raises():
    with pytest.raises(ValueError, match="Unknown checkpoint format"):
        viz.load_model_filters("model.txt")


@pytest.mark.parametrize("n, fs, method", [
    (32, 128.0, "ps"), (32, 128.0, "psd"), (257, 128.0, "ps"),
    (64, 250.0, "psd")])
def test_ps_equals_jax(n, fs, method):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    f, ps = viz.PS(x, fs, method=method)
    g, qs = jax_viz.PS(x, fs, method=method)
    assert f.tobytes() == g.tobytes() and ps.tobytes() == qs.tobytes()


def _figure_data(fig) -> list:
    """What a figure shows: per axes, its texts, lines, images, ticks and
    patch types."""
    out = []
    for ax in fig.axes:
        out.append({
            "title": ax.get_title(), "xlabel": ax.get_xlabel(),
            "ylabel": ax.get_ylabel(), "axison": ax.axison,
            "lines": [(np.asarray(ln.get_xdata()).tobytes(),
                       np.asarray(ln.get_ydata()).tobytes(),
                       ln.get_linestyle(), ln.get_marker(), ln.get_color())
                      for ln in ax.lines],
            "images": [(np.ma.getdata(im.get_array()).tobytes(),
                        np.ma.getmaskarray(im.get_array()).tobytes(),
                        tuple(im.get_extent())) for im in ax.images],
            "xticks": list(ax.get_xticks()),
            "patches": [type(p).__name__ for p in ax.patches],
            "texts": [t.get_text() for t in ax.texts],
            "xlim": ax.get_xlim(), "ylim": ax.get_ylim()})
    return out


def _filters(seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(F1, 32).astype(np.float32),
            rng.randn(F1 * D, C).astype(np.float32))


@pytest.mark.parametrize("plot", ["plot_temporal_filters",
                                  "plot_spatial_filters",
                                  "plot_power_spectra_of_temporal_filters"])
def test_figures_plot_what_jax_plots(tmp_path, plot):
    temporal, spatial = _filters(0)
    figs = {}
    for key, mod in (("port", viz), ("jax", jax_viz)):
        fs = mod.FilterSet(temporal=temporal, spatial=spatial)
        figs[key] = getattr(mod, plot)(fs, show=False,
                                       save_path=tmp_path / f"{key}.png")
        assert (tmp_path / f"{key}.png").stat().st_size > 0
    try:
        port = _figure_data(figs["port"])
        assert len(port) == (F1 * D if plot == "plot_spatial_filters"
                             else F1)
        assert port == _figure_data(figs["jax"])
    finally:
        for fig in figs.values():
            plt.close(fig)


def test_topomap_grid_is_the_image_a_topomap_draws():
    values = np.random.RandomState(7).randn(C)
    grid = viz.topomap_grid(values)
    assert grid.shape == (64, 64)
    assert np.isnan(grid[0, 0]) and np.isfinite(grid[32, 32])
    fig, ax = plt.subplots()
    try:
        viz.plot_topomap(values, ax)
        (im,) = ax.images
        assert np.ma.getdata(im.get_array()).tobytes() == grid.tobytes()
        assert not ax.axison
    finally:
        plt.close(fig)
    assert set(viz.ELECTRODE_XY) == set(viz.EEG_CHANNEL_NAMES)
    assert viz.ELECTRODE_XY == jax_viz.ELECTRODE_XY


# -- the GUI's headless helpers ----------------------------------------------

def test_commands_name_the_ports_clis():
    dataset = ui.build_dataset_cmd("kaggle")
    assert dataset[1:] == ["-m", "eegnetreplication_tpu_torch.dataset",
                           "--src", "kaggle"]
    train = ui.build_train_cmd("Cross-Subject", 500, False, "eegnet",
                               "highest")
    jax_train = jax_ui.build_train_cmd("Cross-Subject", 500, False, "eegnet",
                                       "highest")
    assert train[2] == "eegnetreplication_tpu_torch.train"
    assert train[3:] == jax_train[3:]
    pred = ui.build_predict_cmd("/tmp/m.npz", 3)
    assert pred[1:3] == ["-m", "eegnetreplication_tpu_torch.predict"]
    assert pred[3:] == jax_ui.build_predict_cmd("/tmp/m.npz", 3)[3:]
    args = predict.build_parser().parse_args(pred[3:])
    assert (args.checkpoint, args.subject, args.mode) == ("/tmp/m.npz", 3,
                                                           "Eval")
    assert ui.PKG == "eegnetreplication_tpu_torch"
    assert ui.PRECISIONS == ["highest"]


def test_fetch_refuses_with_the_ports_message():
    """The fetch step launches the port's fetch CLI: JAX's command with
    the port's module (no refusal is left)."""
    for source in ("kaggle", "moabb"):
        cmd = ui.build_fetch_cmd(source)
        want = jax_ui.build_fetch_cmd(source)
        assert cmd == [want[0], "-m", "eegnetreplication_tpu_torch.fetch",
                       *want[3:]]
        assert want[2] == "eegnetreplication_tpu.fetch"
    assert not hasattr(ui, "NO_FETCH")


def test_model_names_are_the_registry_keys():
    assert ui.MODEL_NAMES == sorted(MODEL_REGISTRY)
    assert ui.MODEL_NAMES == jax_ui.MODEL_NAMES


def _report(seed: int, id_key: str, n: int, with_se: bool) -> dict:
    rng = np.random.RandomState(seed)
    accs = np.round(rng.uniform(25, 95, n), 2).tolist()
    order = np.argsort(accs)[::-1]
    rank = {int(i): r + 1 for r, i in enumerate(order)}
    overall = {"average_test_accuracy": round(float(np.mean(accs)), 2),
               "best_subject_accuracy": max(accs),
               "worst_subject_accuracy": min(accs),
               "accuracy_std": round(float(np.std(accs)), 2)}
    if with_se:
        overall["standard_error"] = round(float(np.std(accs)) / 3, 2)
    return {"overall_results": overall, "per_subject_results": [
        {id_key: i + 1, "test_accuracy": a, "performance_rank": rank[i]}
        for i, a in enumerate(accs)]}


REPORTS = [(0, "subject_id", 9, False), (1, "test_subject_id", 9, True),
           (2, "subject_id", 2, True)]


@pytest.mark.parametrize("seed, id_key, n, with_se", REPORTS)
def test_report_helpers_equal_jax(seed, id_key, n, with_se):
    report = _report(seed, id_key, n, with_se)
    assert ui.report_overview_lines(report) == \
        jax_ui.report_overview_lines(report)
    assert ui.report_table_rows(report, id_key) == \
        jax_ui.report_table_rows(report, id_key)
    figs = [mod.accuracy_chart_figure(report["per_subject_results"],
                                      "Within-Subject", id_key)
            for mod in (ui, jax_ui)]
    port, ref = (_figure_data(f) for f in figs)
    assert port == ref
    assert len(figs[0].axes[0].patches) == n


def test_get_report_and_get_model_path_equal_jax(tmp_path):
    paths, jax_paths = Paths.from_root(tmp_path), JaxPaths.from_root(tmp_path)
    assert ui.get_report(paths) == jax_ui.get_report(jax_paths) == {}
    paths.reports.mkdir(parents=True)
    (paths.reports / "latest_within_subject_report.json").write_text(
        json.dumps(_report(0, "subject_id", 9, False)))
    (paths.reports / "latest_cross_subject_report.json").write_text("{bad")
    got = ui.get_report(paths)
    assert got == jax_ui.get_report(jax_paths)
    assert list(got) == ["within_subject"]
    paths.models.mkdir(parents=True)
    cases = [("Within-Subject", "1"), ("Within-Subject", "01"),
             ("Within-Subject", "x"), ("Cross-Subject", "01")]
    for touch in ([], ["subject_01_best_model.pth"],
                  ["subject_01_best_model.npz", "cross_subject_best_model.npz"]):
        for name in touch:
            (paths.models / name).touch()
        for model_type, subject in cases:
            assert ui.get_model_path(model_type, subject, paths) == \
                jax_ui.get_model_path(model_type, subject, jax_paths)
    assert ui.get_model_path("Within-Subject", "1", paths).name == \
        "subject_01_best_model.npz"


GPU_RECORD = {"value": 385.9, "unit": "fold-epochs/s", "platform": "gpu",
              "device": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
              "utc": "2026-10-18T02:00:00Z", "schema_version": 1}


def test_performance_lines_show_only_the_cards_numbers(tmp_path):
    assert "No benchmark artifacts of the card" in \
        ui.performance_overview_lines(tmp_path)[0]
    # TPU and CPU records, and a GPU record that names no card, are skipped
    (tmp_path / "BENCH_ONCHIP_LAST.json").write_text(json.dumps(
        {"value": 49.4, "vs_baseline": 17.1, "platform": "tpu"}))
    (tmp_path / "BENCH_CONV_AB.json").write_text(json.dumps(
        {"ok": True, "platform": "gpu", "speedup": 1.6,
         "banded": {"fold_epochs_per_s": 378.8},
         "lax": {"fold_epochs_per_s": 237.0}}))
    (tmp_path / "BENCH_CS_BASELINE.json").write_text(json.dumps(
        {"value": 0.461, "torch_threads": 1}))
    (tmp_path / "BENCH_CS_SCALE.json").write_text("{corrupt")
    (line,) = ui.performance_overview_lines(tmp_path)
    assert "No benchmark artifacts of the card" in line
    assert len(jax_ui.performance_overview_lines(tmp_path)) == 3
    # the card's own records render, each beside its name and limit
    card = "NVIDIA H100 80GB HBM3, 700.00 W"
    ui_root = tmp_path / "gpu"
    ui_root.mkdir()
    (ui_root / "BENCH_ONCHIP_LAST.json").write_text(json.dumps(GPU_RECORD))
    (ui_root / "BENCH_CONV_AB.json").write_text(json.dumps(
        {"ok": True, "platform": "gpu", "device": GPU_RECORD["device"],
         "power_limit": "700.00 W", "speedup": 1.6,
         "banded": {"fold_epochs_per_s": 378.8},
         "lax": {"fold_epochs_per_s": 237.0}}))
    lines = ui.performance_overview_lines(ui_root)
    assert lines == [
        f"Training throughput ({card}): 385.9 fold-epochs/s "
        "(2026-10-18T02:00:00Z)",
        f"Conv schedule A/B on {card}: banded 378.8 vs lax 237.0 "
        "fold-epochs/s (1.6x)"]


def test_performance_lines_skip_the_repo_roots_tpu_records():
    lines = ui.performance_overview_lines()
    assert len(lines) == 1 and "No benchmark artifacts of the card" in \
        lines[0]
    assert ui.performance_overview_lines(REPO) == lines
    assert not any("tpu" in ln.lower() and "fold-epochs" in ln
                   for ln in lines)


@pytest.fixture
def display():
    if not os.environ.get("DISPLAY"):
        pytest.skip("no X display")


def test_app_builds_its_tabs(display):
    app = ui.App()
    try:
        tabs = [app.notebook.tab(t, "text") for t in app.notebook.tabs()]
        assert tabs == ["Training Pipeline", "Logs", "Training Reports",
                        "Model Exploration", "Performance"]
    finally:
        app.destroy()


def test_the_viz_module_pulls_in_no_matplotlib():
    import subprocess
    import sys

    code = ("import sys; import eegnetreplication_tpu_torch.viz, "
            "eegnetreplication_tpu_torch.ui; "
            "print('matplotlib' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, EEGTPU_NO_LOG_FILE="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "False"
