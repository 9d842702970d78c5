"""One run of one cell: set-up, the measured window, the comparison.

:func:`run_cell` takes the device it is given; ``run.py`` is the entry that
looks for the card first.  The order inside a run:

1. the data from the seed, on the device (:func:`drive.make_sessions`);
2. the protocol's set-up through the port (:func:`drive.build`), timed as
   ``fold_setup_s``;
3. ``warm_epochs`` epochs through ``run_epoch`` (:func:`drive.warm`): the
   first use of every shape the window uses, and what the comparison reads;
4. the window (:func:`drive.window`), traced with ``--trace 1``; ``setup_s``
   runs from the process's start to the window's;
5. the peak memory, read before anything else runs; then the program's
   state is freed and the reference follows the set-up's epochs
   (:mod:`check`).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

import torch

from portbench import check, drive, spec, trace

RANGES = ("train_step", "eval_step", "slot_source", "epoch")


@dataclass
class Run:
    """What a per-layer reader gets."""

    cell: spec.Cell
    device_kind: str
    n_folds: int
    window: drive.Window
    spans: dict[str, float] = field(default_factory=dict)
    slots: dict[str, int] = field(default_factory=dict)
    fold_epoch_flops: float = 0.0
    trace: trace.Summary | None = None


def fold_epoch_flops(cell: spec.Cell, train_pad: int, val_pad: int) -> float:
    """The frozen FLOP count of one fold-epoch: every train step and every
    validation batch of one fold, padded batches at full cost."""
    from portbench.reference.training import model_module

    mod = model_module(cell.config["reference"])
    batch = cell.traffic["batch_size"]
    train_steps = max(1, -(-train_pad // batch))
    val_steps = max(1, -(-val_pad // batch))
    return (train_steps * mod.train_step_flops(cell.config, batch)
            + val_steps * mod.eval_step_flops(cell.config, batch))


def schedule_of(cell: spec.Cell, model) -> str:
    """The dropout stream the configuration states, checked against the
    schedule the program resolved."""
    stated = cell.config["dropout_stream"]
    resolved = getattr(model, "conv_impl", "grouped")
    if resolved != stated:
        raise RuntimeError(
            f"the configuration states the {stated!r} schedule; the program "
            f"runs {resolved!r}")
    return stated


@contextlib.contextmanager
def _traced_layers(trainer):
    """The harness's ranges around the calls into each layer."""
    from eegnetreplication_tpu_torch.training import steps as steps_lib

    source = trainer.slot_source
    trainer.slot_source = trace.ranged("slot_source", source)
    try:
        with drive.patched(steps_lib, "train_step",
                           lambda f: trace.ranged("train_step", f)), \
                drive.patched(steps_lib, "eval_step",
                              lambda f: trace.ranged("eval_step", f)):
            yield
    finally:
        trainer.slot_source = source


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t0: float, *, precision: str | None = None,
             faults=contextlib.nullcontext) -> tuple[dict, dict]:
    """One run; returns the result line's object and every number the
    comparison computed (those without a limit too).  ``precision``
    replaces the traffic's numerics mode and ``faults`` (a context manager)
    breaks the program under the set-up and the window: both for the
    control and the fault tests alone."""
    from eegnetreplication_tpu_torch.utils.device import (
        numerics,
        resolve_device,
    )

    device = resolve_device(device)
    cfg, traffic = cell.config, cell.traffic
    on_card = device.type == "cuda"
    with numerics(precision or traffic["precision"]):
        x, y = drive.make_sessions(cfg, traffic, seed, device)
        if on_card:     # a process that runs several cells
            torch.cuda.reset_peak_memory_stats(device)
        built = drive.build(cfg, traffic, seed, x, y, device, precision)
        schedule = schedule_of(cell, built.model)
        with faults():
            captured = drive.warm(built, traffic["warm_epochs"], check.STEPS)
            summary = None
            if traced:
                with _traced_layers(built.trainer), trace.profiler() as prof:
                    with torch.profiler.record_function(trace.WINDOW):
                        win = drive.window(built, seconds, lambda f:
                                           trace.ranged("epoch", f))
                summary = trace.summarize(
                    trace.events(prof), [trace.PREFIX + r for r in RANGES])
                del prof
            else:
                win = drive.window(built, seconds)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    spec_ = built.setup.spec
    run = Run(cell=cell, device_kind=(torch.cuda.get_device_name(device)
                                      if on_card else "cpu"),
              n_folds=spec_.n_folds, window=win, trace=summary,
              spans={"fold_setup": built.seconds},
              slots={"real": int(spec_.train_n.sum()),
                     "padded": (built.trainer.train_steps
                                * traffic["batch_size"] * spec_.n_folds)},
              fold_epoch_flops=fold_epoch_flops(
                  cell, spec_.train_idx.shape[1], spec_.val_idx.shape[1]))
    del built
    if on_card:
        torch.cuda.empty_cache()

    pool_x, pool_y = drive.pool_of(x, y, traffic["pool_layout"])
    followed = check.follow(cfg, traffic, seed, pool_x, pool_y, schedule)
    values = check.numbers(captured, followed, win.failed)
    ok, table = check.judge(values, cell.limits)

    if traced:
        metrics = {}
        for m in cell.per_layer:
            value = spec.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        e2e = {"fold_epochs_per_s": win.fold_epochs / win.seconds,
               "peak_mem_gib": peak / 2 ** 30,
               "setup_s": win.started - t0}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    result = {"correct": ok, "attempted": win.fold_epochs,
              "failed": win.failed, "metrics": metrics,
              "device": {"platform": "gpu" if on_card else "cpu",
                         "kind": run.device_kind, "count": 1,
                         "memory_peak_bytes": peak}}
    if traced:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        result["breakdown"] = trace.breakdown(summary)
    result["compared"] = table
    return result, values
