"""What the benchmark drives: the port's training path, as the ``train``
CLI takes it.

:func:`make_sessions` makes the data from the seed on the device;
:func:`build` hands it to the protocol's own functions (``build_pool``,
``within_subject_folds`` or ``cross_subject_folds``, ``FoldSetup.build``)
and takes one ``FoldTrainer`` for every fold, inside the run's
``numerics`` scope; :func:`warm` runs the set-up's epochs through
``run_epoch`` and keeps what the comparison needs; :func:`window` calls
``run_epoch`` until the time is up and synchronizes once.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import numpy as np
import torch


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed of its own for each of the benchmark's streams."""
    words = np.random.SeedSequence([seed & (2 ** 64 - 1), stream])
    return int(words.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_sessions(cfg: dict, traffic: dict, seed: int, device
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Every session of the synthetic pool, ``(subjects, sessions, trials,
    C, T)`` float32 and ``(subjects, sessions, trials)`` int64, on the
    device: each class a fixed random pattern scaled by ``signal``, under
    unit Gaussian noise; each session holds every class equally often, in a
    random order."""
    s, k, n = (traffic["subjects"], traffic["sessions"],
               traffic["trials_per_session"])
    classes = cfg["n_classes"]
    if n % classes:
        raise ValueError(f"{n} trials a session do not balance {classes} "
                         "classes")
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 0))
    shape = (cfg["n_channels"], cfg["n_times"])
    patterns = torch.randn((classes, *shape), generator=gen, device=device)
    order = torch.argsort(torch.rand((s, k, n), generator=gen, device=device),
                          dim=-1)
    y = order % classes
    x = torch.randn((s, k, n, *shape), generator=gen, device=device)
    x += traffic["signal"] * patterns[y]
    return x, y


def pool_of(x: torch.Tensor, y: torch.Tensor, layout: str
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The sessions as one pool in the traffic's ``pool_layout``."""
    if layout == "sessions":
        x, y = x.transpose(0, 1), y.transpose(0, 1)
    elif layout != "subjects":
        raise ValueError(f"unknown pool layout {layout!r}")
    return (x.reshape(-1, *x.shape[3:]).contiguous(), y.reshape(-1)
            .contiguous())


def training_config(traffic: dict, precision: str | None = None):
    """The port's ``TrainingConfig`` of the traffic (its numerics mode
    replaced by ``precision`` when given)."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING

    dropout = traffic["dropout"]
    return DEFAULT_TRAINING.replace(
        batch_size=traffic["batch_size"],
        learning_rate=traffic["learning_rate"],
        adam_eps=traffic["adam_eps"],
        dropout_within_subject=dropout, dropout_cross_subject=dropout,
        kfold_splits=traffic.get("kfold_splits", 4),
        kfold_seed=traffic.get("kfold_seed", 42),
        cs_repeats_per_subject=traffic.get("repeats_per_subject", 10),
        cs_train_subjects=traffic.get("train_subjects", 5),
        maxnorm_mode=traffic["maxnorm_mode"],
        precision=precision or traffic["precision"])


@dataclass
class Built:
    setup: object        # the port's FoldSetup
    trainer: object      # its FoldTrainer of every fold
    model: object
    seconds: float       # the protocol's set-up, host clock


def build(cfg: dict, traffic: dict, seed: int, x: torch.Tensor,
          y: torch.Tensor, device, precision: str | None = None) -> Built:
    """The protocol's pool, folds, ``FoldSetup`` and one trainer of every
    fold; call inside the run's ``numerics`` scope."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.models import get_model
    from eegnetreplication_tpu_torch.training import protocols

    config = training_config(traffic, precision)
    xs, ys = x.cpu().numpy(), y.cpu().numpy()
    t0 = time.perf_counter()
    sessions = [[BCICI2ADataset(xs[s, k], ys[s, k])
                 for k in range(xs.shape[1])] for s in range(xs.shape[0])]
    n_subjects = len(sessions)
    if traffic["protocol"] == "cross_subject":
        # every subject's first session, then every subject's second
        pool_x, pool_y, offsets = protocols.build_pool(
            [row[0] for row in sessions] + [row[1] for row in sessions])
        folds = protocols.cross_subject_folds(
            offsets[:n_subjects], offsets[n_subjects:],
            tuple(range(1, n_subjects + 1)), config)
    elif traffic["protocol"] == "within_subject":
        pool_x, pool_y, offsets = protocols.build_pool(
            [row[0].concat(row[1]) for row in sessions])
        folds = protocols.within_subject_folds(offsets, config)
    else:
        raise ValueError(f"unknown protocol {traffic['protocol']!r}")
    model = get_model(cfg["model"], n_channels=cfg["n_channels"],
                      n_times=cfg["n_times"], n_classes=cfg["n_classes"],
                      dropout_rate=traffic["dropout"], device="cpu",
                      **cfg["model_kwargs"],
                      **protocols._model_kwargs_for_precision(config))
    setup = protocols.FoldSetup.build(model, folds, pool_x, pool_y,
                                      config=config, seed=seed, device=device)
    trainer = setup.trainer(0, setup.n_folds)
    return Built(setup, trainer, model, time.perf_counter() - t0)


@contextlib.contextmanager
def patched(module, name: str, wrap):
    """``module.name`` replaced by ``wrap(original)`` inside the block."""
    original = getattr(module, name)
    setattr(module, name, wrap(original))
    try:
        yield
    finally:
        setattr(module, name, original)


@dataclass
class Captured:
    """The program's outputs the comparison reads, on the CPU: flat
    parameter vectors ``(G, P)`` and per-fold series."""

    names: tuple        # the parameter layout: names and shapes
    shapes: tuple
    init: torch.Tensor
    step_losses: torch.Tensor     # (steps, G)
    first_mu: torch.Tensor        # Adam's first moment after step 1
    after_steps: torch.Tensor     # the parameters step ``steps + 1`` gets
    val_loss: torch.Tensor        # (epochs, G)
    val_acc: torch.Tensor         # (epochs, G) percentage
    best: torch.Tensor            # the best-by-validation parameters
    val_n: torch.Tensor           # (G,) real validation trials


def warm(built: Built, epochs: int, steps: int) -> Captured:
    """Run the set-up's ``epochs`` epochs through ``run_epoch``, keeping
    the first ``steps`` train steps' outputs as the program returns them."""
    from eegnetreplication_tpu_torch.training import steps as steps_lib

    trainer = built.trainer
    init = trainer.state.params.clone()
    calls = []

    def keep(train_step):
        def step(*args, **kwargs):
            out = train_step(*args, **kwargs)
            if len(calls) < steps:
                calls.append(out)
            return out
        return step

    with patched(steps_lib, "train_step", keep):
        for _ in range(epochs):
            trainer.run_epoch()
    if len(calls) < steps:
        raise ValueError(f"the set-up ran {len(calls)} train steps; the "
                         f"comparison reads {steps}")
    history = trainer.history_tensors()
    layout = trainer.state.layout.params
    return Captured(
        names=layout.names, shapes=layout.shapes, init=init.cpu(),
        step_losses=torch.stack([c[1] for c in calls]).cpu(),
        first_mu=calls[0][0].mu.cpu(),
        after_steps=calls[steps - 1][0].params.cpu(),
        val_loss=history[1].t().cpu(), val_acc=history[2].t().cpu(),
        best=trainer.best.params.cpu(), val_n=trainer.spec.val_n.cpu())


@dataclass
class Window:
    started: float       # perf_counter at the window's start
    seconds: float
    epochs: int
    fold_epochs: int
    failed: int


def sync(device) -> None:
    """Wait for the device (a no-op on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def window(built: Built, seconds: float, wrap_epoch=None) -> Window:
    """Call ``run_epoch`` until ``seconds`` have passed, then synchronize
    once; the rate is all the fold-epochs over all of that time."""
    trainer = built.trainer
    device = built.setup.device
    done_before = trainer.epoch
    run_epoch = trainer.run_epoch if wrap_epoch is None else wrap_epoch(
        trainer.run_epoch)
    sync(device)
    t0 = time.perf_counter()
    epochs = 0
    while True:
        run_epoch()
        epochs += 1
        if time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    wall = time.perf_counter() - t0
    train_loss, val_loss = trainer.history_tensors(done_before)[:2]
    bad = ~(torch.isfinite(train_loss) & torch.isfinite(val_loss))
    return Window(t0, wall, epochs, epochs * trainer.spec.n_folds,
                  int(bad.sum()))
