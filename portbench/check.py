"""The comparison that decides ``correct``.

The set-up's epochs run through the window's own call (``run_epoch``) on
the trainer the window then drives; the plain reference
(``reference/training.py``) follows the same epochs from the seed alone.
The numbers compared, each against its limit in
``limits/<workload>.json``:

- ``loss1``: the first train step's loss, every fold; the gap over the
  reference's value;
- ``loss``: the same over the first three steps (from the second step on,
  Adam's first update, about ``lr`` times the sign of each gradient
  element, carries the round-off of elements whose gradient is near 0);
- ``grad1``: the first gradient as Adam gets it (its first moment after one
  step, over ``1 - b1``); per fold and parameter, the gap between the
  program's norm and the reference's, over the larger of the reference's
  norm and the fold's median parameter norm;
- ``change3``: the parameters' change over the first three steps, by the
  same measure, leaving out parameters whose reference gradient is under
  a thousandth of the fold's median (their change is round-off);
- ``val_loss``: each warm epoch's validation loss, every fold, the gap over
  the reference's;
- ``val_hits``: each warm epoch's correct validation trials, every fold, the
  difference in trials;
- ``best``: the best-by-validation parameters, whose change since the start
  is held, by ``change3``'s measure, to the reference's parameters after the
  epoch that the reference's rule (the first strict maximum above 0) picks
  from the program's validation accuracies;
- ``nonfinite``: fold-epochs of the window whose training or validation
  loss is not finite (limit 0).

Each is the worst over folds, steps and parameters.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import training as reference

NUMBERS = ("loss1", "loss", "grad1", "change3", "val_loss", "val_hits",
           "best", "nonfinite")
ADAM_B1 = 0.9
STEPS = 3
# A parameter whose reference gradient norm is under this share of the
# fold's median parameter's moves by round-off alone under Adam.
STILL = 1e-3


def leaves(flat: torch.Tensor, names, shapes) -> dict[str, torch.Tensor]:
    """The program's flat ``(G, P)`` vector split into ``(G, n)`` leaves."""
    out, at = {}, 0
    for name, shape in zip(names, shapes):
        n = math.prod(shape)
        out[name] = flat[:, at:at + n].double()
        at += n
    return out


def _norms(stacked: dict) -> dict[str, np.ndarray]:
    """``(G,)`` norms of each of the reference's ``(G, ...)`` leaves."""
    return {k: torch.linalg.vector_norm(v.detach().double().reshape(
        v.shape[0], -1), dim=1).cpu().numpy() for k, v in stacked.items()}


def _norm_gap(prog: dict[str, np.ndarray], ref: dict[str, np.ndarray],
              keep: dict[str, np.ndarray] | None = None) -> float:
    """The worst leaf gap ``|prog - ref| / max(ref, the fold's median
    ref)`` over folds and the kept leaves."""
    names = sorted(ref)
    p = np.stack([prog[k] for k in names], 1)      # (G, leaves)
    r = np.stack([ref[k] for k in names], 1)
    mask = (np.ones_like(r, dtype=bool) if keep is None
            else np.stack([keep[k] for k in names], 1))
    worst = 0.0
    for g in range(r.shape[0]):
        kept = mask[g]
        if not kept.any():
            continue
        scale = np.maximum(np.maximum(r[g, kept], np.median(r[g, kept])),
                           1e-30)
        worst = max(worst, float(np.max(np.abs(p[g, kept] - r[g, kept])
                                        / scale)))
    return worst


def _change(after: dict, start: dict) -> dict:
    return {k: v.detach().double().cpu() - start[k].double().cpu()
            for k, v in after.items()}


def _prog_norms(flat: torch.Tensor, names, shapes) -> dict[str, np.ndarray]:
    return {k: torch.linalg.vector_norm(v, dim=1).numpy()
            for k, v in leaves(flat, names, shapes).items()}


def select_epoch(val_acc: torch.Tensor) -> np.ndarray:
    """Per fold, the epoch (1-based; 0 for the initial state) whose state
    the rule keeps: the first strict maximum above 0."""
    best = np.zeros(val_acc.shape[1])
    picked = np.zeros(val_acc.shape[1], dtype=int)
    for e, row in enumerate(val_acc.numpy()):
        better = row > best
        picked[better] = e + 1
        best = np.maximum(best, row)
    return picked


def numbers(cap, ref: reference.Followed, failed: int) -> dict[str, float]:
    """Every number compared (see the module docstring)."""
    names, shapes = cap.names, cap.shapes
    steps = len(ref.step_losses)
    ref_loss = torch.stack(ref.step_losses).double().cpu()
    gaps = (torch.abs(cap.step_losses[:steps].double() - ref_loss)
            / torch.clamp(ref_loss.abs(), min=1e-12))
    loss1, loss = float(torch.max(gaps[0])), float(torch.max(gaps))

    ref_grad = _norms(ref.first_grads)
    grad1 = _norm_gap(_prog_norms(cap.first_mu / (1.0 - ADAM_B1), names,
                                  shapes), ref_grad)

    median = np.median(np.stack(list(ref_grad.values()), 1), axis=1)
    moving = {k: v >= STILL * median for k, v in ref_grad.items()}
    init_ref = ref.init
    change3 = _norm_gap(_prog_norms(cap.after_steps - cap.init, names, shapes),
                        _norms(_change(ref.after_steps, init_ref)), moving)

    ref_val = torch.stack(ref.val_loss).double().cpu()
    val_loss = float(torch.max(torch.abs(cap.val_loss.double() - ref_val)
                               / torch.clamp(ref_val.abs(), min=1e-12)))
    prog_hits = torch.round(cap.val_acc.double() * cap.val_n.double() / 100)
    ref_hits = torch.stack(ref.val_hits).double().cpu()
    val_hits = float(torch.max(torch.abs(prog_hits - ref_hits)))

    picked = torch.from_numpy(select_epoch(cap.val_acc))
    states = [init_ref] + ref.epoch_params
    chosen = {}
    for k in init_ref:
        stacked = torch.stack([s[k].detach().cpu() for s in states])
        chosen[k] = stacked[picked, torch.arange(len(picked))]
    best = _norm_gap(_prog_norms(cap.best - cap.init, names, shapes),
                     _norms(_change(chosen, init_ref)), moving)
    return {"loss1": loss1, "loss": loss, "grad1": grad1, "change3": change3,
            "val_loss": val_loss, "val_hits": val_hits, "best": best,
            "nonfinite": float(failed)}


def follow(cfg: dict, traffic: dict, seed: int, pool_x, pool_y, schedule: str
           ) -> reference.Followed:
    """The reference over the set-up's epochs."""
    return reference.follow(cfg, traffic, seed, pool_x, pool_y,
                            schedule=schedule, epochs=traffic["warm_epochs"],
                            steps=STEPS)


def judge(values: dict[str, float], limits: dict[str, float]
          ) -> tuple[bool, dict[str, dict[str, float]]]:
    """Whether every number is within its limit, and each beside it."""
    table = {name: {"value": values[name], "limit": limits[name]}
             for name in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in table.values())
    return ok, table
