"""The reference's training loop in float32 with TF32 off.

Each model module writes one model on one batch.  ``torch.func.vmap``
runs it over the folds side by side (each fold its own weights, batch and
masks), and ``torch.func.grad_and_value`` gives each fold's gradient.  Per
epoch and fold: the batches of :func:`protocol.epoch_slots` (the padding
slots at the end of the last batch count in the BatchNorm statistics and
weigh 0 in the loss), the forward with the dropout masks of the program's
stream, the weighted cross-entropy, the gradient, the reference's
gradient clamp, and ``torch.optim.Adam`` over the folds' stacked weights
(elementwise, so each fold's update is its own); then the validation set in
order, in batches, as a ``DataLoader`` without shuffling gives it.  The
masks of one train step are drawn for every fold at once, from one
generator on the device seeded ``seed + 2``, in the shapes the model
module names.
"""

from __future__ import annotations

import contextlib
import importlib
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import protocol


def model_module(name: str):
    """``portbench/reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}")


@contextlib.contextmanager
def full_f32():
    """TF32 off for cuBLAS and cuDNN inside the block."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


@dataclass
class Followed:
    """What the reference computed; parameters as ``{name: (G, ...)}`` on
    the device, series as ``(G,)`` tensors."""

    init: dict = field(default_factory=dict)
    step_losses: list[torch.Tensor] = field(default_factory=list)
    first_grads: dict = field(default_factory=dict)
    after_steps: dict = field(default_factory=dict)
    epoch_params: list[dict] = field(default_factory=list)
    val_loss: list[torch.Tensor] = field(default_factory=list)
    val_hits: list[torch.Tensor] = field(default_factory=list)


def weighted_ce(logits, y, w):
    """Cross-entropy averaged over the slots of weight > 0."""
    ce = F.cross_entropy(logits, y, reduction="none")
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def follow(cfg: dict, traffic: dict, seed: int, pool_x: torch.Tensor,
           pool_y: torch.Tensor, *, schedule: str, epochs: int,
           steps: int) -> Followed:
    """Train every fold of the traffic's protocol for ``epochs`` epochs,
    keeping the first ``steps`` train steps' losses, the first gradient as
    the optimizer gets it, the parameters after ``steps`` steps and after
    each epoch, and each epoch's validation loss and correct count."""
    with full_f32():
        return _follow(cfg, traffic, seed, pool_x, pool_y, schedule, epochs,
                       steps)


def _stack(dicts: list[dict], device) -> dict:
    return {k: torch.stack([d[k] for d in dicts]).to(device)
            for k in dicts[0]}


def _follow(cfg, traffic, seed, pool_x, pool_y, schedule, epochs, steps):
    mod = model_module(cfg["reference"])
    device = pool_x.device
    folds = protocol.folds_of(traffic)
    n_folds = len(folds)
    batch = traffic["batch_size"]
    rate = traffic["dropout"]
    n_train = protocol.n_batches(max(len(f[0]) for f in folds), batch)

    init_gen = torch.Generator().manual_seed(seed)
    drawn = [mod.init(cfg, init_gen) for _ in range(n_folds)]
    params = _stack([p for p, _ in drawn], device)
    stats = _stack([s for _, s in drawn], device)
    out = Followed(init={k: v.clone() for k, v in params.items()})
    for v in params.values():
        v.requires_grad_(True)
    opt = torch.optim.Adam(list(params.values()),
                           lr=traffic["learning_rate"], betas=(0.9, 0.999),
                           eps=traffic["adam_eps"])
    mask_gen = torch.Generator(device=device).manual_seed(seed + 2)
    shapes = (mod.mask_draws(cfg, schedule, n_folds, batch) if rate > 0
              else [])

    def loss_of(p, s, x, y, w, *masks):
        logits, new = mod.forward(cfg, p, s, x, train=True,
                                  masks=list(masks), rate=rate)
        return weighted_ce(logits, y, w), new

    step_fn = torch.func.vmap(torch.func.grad_and_value(loss_of,
                                                        has_aux=True))
    taken = 0
    for epoch in range(epochs):
        slots = [protocol.epoch_slots(tr, n_train * batch, seed + 1, g, epoch)
                 for g, (tr, _, _) in enumerate(folds)]
        idx = torch.from_numpy(np.stack([s[0] for s in slots])).to(device)
        wts = np.stack([s[1] for s in slots])
        w_all = torch.from_numpy(wts).to(device)
        for step in range(n_train):
            sl = slice(step * batch, (step + 1) * batch)
            if not wts[:, sl].any(axis=1).all():
                raise NotImplementedError(
                    "a fold without a real trial in a batch: torch.optim.Adam "
                    "over stacked folds cannot leave one fold's step out")
            masks = [mod.fold_masks(cfg, schedule, torch.rand(
                shape, generator=mask_gen, device=device), layer)
                for layer, shape in enumerate(shapes)]
            b = idx[:, sl]
            grads, (loss, new_stats) = step_fn(
                {k: v.detach() for k, v in params.items()}, stats,
                pool_x[b], pool_y[b], w_all[:, sl], *masks)
            for name, param in params.items():
                grad = grads[name]
                if traffic["maxnorm_mode"] == "reference" and \
                        name in mod.MAXNORM:
                    limit = mod.MAXNORM[name]
                    grad = torch.clamp(grad, -limit, limit)
                param.grad = grad
            opt.step()
            stats = {k: v.detach() for k, v in new_stats.items()}
            if taken == 0:
                out.first_grads = {k: p.grad.clone()
                                   for k, p in params.items()}
            taken += 1
            if taken <= steps:
                out.step_losses.append(loss.detach())
            if taken == steps:
                out.after_steps = {k: v.detach().clone()
                                   for k, v in params.items()}
        out.epoch_params.append({k: v.detach().clone()
                                 for k, v in params.items()})
        loss, hits = _validate(mod, cfg, params, stats, folds, pool_x,
                               pool_y, batch)
        out.val_loss.append(loss)
        out.val_hits.append(hits)
    return out


def _validate(mod, cfg, params, stats, folds, pool_x, pool_y, batch):
    """Each fold's validation loss (the mean over its batches of the batch
    mean) and correct count: batch ``b`` of every fold at once."""
    device = pool_x.device
    val = [np.asarray(va) for _, va, _ in folds]
    n_val = max(len(v) for v in val)

    def forward(p, s, x):
        return mod.forward(cfg, p, s, x, train=False)[0]

    eval_fn = torch.func.vmap(forward)
    detached = {k: v.detach() for k, v in params.items()}
    sums = torch.zeros(len(folds), device=device, dtype=torch.float64)
    batches = torch.zeros(len(folds), device=device, dtype=torch.float64)
    hits = torch.zeros(len(folds), device=device, dtype=torch.int64)
    with torch.no_grad():
        for b in range(protocol.n_batches(n_val, batch)):
            sl = slice(b * batch, (b + 1) * batch)
            part = [v[sl] for v in val]
            n = torch.tensor([len(p) for p in part], device=device)
            # ragged folds: pad with each fold's first trial, weight 0
            rows = np.stack([np.concatenate([p, np.full(batch - len(p),
                                                        v[0])])
                             for p, v in zip(part, val)])
            idx = torch.from_numpy(rows).to(device)
            w = (torch.arange(batch, device=device)[None] < n[:, None])
            logits = eval_fn(detached, stats, pool_x[idx])
            y = pool_y[idx]
            ce = F.cross_entropy(logits.transpose(1, 2), y, reduction="none")
            real = n > 0
            mean = torch.sum(ce * w, 1) / torch.clamp(n, min=1)
            sums += torch.where(real, mean, torch.zeros_like(mean)).double()
            batches += real.double()
            hits += torch.sum((torch.argmax(logits, -1) == y) & w, 1)
    return (sums / batches).float(), hits
