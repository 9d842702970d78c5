"""The mesh drill: the data-parallel step, ZeRO and the time-sharded EMS in
one world of rank processes, beside their one-process counterparts.

    python -m eegnetreplication_tpu_torch.utils.mesh_drill --out d.npz \\
        [--inputs in.npz] [--timing] [--json summary.json]

Four ranks (``parallel/launch.py``, forked: run it in a fresh process)
join one world and build three meshes over it, every rank in the same
order: ``(2 fold, 2 data, 1)``, ``(1, 2 data, 2 model)`` and ``(1, 4 data,
1)``.  Then:

- **DP step.**  Both fold lines of the first mesh run the data-parallel
  step (``parallel/dp.py``) on the same global batches at dropout 0, in
  both BatchNorm modes; rank 0 also runs the port's one-process step on
  the whole batch.  Recorded: each step's loss, the parameters and
  statistics after the first step, the parameters after the last, and the
  data-parallel eval's loss sum and correct count on the first batch.
  The same under the ``bf16`` numerics mode (flax BatchNorm, a bf16
  model inside ``utils/device.py::numerics``): each step's loss.
- **ZeRO.**  The second mesh runs the step with the Adam moments
  partitioned over its model axis (``shard_state``); recorded: the
  parameters after every step beside the replicated step's (the first
  mesh), and each rank's moment elements.
- **EMS.**  ``ems_time_sharded`` of one recording over 2 ranks (the first
  mesh's data axis) and over 4 (the third mesh), beside the one-shot
  ``scan`` (K2s) and ``pallas`` (K2) methods on rank 0, and each rank's
  K2s launches in each call.
- **Mesh shapes.**  ``make_mesh``'s shapes and its ``ValueError`` cases,
  ``make_hybrid_mesh`` over two blocks of two ranks.
- ``--timing`` (on the card): the DP step's ms against the one-process
  step's and the ms of the gloo ``all_reduce`` of the flat gradient, each
  the median of host-clock windows ended by a synchronize.

``--inputs`` is an ``.npz`` of :func:`make_inputs`'s keys (the tests feed
weights from the JAX initialization); without it the inputs are drawn
from seed 0 at EEGNet's full width (C=22, T=257, F1=8, D=2, batch 64,
20 steps, a (22, 345600) session).  Rank 0 writes every record to
``--out``; :func:`summary` reads them into the gates the smoke checks.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

BN_MODES = ("flax", "torch")
# The bf16 DP step against the one-process bf16 step: each loss within 8
# of bf16's unit roundoffs (2**-8), relative.  Splitting the batch changes
# which bf16 convolution algorithm runs and the order of the synced
# BatchNorm's f32 sums, so the two round differently.
BF16_LOSS_RTOL = 8 * 2.0 ** -8
EMS_ATOL, EMS_RTOL = 2e-4, 2e-3


def make_inputs(c: int = 22, t: int = 257, f1: int = 8, d: int = 2,
                batch: int = 64, steps: int = 20, seed: int = 0,
                ems_shape=(22, 345_600), ems_block: int = 1000
                ) -> dict[str, np.ndarray]:
    """Seeded inputs: an EEGNet's ``state_dict`` (``sd/<name>``, drawn
    from ``seed`` by the port's init), ``steps`` global batches, Adam's
    settings and an EMS recording."""
    from eegnetreplication_tpu_torch.models import EEGNet

    model = EEGNet(c, t, 4, f1, d, device="cpu",
                   generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    out = {f"sd/{k}": v.numpy() for k, v in model.state_dict().items()
           if not k.endswith("num_batches_tracked")}
    rows, length = ems_shape
    session = np.cumsum(rng.standard_normal((rows, length)), axis=1) * 0.05
    session += rng.standard_normal((rows, length))
    out.update(
        geometry=np.array([c, t, f1, d]),
        x=rng.standard_normal((steps, batch, c, t)).astype(np.float32),
        y=rng.integers(0, 4, (steps, batch)).astype(np.int64),
        w=np.ones((steps, batch), np.float32),
        adam=np.array([1e-3, 1e-7]),
        ems_x=session.astype(np.float32),
        ems=np.array([1e-3, ems_block]))
    return out


def _flat(state) -> tuple[np.ndarray, np.ndarray]:
    return state.params[0].cpu().numpy(), state.stats[0].cpu().numpy()


def _timed(torch_, fn, device, n: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn`` over ``n`` host-clock windows, each ended by a
    synchronize."""
    times = []
    for i in range(warmup + n):
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch_.cuda.synchronize(device)
        if i >= warmup:
            times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def world_body(inputs_path: str, out_path: str, timing: bool) -> int:
    """One rank of the drill (module docstring); rank 0 writes
    ``out_path``."""
    import torch.distributed as dist

    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.ops import ems as ems_lib
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems_stream
    from eegnetreplication_tpu_torch.parallel import (
        dp,
        make_hybrid_mesh,
        make_mesh,
        shardspec,
    )
    from eegnetreplication_tpu_torch.training import steps
    from eegnetreplication_tpu_torch.utils.device import (
        numerics,
        select_device,
    )

    device = select_device()
    rank = dist.get_rank()
    inp = dict(np.load(inputs_path))
    c, t, f1, d = (int(v) for v in inp["geometry"])
    lr, eps = (float(v) for v in inp["adam"])
    x = torch.from_numpy(inp["x"]).to(device)[:, None]     # (S, 1, B, C, T)
    y = torch.from_numpy(inp["y"]).to(device)[:, None]
    w = torch.from_numpy(inp["w"]).to(device)[:, None]
    n_steps = x.shape[0]
    rec: dict[str, np.ndarray] = {}
    info: dict = {}

    # -- the meshes, in the same order in every rank --------------------
    shapes = {"default": dict(make_mesh().shape),
              "fold_model_4": dict(make_mesh(n_model=4).shape)}
    mesh_a = make_mesh(n_fold=2, n_data=2)
    mesh_b = make_mesh(n_fold=1, n_data=2, n_model=2)
    mesh_c = make_mesh(n_fold=1, n_data=4)
    shapes.update(a=dict(mesh_a.shape), b=dict(mesh_b.shape),
                  c=dict(mesh_c.shape))
    errors = []
    for kw in ({"n_fold": 3, "n_data": 3}, {"n_fold": 4, "n_model": 3},
               {"n_fold": 3}):
        try:
            make_mesh(**kw)
        except ValueError as exc:
            errors.append(str(exc))
    local = os.environ.get("LOCAL_WORLD_SIZE")
    os.environ["LOCAL_WORLD_SIZE"] = "2"
    hybrid = make_hybrid_mesh(n_data_per_host=2)
    shapes["hybrid"] = dict(hybrid.shape)
    shapes["hybrid_data_ranks"] = list(hybrid.group("data").ranks)
    try:
        make_hybrid_mesh(n_data_per_host=4)
    except ValueError as exc:
        errors.append(str(exc))
    os.environ["LOCAL_WORLD_SIZE"] = local or "4"
    info.update(shapes=shapes, errors=errors,
                coords_a=mesh_a.coords, coords_b=mesh_b.coords)

    def fresh_state(model):
        layout = steps.StateLayout.of(model)
        sd = {k: torch.from_numpy(inp[f"sd/{k}"])[None]
              for k in layout.params.names + layout.stats.names}
        return steps.TrainState.create(layout, sd).to(device)

    def model_of(mode, synced=True, **kw):
        return EEGNet(c, t, 4, f1, d, dropout_rate=0.0, bn_mode=mode,
                      bn_axis_name="data" if synced else None, device="cpu",
                      **kw)

    # -- DP against the one-process step, both BatchNorm modes ----------
    for mode in BN_MODES:
        model = model_of(mode)
        step = dp.make_dp_train_step(model, mesh_a, learning_rate=lr,
                                     adam_eps=eps)
        state = fresh_state(model)
        losses = []
        for s in range(n_steps):
            state, loss = step(state, x[s], y[s], w[s])
            losses.append(float(loss[0]))
            if s == 0:
                rec[f"dp/{mode}/params1"], rec[f"dp/{mode}/stats1"] = \
                    _flat(state)
        rec[f"dp/{mode}/loss"] = np.array(losses)
        rec[f"dp/{mode}/params"], rec[f"dp/{mode}/stats"] = _flat(state)
        if mode == "flax":
            evaluate = dp.make_dp_eval_step(model, mesh_a)
            loss_sum, correct = evaluate(state, x[0], y[0], w[0])
            rec["eval/loss_sum"] = loss_sum.cpu().numpy()
            rec["eval/correct"] = correct.cpu().numpy()
        if rank == 0:
            single = model_of(mode, synced=False)
            state = fresh_state(single)
            losses = []
            for s in range(n_steps):
                state, loss, _ = steps.train_step(
                    single, state, x[s], y[s], w[s], learning_rate=lr,
                    adam_eps=eps)
                losses.append(float(loss[0]))
                if s == 0:
                    rec[f"single/{mode}/params1"], \
                        rec[f"single/{mode}/stats1"] = _flat(state)
            rec[f"single/{mode}/loss"] = np.array(losses)
            rec[f"single/{mode}/params"] = _flat(state)[0]
        dist.barrier()

    # -- the bf16 mode: DP against the one-process step -------------------
    bf16 = {"dtype": torch.bfloat16, "precision": None}
    with numerics("bf16"):
        step = dp.make_dp_train_step(model_of("flax", **bf16), mesh_a,
                                     learning_rate=lr, adam_eps=eps)
        state = fresh_state(model_of("flax", **bf16))
        losses = []
        for s in range(n_steps):
            state, loss = step(state, x[s], y[s], w[s])
            losses.append(float(loss[0]))
        rec["dp/bf16/loss"] = np.array(losses)
        if rank == 0:
            single = model_of("flax", synced=False, **bf16)
            state = fresh_state(single)
            losses = []
            for s in range(n_steps):
                state, loss, _ = steps.train_step(
                    single, state, x[s], y[s], w[s], learning_rate=lr,
                    adam_eps=eps)
                losses.append(float(loss[0]))
            rec["single/bf16/loss"] = np.array(losses)
    dist.barrier()

    # -- ZeRO against the replicated step --------------------------------
    model = model_of("flax")
    replicated = dp.make_dp_train_step(model, mesh_a, learning_rate=lr,
                                       adam_eps=eps)
    spec = shardspec.state_shard_spec(fresh_state(model), mesh_b)
    zero = dp.make_dp_train_step(model, mesh_b, learning_rate=lr,
                                 adam_eps=eps, spec=spec)
    r_state = fresh_state(model)
    z_state = shardspec.shard_state(fresh_state(model), mesh_b, spec)
    r_params, z_params = [], []
    for s in range(n_steps):
        r_state, _ = replicated(r_state, x[s], y[s], w[s])
        z_state, _ = zero(z_state, x[s], y[s], w[s])
        r_params.append(_flat(r_state)[0])
        z_params.append(_flat(z_state)[0])
    rec["zero/replicated"] = np.stack(r_params)
    rec["zero/sharded"] = np.stack(z_params)
    numel = [None] * dist.get_world_size()
    dist.all_gather_object(numel, int(z_state.mu.shape[1]))
    rec["zero/local_numel"] = np.array(numel)
    rec["zero/total_numel"] = np.array(r_state.mu.shape[1])
    info["zero_jax_dims"] = dict(spec.jax_dims)
    info["zero_port_dims"] = dict(spec.update)

    # -- the time-sharded EMS ---------------------------------------------
    factor, block = float(inp["ems"][0]), int(inp["ems"][1])
    session = torch.from_numpy(inp["ems_x"]).to(device)
    launches = {}
    for name, mesh in (("2", mesh_a), ("4", mesh_c)):
        before = ems_stream.launches
        out = ems_lib.ems_time_sharded(session, mesh, "data", factor, block)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, ems_stream.launches - before)
        launches[name] = counts
        rec[f"ems/{name}"] = out.cpu().numpy()
    if rank == 0:
        for method in ("scan", "pallas"):
            rec[f"ems/{method}"] = ems_lib.exponential_moving_standardize(
                session, factor, block, method=method).cpu().numpy()
    info["ems_launches"] = launches
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    k1s = [None] * dist.get_world_size()
    dist.all_gather_object(k1s, block1_stacked.launches)
    info["k1_stacked_launches"] = k1s

    # -- timings -------------------------------------------------------------
    if timing:
        step = dp.make_dp_train_step(model, mesh_a, learning_rate=lr,
                                     adam_eps=eps)
        box = {"s": fresh_state(model)}

        def dp_step():
            box["s"], _ = step(box["s"], x[0], y[0], w[0])

        info["dp_step_ms"] = _timed(torch, dp_step, device)
        data = mesh_a.group("data")
        flat = torch.zeros((1, fresh_state(model).params.shape[1] + 1),
                           device=device)
        info["all_reduce_ms"] = _timed(torch, lambda: data.sum(flat),
                                       device, n=30)
        info["all_reduce_bytes"] = int(flat.numel() * 4)
        dist.barrier()
        if rank == 0:
            single = model_of("flax", synced=False)
            sbox = {"s": fresh_state(single)}

            def one_step():
                sbox["s"], _, _ = steps.train_step(
                    single, sbox["s"], x[0], y[0], w[0], learning_rate=lr,
                    adam_eps=eps)

            info["single_step_ms"] = _timed(torch, one_step, device)
        dist.barrier()
    if rank == 0:
        rec["geometry"] = inp["geometry"]
        rec["adam"] = inp["adam"]
        rec["__json__"] = np.array(json.dumps(info))
        np.savez(out_path, **rec)
    dist.barrier()
    return 0


def run(inputs: dict[str, np.ndarray], out_path: str | Path, *,
        timing: bool = False, world: int = 4) -> dict:
    """Launch the drill's world on ``inputs`` and return rank 0's records
    (``info`` under ``"info"``).  Call it from a process that has not
    touched CUDA: the ranks are forked."""
    from eegnetreplication_tpu_torch.parallel import launch

    with tempfile.TemporaryDirectory(prefix="mesh_drill_") as tmp:
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **inputs)
        code = launch.launch(world_body, world,
                             (path, str(out_path), timing))
    if code != 0:
        raise RuntimeError(f"mesh drill: the world exited {code}")
    with np.load(out_path) as f:
        rec = {k: f[k] for k in f.files}
    rec["info"] = json.loads(str(rec.pop("__json__")))
    return rec


def _rel_close(a, b, rtol: float, atol: float = 0.0) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=atol))


# Parameters whose true gradient is 0 up to BatchNorm's eps: the temporal
# BatchNorm's scale and shift, which the BatchNorm after the depthwise
# spatial convolution normalizes away (each of its channels reads one
# temporal filter).  Adam turns their rounding-noise gradients into steps
# of about the learning rate either way, so they are held to steps x
# learning rate.
ZERO_GRADIENT_PARAMS = ("temporal.1.weight", "temporal.1.bias")


def param_errors(rec: dict, got: str, want: str) -> dict[str, float]:
    """Max abs difference of two flat parameter records, by name."""
    from eegnetreplication_tpu_torch.models import EEGNet
    from eegnetreplication_tpu_torch.training.steps import StateLayout

    c, t, f1, d = (int(v) for v in rec["geometry"])
    layout = StateLayout.of(EEGNet(c, t, 4, f1, d, device="cpu"))
    views = [layout.params.views(torch.from_numpy(rec[k])[None])
             for k in (got, want)]
    return {name: float((views[0][name] - views[1][name]).abs().max())
            for name in layout.params.names}


def summary(rec: dict) -> dict:
    """The gates of a drill's records: the DP step against the one-process
    step (the tolerances of the JAX package's DP test: the first step's
    loss within rtol 1e-5 and statistics within rtol 1e-4 / atol 1e-6,
    every step's loss within rtol 1e-3; and after the last step every
    parameter within atol 1e-4, the zero-gradient ones within steps x
    learning rate), ZeRO bitwise the replicated step with 1/n of the
    moment elements a rank, the time-sharded EMS within atol 2e-4 / rtol
    2e-3 of the one-shot ``scan`` and of K2.  Under bf16 every step's loss
    lies within :data:`BF16_LOSS_RTOL` of the one-process bf16 step's."""
    info = rec["info"]
    out: dict = {"info": info}
    lr = float(rec["adam"][0])
    for mode in BN_MODES:
        dp_loss, sd_loss = rec[f"dp/{mode}/loss"], rec[f"single/{mode}/loss"]
        errors = param_errors(rec, f"dp/{mode}/params",
                              f"single/{mode}/params")
        params_ok = all(
            err <= (len(dp_loss) * lr if name in ZERO_GRADIENT_PARAMS
                    else 1e-4) for name, err in errors.items())
        out[f"dp_{mode}"] = {
            "params_max_abs_err_by_name": errors,
            "loss_rel_err_first": float(abs(dp_loss[0] - sd_loss[0])
                                        / abs(sd_loss[0])),
            "loss_max_rel_err": float(np.max(np.abs(dp_loss - sd_loss)
                                             / np.abs(sd_loss))),
            "params_max_abs_err": float(np.max(np.abs(
                rec[f"dp/{mode}/params"] - rec[f"single/{mode}/params"]))),
            "params1_max_abs_err": float(np.max(np.abs(
                rec[f"dp/{mode}/params1"] - rec[f"single/{mode}/params1"]))),
            "stats1_max_abs_err": float(np.max(np.abs(
                rec[f"dp/{mode}/stats1"] - rec[f"single/{mode}/stats1"]))),
            "ok": (_rel_close(dp_loss[0], sd_loss[0], 1e-5)
                   and _rel_close(dp_loss, sd_loss, 1e-3) and params_ok
                   and _rel_close(rec[f"dp/{mode}/stats1"],
                                  rec[f"single/{mode}/stats1"], 1e-4,
                                  1e-6))}
    dp_loss, sd_loss = rec["dp/bf16/loss"], rec["single/bf16/loss"]
    out["dp_bf16"] = {
        "loss_max_rel_err": float(np.max(np.abs(dp_loss - sd_loss)
                                         / np.abs(sd_loss))),
        "rtol": BF16_LOSS_RTOL,
        "ok": _rel_close(dp_loss, sd_loss, BF16_LOSS_RTOL)}
    numel = rec["zero/local_numel"]
    out["zero"] = {
        "bitwise": bool(np.array_equal(rec["zero/replicated"],
                                       rec["zero/sharded"])),
        "local_numel": numel.tolist(),
        "total_numel": int(rec["zero/total_numel"]),
        "ok": (bool(np.array_equal(rec["zero/replicated"],
                                   rec["zero/sharded"]))
               and all(2 * int(n) == int(rec["zero/total_numel"])
                       for n in numel))}
    for n in ("2", "4"):
        got = rec[f"ems/{n}"]
        row = {}
        for ref in ("scan", "pallas"):
            want = rec[f"ems/{ref}"]
            row[f"max_abs_err_vs_{ref}"] = float(np.max(np.abs(got - want)))
            row[f"ok_vs_{ref}"] = _rel_close(got, want, EMS_RTOL, EMS_ATOL)
        row["launches"] = info["ems_launches"][n]
        out[f"ems_{n}"] = row
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True,
                        help="Rank 0's records (.npz).")
    parser.add_argument("--inputs", default=None,
                        help="Inputs (.npz of make_inputs' keys); default: "
                             "drawn from --seed at full width.")
    parser.add_argument("--timing", action="store_true",
                        help="Time the DP step, the one-process step and "
                             "the all_reduce of the flat gradient.")
    parser.add_argument("--json", default=None,
                        help="Also write summary() as JSON here.")
    args = parser.parse_args(argv)
    inputs = (dict(np.load(args.inputs)) if args.inputs
              else make_inputs())
    t0 = time.perf_counter()
    rec = run(inputs, args.out, timing=args.timing)
    result = summary(rec)
    result["wall_s"] = time.perf_counter() - t0
    text = json.dumps(result, indent=1)
    if args.json:
        Path(args.json).write_text(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
