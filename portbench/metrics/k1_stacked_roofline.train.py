"""K1-stacked's share of its roofline in the validation pass: the least
time a launch of its shape could take (``yardstick.block1_stacked``: bytes
at the card's bandwidth or operations at its FP32 peak, the larger), over
the mean time of the kernel by name in the trace."""

from portbench import yardstick

KERNEL = "block1_stacked_kernel"


def read(run):
    times = [t for name, ts in run.trace.by_name().items() if KERNEL in name
             for t in ts]
    if not times:
        return None
    cfg, traffic = run.cell.config, run.cell.traffic
    nbytes, flops = yardstick.block1_stacked(
        run.n_folds * traffic["batch_size"], cfg["n_channels"],
        cfg["n_times"], cfg["F1"] * cfg["D"], run.n_folds,
        cfg["temporal_kernel"], cfg["pool_1"])
    bound = yardstick.bound_s(nbytes, flops, run.device_kind)
    if bound is None:
        return None
    return 100.0 * bound / (sum(times) / len(times))
