"""The committed Orbax fixture, and a load timer for Orbax directories.

``tests/fixtures/orbax_eegnet/`` holds an EEGNet at the product width
(22 x 257, F1 = 8, D = 2) with seeded variables (``torch_port_cases.
jax_variables(..., seed=SEED)``), written by the JAX package twice:
``eegnet.orbax/`` through its ``save_orbax_checkpoint`` (Orbax's default
layout: OCDBT, zstd-compressed nodes and zarr chunks) and ``eegnet.npz``
through its ``save_checkpoint``.  The card's machine has no JAX and cannot
write it, so the file is committed; ``chip_smoke.py`` loads it there.

Regenerate it (the JAX package, on the CPU)::

    JAX_PLATFORMS=cpu python tests/orbax_fixture.py

Write a JAX-written DeepConvNet at the product width (22 x 257) into DIR, to
time a load of 0.6 MB of zstd-compressed chunks::

    JAX_PLATFORMS=cpu python tests/orbax_fixture.py --deep DIR

Time the port's load of an Orbax directory (no JAX; on the card's host)::

    python tests/orbax_fixture.py --time DIR [--repeats N]
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "orbax_eegnet"
SEED = 20
GEOMETRY = (22, 257, 8, 2)
METADATA = {"model": "eegnet", "n_channels": 22, "n_times": 257, "F1": 8,
            "D": 2}
DEEP_GEOMETRY = (22, 257)


def seeded_variables():
    """``(params, batch_stats)`` of the fixture: numpy leaves in flax
    names and layouts."""
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from torch_port_cases import jax_variables

    return jax_variables(*GEOMETRY, seed=SEED)


def write_fixture(out: Path = FIXTURE) -> None:
    from eegnetreplication_tpu.training import checkpoint as jax_ckpt
    from eegnetreplication_tpu.training import orbax_io as jax_orbax

    params, batch_stats = seeded_variables()
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    jax_orbax.save_orbax_checkpoint(out / "eegnet.orbax", params,
                                    batch_stats, METADATA)
    jax_ckpt.save_checkpoint(out / "eegnet.npz", params, batch_stats,
                             METADATA)


def write_deep(out: Path) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from eegnetreplication_tpu.models import get_model
    from eegnetreplication_tpu.training import orbax_io as jax_orbax

    c, t = DEEP_GEOMETRY
    model = get_model("deep_convnet", n_channels=c, n_times=t)
    variables = model.init(jax.random.PRNGKey(SEED), jnp.zeros((1, c, t)))
    params, batch_stats = (jax.tree_util.tree_map(np.asarray, variables[k])
                           for k in ("params", "batch_stats"))
    shutil.rmtree(out, ignore_errors=True)
    jax_orbax.save_orbax_checkpoint(
        out, params, batch_stats,
        {"model": "deep_convnet", "n_channels": c, "n_times": t})


def time_load(path: Path, repeats: int) -> dict:
    """The port's load of ``path``, each repeat timed on the host clock."""
    from eegnetreplication_tpu_torch.training import orbax_io

    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        state_dict, meta = orbax_io.load_orbax_checkpoint(path)
        times.append((time.perf_counter() - t0) * 1e3)
    n_bytes = sum(int(v.numel()) * v.element_size()
                  for v in state_dict.values())
    on_disk = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    return {"path": str(path), "model": meta.get("model"),
            "array_bytes": n_bytes, "bytes_on_disk": on_disk,
            "load_ms": times}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--deep", type=Path, default=None)
    parser.add_argument("--time", type=Path, default=None)
    parser.add_argument("--repeats", type=int, default=3)
    args = parser.parse_args(argv)
    if args.time is not None:
        print(json.dumps(time_load(args.time, args.repeats)))
    elif args.deep is not None:
        write_deep(args.deep)
    else:
        write_fixture()
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    raise SystemExit(main())
