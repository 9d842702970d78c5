"""Where a port process's start goes, step by step, on the host clock.

    python -m eegnetreplication_tpu_torch.utils.startup [--launched T]

Every port CLI (``serve``, a fleet's replica, ``train``, ``predict``) pays
the same steps before its first request or epoch: the interpreter,
``import torch``, the device's check (``platform_device``: CUDA present,
no context), the numerics pins ``select_device`` adds on the card
(TF32 off and the deterministic mode, which load cuDNN), the first
tensor on the device and the kernels' libraries.  This prints one JSON
object with the seconds of each step and their sum; ``--launched`` (a
``time.time()`` taken by the caller just before it started this process)
adds the interpreter's own start.  It runs on the CPU too
(``EEGTPU_PLATFORM=cpu``), where the card's steps are skipped.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

T_MAIN = time.time()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--launched", type=float, default=None,
                        help="time.time() just before this process started")
    args = parser.parse_args(argv)
    steps = {}
    if args.launched is not None:
        steps["interpreter"] = T_MAIN - args.launched
    t = time.time()

    def step(name):
        nonlocal t
        now = time.time()
        steps[name] = now - t
        t = now

    import torch

    step("import_torch")
    from eegnetreplication_tpu_torch.utils.device import (
        platform_device,
        select_device,
    )

    device = platform_device()
    step("platform_device")
    select_device()
    step("select_device_pins")
    if device.type == "cuda":
        torch.zeros(1, device=device)
        torch.cuda.synchronize()
        step("first_tensor")
        from eegnetreplication_tpu_torch.ops import build

        for name in build.SOURCES:
            build.load(name)
        step("kernel_libraries")
    print(json.dumps({"device": str(device), "steps_s": steps,
                      "total_s": sum(steps.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
