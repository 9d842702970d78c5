"""Where K2s's time goes: time variants of ``ops/csrc/ems_stream.cu``.

    python -m eegnetreplication_tpu_torch.utils.k2s_variants [--out DIR]

``DIR`` defaults to ``eegnetreplication_tpu_torch/_build/k2s_variants``.

On a CUDA card with ``nvcc``.  Each variant is the checkout's K2s source
with one part taken out or resized, built with the port's flags into
``DIR`` and launched through the same C interface on the same inputs; the
outputs of the variants that take something out are not meaningful, only
their times.  Prints the median of 10 launches (CUDA events) at (22,
345600), (1, 345600) and (22, 250), per call and per sample:

- ``full``: the kernel as built;
- ``no_divsqrt``: the output phase adds instead of dividing by the square
  root (the price of the correctly rounded ``__fdiv_rn``/``__fsqrt_rn``);
- ``no_chain``: warp 0 skips the recurrences (what staging, loads, the
  output phase and the barriers cost on their own);
- ``unroll8``: the chain reads 8 steps ahead instead of 32;
- ``tile184``: 184-sample tiles instead of 128 (the most the static shared
  memory holds).

Also writes ``nvcc``'s ptxas report of each variant and the ``full``
variant's SASS (``cuobjdump -sass``) into ``DIR``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from eegnetreplication_tpu_torch.ops import build

SHAPES = ((22, 345_600), (1, 345_600), (22, 250))
OUT_LINE = "__fdiv_rn(dev[r][j], __fsqrt_rn(__fadd_rn(var[r][j], eps)));"


def variants(src: str) -> dict[str, str]:
    edits = {
        "no_divsqrt": (OUT_LINE, "dev[r][j] + var[r][j];"),
        "no_chain": ("const bool chain = tid < 32 && lane < rows;",
                     "const bool chain = false;"),
        "unroll8": ("constexpr int kUnroll = 32;",
                    "constexpr int kUnroll = 8;"),
        "tile184": ("constexpr int kTile = 128;",
                    "constexpr int kTile = 184;"),
    }
    out = {"full": src}
    for name, (old, new) in edits.items():
        if old not in src:
            raise ValueError(f"{name}: {old!r} is not in the source")
        out[name] = src.replace(old, new)
    return out


def build_all(sources: dict[str, str], out: Path) -> dict[str, Path]:
    """One ``nvcc`` per variant, all started together."""
    procs = {}
    for name, text in sources.items():
        cu = out / f"{name}.cu"
        cu.write_text(text)
        so = out / f"lib{name}.so"
        procs[name] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.ptxas.txt").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {proc.returncode}\n"
                               f"{log}")
        libs[name] = so
    return libs


def time_ms(fn, n: int = 10, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=str(build.BUILD_DIR
                                             / "k2s_variants"))
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("k2s_variants: needs a CUDA card")
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "ems_stream.cu").read_text()
    libs = build_all(variants(src), out)
    sass = subprocess.run(
        [str(Path(build.nvcc_path()).parent / "cuobjdump"), "-sass",
         str(libs["full"])], capture_output=True, text=True)
    (out / "full.sass.txt").write_text(sass.stdout + sass.stderr)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c, n in SHAPES:
        x = torch.randn(c, n, device=dev)
        mean0 = torch.zeros(c, device=dev)
        res = torch.empty_like(x)
        for name, so in libs.items():
            fn = ctypes.CDLL(str(so)).eeg_ems_stream_launch
            fn.argtypes = ([ctypes.c_void_p] * 5
                           + [ctypes.c_int, ctypes.c_longlong]
                           + [ctypes.c_float] * 3 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            m, v = torch.zeros(c, device=dev), torch.ones(c, device=dev)

            def call(fn=fn, m=m, v=v):
                err = fn(x.data_ptr(), mean0.data_ptr(), m.data_ptr(),
                         v.data_ptr(), res.data_ptr(), c, n, 1e-3, 0.999,
                         1e-10, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            ms = time_ms(call)
            print(f"C={c} n={n} {name}: {ms:.4f} ms, "
                  f"{ms * 1e6 / n:.2f} ns a sample", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
