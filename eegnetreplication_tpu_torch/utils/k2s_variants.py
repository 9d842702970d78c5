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
- ``no_divsqrt``: the output warps add instead of dividing by the square
  root (the price of the correctly rounded ``__fdiv_rn``/``__fsqrt_rn``);
- ``no_chain``: the m and v warps skip the recurrences (what the producer,
  the output warp and the ring's hand-offs cost on their own);
- ``no_copy``: the producer issues no copies (the chain, the output and
  the hand-offs without the loads);
- ``try_wait``: the waits suspend in ``mbarrier.try_wait`` instead of
  polling ``mbarrier.test_wait``;
- ``ring8``: a ring of 8 tiles with 4 in flight instead of 4 and 2;
- ``tile256``: tiles of 256 samples instead of 512;
- ``push_off``: every chunk through the ring, pushes too;
- ``push32``: only chunks of up to 32 samples on one warp, not 256;
- ``v_on_m_scheduler``: the v warp is warp 4, on the m warp's scheduler;
- ``ch2``, ``ch4``: 2 or 4 channels a block instead of 1.

First it measures, with ``clock64`` in one warp, what bounds a chain:
SM cycles a step of ``m = c * m + u`` (a dependent ``__fmul_rn`` then
``__fadd_rn``) takes alone, and with 2, 4 and 7 more f32 operations a
step that read ``m`` but do not feed the chain (a lone warp's issue rate:
the whole step of ``step`` is the chain and 7 more).  Also writes
``nvcc``'s ptxas report of each variant and the ``full`` variant's SASS
(``cuobjdump -sass``) into ``DIR``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
from pathlib import Path

import torch

from eegnetreplication_tpu_torch.ops import build

SHAPES = ((22, 345_600), (1, 345_600), (22, 250), (22, 25))
OUT_LINE = "__fdiv_rn(dev[r][j], __fsqrt_rn(__fadd_rn(var[r][j], eps)))"


def variants(src: str) -> dict[str, str]:
    """Each variant's source: the checkout's K2s with text edits; an edit
    whose text is not in the source raises."""
    edits = {
        "no_divsqrt": [(OUT_LINE, "dev[r][j] + var[r][j]")],
        "no_chain": [("const bool chain = lane < rows;",
                      "const bool chain = false;")],
        "no_copy": [("if (i < n_tiles) issue(i);", ";"),
                    ("if (j + kAhead - 1 < n_tiles) issue(j + kAhead - 1);",
                     ";")],
        "try_wait": [("mbarrier.test_wait.parity",
                      "mbarrier.try_wait.parity")],
        "ring8": [("constexpr int kRing = 4;", "constexpr int kRing = 8;"),
                  ("constexpr int kAhead = 2;", "constexpr int kAhead = 4;")],
        "tile256": [("constexpr int kTile = 512;",
                     "constexpr int kTile = 256;")],
        "push_off": [("constexpr int kPush = 256;",
                      "constexpr int kPush = 0;")],
        "push32": [("constexpr int kPush = 256;",
                    "constexpr int kPush = 32;")],
        "v_on_m_scheduler": [("constexpr int kWarpV = 1;",
                              "constexpr int kWarpV = 4;")],
        "ch2": [("constexpr int kChannels = 1;",
                 "constexpr int kChannels = 2;")],
        "ch4": [("constexpr int kChannels = 1;",
                 "constexpr int kChannels = 4;")],
    }
    out = {"full": src}
    for name, pairs in edits.items():
        text = src
        for old, new in pairs:
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        out[name] = text
    return out


CHAIN_SRC = r"""
#include <cstdio>
// Cycles a step of one warp's chain m = c * m + u, with kSide more f32
// operations a step that read m but that the chain does not wait on
// (d = z - m, kSide - 2 products, a sum), as the step's other work does.
template <int kSide>
__global__ void chain(float* io, long long* cycles, float c, int n) {
  float m = io[0], z[32], side = 0.0f;
  for (int k = 0; k < 32; ++k) z[k] = io[1] + k;
  const long long t0 = clock64();
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      m = __fadd_rn(__fmul_rn(c, m), z[k]);
      if (kSide > 0) {
        float d = __fsub_rn(z[k], m);
#pragma unroll
        for (int e = 0; e < kSide - 2; ++e) d = __fmul_rn(d, c);
        side = __fadd_rn(side, d);
      }
    }
  }
  cycles[0] = clock64() - t0;
  io[2] = m + side;
}
template <int kSide>
void run(float* io, long long* cycles, int n) {
  chain<kSide><<<1, 32>>>(io, cycles, 0.999f, n);
  long long c = 0;
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  std::printf("chain step with %d side operations: %.2f SM cycles\n",
              kSide, double(c) / (32.0 * n));
}
int main() {
  float* io;
  long long* cycles;
  cudaMalloc(&io, 16);
  cudaMalloc(&cycles, 8);
  const float h[3] = {1.0f, 0.5f, 0.0f};
  cudaMemcpy(io, h, sizeof(h), cudaMemcpyHostToDevice);
  run<0>(io, cycles, 20000);
  run<2>(io, cycles, 20000);
  run<4>(io, cycles, 20000);
  run<7>(io, cycles, 20000);
  return 0;
}
"""


def chain_cycles(out: Path) -> str:
    """Build and run the chain probe (``CHAIN_SRC``); returns its lines."""
    cu, exe = out / "chain.cu", out / "chain"
    cu.write_text(CHAIN_SRC)
    subprocess.run([build.nvcc_path(), "-gencode=arch=compute_90a,code=sm_90a",
                    "-O3", "-o", str(exe), str(cu)], check=True)
    return subprocess.run([str(exe)], capture_output=True, text=True,
                          check=True).stdout.strip()


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
    """Median device time of one ``fn()`` from CUDA events; each timed call
    is enqueued behind a spin kernel, so the events bracket the call's
    device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


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
    print(chain_cycles(out), flush=True)
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
