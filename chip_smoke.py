#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It drives the port's serving
path end to end and holds every hand-written kernel against its plain
PyTorch version:

1. device: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build every kernel from the checkout's sources (``ops/build.py``);
3. K1 (``block1``) against ``block1_reference`` on the card at the serving
   shapes, random and perturbed BatchNorm, atol 1e-5 / rtol 1e-5 (only the
   order of the f32 sums differs);
4. the engine's fused forward on the card against the plain ``EEGNet``
   forward on the CPU: logits to atol 1e-5 / rtol 1e-4, equal argmax;
5. serve: a seeded checkpoint (perturbed BatchNorm) written by the port's
   ``save_checkpoint``, ``python -m eegnetreplication_tpu_torch.serve``
   answering JSON, npz and 8 concurrent requests plus ``/healthz``; its
   predictions must equal the ``predict`` CLI's, every forward must have
   launched K1 exactly once, and SIGTERM must drain and exit 75;
6. times per bucket (1/8/32/128): K1, the plain version and one library
   composite (cuDNN ``conv1d`` + ELU + ``avg_pool1d``) as the median of
   CUDA-event timings, the engine's end-to-end ``infer`` and ``/predict``
   latency on the host clock, each beside its bound on the card.

The last lines are the ``{"kernels": [...]}`` record and, last of all,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import queue
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# without tensor cores.  The bound of a call is the larger of its bytes over
# the first and its FLOPs over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

K1_ATOL, K1_RTOL = 1e-5, 1e-5
LOGITS_ATOL, LOGITS_RTOL = 1e-5, 1e-4
BUCKETS = (1, 8, 32, 128)
N_TIMED = 60             # timed runs per measurement (median)
N_LATENCY = 30           # /predict requests per size (median)
SERVE_START_TIMEOUT_S = 300.0


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


# --------------------------------------------------------------------------
# Seeded models and inputs
# --------------------------------------------------------------------------

def seeded_model(torch, c, t, f1, d, seed, device, perturb_bn=True):
    """An EEGNet drawn from ``seed``; with ``perturb_bn`` its BatchNorm
    affine and running statistics are moved off the identity so the
    folding is exercised."""
    from eegnetreplication_tpu_torch.models import EEGNet

    g = torch.Generator().manual_seed(seed)
    model = EEGNet(c, t, F1=f1, D=d, device="cpu", generator=g)
    if perturb_bn:
        with torch.no_grad():
            for bn in (model.temporal[1], model.aggregation[0],
                       model.block_2[2]):
                n = bn.num_features
                bn.weight.copy_(1.0 + 0.2 * torch.randn(n, generator=g))
                bn.bias.copy_(0.2 * torch.randn(n, generator=g))
                bn.running_mean.copy_(0.3 * torch.randn(n, generator=g))
                bn.running_var.copy_(0.5 + torch.rand(n, generator=g))
    return model.to(device)


def trials(torch, n, c, t, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, c, t), generator=g)


# --------------------------------------------------------------------------
# Timing
# --------------------------------------------------------------------------

def device_ms(torch, fn, n=N_TIMED, warmup=5):
    """Median device time of one ``fn()`` call from CUDA events.  Each
    timed call is enqueued behind a spin kernel, so the events bracket the
    call's device work and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(10_000_000)  # ~5 ms of spinning: host gets ahead
        start.record()
        fn()
        end.record()
        times.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in times)


def call_ms(torch, fn, n=N_TIMED, warmup=5):
    """Median time of one ``fn()`` call from an idle stream (CUDA events):
    what one call costs its caller, host launch overhead included."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, n=N_TIMED, warmup=3):
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1000.0)
    return statistics.median(times)


def block1_bound(b, c, t, f2):
    """(bound_ms, bound_by, bytes, flops) of one block-1 call: x read once,
    weights read once, the pooled output written once; the mix, the 32
    taps, the affine, ELU and the pool as this input needs them."""
    t_used = 4 * (t // 4)
    nbytes = 4 * (b * c * t + f2 * (c + 32 + 2) + b * f2 * (t // 4))
    flops = (2 * b * f2 * c * t           # mix
             + 2 * b * f2 * 32 * t_used   # taps
             + 2 * b * f2 * t_used        # affine
             + b * f2 * t_used            # ELU
             + b * f2 * t_used)           # pool
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


# --------------------------------------------------------------------------
# Phases
# --------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(),
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"device 0: {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from eegnetreplication_tpu_torch.ops import build

    t0 = time.perf_counter()
    results = build.build()
    wall = time.perf_counter() - t0
    for r in results.values():
        log(f"built {r.name} -> {r.path.name} in {r.seconds:.2f}s")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build: {wall:.2f}s for {len(results)} kernel source(s)")
    return wall


def phase_k1(torch, dev):
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_reference,
        fold_block1_params,
    )

    cases = [(c, t, f1, d, b, p)
             for c, t in ((22, 257), (22, 256))
             for f1, d in ((8, 2), (16, 4))
             for b in BUCKETS
             for p in (False, True)]
    cases += [(8, 64, 8, 2, 8, False), (8, 64, 8, 2, 8, True),
              # past 48 KB of shared memory: the opt-in attribute path
              (22, 1125, 8, 2, 8, True)]
    worst = 0.0
    for i, (c, t, f1, d, b, p) in enumerate(cases):
        model = seeded_model(torch, c, t, f1, d, 100 + i, dev, perturb_bn=p)
        with torch.inference_mode():
            S, W, A, B = fold_block1_params(model.state_dict(),
                                            model.bn_epsilon)
            x = trials(torch, b, c, t, 200 + i).to(dev)
            got = block1(x, S, W, A, B)
            want = block1_reference(x, S, W, A, B)
        torch.cuda.synchronize()
        check(got.shape == want.shape,
              f"K1 shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(bool(torch.isfinite(got).all()), f"K1 non-finite at {cases[i]}")
        check(torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL),
              f"K1 disagrees with block1_reference at (C,T,F1,D,B,bn)="
              f"{cases[i]}: max abs err {err:.3e}")
    log(f"K1 vs block1_reference: {len(cases)} cases, max abs err "
        f"{worst:.3e} (atol {K1_ATOL}, rtol {K1_RTOL})")
    return worst


def phase_forward(torch, dev):
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    worst = 0.0
    for f1, d in ((8, 2), (16, 4)):
        gpu_model = seeded_model(torch, 22, 257, f1, d, 7, dev)
        cpu_model = seeded_model(torch, 22, 257, f1, d, 7, "cpu")
        engine = InferenceEngine(gpu_model, device=dev)
        x = trials(torch, 37, 22, 257, 8)
        with torch.inference_mode():
            got = engine.forward(x.to(dev)).cpu()
            want = cpu_model(x)
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, atol=LOGITS_ATOL, rtol=LOGITS_RTOL),
              f"engine logits (F1={f1}, D={d}) disagree with the CPU "
              f"forward: max abs err {err:.3e}")
        check(torch.equal(got.argmax(-1), want.argmax(-1)),
              f"engine argmax (F1={f1}, D={d}) differs from the CPU forward")
        preds = engine.infer(x.numpy())
        check((preds == want.argmax(-1).numpy()).all(),
              f"engine.infer (F1={f1}, D={d}) differs from the CPU argmax")
    log(f"engine forward (cuda) vs EEGNet.forward (cpu): max abs logit err "
        f"{worst:.3e} (atol {LOGITS_ATOL}, rtol {LOGITS_RTOL}), argmax equal")
    return worst


def _post(url, body: bytes, ctype: str, timeout=60.0):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _npz_body(np, x) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=np.asarray(x, np.float32))
    return buf.getvalue()


def _json_body(x) -> bytes:
    return json.dumps({"trials": x.tolist()}).encode()


def _start_server(ckpt: Path, work: Path, env: dict):
    stderr = open(work / "serve.stderr.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         "--checkpoint", str(ckpt), "--port", "0"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=stderr, text=True)
    lines: queue.Queue = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()
    deadline = time.monotonic() + SERVE_START_TIMEOUT_S
    while True:
        try:
            line = lines.get(timeout=max(0.1, deadline - time.monotonic()))
        except queue.Empty:
            raise SmokeFailure("server did not print 'serving at' in "
                               f"{SERVE_START_TIMEOUT_S:.0f}s")
        if line is None:
            raise SmokeFailure(
                f"server exited {proc.wait()} before serving:\n"
                + (work / "serve.stderr.log").read_text()[-4000:])
        if line.startswith("serving at "):
            return proc, line.split("serving at ", 1)[1].strip(), stderr


def phase_serve(torch, np, dev, work: Path, env: dict):
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        CLASS_NAMES,
        load_model_from_checkpoint,
    )
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1

    model = seeded_model(torch, 22, 257, 8, 2, 11, "cpu")
    ckpt = ckpt_lib.save_checkpoint(
        work / "smoke_model.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    x = trials(torch, 37, 22, 257, 12).numpy()
    y = np.random.RandomState(13).randint(0, 4, size=37).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")

    # The CLI's own function, in process: the reference predictions.
    block1.launches = 0
    ref_preds = predict_trials(load_model_from_checkpoint(ckpt, device=dev),
                               x, device=dev)
    in_process_launches = block1.launches

    result: dict = {"in_process_launches": in_process_launches}
    proc, url, stderr = _start_server(ckpt, work, env)
    try:
        log(f"server up at {url}")
        status, one = _post(url + "/predict", _json_body(x[:1]),
                            "application/json")
        check(status == 200 and one["n"] == 1, f"JSON /predict: {one}")
        status, many = _post(url + "/predict", _npz_body(np, x),
                             "application/octet-stream")
        check(status == 200 and many["n"] == 37, f"npz /predict: {many}")
        served = np.asarray(many["predictions"], np.int64)
        check(one["predictions"][0] == served[0],
              "bucket padding changed trial 0's prediction")
        check((served == ref_preds).all(),
              f"served predictions {served.tolist()} != predict_trials "
              f"{ref_preds.tolist()}")

        # 8 concurrent requests: the batcher coalesces them.
        chunks = [x[4 * i:4 * i + 4] for i in range(8)]
        answers: list = [None] * 8

        def send(i):
            body = (_json_body(chunks[i]) if i % 2 else _npz_body(np,
                                                                   chunks[i]))
            ctype = "application/json" if i % 2 else "application/octet-stream"
            answers[i] = _post(url + "/predict", body, ctype)

        threads = [threading.Thread(target=send, args=(i,)) for i in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        for i, ans in enumerate(answers):
            check(ans is not None and ans[0] == 200,
                  f"concurrent request {i} failed: {ans}")
            check(ans[1]["predictions"] == served[4 * i:4 * i + 4].tolist(),
                  f"concurrent request {i} predictions differ")

        # Latency of /predict at 1 and 128 trials (host clock, median).
        x128 = trials(torch, 128, 22, 257, 14).numpy()
        body1, body128 = _npz_body(np, x[:1]), _npz_body(np, x128)
        lat = {}
        for n, body in ((1, body1), (128, body128)):
            lat[n] = host_ms(lambda body=body: _post(
                url + "/predict", body, "application/octet-stream"),
                n=N_LATENCY)
        result["predict_latency_ms"] = lat

        status, health = _get(url + "/healthz")
        check(status == 200 and health["status"] == "ok", f"/healthz: {health}")
        check(health["model_digest"] == many["model_digest"]
              == health["variables_digest"], "digest mismatch in /healthz")
        check(health["geometry"] == {"n_channels": 22, "n_times": 257},
              f"/healthz geometry {health['geometry']}")
        launches = health["kernel_launches"]["block1"]
        batches = health["batches"]
        n_warm = len(health["buckets"])
        # Every forward is one bucket chunk (no request here exceeds 128
        # trials) and so exactly one K1 launch, after one per bucket at
        # warmup.
        check(launches == n_warm + batches,
              f"K1 launches {launches} != {n_warm} warmup + {batches} "
              "forwards")
        n_requests = 2 + 8 + 2 * (N_LATENCY + 3)
        log(f"/healthz: {batches} forwards for {n_requests} requests, "
            f"K1 launches {launches}")
        result.update(launches=launches, batches=batches,
                      requests=n_requests, digest=health["model_digest"])

        # The predict CLI on the same trials and checkpoint.
        cli = subprocess.run(
            [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
             "--checkpoint", str(ckpt), "--input", str(trials_path)],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        check(cli.returncode == 0, f"predict CLI exited {cli.returncode}:\n"
              + cli.stderr[-4000:])
        want_line = f"accuracy: {100.0 * float(np.mean(served == y)):.2f}%"
        got_line = cli.stdout.strip().splitlines()[-1]
        check(got_line == want_line,
              f"predict CLI printed {got_line!r}, served trials give "
              f"{want_line!r}")
        counts = np.bincount(served, minlength=4)
        for k, name in enumerate(CLASS_NAMES):
            check(f"class {k} ({name}): {counts[k]} trials" in cli.stderr,
                  f"predict CLI's count for class {k} differs from served")
        log(f"predict CLI: {got_line!r} == served; class counts equal")

        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 75, f"server exited {rc} after SIGTERM, want 75")
        log("SIGTERM: drained, exit 75")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stderr.close()
    return result


def phase_times(torch, np, dev):
    import torch.nn.functional as F

    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_reference,
        fold_block1_params,
    )
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine

    model = seeded_model(torch, 22, 257, 8, 2, 21, dev)
    engine = InferenceEngine(model, device=dev)
    engine.warmup()
    with torch.inference_mode():
        S, W, A, B = fold_block1_params(model.state_dict(), model.bn_epsilon)
    f2 = S.shape[0]

    def library(x):
        # One library composite of the same function (never used by the
        # port): cuDNN conv1d for the mix and the taps, then the affine,
        # ELU and avg_pool1d.
        mixed = F.conv1d(x, S[:, :, None])
        acc = F.conv1d(F.pad(mixed, (15, 16)), W[:, None, :], groups=f2)
        return F.avg_pool1d(F.elu(A[:, None] * acc + B[:, None]), 4)

    per_bucket = {}
    for b in BUCKETS:
        x = trials(torch, b, 22, 257, 30 + b).to(dev)
        xn = x.cpu().numpy()
        with torch.inference_mode():
            lib_out = library(x)
            ref_out = block1_reference(x, S, W, A, B)
            check(torch.allclose(lib_out, ref_out, atol=1e-5, rtol=1e-5),
                  f"library composite disagrees at B={b}")
            k1 = lambda: block1(x, S, W, A, B)              # noqa: E731
            plain = lambda: block1_reference(x, S, W, A, B)  # noqa: E731
            lib = lambda: library(x)                        # noqa: E731
            row = {
                "ms": device_ms(torch, k1),
                "plain_ms": device_ms(torch, plain),
                "library_ms": device_ms(torch, lib),
                "call_ms": call_ms(torch, k1),
                "plain_call_ms": call_ms(torch, plain),
                "library_call_ms": call_ms(torch, lib),
            }
        row["engine_infer_ms"] = host_ms(lambda: engine.infer(xn))
        bound, by, nbytes, flops = block1_bound(b, 22, 257, f2)
        row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
        per_bucket[b] = row
        log(f"B={b}: K1 {row['ms']:.4f} ms (call {row['call_ms']:.4f}), "
            f"plain {row['plain_ms']:.4f}, library {row['library_ms']:.4f}, "
            f"bound {bound:.5f} ({by}), engine infer "
            f"{row['engine_infer_ms']:.3f} ms")
    return per_bucket


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None,
                        help="Also write every number as JSON to this file.")
    args = parser.parse_args(argv)

    os.environ.setdefault("EEGTPU_NO_LOG_FILE", "1")
    os.environ.pop("EEGTPU_PLATFORM", None)   # the port's default: the card
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: FAIL: torch.cuda.is_available() is false; this "
              "smoke test runs on a CUDA card", file=sys.stderr)
        return 1
    try:
        import numpy as np

        import eegnetreplication_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: FAIL: cannot import the torch port ({exc}); run "
              "from the repository root", file=sys.stderr)
        return 1

    env = dict(os.environ, PYTHONUNBUFFERED="1")
    from eegnetreplication_tpu_torch.utils.device import select_device

    t_start = time.perf_counter()
    try:
        card = phase_device(torch)
        dev = select_device()
        build_s = phase_build()
        k1_err = phase_k1(torch, dev)
        fwd_err = phase_forward(torch, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve = phase_serve(torch, np, dev, Path(tmp), env)
        times = phase_times(torch, np, dev)
    except Exception:  # noqa: BLE001 — every failure ends the run
        traceback.print_exc()
        print("chip_smoke: FAIL", file=sys.stderr)
        return 1

    top = times[BUCKETS[-1]]
    kernels = {"kernels": [{
        "name": "block1",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/block1.cu",
        "replaces": "eegnetreplication_tpu/ops/fused_eegnet.py:134",
        "launches": serve["launches"],
        "max_abs_err": k1_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }]}
    record = {
        "card": card, "build_s": build_s, "k1_max_abs_err": k1_err,
        "forward_max_abs_err": fwd_err, "serve": serve,
        "times_by_bucket": times,
        "wall_s": time.perf_counter() - t_start,
    }
    print(json.dumps({"timings": record}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(record, **kernels),
                                             indent=1))
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
