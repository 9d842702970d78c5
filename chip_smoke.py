#!/usr/bin/env python3
"""Chip smoke test of the torch port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Run from the repository root on a machine with one CUDA card, the CUDA
toolkit (``nvcc``) and PyTorch built for CUDA.  It drives the port's serving
path and its dataset preprocessing path end to end and holds every
hand-written kernel against its plain PyTorch version:

1. device: require CUDA; print ``nvidia-smi``'s name and power limit;
2. build every kernel from the checkout's sources (``ops/build.py``);
3. K1 (``block1``) against ``block1_reference`` on the card at the serving
   shapes, random and perturbed BatchNorm, at T=1125, at B=1024 and with T
   on the edges of K1's time tile, atol 1e-5 / rtol 1e-5 (only the order of
   the f32 sums differs);
4. the engine's fused forward on the card against the plain ``EEGNet``
   forward on the CPU: logits to atol 1e-5 / rtol 1e-4, equal argmax;
5. serve: a seeded checkpoint (perturbed BatchNorm) written by the port's
   ``save_checkpoint``, ``python -m eegnetreplication_tpu_torch.serve``
   answering JSON, npz and 8 concurrent requests plus ``/healthz``; its
   predictions must equal the ``predict`` CLI's, every forward must have
   launched K1 exactly once, and SIGTERM must drain and exit 75;
6. the timer's floor (an empty event window and one one-element kernel);
   times per bucket (1/8/32/128): K1, the plain version and one library
   composite (cuDNN ``conv1d`` + ELU + ``avg_pool1d``) as the median of
   CUDA-event timings, the engine's end-to-end ``infer`` and ``/predict``
   latency on the host clock, each beside its bound on the card;
7. K2 (``ems``) against ``ems_reference`` on the card at a competition
   session's (22, 345600) and at the edge shapes (ragged, short init block,
   init block past T, a constant signal, ``factor_new`` 0.1, K2's tile
   boundaries with up to 86 tiles a channel, 64 channels), atol/rtol 1e-4;
   three calls at the session shape bitwise equal; and against the port's
   ``associative`` and ``scan`` methods;
8. the dataset path: a synthetic raw tree (2 subjects x Train/Eval,
   45-minute 25-channel 250 Hz GDF sessions with 288 cues each and
   ``TrueLabels``) through ``EEGTPU_EMS_METHOD=pallas python -m
   eegnetreplication_tpu_torch.dataset`` and, in process,
   ``build_processed_tree`` (one K2 launch per session); trial shapes and
   labels, one session against the port's CPU run (plain versions) and the
   card's ``associative`` run to 1e-3, and ``predict --subject 1`` on the
   result;
9. times at (22, 345600): K2, ``ems_reference`` and ``associative`` as the
   median of CUDA-event timings with the L2 cache flushed, beside the
   bound, and the two things ``ems`` runs besides K2 (the seed statistics,
   the zeroed status words); and a session's stages on the host clock.

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
# The JAX package's own Pallas-vs-scan tolerance (tests/test_ems.py).
K2_ATOL, K2_RTOL = 1e-4, 1e-4
DATASET_ATOL, DATASET_RTOL = 1e-3, 1e-3
SESSION = (22, 345_600)   # a 45-minute session after the 128 Hz resample
SESSION_S = 45 * 60       # a competition session: 45 minutes at 250 Hz,
N_TRIALS = 288            # 288 cued trials (6 runs of 48)
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

def device_ms(torch, fn, n=N_TIMED, warmup=5, flush=None):
    """Median device time of one ``fn()`` call from CUDA events.  Each
    timed call is enqueued behind a spin kernel, so the events bracket the
    call's device work and not the host's launch overhead.  With ``flush``
    (a large tensor) it is zeroed before each call, outside the events, so
    the call finds the L2 cache cold."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if flush is not None:
            flush.zero_()
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
              # a 4.5 s trial at 250 Hz: 36 time tiles a trial
              (22, 1125, 8, 2, 8, True), (22, 1125, 8, 2, 1, True),
              # the largest batch a caller may hand the kernel at once
              (22, 257, 8, 2, 1024, True)]
    # T on the edges of K1's time tile (32 conv positions) and of a pool
    # window, one trial each.
    cases += [(22, t, 8, 2, 1, True)
              for t in (4, 31, 32, 33, 35, 36, 63, 64, 65)]
    worst = 0.0
    for i, (c, t, f1, d, b, p) in enumerate(cases):
        # Block 1's folded weights do not depend on T; an EEGNet of fewer
        # than 32 samples has no classifier to build, so take a longer one.
        model = seeded_model(torch, c, max(t, 64), f1, d, 100 + i, dev,
                             perturb_bn=p)
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


def phase_timer_floor(torch, dev):
    """What ``device_ms`` reads for no work and for one one-element kernel:
    the floor under every kernel time of phases 6 and 9."""
    tiny = torch.zeros(1, device=dev)
    floor = {"empty_window_ms": device_ms(torch, lambda: None),
             "one_tiny_kernel_ms": device_ms(torch, lambda: tiny.add_(1))}
    log(f"timer floor: empty window {floor['empty_window_ms']:.4f} ms, one "
        f"one-element kernel {floor['one_tiny_kernel_ms']:.4f} ms")
    return floor


def ems_bound(c, t, init_block_size=1000):
    """(bound_ms, bound_by, bytes, flops) of one EMS call on (C, T) f32:
    x read once and the output written once; per sample the centring, both
    recurrences (3 each), the deviation and its square, eps, the square
    root and the division (12), plus the seed statistics of the first
    ``init_block_size`` samples (3 per sample)."""
    nbytes = 4 * 2 * c * t
    flops = 12 * c * t + 3 * c * min(init_block_size, t)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


def session_signal(np, c, t, seed):
    """An EEG-like (C, T) float32 session from ``seed``: per-channel
    offsets, 10 Hz alpha and 20 Hz beta rhythms and broadband noise, in
    microvolts."""
    rng = np.random.RandomState(seed)
    tt = np.arange(t, dtype=np.float32) / np.float32(250.0)
    sig = rng.standard_normal((c, t)).astype(np.float32)
    sig *= np.float32(8.0)
    sig += rng.uniform(-30, 30, (c, 1)).astype(np.float32)
    sig += (np.float32(12.0) * np.sin(np.float32(2 * np.pi * 10.0) * tt))
    sig += (np.float32(5.0) * np.sin(np.float32(2 * np.pi * 20.0) * tt
                                      + np.float32(0.7)))
    return sig


def phase_k2(torch, np, dev):
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems, ems_reference

    rng = np.random.RandomState(40)
    session = torch.from_numpy(session_signal(np, *SESSION, 41)).to(dev)
    cases = [
        ("session (22, 345600)", session, {}),
        ("(4, 3000)", rng.randn(4, 3000) * 5.0 + 2.0, {}),
        ("ragged (3, 700)", rng.randn(3, 700), {}),
        ("(1, 500) init 100", rng.randn(1, 500), {"init_block_size": 100}),
        ("(2, 50) init 1000 > T", rng.randn(2, 50), {}),
        ("constant (3, 400)", np.full((3, 400), 5.0), {"init_block_size": 100}),
        ("(4, 3000) factor_new 0.1", rng.randn(4, 3000) * 5.0 + 2.0,
         {"factor_new": 0.1}),
        # K2's tile boundaries (4096 samples a block), many tiles a channel
        ("(1, 4095)", rng.randn(1, 4095), {}),
        ("(1, 4096)", rng.randn(1, 4096), {}),
        ("(2, 3 x 4096 - 1)", rng.randn(2, 3 * 4096 - 1), {}),
        ("(2, 3 x 4096 + 1)", rng.randn(2, 3 * 4096 + 1), {}),
        ("(1, 85 x 4096 - 1)", rng.randn(1, 85 * 4096 - 1), {}),
        ("(1, 85 x 4096 + 1)", rng.randn(1, 85 * 4096 + 1), {}),
        ("(64, 345600)", rng.randn(64, 345_600) * 5.0 + 2.0, {}),
    ]
    worst = 0.0
    for name, x, kw in cases:
        if not torch.is_tensor(x):
            x = torch.from_numpy(x.astype(np.float32)).to(dev)
        got = ems(x, **kw)
        want = ems_reference(x, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(got.shape == x.shape, f"K2 shape {tuple(got.shape)} at {name}")
        check(bool(torch.isfinite(got).all()), f"K2 non-finite at {name}")
        check(torch.allclose(got, want, atol=K2_ATOL, rtol=K2_RTOL),
              f"K2 disagrees with ems_reference at {name}: max abs err "
              f"{err:.3e}")
        if name.startswith("constant"):
            check(float(got.abs().max()) < 1e-3,
                  f"K2 on a constant signal is not ~0: {got.abs().max()}")
    log(f"K2 vs ems_reference: {len(cases)} cases, max abs err {worst:.3e} "
        f"(atol {K2_ATOL}, rtol {K2_RTOL})")

    # Deterministic: three calls at the session shape, the same bits.
    runs = [ems(session) for _ in range(3)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]),
          "K2 gave different bits on three calls at the session shape")
    log("K2 at the session shape: three calls, bitwise equal")

    other = {}
    x4 = session[:4, :3000].contiguous()
    for method, x in (("associative", session), ("scan", x4)):
        got = ems(x)
        want = exponential_moving_standardize(x, method=method)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(torch.allclose(got, want, atol=K2_ATOL, rtol=K2_RTOL),
              f"K2 disagrees with method={method!r} at {tuple(x.shape)}: "
              f"max abs err {err:.3e}")
        other[method] = err
        log(f"K2 vs {method} at {tuple(x.shape)}: max abs err {err:.3e}")
    return worst, other


def write_raw_tree(np, raw, subjects=(1, 2), sfreq=250.0):
    """The competition's raw layout under ``raw``: ``{Train,Eval}/A0sX.gdf``
    sessions of 25 channels (22 EEG + 3 EOG) and ``TrueLabels/A0sE.mat``.
    Each session holds ``N_TRIALS`` trials: a trial start (768) 2 s before
    each cue, cues 8 s apart from the first minute on, codes 769-772 in
    Train (a quarter each, shuffled) and 783 in Eval, whose classes go to
    the .mat.  One second of channel 3 of the first Train session is NaN,
    like the competition's artifact spans.  Returns the expected labels by
    stem."""
    from scipy.io import savemat

    from eegnetreplication_tpu_torch.config import (
        EEG_CHANNEL_NAMES,
        EOG_CHANNEL_NAMES,
    )
    from eegnetreplication_tpu_torch.data.gdf import write_gdf

    n = int(SESSION_S * sfreq)
    labels = list(EEG_CHANNEL_NAMES + EOG_CHANNEL_NAMES)
    cue_pos = (int(60 * sfreq) + np.arange(N_TRIALS) * int(8 * sfreq)
               ).astype(np.int64)
    expected = {}
    for s in subjects:
        for mode in ("Train", "Eval"):
            seed = 1000 * s + (mode == "Eval")
            rng = np.random.RandomState(seed)
            classes = rng.permutation(np.repeat(np.arange(4),
                                                N_TRIALS // 4))
            sig = session_signal(np, 25, n, seed)
            if s == subjects[0] and mode == "Train":
                sig[3, 5000:5250] = np.nan
            cue_typ = (769 + classes) if mode == "Train" \
                else np.full(N_TRIALS, 783)
            pos = np.stack([cue_pos - int(2 * sfreq), cue_pos], 1).ravel()
            typ = np.stack([np.full(N_TRIALS, 768), cue_typ], 1).ravel()
            stem = f"A{s:02d}{mode[0]}"
            write_gdf(raw / mode / f"{stem}.gdf", sig, sfreq, labels=labels,
                      event_pos=pos, event_typ=typ)
            if mode == "Eval":
                (raw / "TrueLabels").mkdir(parents=True, exist_ok=True)
                savemat(raw / "TrueLabels" / f"{stem}.mat",
                        {"classlabel": (classes + 1).astype(np.uint8)})
            expected[stem] = classes.astype(np.int64)
    return expected


def _session_trials(np, rec_path, mode, paths, device, method):
    """One session through the port's chain on ``device`` with
    ``EEGTPU_EMS_METHOD=method``: (X, y)."""
    from eegnetreplication_tpu_torch.data.epoching import (
        break_recording_into_epochs,
    )
    from eegnetreplication_tpu_torch.data.gdf import read_gdf
    from eegnetreplication_tpu_torch.data.preprocess import (
        EMS_METHOD_ENV,
        preprocess_recording,
    )

    saved = os.environ.get(EMS_METHOD_ENV)
    os.environ[EMS_METHOD_ENV] = method
    try:
        rec = preprocess_recording(read_gdf(rec_path), device=device)
    finally:
        if saved is None:
            os.environ.pop(EMS_METHOD_ENV, None)
        else:
            os.environ[EMS_METHOD_ENV] = saved
    out = paths.project_root / f"{method}-{device.type}" / (
        rec_path.stem + "-preprocessed.npz")
    rec.save(out)
    return break_recording_into_epochs(out, mode=mode, paths=paths)


def phase_dataset(torch, np, dev, work: Path, env: dict):
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.io import (
        load_subject_dataset,
        load_trials,
    )
    from eegnetreplication_tpu_torch.dataset import build_processed_tree
    from eegnetreplication_tpu_torch.ops.ems_kernel import ems
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    cli_paths = Paths.from_root(work / "cli")
    t0 = time.perf_counter()
    expected = write_raw_tree(np, cli_paths.data_raw)
    log(f"raw tree: {len(expected)} sessions written in "
        f"{time.perf_counter() - t0:.1f}s")

    # The CLI a user runs, on the card, EMS in K2.
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.dataset",
         "--src", "kaggle"], cwd=ROOT,
        env=dict(env, EEGTPU_EMS_METHOD="pallas",
                 EEGTPU_DATA_ROOT=str(cli_paths.project_root)),
        capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"dataset CLI exited {cli.returncode}:\n"
          + cli.stderr[-4000:])
    log(f"dataset CLI (pallas): {cli_s:.1f}s for {len(expected)} sessions")

    # The same path in process, so K2's launches are counted: the main path.
    paths = Paths.from_root(work / "inproc")
    paths.data_processed.parent.mkdir(parents=True)
    paths.data_raw.symlink_to(cli_paths.data_raw, target_is_directory=True)
    os.environ["EEGTPU_EMS_METHOD"] = "pallas"
    try:
        ems.launches = 0
        block1.launches = 0
        t0 = time.perf_counter()
        build_processed_tree(paths)
        inproc_s = time.perf_counter() - t0
        launches = ems.launches
    finally:
        os.environ.pop("EEGTPU_EMS_METHOD", None)
    check(launches == len(expected),
          f"K2 launched {launches} times for {len(expected)} sessions")
    log(f"build_processed_tree in process: {inproc_s:.1f}s, K2 launches "
        f"{launches}")

    worst_repeat = 0.0
    for stem, classes in expected.items():
        mode = "Train" if stem.endswith("T") else "Eval"
        for p in (cli_paths, paths):
            for suffix in ("-preprocessed.npz", "-trials.npz"):
                check((p.data_processed / mode / f"{stem}{suffix}").is_file(),
                      f"{stem}{suffix} missing under {p.data_processed}")
        ds = load_trials(cli_paths.data_processed / mode
                         / f"{stem}-trials.npz")
        again = load_trials(paths.data_processed / mode
                            / f"{stem}-trials.npz")
        check(ds.X.shape == (N_TRIALS, 22, 257)
              and ds.X.dtype == np.float32,
              f"{stem}: trials {ds.X.shape} {ds.X.dtype}")
        check(bool(np.isfinite(ds.X).all()), f"{stem}: non-finite trials")
        check(np.array_equal(ds.y, classes),
              f"{stem}: labels differ from the cue codes / TrueLabels")
        check(np.array_equal(again.y, classes), f"{stem}: in-process labels")
        worst_repeat = max(worst_repeat,
                           float(np.abs(ds.X - again.X).max()))
    check(worst_repeat <= 1e-5,
          f"CLI and in-process runs differ by {worst_repeat:.3e}")
    log(f"{len(expected)} sessions: ({N_TRIALS}, 22, 257) trials, labels "
        f"equal to "
        f"the cues and TrueLabels; CLI vs in-process max diff "
        f"{worst_repeat:.3e}")

    # One session against the port on the CPU (plain versions) and against
    # the card's default method.
    raw = cli_paths.data_raw / "Train" / "A01T.gdf"
    card = load_trials(cli_paths.data_processed / "Train" / "A01T-trials.npz")
    cpu_X, cpu_y = _session_trials(np, raw, "Train", paths,
                                   torch.device("cpu"), "pallas")
    assoc_X, assoc_y = _session_trials(np, raw, "Train", paths, dev,
                                       "associative")
    cmp = {}
    for name, X, y in (("cpu", cpu_X, cpu_y), ("associative", assoc_X,
                                               assoc_y)):
        err = float(np.abs(card.X - X).max())
        check(np.array_equal(card.y, y), f"A01T labels differ from {name}")
        check(np.allclose(card.X, X, atol=DATASET_ATOL, rtol=DATASET_RTOL),
              f"A01T trials on the card (pallas) differ from {name}: max "
              f"abs err {err:.3e}")
        cmp[name] = err
    log(f"A01T card (pallas) vs CPU (plain): {cmp['cpu']:.3e}; vs card "
        f"associative: {cmp['associative']:.3e} (atol {DATASET_ATOL}, rtol "
        f"{DATASET_RTOL})")

    # The port's predict CLI reads what the dataset CLI wrote.
    model = seeded_model(torch, 22, 257, 8, 2, 11, "cpu")
    ckpt = ckpt_lib.save_checkpoint(
        work / "smoke_model.npz", model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(ckpt), "--subject", "1", "--mode", "Train"],
        cwd=ROOT, env=dict(env, EEGTPU_DATA_ROOT=str(cli_paths.project_root)),
        capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict --subject 1 exited "
          f"{pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(k1 > 0, "predict --subject 1 launched K1 no time")
    check(len(load_subject_dataset(1, "Train", cli_paths)) == N_TRIALS,
          f"load_subject_dataset(1, 'Train') did not give {N_TRIALS} trials")
    log(f"predict --subject 1 --mode Train: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {k1}")
    return {"launches": launches, "sessions": len(expected),
            "cli_s": cli_s, "inproc_s": inproc_s,
            "repeat_max_abs_diff": worst_repeat,
            "cpu_max_abs_err": cmp["cpu"],
            "associative_max_abs_err": cmp["associative"],
            "predict_k1_launches": k1, "raw_session": str(raw)}


def phase_k2_times(torch, np, dev, raw_session: Path, work: Path):
    from eegnetreplication_tpu_torch.config import (
        BANDPASS_HIGH_HZ,
        BANDPASS_LOW_HZ,
        N_EEG_CHANNELS,
        TARGET_SFREQ,
    )
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.epoching import (
        break_recording_into_epochs,
    )
    from eegnetreplication_tpu_torch.data.gdf import read_gdf
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.data.preprocess import ProcessedRecording
    from eegnetreplication_tpu_torch.ops.dsp import (
        fir_bandpass,
        mne_style_bandpass_design,
        resample_fft,
    )
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems,
        ems_reference,
        n_tiles,
        seed_stats,
    )

    x = torch.from_numpy(session_signal(np, *SESSION, 42)).to(dev)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    with torch.inference_mode():
        row = {
            "ms": device_ms(torch, lambda: ems(x), flush=flush),
            "plain_ms": device_ms(torch, lambda: ems_reference(x),
                                  flush=flush),
            "associative_ms": device_ms(
                torch, lambda: exponential_moving_standardize(x),
                flush=flush),
            "warm_ms": device_ms(torch, lambda: ems(x)),
            "call_ms": call_ms(torch, lambda: ems(x)),
            # What ems(x) runs besides K2: the seed statistics and the
            # zeroed status words K2 publishes its aggregates in.
            "seed_stats_ms": device_ms(
                torch, lambda: seed_stats(x, 1000), flush=flush),
            "status_zeros_ms": device_ms(torch, lambda: torch.zeros(
                1 + 2 * SESSION[0] * n_tiles(SESSION[1]), dtype=torch.int64,
                device=dev)),
        }
    del flush
    bound, by, nbytes, flops = ems_bound(*SESSION)
    row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
               shape=list(SESSION))
    log(f"K2 at {SESSION}: {row['ms']:.4f} ms cold L2 ({row['warm_ms']:.4f} "
        f"warm, {row['call_ms']:.4f} from an idle stream), ems_reference "
        f"{row['plain_ms']:.3f}, associative {row['associative_ms']:.4f}, "
        f"bound {bound:.5f} ({by}); of ems(x): seed statistics "
        f"{row['seed_stats_ms']:.4f}, status zeros {row['status_zeros_ms']:.4f}")

    # One session's stages on the host clock, each ended by a synchronize.
    kernel = mne_style_bandpass_design(TARGET_SFREQ, BANDPASS_LOW_HZ,
                                       BANDPASS_HIGH_HZ)
    stages = {k: [] for k in ("read_gdf", "to_device", "resample_fft",
                              "fir_bandpass", "ems", "to_host",
                              "save_preprocessed", "epoch_and_save_trials")}
    paths = Paths.from_root(work / "stages")
    bundle = paths.data_processed / "Train" / "A01T-preprocessed.npz"

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        stages[name].append((time.perf_counter() - t0) * 1e3)
        return out

    for _ in range(6):
        rec = timed("read_gdf", lambda: read_gdf(raw_session))
        sig = np.ascontiguousarray(rec.signals[:N_EEG_CHANNELS])
        sig = np.where(np.isfinite(sig), sig, 0.0).astype(np.float32)
        num = int(round(sig.shape[1] * TARGET_SFREQ / rec.sfreq))
        xt = timed("to_device", lambda: torch.from_numpy(sig).to(dev))
        xt = timed("resample_fft", lambda: resample_fft(xt, num))
        xt = timed("fir_bandpass", lambda: fir_bandpass(
            xt, TARGET_SFREQ, BANDPASS_LOW_HZ, BANDPASS_HIGH_HZ,
            kernel=kernel))
        xt = timed("ems", lambda: exponential_moving_standardize(
            xt, method="pallas"))
        out = timed("to_host", lambda: xt.cpu().numpy())
        processed = ProcessedRecording(
            data=out, sfreq=TARGET_SFREQ, labels=[], event_pos=np.round(
                rec.event_pos * (TARGET_SFREQ / rec.sfreq)).astype(np.int64),
            event_typ=rec.event_typ)
        timed("save_preprocessed", lambda: processed.save(bundle))
        timed("epoch_and_save_trials", lambda: save_trials(
            BCICI2ADataset(*break_recording_into_epochs(bundle, "Train",
                                                        paths)),
            bundle.with_name("A01T-trials.npz")))
    session = {k: statistics.median(v[1:]) for k, v in stages.items()}
    log("session stages (host ms, median of 5 after one warmup): "
        + ", ".join(f"{k} {v:.3f}" for k, v in session.items()))
    row["session_stage_ms"] = session
    return row


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
        timer_floor = phase_timer_floor(torch, dev)
        times = phase_times(torch, np, dev)
        k2_err, k2_vs_methods = phase_k2(torch, np, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
            dataset = phase_dataset(torch, np, dev, Path(tmp), env)
            k2_times = phase_k2_times(torch, np, dev,
                                      Path(dataset["raw_session"]), Path(tmp))
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
    }, {
        "name": "ems",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/ems.cu",
        "replaces": "eegnetreplication_tpu/ops/ems_pallas.py:95",
        "launches": dataset["launches"],
        "max_abs_err": k2_err,
        "ms": k2_times["ms"],
        "plain_ms": k2_times["plain_ms"],
        "bound_ms": k2_times["bound_ms"],
        "bound_by": k2_times["bound_by"],
        "library_ms": None,   # no single PyTorch call computes EMS
        "associative_ms": k2_times["associative_ms"],
    }]}
    record = {
        "card": card, "build_s": build_s, "k1_max_abs_err": k1_err,
        "forward_max_abs_err": fwd_err, "serve": serve,
        "timer_floor": timer_floor,
        "times_by_bucket": times, "k2_max_abs_err": k2_err,
        "k2_vs_methods_max_abs_err": k2_vs_methods, "dataset": dataset,
        "k2_times": k2_times,
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
