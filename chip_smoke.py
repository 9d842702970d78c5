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
   replayed its bucket's CUDA graph and so launched K1 exactly once, and
   SIGTERM must drain and exit 75;
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
   the zeroed status words); and a session's stages on the host clock;
10. training, in phase 8's tree (2 subjects x 576 trials: 8 folds of 346
   train, 86 validation and 144 test trials): ``python -m
   eegnetreplication_tpu_torch.train --trainingType Within-Subject``
   writes the JAX report's keys and both model files per subject, and
   ``predict`` serves the trained ``.npz``; in process, the protocol at
   dropout 0 on the card launches the stacked K1 exactly ``epochs *
   val_steps + test_steps`` times and its per-epoch losses agree with the
   CPU run from the same seed to TRAIN_ATOL/TRAIN_RTOL; on a separable
   pool drawn from a seed it learns well above chance; fold-epochs/s and
   wall per epoch at 8 and at 36 folds (the two subjects replicated), and
   the device's idle share over one epoch under ``torch.profiler``; the
   CLI's run journal holds one ``epoch`` event per epoch; ``--profileDir``
   over one epoch writes a Chrome trace naming K1-stacked's kernel; and,
   each in turns on, off, off, on in this process, fold-epochs/s with the
   card's deterministic mode and without it (8 and 36 folds) and with
   ``--debugNans``'s checks and without them (8 folds);
11. cross-subject training over the two subjects replicated to nine (90
   folds): the CLI (report keys, journal, ``predict`` on its model), the
   counted in-process runs (one group, groups of 15), groups against one
   group at dropout 0, the separable pool, the group-size sweep with one
   epoch under the profiler, the determinism cost at 90 folds, the size of
   one epoch's ``--profileDir`` trace and the journal's host time per
   epoch, the snapshot writer; the resume drill through the CLI (two
   unbroken runs, SIGTERM -> 75 -> ``--resume``, ``--chaos
   train.chunk:after=1`` -> ``--resume``: all bitwise equal, each journal
   read back with its ``run_end`` status and an ``epoch`` event per epoch
   trained); and the chaos leg (``--chaos train.step:if_folds_over=4`` in
   groups of 8 halves them to 4, journals ``device_fault`` and ``retry``,
   and equals a run in groups of 4 bit for bit);
12. serving beyond one fp32 model: nine seeded checkpoints behind
   ``serve --zoo`` (``/healthz`` stacked with nine tenants; mixed-tenant
   JSON and npz requests 8 at once, each answer equal to ``predict
   --zoo --model``'s; one K1-stacked launch per coalesced chunk and no
   K1; ``stack_gate`` journaled ``pass``), ``serve --precision int8``
   (``/healthz`` says int8, ``quant_gate`` pass at >= 0.99, answers equal
   to ``predict --precision int8``'s, logits within atol 1e-5 / rtol 1e-4
   of the plain int8 forward on the CPU, K1 once per chunk), ``/reload``
   of a tenant and of the int8 model under 8 concurrent clients (200 with
   the new digest, no request failed, answers after the swap equal the new
   checkpoint's; a corrupt file 400 with the old digest serving), and the
   timings: K1-stacked at a 128-trial chunk over nine tenants beside its
   plain version, a grouped cuDNN composite and its bound, the engines'
   ``infer`` at buckets 1 and 128, ``/predict`` at 1 and 128 trials;
13. live streaming sessions (K2s, ``ems_stream``, the EMS carry): K2s
   against its plain version with the carry threaded through 3 chunks at C
   in {1, 22, 64} and n from 1 to 15000, atol/rtol 1e-6 (and whether they
   are bitwise equal); a (22, 15000) stream in chunks of 25, 64, 997, 1
   (the first 2000 samples) and whole gives the one-shot ``scan``'s bytes
   and final carry; three calls bitwise equal; a whole 45-minute session at
   1 and at 64 channels in pushes of 25 and in chunks of 997 gives the
   one-shot call's bits, out and carry.  Three servers start at
   once: nine concurrent sessions, one per subject, each 60 s of a seeded
   22-channel 250 Hz recording pushed as raw f32 chunks of 25 samples
   (window 257, hop 64, seed block 1000, deadline 1024 ms): every decision
   ``ok`` and equal to the offline pipeline (one-shot ``scan`` on the card,
   the same windows, the engine), each exported carry equal to the
   one-shot kernel's bit for bit, ``/healthz``'s ``ems_stream`` launches
   equal to the pushes from the seeding push on, p95 window latency under
   the 256 ms hop, the journal read back with its session events; a
   session SIGKILLed after half its windows (``--sessionSnapshotEvery
   20``), relaunched with ``--resume`` and replayed from the acked cursor
   equals the uninterrupted stream, every window decided again equals
   what the client was told, and SIGTERM exits 75 with the open session
   in ``sessions.npz``; one session against a ``--zoo`` server equals the
   offline pipeline through the default tenant's engine.  Then K2s's
   times at (22, 25), (22, 250) and (22, 345600), its plain version at the
   first two, K2 and ``associative`` at the last, beside the bound and the
   serial chain's latency at the card's maximum SM clock.

14. the serving control plane: at every bucket of the fp32, int8 and
   nine-tenant engines the replay of the bucket's captured CUDA graph gives
   the eager forward's logits bit for bit and the plain CPU forward's to
   atol 1e-5 / rtol 1e-4, with the capture's wall and memory pool bytes and
   ``infer`` eager against graphed (host ms, the device's idle share and
   device ops per call under ``torch.profiler``); ``serve --tuneEveryS 1``
   under 8 clients of steady 40-trial requests (each one every 100 ms,
   on a kept-alive connection) applies a ``ladder_retune``
   under load with no request failed and every answer equal to
   ``predict_trials`` (and the ``predict`` CLI's accuracy line and class
   counts), K1's launches equal to the eager warm runs plus the graph
   replays, ``/metrics`` (JSON and Prometheus text) agreeing with
   ``/healthz``, and ``POST /profile``'s trace naming ``block1_kernel``
   inside the replays; then the breaker (a retried ``serve.forward``
   fault, a persistent one opening the circuit, the close after the
   cooldown), adaptive admission (429 ``shed``), parented trace spans
   under a client's trace id and an SLO breach degrading ``/healthz``, in
   process on the card;
15. online adaptation (``utils/adapt_drill.py``) at the product width: a
   baseline trained on the card with the port's step on a synthetic cue
   stream serves as the default tenant of a nine-tenant ``serve --zoo``;
   one 250 Hz session streams a window a push and drifts after 16 pushes
   (``--chaos session.drift``).  A server without ``--adapt`` is the
   no-adaptation control; then ``--adapt --probeIntervalS 0.2`` with the
   JAX defaults (60 steps of 32, 16 labels, floor 0.55 over 12 shadow / 8
   labeled evals) and ``adapt.promote`` armed once: the client labels every
   drifted window, the fine-tune runs on its own stream beside the
   serving, the shadow's bucket-1 graph is captured under load, the first
   promotion fails mid-swap with the prior digest serving and the retry
   promotes; accuracy before, during and after, recovery above the
   drifted accuracy, the journal's causal order, ``POST /adapt/rollback``
   under 8 ``/predict`` clients with none failed, probes outside
   ``requests_total``, exact K1, K1-stacked and K2s counts from the
   journal, the candidate's card logits against its CPU forward, two card
   fine-tunes bitwise equal, and the fine-tune's wall, the shadow's capture,
   the promotion's reload and ``/predict`` and window latency during the
   fine-tune against the control.

Phases 10 and 11 print GFLOP/s and the MFU against the card's FP32 peak
(``utils/flops.py``) beside fold-epochs/s at 8, 36 and 90 folds.

Phase 3b holds the stacked form of K1 (``block1_stacked``: G weight sets,
an index per trial, what the training loop's validation and test passes
launch) against ``block1_stacked_reference`` at G in {1, 8, 36}, B in {1,
64}, T in {257, 1125} and permuted indices, atol/rtol 1e-5, checks three
calls at (512, 22, 257) bitwise equal, and holds it to K1 bit for bit per
weight set at the 90-fold validation batch (90 x 64 trials, permuted) and
at a zoo chunk (128 trials over nine sets); the timing phase times it at
(512, 22, 257) and (2304, 22, 257), the 8- and 36-fold validation batches,
beside its plain version, a grouped cuDNN composite and its bound.

The last lines are the ``{"kernels": [...]}`` record and, last of all,
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before the
result line.  Nothing here imports JAX or the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
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
import urllib.error
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# The port is imported from the checkout this script sits in, whatever the
# working directory and even where Python leaves the script's directory off
# the path (``-P``, ``-I``, ``PYTHONSAFEPATH``).  Its subprocesses get the
# same through PYTHONPATH.
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

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
# Training (phase 10).  Per-epoch losses of the card and the CPU from one
# seed at dropout 0 agree to the tolerance the CPU tests hold the port to
# against the JAX package (tests/test_torch_train_step.py): only the order
# of f32 sums differs (cuDNN's algorithms, grouped convolutions), and Adam
# carries the differences along.
TRAIN_ATOL, TRAIN_RTOL = 2e-3, 2e-3
TRAIN_EPOCHS = 5          # the CLI and the card's in-process run
CPU_EPOCHS = 2            # the CPU half of the card-vs-CPU check
LEARN_EPOCHS = 30         # the separable pool
TIME_EPOCHS = 10          # the throughput runs
# (folds, batch): the 8- and 36-fold within-subject validation batches and
# the 90-fold cross-subject one (512, 2304 and 5760 trials)
K1_STACKED_SIZES = ((8, 64), (36, 64), (90, 64))
# Cross-subject training and resume (phase 11).
CS_EPOCHS = 2             # the CLI and the counted runs
CS_GROUP = 15             # the counted run in groups: 6 groups of 15
CS_SWEEP = (15, 30, 45, 90)
CS_SWEEP_EPOCHS = 2       # timed, after one warm-up epoch
CS_LEARN_EPOCHS = 10
# The resume drill: a resumed card run against an unbroken one, and two
# unbroken ones.  The card's runs are deterministic (utils/device.py), so
# every leg must give the same weights bit for bit.
RESUME_EPOCHS, RESUME_EVERY = 4, 2
RESUME_WAIT_S = 600.0
# The chaos leg: an out-of-memory error injected into every group of more
# than 4 folds halves the cross-subject CLI's groups of 8 to 4.
CHAOS_GROUP, CHAOS_OVER = 8, 4
# The cost legs: epochs timed per measurement, in turns on, off, off, on.
DET_EPOCHS = {8: 5, 36: 5, 90: 2}
NAN_EPOCHS = 2
WS_REPORT_KEYS = {
    "": {"training_type", "timestamp", "model_parameters",
         "overall_results", "per_subject_results", "model_info",
         "summary_statistics"},
    "model_parameters": {"batch_size", "epochs", "learning_rate",
                         "dropout_probability", "cross_validation_folds"},
    "overall_results": {"average_test_accuracy", "number_of_subjects",
                        "best_subject_accuracy", "worst_subject_accuracy",
                        "accuracy_std"},
    "model_info": {"architecture", "optimizer", "loss_function",
                   "saved_models_count"},
    "summary_statistics": {"accuracy_distribution", "accuracy_quartiles"},
}
CS_REPORT_KEYS = {
    "": WS_REPORT_KEYS[""],
    "model_parameters": {"batch_size", "epochs", "learning_rate",
                         "dropout_probability", "total_folds",
                         "repeats_per_subject", "train_subjects_per_fold",
                         "validation_subjects_per_fold"},
    "overall_results": {"average_test_accuracy", "standard_error",
                        "number_of_test_subjects", "best_subject_accuracy",
                        "worst_subject_accuracy", "accuracy_std"},
    "model_info": {"architecture", "optimizer", "loss_function",
                   "saved_model"},
    "summary_statistics": WS_REPORT_KEYS["summary_statistics"],
}


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


def block1_bound(b, c, t, f2, sets=0):
    """(bound_ms, bound_by, bytes, flops) of one block-1 call: x read once,
    weights read once, the pooled output written once; the mix, the 32
    taps, the affine, ELU and the pool as this input needs them.  With
    ``sets`` (the stacked form) the weights are that many sets and an int32
    index per trial is read too."""
    t_used = 4 * (t // 4)
    nbytes = 4 * (b * c * t + max(sets, 1) * f2 * (c + 32 + 2)
                  + b * f2 * (t // 4) + (b if sets else 0))
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


def stacked_weights(torch, g, c, f2, seed):
    """G folded block-1 weight sets ``(S, W, A, B)`` drawn from ``seed``,
    at the scales folding a trained EEGNet gives."""
    gen = torch.Generator().manual_seed(seed)
    return (0.3 * torch.randn((g, f2, c), generator=gen),
            0.2 * torch.randn((g, f2, 32), generator=gen),
            1.0 + 0.2 * torch.randn((g, f2), generator=gen),
            0.2 * torch.randn((g, f2), generator=gen))


def phase_k1_stacked(torch, dev):
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
        fold_index,
    )

    cases = [(g, b, t, False) for g in (1, 8, 36) for b in (1, 64)
             for t in (257, 1125)]
    cases += [(8, 64, 257, True), (36, 64, 257, True), (36, 1, 1125, True),
              # a cross-subject validation batch of 90 folds: 5760 trials
              (90, 64, 257, False), (90, 64, 257, True)]
    worst = 0.0
    for i, (g, b, t, permuted) in enumerate(cases):
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         300 + i))
        x = trials(torch, g * b, 22, t, 400 + i).to(dev)
        idx = fold_index(g, b, dev)
        if permuted:
            perm = torch.randperm(g * b,
                                  generator=torch.Generator().manual_seed(i))
            idx = idx[perm.to(dev)].contiguous()
        with torch.no_grad():
            got = block1_stacked(x, S, W, A, B, idx)
            want = block1_stacked_reference(x, S, W, A, B, idx)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (g * b, 16, t // 4),
              f"K1-stacked shape {tuple(got.shape)} at {cases[i]}")
        check(bool(torch.isfinite(got).all()),
              f"K1-stacked non-finite at (G,B,T,permuted)={cases[i]}")
        err = float((got - want).abs().max())
        worst = max(worst, err)
        check(torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL),
              f"K1-stacked disagrees with block1_stacked_reference at "
              f"(G,B,T,permuted)={cases[i]}: max abs err {err:.3e}")
    log(f"K1-stacked vs block1_stacked_reference: {len(cases)} cases, max "
        f"abs err {worst:.3e} (atol {K1_ATOL}, rtol {K1_RTOL})")

    S, W, A, B = (v.to(dev) for v in stacked_weights(torch, 8, 22, 16, 9))
    x = trials(torch, 512, 22, 257, 10).to(dev)
    idx = fold_index(8, 64, dev)
    with torch.no_grad():
        runs = [block1_stacked(x, S, W, A, B, idx) for _ in range(3)]
    torch.cuda.synchronize()
    check(torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2]),
          "K1-stacked gave different bits on three calls at (512, 22, 257)")
    log("K1-stacked at (512, 22, 257): three calls, bitwise equal")
    _k1_stacked_equals_k1(torch, dev)
    return worst


def _k1_stacked_equals_k1(torch, dev):
    """K1-stacked keeps K1's order of every sum (csrc/block1_stacked.cu), so
    each trial equals K1 on its trial and weight set bit for bit: the
    90-fold validation batch permuted, and a zoo chunk of 128 trials mixed
    over nine sets (the short work items)."""
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1,
        block1_stacked,
        fold_index,
    )

    for what, g, n, seed in (("(90, 64, 257) permuted", 90, 5760, 31),
                             ("the zoo chunk, 128 over 9", N_TENANTS, 128,
                              32)):
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         seed))
        x = trials(torch, n, 22, 257, seed + 1).to(dev)
        idx = (fold_index(g, n // g, dev) if n % g == 0 else
               (torch.arange(n, dtype=torch.int32, device=dev) % g))
        perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
        idx = idx[perm.to(dev)].contiguous()
        with torch.no_grad():
            got = block1_stacked(x, S, W, A, B, idx)
            for s in range(g):
                rows = (idx == s).nonzero()[:, 0]
                want = block1(x[rows].contiguous(), S[s], W[s], A[s], B[s])
                check(torch.equal(got[rows], want),
                      f"K1-stacked differs from K1 on set {s} at {what}")
        torch.cuda.synchronize()
        log(f"K1-stacked equals K1 bit for bit per weight set at {what}")


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


def _post(url, body: bytes, ctype: str, timeout=60.0, headers=None):
    """POST; ``(status, JSON reply)``, an HTTP error's too."""
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": ctype,
                                          **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read().decode())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read().decode())


def _npz_body(np, x) -> bytes:
    buf = io.BytesIO()
    np.savez(buf, X=np.asarray(x, np.float32))
    return buf.getvalue()


def _json_body(x) -> bytes:
    return json.dumps({"trials": x.tolist()}).encode()


def _start_server(args: list, work: Path, env: dict, name: str = "serve"):
    """Start the serve CLI with ``args`` on an ephemeral port and wait for
    its ``serving at`` line; ``(process, url, stderr file)``."""
    log_path = work / f"{name}.stderr.log"
    stderr = open(log_path, "w")
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "eegnetreplication_tpu_torch.serve",
         *args, "--port", "0"],
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
                + log_path.read_text()[-4000:])
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
    proc, url, stderr = _start_server(["--checkpoint", str(ckpt)], work,
                                      env)
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
        # trials), one replay of its bucket's CUDA graph and so exactly one
        # K1 launch, after one eager warm run per bucket (the capture
        # itself launches nothing).
        check(health["graph_replays"] == batches,
              f"{health['graph_replays']} graph replays for {batches} "
              "forwards")
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


def phase_k1_stacked_times(torch, dev):
    """K1-stacked at the validation batches of 8, 36 and 90 folds (CUDA
    events, median), beside its plain version, one grouped cuDNN composite
    of the same function and its bound."""
    import torch.nn.functional as F

    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
        fold_index,
    )

    rows = {}
    for g, b in K1_STACKED_SIZES:
        n = g * b
        S, W, A, B = (v.to(dev) for v in stacked_weights(torch, g, 22, 16,
                                                         600 + g))
        f2 = S.shape[1]
        x = trials(torch, n, 22, 257, 700 + g).to(dev)
        idx = fold_index(g, b, dev)

        def library():
            # Never used by the port: the folds as groups of cuDNN
            # convolutions (mix, then taps), the affine, ELU and the pool.
            xs = x.reshape(g, b, 22, 257).transpose(0, 1).reshape(
                b, g * 22, 257)
            mixed = F.conv1d(xs, S.reshape(g * f2, 22, 1), groups=g)
            acc = F.conv1d(F.pad(mixed, (15, 16)),
                           W.reshape(g * f2, 1, 32), groups=g * f2)
            out = F.avg_pool1d(F.elu(A.reshape(-1, 1) * acc
                                     + B.reshape(-1, 1)), 4)
            return out.reshape(b, g, f2, -1).transpose(0, 1).reshape(
                n, f2, -1)

        with torch.no_grad():
            check(torch.allclose(library(), block1_stacked_reference(
                x, S, W, A, B, idx), atol=1e-5, rtol=1e-5),
                f"grouped library composite disagrees at {n} trials")
            block1_stacked(x, S, W, A, B, idx)   # checks idx once
            row = {
                "ms": device_ms(torch, lambda: block1_stacked(
                    x, S, W, A, B, idx)),
                "plain_ms": device_ms(torch, lambda: block1_stacked_reference(
                    x, S, W, A, B, idx)),
                "library_ms": device_ms(torch, library),
                "call_ms": call_ms(torch, lambda: block1_stacked(
                    x, S, W, A, B, idx)),
            }
        bound, by, nbytes, flops = block1_bound(n, 22, 257, f2, sets=g)
        row.update(folds=g, batch=b, trials=n, bound_ms=bound, bound_by=by,
                   bytes=nbytes, flops=flops)
        rows[n] = row
        log(f"K1-stacked at ({n}, 22, 257): {row['ms']:.4f} ms (call "
            f"{row['call_ms']:.4f}), plain {row['plain_ms']:.4f}, grouped "
            f"library {row['library_ms']:.4f}, bound {bound:.5f} ({by})")
    return rows


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


def separable_subject(np, subject, mode, n=N_TRIALS, c=22, t=257):
    """A session of ``n`` trials at the product width in which each class
    adds its own rhythm (6, 10, 14 or 18 Hz at 128 Hz) through its own
    spatial pattern to unit noise, drawn from the subject and session."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset

    rng = np.random.RandomState(5000 + 10 * subject + (mode == "Eval"))
    y = rng.randint(0, 4, size=n)
    x = rng.standard_normal((n, c, t)).astype(np.float32)
    patterns = np.random.RandomState(77).standard_normal((4, c))
    tt = np.arange(t) / 128.0
    for k in range(4):
        wave = np.sin(2 * np.pi * (6.0 + 4.0 * k) * tt)
        x[y == k] += (patterns[k][:, None] * wave[None, :]).astype(np.float32)
    return BCICI2ADataset(X=x, y=y.astype(np.int64))


@contextlib.contextmanager
def _deterministic(torch, on: bool):
    """The card's deterministic mode (``utils/device.py``) for the block,
    or the settings before it (cuDNN's autotuner off either way); on again
    after."""
    torch.use_deterministic_algorithms(on)
    torch.backends.cudnn.deterministic = on
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(True)
        torch.backends.cudnn.deterministic = True


def _rates_in_turns(torch, run_epoch, n_folds, epochs, mode) -> dict:
    """fold-epochs/s of ``run_epoch`` under ``mode(True)`` and
    ``mode(False)`` in turns True, False, False, True: one warm-up epoch in
    each, then ``epochs`` timed (host clock ended by a synchronize)."""
    rates = {True: [], False: []}
    for on in (True, False, False, True):
        with mode(on):
            run_epoch()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(epochs):
                run_epoch()
            torch.cuda.synchronize()
            rates[on].append(n_folds * epochs / (time.perf_counter() - t0))
    return {"on": rates[True], "off": rates[False],
            "on_over_off": statistics.mean(rates[True])
            / statistics.mean(rates[False])}


def _determinism_cost(torch, run_epoch, n_folds) -> dict:
    """fold-epochs/s with the card's deterministic mode and without it."""
    row = _rates_in_turns(torch, run_epoch, n_folds, DET_EPOCHS[n_folds],
                          lambda on: _deterministic(torch, on))
    log(f"determinism at {n_folds} folds: {statistics.mean(row['on']):.2f} "
        f"fold-epochs/s on, {statistics.mean(row['off']):.2f} off "
        f"(on/off {row['on_over_off']:.3f}; turns on, off, off, on: "
        f"{', '.join(f'{r:.2f}' for r in row['on'][:1] + row['off'] + row['on'][1:])})")
    return row


def _epoch_times(torch, np, dev, loader, subjects, config):
    """Wall per epoch and fold-epochs/s of the protocol's trainer (host
    clock, TIME_EPOCHS epochs after one warm-up epoch, ended by a
    synchronize), and one epoch's device busy time and idle share under
    ``torch.profiler``."""
    from eegnetreplication_tpu_torch.training.protocols import (
        build_pool,
        within_subject_trainer,
    )
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    datasets = [loader(s, "Train").concat(loader(s, "Eval"))
                for s in subjects]
    trainer, _, folds = within_subject_trainer(
        *build_pool(datasets), config=config, seed=3, device=dev)
    trainer.run_epoch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIME_EPOCHS):
        trainer.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    profile = breakdown(trainer.run_epoch, n_calls=1, top=10)
    row = {"folds": len(folds), "epochs": TIME_EPOCHS,
           "wall_s": wall, "wall_per_epoch_ms": wall * 1e3 / TIME_EPOCHS,
           "fold_epochs_per_s": len(folds) * TIME_EPOCHS / wall,
           "train_steps": trainer.train_steps,
           "val_steps": trainer.val_steps, "epoch_profile": profile,
           "determinism": _determinism_cost(torch, trainer.run_epoch,
                                            len(folds))}
    row.update(_mfu_fields(row))
    if len(folds) == 8:
        from eegnetreplication_tpu_torch.training.loop import debug_nans

        row["debug_nans"] = _rates_in_turns(torch, trainer.run_epoch, 8,
                                            NAN_EPOCHS, debug_nans)
        log(f"--debugNans at 8 folds: "
            f"{statistics.mean(row['debug_nans']['on']):.2f} fold-epochs/s "
            f"checked, {statistics.mean(row['debug_nans']['off']):.2f} "
            f"unchecked")
    return row


def phase_train(torch, np, dev, work: Path, env: dict, data_root: Path):
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.training.loop import n_steps
    from eegnetreplication_tpu_torch.training.protocols import (
        within_subject_training,
    )

    # The CLI a user runs, on the card, over phase 8's processed tree.
    data_paths = Paths.from_root(data_root)
    run_env = dict(env, EEGTPU_DATA_ROOT=str(data_root))
    profiled = _start_profile_leg(work, env, data_root)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Within-Subject", "--epochs", str(TRAIN_EPOCHS),
         "--subjects", "1,2"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"train CLI exited {cli.returncode}:\n"
          + cli.stderr[-4000:])
    report = json.loads((data_paths.reports
                         / "latest_within_subject_report.json").read_text())
    for section, keys in WS_REPORT_KEYS.items():
        got = set(report[section] if section else report)
        check(got == keys, f"report {section or 'top level'} keys {got} != "
              f"the JAX report's {keys}")
    check([e["subject_id"] for e in report["per_subject_results"]] == [1, 2],
          f"report subjects {report['per_subject_results']}")
    for s in (1, 2):
        for ext in ("pth", "npz"):
            f = data_paths.models / f"subject_{s:02d}_best_model.{ext}"
            check(f.is_file(), f"train CLI did not write {f.name}")
    log(f"train CLI: {TRAIN_EPOCHS} epochs of 8 folds in {cli_s:.1f}s, "
        f"report keys equal the JAX report's, 4 model files; average test "
        f"accuracy {report['overall_results']['average_test_accuracy']}%")

    # The trained checkpoint, served by the predict CLI.
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(data_paths.models / "subject_01_best_model.npz"),
         "--subject", "1"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict on the trained checkpoint exited "
          f"{pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    predict_k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(predict_k1 > 0, "predict on the trained checkpoint launched no K1")
    log(f"predict --checkpoint subject_01_best_model.npz --subject 1: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {predict_k1}")
    cli_events = _journal(np, data_paths.reports / "obs", "ok")
    check(_epochs_journaled(cli_events) == list(range(1, TRAIN_EPOCHS + 1)),
          "the train CLI's journal lacks an epoch event per epoch")
    profile_leg = _finish_profile_leg(*profiled)

    # In process at dropout 0, the card against the CPU from one seed: the
    # main path whose stacked-K1 launches are counted.
    def loader(s, mode):
        return load_subject_dataset(s, mode, data_paths)

    p0 = DEFAULT_TRAINING.replace(dropout_within_subject=0.0)
    kw = dict(config=p0, loader=loader, subjects=(1, 2), seed=0,
              save_models=False, paths=Paths.from_root(work / "p0"))
    block1_stacked.launches = 0
    card = within_subject_training(TRAIN_EPOCHS, device=dev, **kw)
    launches = block1_stacked.launches
    n_sub = N_TRIALS * 2               # Train + Eval sessions of a subject
    val_steps = n_steps(n_sub * 3 // 4 // 5, p0.batch_size, 1)
    test_steps = n_steps(n_sub // 4, p0.batch_size, 1)
    want = TRAIN_EPOCHS * val_steps + test_steps
    check(launches == want,
          f"K1-stacked launched {launches} times in {TRAIN_EPOCHS} epochs; "
          f"want {TRAIN_EPOCHS} x {val_steps} validation + {test_steps} test "
          f"= {want}")
    log(f"in process (card, dropout 0): 8 folds x {TRAIN_EPOCHS} epochs, "
        f"K1-stacked launches {launches} = {TRAIN_EPOCHS} x {val_steps} + "
        f"{test_steps}")
    cpu = within_subject_training(CPU_EPOCHS, device=torch.device("cpu"),
                                  **kw)
    deltas = {}
    for name in ("train_losses", "val_losses"):
        a = getattr(card.folds, name)[:, :CPU_EPOCHS]
        b = getattr(cpu.folds, name)
        check(bool(torch.isfinite(a).all()), f"card {name} not finite")
        deltas[name] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=TRAIN_ATOL, rtol=TRAIN_RTOL),
              f"card vs CPU {name} over {CPU_EPOCHS} epochs differ by "
              f"{deltas[name]:.3e} (atol {TRAIN_ATOL}, rtol {TRAIN_RTOL})")
    log(f"card vs CPU, {CPU_EPOCHS} epochs of 8 folds: train losses "
        f"{deltas['train_losses']:.3e}, validation losses "
        f"{deltas['val_losses']:.3e} (atol {TRAIN_ATOL}, rtol {TRAIN_RTOL})")

    # The port learns on the card (phase 8's tree carries no class signal).
    def sep_loader(s, mode):
        return separable_subject(np, (s - 1) % 2 + 1, mode)

    learn = within_subject_training(
        LEARN_EPOCHS, loader=sep_loader, subjects=(1, 2), seed=1,
        save_models=False, paths=Paths.from_root(work / "learn"), device=dev)
    check(learn.avg_test_acc > 50.0,
          f"separable pool: test accuracy {learn.avg_test_acc:.2f}% after "
          f"{LEARN_EPOCHS} epochs (chance 25%)")
    log(f"separable pool, {LEARN_EPOCHS} epochs at dropout 0.5: test "
        f"accuracy {learn.avg_test_acc:.2f}% (chance 25%), "
        f"{learn.epoch_throughput:.1f} fold-epochs/s")

    times = {}
    for n_folds, subjects in ((8, (1, 2)), (36, tuple(range(1, 10)))):
        row = _epoch_times(torch, np, dev, sep_loader, subjects,
                           DEFAULT_TRAINING)
        check(row["folds"] == n_folds, f"{row['folds']} folds")
        times[n_folds] = row
        prof = row["epoch_profile"]
        log(f"{n_folds} folds: {row['fold_epochs_per_s']:.1f} fold-epochs/s, "
            f"{row['gflops_per_s']:.2f} GFLOP/s = "
            f"{100 * (row['mfu'] or 0):.4f}% MFU ({row['peak']}), "
            f"{row['wall_per_epoch_ms']:.1f} ms per epoch ({row['train_steps']}"
            f" train steps, {row['val_steps']} validation batches); one epoch "
            f"under the profiler: wall {prof['wall_ms_per_call']:.1f} ms, "
            f"device busy {prof['device_busy_ms_per_call']:.1f} ms, idle "
            f"share {prof['device_idle_share']}")
    return {"cli_s": cli_s, "predict_k1_launches": predict_k1,
            "profile_leg": profile_leg,
            "launches": launches, "val_steps": val_steps,
            "test_steps": test_steps, "card_vs_cpu_max_abs": deltas,
            "card_p0_fold_epochs_per_s": card.epoch_throughput,
            "learn_test_acc": learn.avg_test_acc,
            "learn_fold_epochs_per_s": learn.epoch_throughput,
            "times_by_folds": times}

def _start_profile_leg(work: Path, env: dict, data_root: Path):
    """Start ``train --profileDir`` over one epoch of 8 folds (it runs
    beside the phase's CLI run); :func:`_finish_profile_leg` checks it."""
    paths = _replicated_tree(data_root, work / "profiled", (1, 2))
    trace_dir = work / "profiled" / "trace"
    log_path = work / "profiled.log"
    proc = _spawn(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--subjects", "1,2", "--epochs", "1", "--profileDir",
         str(trace_dir)], dict(env, EEGTPU_DATA_ROOT=str(paths.project_root)),
        log_path)
    return proc, log_path, trace_dir, time.perf_counter()


def _finish_profile_leg(proc, log_path: Path, trace_dir: Path,
                        t0: float) -> dict:
    """The ``torch.profiler`` trace of the ``--profileDir`` run landed in
    its directory and names K1-stacked's kernel (the ``kStacked`` instance
    ``block1_stacked_kernel``, ``csrc/block1_stacked.cu``)."""
    ((rc, err),) = _wait_all({"p": proc}, {"p": log_path}, 900).values()
    wall = time.perf_counter() - t0
    check(rc == 0, f"train --profileDir exited {rc}:\n" + err[-4000:])
    traces = sorted(trace_dir.glob("trace-*.json"))
    check(len(traces) == 1, f"--profileDir wrote {traces}")
    text = traces[0].read_text()
    check("block1_stacked_kernel" in text, "the --profileDir trace does not "
          "name K1-stacked's kernel block1_stacked_kernel")
    mb = traces[0].stat().st_size / 1e6
    log(f"train --profileDir, 8 folds x 1 epoch: {mb:.1f} MB Chrome trace "
        f"naming block1_stacked_kernel ({wall:.1f}s)")
    return {"trace_mb": mb, "wall_s": wall}


def _replicated_tree(src: Path, dst: Path, subjects=tuple(range(1, 10))):
    """A processed tree under ``dst`` whose subject ``s`` is ``src``'s
    subject ``(s - 1) % 2 + 1`` (symlinks to phase 8's two subjects)."""
    from eegnetreplication_tpu_torch.config import Paths
    from eegnetreplication_tpu_torch.data.io import trials_filename

    src_paths, dst_paths = Paths.from_root(src), Paths.from_root(dst)
    for mode in ("Train", "Eval"):
        (dst_paths.data_processed / mode).mkdir(parents=True)
        for s in subjects:
            (dst_paths.data_processed / mode / trials_filename(s, mode)
             ).symlink_to(src_paths.data_processed / mode
                          / trials_filename((s - 1) % 2 + 1, mode))
    return dst_paths


def _check_report(path: Path, keys: dict, what: str) -> dict:
    report = json.loads(path.read_text())
    for section, want in keys.items():
        got = set(report[section] if section else report)
        check(got == want, f"{what} report {section or 'top level'} keys "
              f"{got} != the JAX report's {want}")
    return report


def _journal(np, metrics_dir: Path, status: str) -> list:
    """The one run journal under ``metrics_dir``, read with the port's
    ``read_events``: no event flagged ``_schema_error``, ``run_end`` with
    ``status``; returns its events."""
    from eegnetreplication_tpu_torch.obs import read_events

    runs = sorted(metrics_dir.iterdir())
    check(len(runs) == 1, f"{metrics_dir}: {len(runs)} run journals")
    events = read_events(runs[0] / "events.jsonl")
    bad = [e for e in events if "_schema_error" in e]
    check(not bad, f"{runs[0]}: events flagged by the schema: {bad[:2]}")
    end = events[-1]
    check(end["status"] == status, f"{runs[0]}: run_end status "
          f"{end['status']!r}, want {status!r} ({end.get('error')})")
    return events


def _epochs_journaled(events) -> list:
    return [e["epoch"] for e in events if e["event"] == "epoch"]


def _same_weights(got_dir: Path, want_dir: Path, names, what: str) -> None:
    """Every tensor of each named ``.npz`` model equal bit for bit."""
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    for name in names:
        got, _ = ckpt_lib.load_checkpoint(got_dir / name)
        want, _ = ckpt_lib.load_checkpoint(want_dir / name)
        check(got.keys() == want.keys(), f"{what}: {name} has other keys")
        for key in want:
            diff = float((got[key] - want[key]).abs().max())
            check(bool((got[key] == want[key]).all()),
                  f"{what}: {name} {key} differs by {diff:.3e}; the card's "
                  "runs must repeat bit for bit")


def _spawn(argv, env: dict, log_path: Path, out_path: Path | None = None):
    """Start a CLI from the checkout with its stderr in ``log_path`` (and
    its stdout in ``out_path``, else dropped)."""
    with open(log_path, "w") as stderr, \
            open(out_path or os.devnull, "w") as stdout:
        return subprocess.Popen(argv, cwd=ROOT, stdout=stdout,
                                stderr=stderr, env=env)


def _wait_all(procs: dict, logs: dict, timeout: float) -> dict:
    """Wait for every process, killing what is left at the deadline or on
    an error; ``{name: (exit code, stderr)}``."""
    deadline = time.monotonic() + timeout
    out = {}
    try:
        for name, proc in procs.items():
            rc = proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            out[name] = (rc, logs[name].read_text())
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def _resume_drill(np, work: Path, env: dict, data_root: Path) -> dict:
    """Within-subject training at 8 folds through the CLI, each leg with
    its own ``--metricsDir``: two unbroken runs; SIGTERM once the first
    run snapshot exists (exit 75, a snapshot left, ``run_end`` preempted),
    then ``--resume``; ``train.chunk:after=1`` in 1-epoch chunks (a crash
    after the second chunk), then ``--resume``.  Every leg's weights equal
    the unbroken run's bit for bit, and each journal holds one ``epoch``
    event per epoch it trained.  The legs that do not wait for one another
    run at once (deterministic kernels give the same bits under any load);
    that halves the drill's wall."""
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    argv = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Within-Subject", "--subjects", "1,2",
            "--epochs", str(RESUME_EPOCHS)]
    every = {"unbroken": RESUME_EVERY, "unbroken2": RESUME_EVERY,
             "stopped": RESUME_EVERY, "crashed": 1}
    roots = {name: _replicated_tree(data_root, work / name, (1, 2))
             for name in every}
    models = [f"subject_{s:02d}_best_model.npz" for s in (1, 2)]

    def start(name, leg, extra=()):
        obs_dir = work / "obs" / name / leg
        cmd = argv + ["--checkpointEvery", str(every[name]), "--metricsDir",
                      str(obs_dir), *extra]
        env_leg = dict(env, EEGTPU_DATA_ROOT=str(roots[name].project_root))
        return _spawn(cmd, env_leg, work / f"{name}-{leg}.log")

    def journal(name, leg, status):
        return _journal(np, work / "obs" / name / leg, status)

    # Round 1: the unbroken runs, the SIGTERM'd run, the crashed run.
    snap = roots["stopped"].models / "within_subject_eegnet.run.npz"
    legs = {"unbroken": (), "unbroken2": (), "stopped": (),
            "crashed": ("--chaos", "train.chunk:after=1")}
    procs = {name: start(name, "first", extra) for name, extra in legs.items()}
    logs = {name: work / f"{name}-first.log" for name in legs}
    try:
        deadline = time.monotonic() + RESUME_WAIT_S
        stopped = procs["stopped"]
        while not snap.exists() and stopped.poll() is None \
                and time.monotonic() < deadline:
            time.sleep(0.001)
        signalled = stopped.poll() is None and snap.exists()
        if signalled:
            stopped.send_signal(signal.SIGTERM)
    finally:
        done = _wait_all(procs, logs, RESUME_WAIT_S)
    for name in ("unbroken", "unbroken2"):
        rc, err = done[name]
        check(rc == 0, f"{name} train CLI exited {rc}:\n{err[-4000:]}")
        check(_epochs_journaled(journal(name, "first", "ok"))
              == list(range(1, RESUME_EPOCHS + 1)),
              f"{name}: not one epoch event per epoch")
    _same_weights(roots["unbroken2"].models, roots["unbroken"].models,
                  models, "two unbroken card runs")
    log("resume drill: two unbroken card runs give the same weights bit "
        "for bit")

    rc, err = done["stopped"]
    check(signalled, f"the drill missed its window: the run exited {rc} "
          f"before SIGTERM:\n{err[-4000:]}")
    check(rc == 75, f"SIGTERM'd train CLI exited {rc}, want 75:\n"
          + err[-4000:])
    stored = ckpt_lib.read_snapshot_signature(snap)
    check(stored is not None, "no readable run snapshot after exit 75")
    _, epochs_done = ckpt_lib.load_run_snapshot(snap, stored)
    events = journal("stopped", "first", "preempted")
    check(_epochs_journaled(events) == list(range(1, epochs_done + 1)),
          f"the SIGTERM'd leg journaled epochs {_epochs_journaled(events)} "
          f"with the epoch-{epochs_done} snapshot on disk")
    log(f"resume drill: SIGTERM once the first snapshot existed -> exit "
        f"75 with the epoch-{epochs_done} snapshot on disk, run_end "
        f"preempted")

    rc, err = done["crashed"]
    check(rc != 0 and "injected crash after chunk 2" in err,
          f"train.chunk:after=1 exited {rc}:\n{err[-4000:]}")
    events = journal("crashed", "first", "error")
    check([e["site"] for e in events if e["event"] == "fault_injected"]
          == ["train.chunk"] and _epochs_journaled(events) == [1, 2],
          "the crashed leg's journal lacks its firing or its epochs")

    # Round 2: both resumes.
    procs = {name: start(name, "resumed", ("--resume",))
             for name in ("stopped", "crashed")}
    done = _wait_all(procs, {name: work / f"{name}-resumed.log"
                             for name in procs}, RESUME_WAIT_S)
    for name, first_epoch in (("stopped", epochs_done + 1), ("crashed", 3)):
        rc, err = done[name]
        check(rc == 0, f"--resume of the {name} run exited {rc}:\n"
              f"{err[-4000:]}")
        check(f"at epoch {first_epoch - 1}" in err,
              f"the {name} run's --resume did not report resuming at epoch "
              f"{first_epoch - 1}")
        check(_epochs_journaled(journal(name, "resumed", "ok"))
              == list(range(first_epoch, RESUME_EPOCHS + 1)),
              f"the resumed {name} leg did not journal the epochs it trained")
        left = sorted(p.name for p in roots[name].models.glob("*.run.npz*"))
        check(not left, f"--resume left run snapshots behind: {left}")
        _same_weights(roots[name].models, roots["unbroken"].models, models,
                      f"{name}, resumed, vs unbroken")
    log("resume drill: --resume after the SIGTERM and after "
        "train.chunk:after=1 (a crash after chunk 2) completed, cleaned up, "
        "and gave the unbroken run's weights bit for bit")
    return {"epochs_done_at_stop": epochs_done, "bitwise": True}


def _chaos_leg(np, work: Path, env: dict, cs_paths) -> dict:
    """``--chaos train.step:if_folds_over=4`` on the cross-subject CLI in
    groups of 8 (the CLI trains every subject's 10 repeats, so 90 folds):
    the first group's out-of-memory error halves the groups to 4
    (``device_fault`` and ``retry`` journaled), the report is written, and
    the weights equal a run started in groups of 4, bit for bit (a halved
    group has the folds, shapes and dropout generator of a group of 4).
    The two runs go at once; each keeps the halving's record of the card's
    group size in a temporary directory of its own."""
    base = [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
            "--trainingType", "Cross-Subject", "--epochs", "1"]
    legs = {"chaos": ["--maxFoldsPerProgram", str(CHAOS_GROUP), "--chaos",
                      f"train.step:if_folds_over={CHAOS_OVER}"],
            "fours": ["--maxFoldsPerProgram", str(CHAOS_OVER)]}
    paths, procs = {}, {}
    t0 = time.perf_counter()
    for name, extra in legs.items():
        paths[name] = _replicated_tree(cs_paths.project_root, work / name)
        (work / name / "tmp").mkdir()
        procs[name] = _spawn(
            base + extra + ["--metricsDir", str(work / name / "obs")],
            dict(env, EEGTPU_DATA_ROOT=str(paths[name].project_root),
                 TMPDIR=str(work / name / "tmp")), work / f"{name}.log")
    done = _wait_all(procs, {n: work / f"{n}.log" for n in legs}, 900)
    wall = time.perf_counter() - t0
    for name, (rc, err) in done.items():
        check(rc == 0, f"chaos leg {name} exited {rc}:\n" + err[-4000:])
    events = _journal(np, work / "chaos" / "obs", "ok")
    faults = [e for e in events if e["event"] == "device_fault"]
    check(len(faults) == 1 and (faults[0]["fold_lo"], faults[0]["fold_hi"],
                                faults[0]["retry_fold_batch"])
          == (0, CHAOS_GROUP, CHAOS_OVER), f"device_fault events {faults}")
    retries = [e for e in events if e["event"] == "retry"]
    check(len(retries) == 1 and retries[0]["classification"]
          == "device_fault", f"retry events {retries}")
    groups = [e["fold_hi"] - e["fold_lo"] for e in events
              if e["event"] == "fold_group"]
    check(groups[0] == CHAOS_GROUP and set(groups[1:]) <= {CHAOS_OVER, 2},
          f"fold groups {groups}")
    _journal(np, work / "fours" / "obs", "ok")
    _check_report(paths["chaos"].reports / "latest_cross_subject_report.json",
                  CS_REPORT_KEYS, "chaos leg")
    _same_weights(paths["chaos"].models, paths["fours"].models,
                  ["cross_subject_best_model.npz"],
                  "halved groups vs groups of 4")
    log(f"chaos leg: train.step:if_folds_over={CHAOS_OVER} halved the 90-fold"
        f" CLI's groups of {CHAOS_GROUP} to {CHAOS_OVER} ({len(groups)} "
        f"fold_group events, one device_fault and one retry), wrote the "
        f"report, and its weights equal a run in groups of {CHAOS_OVER} bit "
        f"for bit ({wall:.1f}s for both runs at once)")
    return {"fold_groups": groups, "wall_s": wall}


def _group_sweep(torch, dev, setup) -> dict:
    """Fold-epochs/s of the whole protocol at each group size: every
    group's trainer takes one warm-up epoch, then CS_SWEEP_EPOCHS timed
    epochs each, group after group (host clock, ended by a synchronize);
    the peak device memory of the size."""
    rows = {}
    for size in CS_SWEEP:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        trainers = [setup.trainer(lo, min(lo + size, setup.n_folds))
                    for lo in range(0, setup.n_folds, size)]
        for trainer in trainers:
            trainer.run_epoch()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for trainer in trainers:
            for _ in range(CS_SWEEP_EPOCHS):
                trainer.run_epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rows[size] = {
            "groups": len(trainers), "wall_s": wall,
            "wall_per_epoch_ms": wall * 1e3 / CS_SWEEP_EPOCHS,
            "fold_epochs_per_s": setup.n_folds * CS_SWEEP_EPOCHS / wall,
            "peak_memory_gb": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
            "train_steps": trainers[0].train_steps,
            "val_steps": trainers[0].val_steps}
        rows[size].update(_mfu_fields(rows[size]))
        log(f"group size {size} ({len(trainers)} groups): "
            f"{rows[size]['fold_epochs_per_s']:.2f} fold-epochs/s, "
            f"{rows[size]['gflops_per_s']:.2f} GFLOP/s = "
            f"{100 * (rows[size]['mfu'] or 0):.4f}% MFU, "
            f"{rows[size]['wall_per_epoch_ms']:.1f} ms per protocol epoch, "
            f"peak memory {rows[size]['peak_memory_gb']:.2f} GiB")
        del trainers
    return rows


def _trace_size(torch, run_epoch, log_dir: Path) -> float:
    """The Chrome trace of one protocol epoch under ``utils/profiling.py::
    trace`` (what ``--profileDir`` writes), in MB on disk."""
    from eegnetreplication_tpu_torch.utils.profiling import trace

    with trace(log_dir) as path:
        run_epoch()
        torch.cuda.synchronize()
    mb = path.stat().st_size / 1e6
    path.unlink()
    log(f"one 90-fold epoch under --profileDir's trace: {mb:.1f} MB")
    return mb


def _journal_cost(np, work: Path, epoch_ms: float) -> dict:
    """Host time the journal adds to a 90-fold epoch: one chunk's
    ``epoch`` events (fold means of a (90, 100) history already on the
    host, written and flushed) and the chunk's metrics, against the
    epoch's wall from the sweep."""
    from eegnetreplication_tpu_torch import obs
    from eegnetreplication_tpu_torch.training.protocols import (
        _journal_epochs,
    )

    epochs = 100
    history = [np.random.RandomState(i).rand(90, epochs).astype(np.float32)
               for i in range(4)]
    with obs.run(work) as jr:
        t0 = time.perf_counter()
        _journal_epochs(jr, history, 0, epochs, epochs, 90)
        jr.metrics.observe("chunk_wall_s", 1.0)
        jr.metrics.inc("fold_epochs_total", 90.0 * epochs)
        per_epoch_ms = (time.perf_counter() - t0) * 1e3 / epochs
    share = per_epoch_ms / epoch_ms
    log(f"journal at 90 folds: {per_epoch_ms:.4f} ms of host time an epoch, "
        f"{100 * share:.4f}% of a {epoch_ms:.1f} ms epoch")
    return {"ms_per_epoch": per_epoch_ms, "share_of_epoch": share}


def _writer_times(torch, trainer, work: Path) -> dict:
    """The snapshot writer at a 90-fold carry, both modes: two snapshots
    each with an epoch between them; what the write takes and what the
    loop waits (host clock)."""
    from eegnetreplication_tpu_torch.training.async_ckpt import SnapshotWriter

    carry_mb = sum(v.numel() * v.element_size()
                   for v in trainer.carry().values()) / 1e6
    out = {"carry_mb": carry_mb}
    for mode in ("async", "sync"):
        writer = SnapshotWriter(work / f"writer_{mode}.run.npz",
                                {"smoke": mode}, async_=mode == "async")
        submit_s = []
        for i in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            writer.submit(trainer.carry(), epochs_done=trainer.epoch)
            submit_s.append(time.perf_counter() - t0)
            if i == 0:
                trainer.run_epoch()
        writer.close()
        recs = writer.records
        loop_waits = [r["stage_s"] + r["blocked_s"] for r in recs
                      if not r["drain"]]
        out[mode] = {
            "write_ms": [r["write_s"] * 1e3 for r in recs],
            "stage_ms": [r["stage_s"] * 1e3 for r in recs],
            "loop_blocked_ms": [w * 1e3 for w in loop_waits],
            "submit_call_ms": [t * 1e3 for t in submit_s]}
        log(f"snapshot writer ({mode}) at 90 folds ({carry_mb:.2f} MB "
            f"carry): write {', '.join(f'{x:.1f}' for x in out[mode]['write_ms'])}"
            f" ms; the loop waited "
            f"{', '.join(f'{x:.2f}' for x in out[mode]['loop_blocked_ms'])} ms")
    return out


def phase_cross_subject(torch, np, dev, work: Path, env: dict,
                        data_root: Path):
    """Phase 11: cross-subject training over phase 8's two subjects
    replicated to nine, group sizes, the snapshot writer, and the resume
    drill."""
    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING, Paths
    from eegnetreplication_tpu_torch.data.io import load_subject_dataset
    from eegnetreplication_tpu_torch.ops.fused_eegnet import block1_stacked
    from eegnetreplication_tpu_torch.training.loop import n_steps
    from eegnetreplication_tpu_torch.training.protocols import (
        CS_CARD_FOLD_BATCH,
        cross_subject_setup,
        cross_subject_training,
    )
    from eegnetreplication_tpu_torch.utils.profiling import breakdown

    cs_paths = _replicated_tree(data_root, work / "tree")
    run_env = dict(env, EEGTPU_DATA_ROOT=str(cs_paths.project_root))

    # The CLI a user runs, on the card, 9 subjects x 10 repeats = 90 folds.
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train",
         "--trainingType", "Cross-Subject", "--epochs", str(CS_EPOCHS)],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=900)
    cli_s = time.perf_counter() - t0
    check(cli.returncode == 0, f"cross-subject train CLI exited "
          f"{cli.returncode}:\n" + cli.stderr[-4000:])
    report = _check_report(
        cs_paths.reports / "latest_cross_subject_report.json",
        CS_REPORT_KEYS, "cross-subject")
    check(report["model_parameters"]["total_folds"] == 90,
          f"report total_folds {report['model_parameters']['total_folds']}")
    for ext in ("pth", "npz"):
        f = cs_paths.models / f"cross_subject_best_model.{ext}"
        check(f.is_file(), f"cross-subject CLI did not write {f.name}")
    log(f"cross-subject train CLI: {CS_EPOCHS} epochs of 90 folds in "
        f"{cli_s:.1f}s, report keys equal the JAX report's, average test "
        f"accuracy {report['overall_results']['average_test_accuracy']}%")
    check(_epochs_journaled(_journal(np, cs_paths.reports / "obs", "ok"))
          == list(range(1, CS_EPOCHS + 1)),
          "the cross-subject CLI's journal lacks an epoch event per epoch")
    pred = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.predict",
         "--checkpoint", str(cs_paths.models / "cross_subject_best_model.npz"),
         "--subject", "1"],
        cwd=ROOT, env=run_env, capture_output=True, text=True, timeout=600)
    check(pred.returncode == 0, f"predict on the cross-subject checkpoint "
          f"exited {pred.returncode}:\n" + pred.stderr[-4000:])
    marker = "block1 kernel launches: "
    check(marker in pred.stderr, "predict did not report K1 launches")
    predict_k1 = int(pred.stderr.split(marker, 1)[1].split()[0])
    check(predict_k1 > 0, "predict on the cross-subject model launched no K1")
    log(f"predict --checkpoint cross_subject_best_model.npz --subject 1: "
        f"{pred.stdout.strip().splitlines()[-1]!r}, K1 launches {predict_k1}")

    # In process: the main path whose stacked-K1 launches are counted.
    def loader(s, mode):
        return load_subject_dataset(s, mode, cs_paths)

    subjects = tuple(range(1, 10))
    kw = dict(loader=loader, subjects=subjects, save_models=False,
              paths=Paths.from_root(work / "inproc"), device=dev)
    val_steps = n_steps(3 * N_TRIALS, DEFAULT_TRAINING.batch_size, 1)
    test_steps = n_steps(N_TRIALS, DEFAULT_TRAINING.batch_size, 1)
    per_group = CS_EPOCHS * val_steps + test_steps
    launches = {}
    for fold_batch, n_groups in ((0, 1), (CS_GROUP, 90 // CS_GROUP)):
        block1_stacked.launches = 0
        run = cross_subject_training(CS_EPOCHS, fold_batch=fold_batch, **kw)
        launches[fold_batch] = block1_stacked.launches
        want = n_groups * per_group
        check(launches[fold_batch] == want,
              f"K1-stacked launched {launches[fold_batch]} times in "
              f"{n_groups} group(s) of {CS_EPOCHS} epochs; want {n_groups} x "
              f"({CS_EPOCHS} x {val_steps} + {test_steps}) = {want}")
        check(np.isfinite(run.fold_min_val_loss).all()
              and run.fold_test_acc.shape == (90,),
              f"cross-subject run at fold_batch={fold_batch}: non-finite "
              "losses or a wrong fold count")
        log(f"in process: 90 folds x {CS_EPOCHS} epochs in {n_groups} "
            f"group(s), K1-stacked launches {launches[fold_batch]} = "
            f"{n_groups} x ({CS_EPOCHS} x {val_steps} + {test_steps}); "
            f"{run.epoch_throughput:.2f} fold-epochs/s")

    # Groups against one group at dropout 0, 18 folds.
    p0 = DEFAULT_TRAINING.replace(dropout_cross_subject=0.0,
                                  cs_repeats_per_subject=2)
    runs = {fb: cross_subject_training(CS_EPOCHS, config=p0, fold_batch=fb,
                                       **kw) for fb in (0, 6)}
    group_delta = {}
    for name in ("train_losses", "val_losses", "min_val_loss"):
        a, b = (getattr(runs[fb].folds, name) for fb in (6, 0))
        check(bool(torch.isfinite(a).all()), f"grouped {name} not finite")
        group_delta[name] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=TRAIN_ATOL, rtol=TRAIN_RTOL),
              f"fold_batch=6 vs one group: {name} differ by "
              f"{group_delta[name]:.3e} (atol {TRAIN_ATOL})")
    log(f"18 folds at dropout 0, groups of 6 vs one group: train losses "
        f"{group_delta['train_losses']:.3e}, validation losses "
        f"{group_delta['val_losses']:.3e} (atol {TRAIN_ATOL})")

    # Learning: the separable pool, class patterns shared across subjects.
    def sep_loader(s, mode):
        return separable_subject(np, s, mode)

    learn = cross_subject_training(
        CS_LEARN_EPOCHS, config=DEFAULT_TRAINING.replace(
            cs_repeats_per_subject=2), **dict(kw, loader=sep_loader))
    check(learn.avg_test_acc > 50.0,
          f"separable pool, cross-subject: test accuracy "
          f"{learn.avg_test_acc:.2f}% after {CS_LEARN_EPOCHS} epochs")
    log(f"separable pool, cross-subject, 18 folds x {CS_LEARN_EPOCHS} epochs "
        f"at dropout 0.25: test accuracy {learn.avg_test_acc:.2f}% (chance "
        f"25%)")

    drill = _resume_drill(np, work / "drill", env, data_root)
    chaos = _chaos_leg(np, work / "chaos", env, cs_paths)

    # Group sizes of the full protocol, then one epoch of the best under
    # the profiler, and the snapshot writer at 90 folds.
    setup, _ = cross_subject_setup(loader, subjects, device=dev)
    sweep = _group_sweep(torch, dev, setup)
    best = max(sweep, key=lambda size: sweep[size]["fold_epochs_per_s"])
    trainers = [setup.trainer(lo, min(lo + best, 90))
                for lo in range(0, 90, best)]
    for trainer in trainers:
        trainer.run_epoch()
    profile = breakdown(lambda: [t.run_epoch() for t in trainers],
                        n_calls=1, top=10)
    log(f"fastest group size {best} (CS_CARD_FOLD_BATCH = "
        f"{CS_CARD_FOLD_BATCH}); one epoch under the profiler: wall "
        f"{profile['wall_ms_per_call']:.1f} ms, device busy "
        f"{profile['device_busy_ms_per_call']:.1f} ms, idle share "
        f"{profile['device_idle_share']}")

    def protocol_epoch():
        for t in trainers:
            t.run_epoch()

    determinism = _determinism_cost(torch, protocol_epoch, 90)
    with _deterministic(torch, False):
        protocol_epoch()
        determinism["profile_off"] = breakdown(protocol_epoch, n_calls=1,
                                               top=10)
    log("90 folds, one epoch under the profiler without the deterministic "
        "mode, top kernels: " + "; ".join(
            f"{k['name'][:48]} {k['ms']:.1f} ms"
            for k in determinism["profile_off"]["top_device_ms_per_call"]))
    log("... and with it: " + "; ".join(
        f"{k['name'][:48]} {k['ms']:.1f} ms"
        for k in profile["top_device_ms_per_call"]))
    trace_mb = _trace_size(torch, protocol_epoch, work / "trace90")
    del trainers
    journal_cost = _journal_cost(np, work / "journal_cost",
                                 sweep[best]["wall_per_epoch_ms"])
    writer = _writer_times(torch, setup.trainer(0, 90), work)
    return {"cli_s": cli_s, "predict_k1_launches": predict_k1,
            "launches_one_group": launches[0],
            "launches_groups": launches[CS_GROUP],
            "val_steps": val_steps, "test_steps": test_steps,
            "group_vs_one_max_abs": group_delta,
            "learn_test_acc": learn.avg_test_acc,
            "learn_fold_epochs_per_s": learn.epoch_throughput,
            "resume_drill": drill, "group_sweep": sweep, "best_group": best,
            "card_fold_batch": CS_CARD_FOLD_BATCH, "epoch_profile": profile,
            "writer": writer, "chaos": chaos, "determinism": determinism,
            "trace_mb_per_epoch": trace_mb, "journal_cost": journal_cost}


# --------------------------------------------------------------------------
# Phase 12: serving beyond one fp32 model
# --------------------------------------------------------------------------

N_TENANTS = 9
ZOO_REQ_TRIALS = 16       # 8 concurrent requests of 16 trials: 128 a batch
ZOO_ROUNDS = 3
RELOAD_CLIENTS = 8


def _save_seeded(torch, path: Path, seed: int) -> Path:
    from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

    model = seeded_model(torch, 22, 257, 8, 2, seed, "cpu")
    return ckpt_lib.save_checkpoint(
        path, model.state_dict(),
        metadata={"model": "eegnet", "n_channels": 22, "n_times": 257,
                  "F1": 8, "D": 2})


def _spawn_predict(args: list, env: dict, work: Path, name: str):
    """Start the predict CLI with ``args``, its stdout and stderr in files
    under ``work``."""
    return _spawn([sys.executable, "-m",
                   "eegnetreplication_tpu_torch.predict", *args], env,
                  work / f"{name}.stderr.log", work / f"{name}.stdout.log")


def _check_predict_cli(np, proc, work: Path, name: str, served, y,
                       what: str) -> str:
    """The predict CLI's accuracy line and class counts equal those of the
    served predictions."""
    from eegnetreplication_tpu_torch.serve.engine import CLASS_NAMES

    rc = proc.wait(timeout=600)
    stdout = (work / f"{name}.stdout.log").read_text()
    stderr = (work / f"{name}.stderr.log").read_text()
    check(rc == 0, f"{what} exited {rc}:\n" + stderr[-4000:])
    served = np.asarray(served)
    want_line = f"accuracy: {100.0 * float(np.mean(served == y)):.2f}%"
    got_line = stdout.strip().splitlines()[-1]
    check(got_line == want_line, f"{what} printed {got_line!r}, served "
          f"trials give {want_line!r}")
    counts = np.bincount(served, minlength=4)
    for k, cname in enumerate(CLASS_NAMES):
        check(f"class {k} ({cname}): {counts[k]} trials" in stderr,
              f"{what}: class {k} count differs from the served one")
    return got_line


def _health_counts(url) -> tuple[int, int, int]:
    """(K1 launches, K1-stacked launches, coalesced forwards) of a
    server, read from /healthz."""
    status, health = _get(url + "/healthz")
    check(status == 200, f"/healthz answered {status}")
    k = health["kernel_launches"]
    return k["block1"], k["block1_stacked"], health["batches"]


def _reload_under_load(np, url, body: bytes, headers: dict, reload_body,
                       what: str) -> tuple[dict, list]:
    """POST /reload while RELOAD_CLIENTS clients send ``body`` to
    /predict in a loop; every answer must be 200.  Returns the reload's
    reply and the answers (status, reply) in the order they came."""
    answers, stop = [], threading.Event()
    lock = threading.Lock()

    def client():
        while not stop.is_set():
            got = _post(url + "/predict", body, "application/octet-stream",
                        headers=headers)
            with lock:
                answers.append(got)

    threads = [threading.Thread(target=client)
               for _ in range(RELOAD_CLIENTS)]
    for th in threads:
        th.start()
    try:
        time.sleep(0.3)
        status, reply = _post(url + "/reload",
                              json.dumps(reload_body).encode(),
                              "application/json", timeout=300)
        time.sleep(0.3)
    finally:
        stop.set()
        for th in threads:
            th.join(120)
    check(status == 200, f"{what}: /reload answered {status}: {reply}")
    failed = [a for a in answers if a[0] != 200]
    check(not failed, f"{what}: {len(failed)} of {len(answers)} requests "
          f"failed during the reload: {failed[:2]}")
    return reply, answers


def _stacked_library(torch, x, S, W, A, B, idx):
    """One library composite of K1-stacked on a mixed-tenant batch (never
    used by the port): the per-trial weights gathered, then cuDNN grouped
    convolutions (a group per trial for the mix, per trial and filter for
    the taps), the affine, ELU and the pool."""
    import torch.nn.functional as F

    n, c, t = x.shape
    f2 = S.shape[1]
    i = idx.long()
    mixed = F.conv1d(x.reshape(1, n * c, t), S[i].reshape(n * f2, c, 1),
                     groups=n)
    acc = F.conv1d(F.pad(mixed, (15, 16)), W[i].reshape(n * f2, 1, 32),
                   groups=n * f2)
    out = F.avg_pool1d(F.elu(A[i].reshape(1, -1, 1) * acc
                             + B[i].reshape(1, -1, 1)), 4)
    return out.reshape(n, f2, -1)


def phase_serving_zoo(torch, np, dev, work: Path, env: dict):
    """Phase 12: the zoo of nine tenants behind ``serve --zoo`` (one
    K1-stacked launch per coalesced chunk, no K1), int8 behind its gate
    (``serve --precision int8``, K1 once per chunk), hot ``/reload`` under
    8 concurrent clients for both, and their timings."""
    from concurrent.futures import ThreadPoolExecutor

    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.ops import quant
    from eegnetreplication_tpu_torch.ops.fused_eegnet import (
        block1_stacked,
        block1_stacked_reference,
    )
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    zoo_dir = work / "zoo"
    zoo_dir.mkdir(parents=True)
    ids = [f"subject_{z + 1:02d}_best_model" for z in range(N_TENANTS)]
    paths = {mid: _save_seeded(torch, zoo_dir / f"{mid}.npz", 1200 + z)
             for z, mid in enumerate(ids)}
    single = _save_seeded(torch, work / "single.npz", 1300)
    new_tenant = _save_seeded(torch, work / "new_tenant.npz", 1301)
    new_single = _save_seeded(torch, work / "new_single.npz", 1302)
    corrupt = work / "corrupt.npz"
    corrupt.write_bytes(new_single.read_bytes()[:400])
    x = trials(torch, ZOO_REQ_TRIALS * 8, 22, 257, 1400).numpy()
    y = np.random.RandomState(1401).randint(0, 4, len(x)).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")
    zoo_obs, int8_obs = work / "obs_zoo", work / "obs_int8"

    # Both servers and the predict CLIs start at once.
    cli = {
        "predict_zoo_3": _spawn_predict(
            ["--zoo", str(zoo_dir), "--model", ids[3], "--input",
             str(trials_path)], env, work, "predict_zoo_3"),
        "predict_int8": _spawn_predict(
            ["--checkpoint", str(single), "--precision", "int8", "--input",
             str(trials_path)], env, work, "predict_int8"),
    }
    with ThreadPoolExecutor(2) as pool:
        zoo_f = pool.submit(_start_server, [
            "--zoo", str(zoo_dir), "--metricsDir", str(zoo_obs)], work, env,
            "serve_zoo")
        int8_f = pool.submit(_start_server, [
            "--checkpoint", str(single), "--precision", "int8",
            "--metricsDir", str(int8_obs)], work, env, "serve_int8")
        servers = {}
        for name, fut in (("zoo", zoo_f), ("int8", int8_f)):
            try:
                servers[name] = fut.result()
            except Exception:
                for proc, _, _ in servers.values():
                    proc.kill()
                raise
    result: dict = {}
    try:
        zoo_url, int8_url = servers["zoo"][1], servers["int8"][1]

        # --- the zoo --------------------------------------------------------
        status, health = _get(zoo_url + "/healthz")
        check(health["stacked"] is True and len(health["tenants"]) ==
              N_TENANTS and health["precision"] == "fp32",
              f"zoo /healthz: stacked {health['stacked']}, "
              f"{len(health['tenants'] or [])} tenants, "
              f"{health['precision']}")
        tenant_digest = {e["model"]: e["digest"] for e in health["tenants"]}
        want = {mid: predict_trials(load_model_from_checkpoint(
            paths[mid], device=dev), x, device=dev) for mid in ids}
        k1_0, k1s_0, b_0 = _health_counts(zoo_url)
        n_requests = 0
        for r in range(ZOO_ROUNDS):
            answers: list = [None] * 8

            def send(i, r=r):
                mid = ids[(i + 3 * r) % N_TENANTS]
                chunk = x[ZOO_REQ_TRIALS * i:ZOO_REQ_TRIALS * (i + 1)]
                if i % 2:
                    body = json.dumps({"trials": chunk.tolist(),
                                       "model": mid}).encode()
                    got = _post(zoo_url + "/predict", body,
                                "application/json")
                else:
                    got = _post(zoo_url + "/predict", _npz_body(np, chunk),
                                "application/octet-stream",
                                headers={"X-Model": mid})
                answers[i] = (mid, got)

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(8)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(120)
            for i, ans in enumerate(answers):
                check(ans is not None and ans[1][0] == 200,
                      f"zoo request {i} of round {r} failed: {ans}")
                mid, (_, reply) = ans
                sl = slice(ZOO_REQ_TRIALS * i, ZOO_REQ_TRIALS * (i + 1))
                check(reply["model"] == mid
                      and reply["model_digest"] == tenant_digest[mid],
                      f"zoo reply names {reply['model']} "
                      f"{reply['model_digest'][:12]}, sent {mid}")
                check(reply["predictions"] == want[mid][sl].tolist(),
                      f"zoo answer for {mid} differs from predict --zoo "
                      f"--model {mid}")
            n_requests += 8
        k1_1, k1s_1, b_1 = _health_counts(zoo_url)
        batches = b_1 - b_0
        check(k1_1 == k1_0, f"the zoo launched K1 {k1_1 - k1_0} times; a "
              "stacked zoo launches K1-stacked only")
        check(k1s_1 - k1s_0 == batches and batches > 0,
              f"K1-stacked launched {k1s_1 - k1s_0} times for {batches} "
              "coalesced chunks; want one each")
        log(f"zoo: {n_requests} mixed-tenant requests of {ZOO_REQ_TRIALS} "
            f"trials (JSON and npz, 8 at once) in {batches} chunks, "
            f"K1-stacked launches {k1s_1 - k1s_0}, K1 0; every answer equal "
            "to predict_trials of its tenant")
        result["zoo"] = {"requests": n_requests, "chunks": batches,
                         "k1_stacked_launches": k1s_1 - k1s_0}
        status, whole = _post(zoo_url + "/predict", _npz_body(np, x),
                              "application/octet-stream",
                              headers={"X-Model": ids[3]})
        check(status == 200
              and whole["predictions"] == want[ids[3]].tolist(),
              f"zoo answer for {ids[3]} (128 trials) differs from predict "
              f"--zoo --model {ids[3]}")
        result["zoo"]["predict_cli"] = _check_predict_cli(
            np, cli.pop("predict_zoo_3"), work, "predict_zoo_3",
            whole["predictions"], y, f"predict --zoo --model {ids[3]}")

        # /predict latency, zoo (mixed tenants) and the int8 single model.
        x128 = trials(torch, 128, 22, 257, 1402).numpy()
        lat = {}
        for name, url, hdr in (("zoo", zoo_url, {"X-Model": ids[5]}),
                               ("int8", int8_url, {})):
            for n, body in ((1, _npz_body(np, x128[:1])),
                            (128, _npz_body(np, x128))):
                lat[f"{name}_{n}"] = host_ms(
                    lambda body=body, url=url, hdr=hdr: _post(
                        url + "/predict", body, "application/octet-stream",
                        headers=hdr), n=N_LATENCY)
        result["predict_latency_ms"] = lat
        log("/predict latency (median, host clock): " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in lat.items()))

        # A corrupt tenant reload: 400, the old digest still serves.
        mid = ids[2]
        status, reply = _post(zoo_url + "/reload", json.dumps(
            {"model": mid, "checkpoint": str(corrupt)}).encode(),
            "application/json", timeout=300)
        check(status == 400, f"zoo /reload of a corrupt file: {status}")
        status, reply = _post(zoo_url + "/predict", _npz_body(np, x[:4]),
                              "application/octet-stream",
                              headers={"X-Model": mid})
        check(status == 200 and reply["model_digest"] == tenant_digest[mid],
              "after a refused reload the tenant's old digest must serve")
        reply, answers = _reload_under_load(
            np, zoo_url, _npz_body(np, x[:8]), {"X-Model": mid},
            {"model": mid, "checkpoint": str(new_tenant)}, "zoo reload")
        check(reply["model_digest"] != tenant_digest[mid]
              and reply["stacked"] is True,
              f"zoo reload reply {reply}")
        new_want = predict_trials(load_model_from_checkpoint(
            new_tenant, device=dev), x[:8], device=dev).tolist()
        old_want = want[mid][:8].tolist()
        # An answer computed across the swap may name either digest (the
        # reply reads it after the forward), but its predictions must be
        # the old model's or the new one's.
        for status, ans in answers:
            check(ans["predictions"] in (old_want, new_want)
                  and ans["model_digest"] in (tenant_digest[mid],
                                              reply["model_digest"]),
                  "an answer during the zoo reload is neither the old "
                  "model's nor the new one's")
        status, after = _post(zoo_url + "/predict", _npz_body(np, x[:8]),
                              "application/octet-stream",
                              headers={"X-Model": mid})
        check(after["model_digest"] == reply["model_digest"]
              and after["predictions"] == new_want,
              "after the zoo reload the tenant serves other answers than "
              "its new checkpoint's predict")
        log(f"zoo reload of {mid} under {RELOAD_CLIENTS} clients: 200, "
            f"{len(answers)} requests, none failed; corrupt file 400 with "
            "the old digest serving")
        result["zoo"]["reload_requests"] = len(answers)

        # --- int8 -----------------------------------------------------------
        status, health = _get(int8_url + "/healthz")
        check(health["precision"] == "int8",
              f"int8 server serves {health['precision']}")
        int8_digest = health["model_digest"]
        model = load_model_from_checkpoint(single, device=dev)
        int8_want = predict_trials(model, x, device=dev, precision="int8")
        k1_0, k1s_0, b_0 = _health_counts(int8_url)
        status, many = _post(int8_url + "/predict", _npz_body(np, x),
                             "application/octet-stream")
        check(status == 200 and many["predictions"] == int8_want.tolist(),
              "int8 served predictions differ from predict --precision "
              "int8's")
        k1_1, k1s_1, b_1 = _health_counts(int8_url)
        check(k1_1 - k1_0 == b_1 - b_0 == 1 and k1s_1 == k1s_0,
              f"int8: K1 {k1_1 - k1_0} launches for {b_1 - b_0} chunks")
        engine = InferenceEngine(model, device=dev, precision="int8")
        cpu = InferenceEngine(load_model_from_checkpoint(single,
                                                         device="cpu"),
                              device="cpu", precision="int8")
        with torch.inference_mode():
            got = engine.forward(torch.from_numpy(x).to(dev)).cpu()
            plain = quant.quantized_eval_forward_reference(
                cpu._qpack, torch.from_numpy(x))
        err = float((got - plain).abs().max())
        check(torch.allclose(got, plain, atol=LOGITS_ATOL, rtol=LOGITS_RTOL)
              and torch.equal(got.argmax(-1), plain.argmax(-1)),
              f"int8 logits on the card vs the plain CPU forward: {err:.3e}")
        log(f"int8: served, predict_trials(precision=int8) equal; K1 once "
            f"per chunk; logits vs the plain CPU int8 forward {err:.3e}")
        result["int8"] = {"logits_max_abs_err": err,
                          "k1_launches": k1_1 - k1_0,
                          "predict_cli": _check_predict_cli(
                              np, cli.pop("predict_int8"), work,
                              "predict_int8", int8_want, y,
                              "predict --precision int8")}
        status, reply = _post(int8_url + "/reload", json.dumps(
            {"checkpoint": str(corrupt)}).encode(), "application/json",
            timeout=300)
        check(status == 400, f"int8 /reload of a corrupt file: {status}")
        status, reply = _post(int8_url + "/predict", _npz_body(np, x[:4]),
                              "application/octet-stream")
        check(reply["model_digest"] == int8_digest,
              "after a refused reload the old digest must serve")
        reply, answers = _reload_under_load(
            np, int8_url, _npz_body(np, x[:8]), {},
            {"checkpoint": str(new_single)}, "int8 reload")
        new_want = predict_trials(load_model_from_checkpoint(
            new_single, device=dev), x[:8], device=dev,
            precision="int8").tolist()
        for status, ans in answers:
            check(ans["predictions"] in (int8_want[:8].tolist(), new_want),
                  "an answer during the int8 reload is neither the old "
                  "model's nor the new one's")
        status, after = _post(int8_url + "/predict", _npz_body(np, x[:8]),
                              "application/octet-stream")
        check(reply["model_digest"] != int8_digest
              and after["model_digest"] == reply["model_digest"]
              and after["predictions"] == new_want,
              "after the reload the server answers other than the new "
              "checkpoint's predict --precision int8")
        log(f"int8 reload under {RELOAD_CLIENTS} clients: 200, "
            f"{len(answers)} requests, none failed; corrupt file 400")
        result["int8"]["reload_requests"] = len(answers)

        for name, (proc, _, stderr) in servers.items():
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 75, f"{name} server exited {rc} after SIGTERM")
    finally:
        for proc, _, stderr in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stderr.close()
        for proc in cli.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # The journals: the gates passed, the restacks and swaps are there.
    zoo_events = _journal(np, zoo_obs, "ok")
    gates = [e for e in zoo_events if e["event"] == "stack_gate"]
    restacks = [e["outcome"] for e in zoo_events
                if e["event"] == "zoo_restack"]
    check(gates and all(g["outcome"] == "pass" and g["agreement"] == 1.0
                        for g in gates), f"zoo stack_gate events {gates}")
    check(restacks == ["pass", "pass"], f"zoo_restack outcomes {restacks}")
    int8_events = _journal(np, int8_obs, "ok")
    qgates = [e for e in int8_events if e["event"] == "quant_gate"]
    check(len(qgates) == 2 and all(
        g["outcome"] == "pass" and g["agreement"] >= 0.99 for g in qgates),
        f"quant_gate events {qgates}")
    for events, what in ((zoo_events, "zoo"), (int8_events, "int8")):
        swaps = [e for e in events if e["event"] == "model_swap"]
        check(len(swaps) == 1, f"{what}: {len(swaps)} model_swap events")
    result["stack_gate_agreement"] = gates[-1]["agreement"]
    result["quant_gate_agreement"] = [g["agreement"] for g in qgates]
    log(f"journals: stack_gate pass (agreement 1.0 over "
        f"{gates[0]['n_trials']} trials), zoo_restack pass x2, quant_gate "
        f"pass {result['quant_gate_agreement']}, one model_swap each")

    # Timings: K1-stacked at a 128-trial chunk mixed over nine tenants,
    # beside its plain version, a grouped cuDNN composite and its bound;
    # the engines' infer at buckets 1 and 128.
    models = [load_model_from_checkpoint(paths[mid], device=dev)
              for mid in ids]
    stack = StackedEngine(list(zip(ids, models)), device=dev)
    pack = stack._pack
    S, W, A, B = pack["S"], pack["W"], pack["A"], pack["B"]
    xt = torch.from_numpy(x128).to(dev)
    idx = (torch.arange(128, dtype=torch.int32, device=dev) % N_TENANTS)
    idx = idx[torch.randperm(128, generator=torch.Generator().manual_seed(
        5)).to(dev)].contiguous()
    with torch.inference_mode():
        k1s = block1_stacked(xt, S, W, A, B, idx)
        ref = block1_stacked_reference(xt, S, W, A, B, idx)
        lib = _stacked_library(torch, xt, S, W, A, B, idx)
        check(torch.allclose(k1s, ref, atol=K1_ATOL, rtol=K1_RTOL)
              and torch.allclose(lib, ref, atol=K1_ATOL, rtol=K1_RTOL),
              "K1-stacked or the library composite disagrees at the zoo "
              "chunk")
        row = {
            "max_abs_err": float((k1s - ref).abs().max()),
            "ms": device_ms(torch, lambda: block1_stacked(
                xt, S, W, A, B, idx)),
            "plain_ms": device_ms(torch, lambda: block1_stacked_reference(
                xt, S, W, A, B, idx)),
            "library_ms": device_ms(torch, lambda: _stacked_library(
                torch, xt, S, W, A, B, idx)),
            "call_ms": call_ms(torch, lambda: block1_stacked(
                xt, S, W, A, B, idx)),
        }
    bound, by, nbytes, flops = block1_bound(128, 22, 257, 16,
                                            sets=N_TENANTS)
    row.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    result["k1_stacked_zoo_chunk"] = row
    log(f"K1-stacked at a 128-trial chunk over {N_TENANTS} tenants: "
        f"{row['ms']:.4f} ms (call {row['call_ms']:.4f}), plain "
        f"{row['plain_ms']:.4f}, grouped library {row['library_ms']:.4f}, "
        f"bound {bound:.5f} ({by})")
    infer = {}
    fp32 = InferenceEngine(models[0], device=dev)
    int8 = InferenceEngine(models[0], device=dev, precision="int8")
    for eng in (fp32, int8, stack):
        eng.warmup()
    for n in (1, 128):
        xn = x128[:n]
        tn = np.arange(n) % N_TENANTS
        infer[f"fp32_{n}"] = host_ms(lambda xn=xn: fp32.infer(xn))
        infer[f"int8_{n}"] = host_ms(lambda xn=xn: int8.infer(xn))
        infer[f"zoo_{n}"] = host_ms(lambda xn=xn, tn=tn: stack.infer(xn,
                                                                     tn))
    result["infer_ms"] = infer
    log("engine infer (median, host clock): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in infer.items()))
    return result


# --------------------------------------------------------------------------
# Phase 13: live streaming sessions
# --------------------------------------------------------------------------

# K2s against its plain version: each operation is rounded on its own in
# both (csrc/ems_stream.cu, ops/ems_kernel.py), so they should agree to the
# bit; 1e-6 leaves room for nothing but that.
K2S_ATOL, K2S_RTOL = 1e-6, 1e-6
K2S_CHANNELS = (1, 22, 64)
K2S_LENGTHS = (1, 2, 25, 64, 250, 1000, 4096, 15000)
K2S_SPLITS = (25, 64, 997, 1)
K2S_SPLIT_ONE = 2000     # chunks of one sample over the first 2000
K2S_SESSION_CHANNELS = (1, 64)   # whole sessions, chunked and one-shot
# K2s's step (csrc/ems_stream.cu::step): 12 operations a sample, and a
# chain of a dependent multiply and add (4 cycles each) from one sample's
# m (and v) to the next.
K2S_OPS_PER_SAMPLE = 12
K2S_CHAIN_CYCLES = 8
# The live streams: one headset per BCI IV 2a subject, 22 channels at
# 250 Hz for 60 s, pushed 100 ms at a time; EEGNet's 257-sample window
# every 64 samples; the stream bench's per-window deadline of four hops.
STREAM_SUBJECTS = 9
STREAM_HZ = 250
STREAM_SAMPLES = 60 * STREAM_HZ
STREAM_CHUNK = 25
STREAM_WINDOW, STREAM_HOP = 257, 64
STREAM_BLOCK = 1000
STREAM_DEADLINE_MS = 1024.0
HOP_MS = 1000.0 * STREAM_HOP / STREAM_HZ        # 256 ms
STREAM_OPEN = {"window": STREAM_WINDOW, "hop": STREAM_HOP,
               "ems_init_block_size": STREAM_BLOCK,
               "deadline_ms": STREAM_DEADLINE_MS}
KILL_SNAPSHOT_EVERY = 20
K2S_TIMED = (STREAM_CHUNK, 250, SESSION[1])


def stream_recording(np, seed, c=22, n=None):
    """A seeded synthetic headset recording ``(c, n)`` f32 in microvolts
    (``n`` defaults to STREAM_SAMPLES): noise, a 10 Hz rhythm and a
    per-channel offset."""
    n = STREAM_SAMPLES if n is None else n
    rng = np.random.RandomState(seed)
    t = np.arange(n) / STREAM_HZ
    x = (8.0 * rng.randn(c, n) + 20.0 * rng.randn(c, 1)
         + 5.0 * np.sin(2 * np.pi * 10.0 * t + rng.rand(c, 1) * 6.28))
    return x.astype(np.float32)


def n_windows(n, window=STREAM_WINDOW, hop=STREAM_HOP) -> int:
    return (n - window) // hop + 1 if n >= window else 0


def k2s_bound(c, n):
    """(bound_ms, bound_by, bytes, ops) of one K2s call: x read once, the
    seed mean and the carry read once, out and the carry written once; 12
    operations a sample."""
    nbytes = 4 * (2 * c * n + 5 * c)
    ops = K2S_OPS_PER_SAMPLE * c * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, ops)


def max_sm_clock_ghz() -> float:
    """The card's maximum SM clock from ``nvidia-smi``."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0]) / 1e3


def _get_bytes(url, timeout=60.0) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.read()


def _k2s_against_plain(torch, np, dev) -> dict:
    """13a: K2s against ``ems_stream_reference`` on the card, the carry
    threaded through 3 chunks, at every (C, n) of the grid."""
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems_stream,
        ems_stream_reference,
        seed_stats,
    )

    worst, bitwise = 0.0, True
    for c in K2S_CHANNELS:
        for n in K2S_LENGTHS:
            x = torch.from_numpy(stream_recording(np, 500 + c, c, 3 * n)
                                 ).to(dev)
            mean0, var0 = seed_stats(x, STREAM_BLOCK)
            mk, vk = torch.zeros_like(mean0), var0.clone()
            mp, vp = torch.zeros_like(mean0), var0.clone()
            for k in range(3):
                chunk = x[:, k * n:(k + 1) * n].contiguous()
                got = ems_stream(chunk, mean0, mk, vk)
                want = ems_stream_reference(chunk, mean0, mp, vp)
                torch.cuda.synchronize()
                for g, w, what in ((got, want, "out"), (mk, mp, "m"),
                                   (vk, vp, "v")):
                    check(torch.allclose(g, w, atol=K2S_ATOL,
                                         rtol=K2S_RTOL),
                          f"K2s {what} at C={c}, n={n}, chunk {k}: max "
                          f"err {float((g - w).abs().max()):.3e}")
                    bitwise = bitwise and bool(torch.equal(g, w))
                worst = max(worst, float((got - want).abs().max()))
    log(f"K2s vs its plain version at C {K2S_CHANNELS} x n {K2S_LENGTHS}, "
        f"3 chunks each: max abs err {worst:.3e} (atol/rtol {K2S_ATOL}); "
        f"bitwise equal: {bitwise}")
    return {"max_abs_err": worst, "bitwise": bitwise}


def _k2s_invariance(torch, np, dev) -> None:
    """13a: any split of a (22, 15000) stream through the carrier gives the
    one-shot ``scan``'s bytes and final carry; three calls repeat."""
    from eegnetreplication_tpu_torch.ops.ems import (
        StreamingEMS,
        exponential_moving_standardize,
        scan_with_carry,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems_stream,
        seed_stats,
    )

    x = stream_recording(np, 600)
    xt = torch.from_numpy(x).to(dev)
    check(torch.equal(scan_with_carry(xt, init_block_size=STREAM_BLOCK)[0],
                      exponential_moving_standardize(
                          xt, init_block_size=STREAM_BLOCK, method="scan")),
          "scan_with_carry and method='scan' differ on the card")
    for split in K2S_SPLITS + (STREAM_SAMPLES,):
        n = K2S_SPLIT_ONE if split == 1 else STREAM_SAMPLES
        out, m, v = (t.cpu().numpy() for t in scan_with_carry(
            xt[:, :n].contiguous(), init_block_size=STREAM_BLOCK))
        ems = StreamingEMS(22, init_block_size=STREAM_BLOCK, device=dev)
        got = np.concatenate([ems.push(x[:, p:min(p + split, n)])
                              for p in range(0, n, split)], axis=1)
        state = ems.state_arrays()
        check(np.array_equal(got, out) and np.array_equal(state["m"], m)
              and np.array_equal(state["v"], v),
              f"a stream in chunks of {split} differs from the one-shot "
              "scan on the card")
    mean0, var0 = seed_stats(xt, STREAM_BLOCK)
    runs = []
    for _ in range(3):
        mm, vv = torch.zeros_like(mean0), var0.clone()
        runs.append((ems_stream(xt, mean0, mm, vv), mm, vv))
    check(all(torch.equal(a, b) for r in runs[1:]
              for a, b in zip(runs[0], r)),
          "three K2s calls on one input differ")
    # A whole 45-minute session at one channel (one SM) and at 64 (64
    # SMs): the one-shot call against pushes of 25 (one warp each) and
    # chunks of 997 (the ring), out and carry to the bit.
    for c in K2S_SESSION_CHANNELS:
        xs = torch.from_numpy(stream_recording(np, 610 + c, c, SESSION[1])
                              ).to(dev)
        mean0, var0 = seed_stats(xs, STREAM_BLOCK)
        m1, v1 = torch.zeros_like(mean0), var0.clone()
        one = ems_stream(xs, mean0, m1, v1)
        for split in (STREAM_CHUNK, 997):
            mm, vv = torch.zeros_like(mean0), var0.clone()
            parts = [ems_stream(xs[:, p:p + split].contiguous(), mean0, mm,
                                vv) for p in range(0, SESSION[1], split)]
            torch.cuda.synchronize()
            check(torch.equal(torch.cat(parts, dim=1), one)
                  and torch.equal(mm, m1) and torch.equal(vv, v1),
                  f"K2s at ({c}, {SESSION[1]}) in chunks of {split} differs "
                  "from the one-shot call")
    log(f"chunk invariance on the card: chunks of "
        f"{list(K2S_SPLITS + (STREAM_SAMPLES,))} (1 over the first "
        f"{K2S_SPLIT_ONE}) give the one-shot scan's out and carry bit for "
        f"bit; three calls bitwise equal; {SESSION[1]} samples at "
        f"{' and '.join(map(str, K2S_SESSION_CHANNELS))} channels in chunks "
        f"of {STREAM_CHUNK} and 997 give the one-shot call's bits")


def _k2s_times(torch, np, dev) -> dict:
    """13b: K2s at a push, a second's chunk and a 45-minute session; its
    plain version at the first two; K2 and ``associative`` at the last."""
    from eegnetreplication_tpu_torch.ops.ems import (
        exponential_moving_standardize,
    )
    from eegnetreplication_tpu_torch.ops.ems_kernel import (
        ems,
        ems_stream,
        ems_stream_reference,
        seed_stats,
    )

    clock = max_sm_clock_ghz()
    rows = {}
    for n in K2S_TIMED:
        x = torch.from_numpy(stream_recording(np, 700, 22, n)).to(dev)
        mean0, var0 = seed_stats(x, STREAM_BLOCK)
        m, v = torch.zeros_like(mean0), var0.clone()
        bound, by, nbytes, ops = k2s_bound(22, n)
        row = {"ms": device_ms(torch, lambda: ems_stream(x, mean0, m, v)),
               "call_ms": call_ms(torch, lambda: ems_stream(x, mean0, m,
                                                            v)),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes,
               "ops": ops, "chain_ms": n * K2S_CHAIN_CYCLES / clock / 1e6,
               "plain_ms": None}
        if n < STREAM_BLOCK:
            mp, vp = m.clone(), v.clone()
            row["plain_ms"] = device_ms(torch, lambda: ems_stream_reference(
                x, mean0, mp, vp), warmup=2)
        else:
            flush = torch.empty(64 * 2 ** 20, dtype=torch.uint8, device=dev)
            row["k2_ms"] = device_ms(torch, lambda: ems(x), flush=flush)
            row["associative_ms"] = device_ms(
                torch, lambda: exponential_moving_standardize(
                    x, method="associative"), flush=flush)
        rows[n] = row
        log(f"K2s at (22, {n}): {row['ms']:.4f} ms (call "
            f"{row['call_ms']:.4f}), plain {row['plain_ms']}, bound "
            f"{bound:.6f} ({by}), serial chain {row['chain_ms']:.4f} at "
            f"{clock:.2f} GHz" + (
                f"; K2 {row['k2_ms']:.4f}, associative "
                f"{row['associative_ms']:.4f}" if "k2_ms" in row else ""))
    # A push's host side: StreamingEMS.push of 25 samples once seeded, and
    # the two copies in it (the chunk to the card, the samples back).
    from eegnetreplication_tpu_torch.ops.ems import StreamingEMS

    rec = stream_recording(np, 701, 22, STREAM_BLOCK + STREAM_CHUNK)
    ems = StreamingEMS(22, init_block_size=STREAM_BLOCK, device=dev)
    ems.push(rec[:, :STREAM_BLOCK])
    chunk = np.ascontiguousarray(rec[:, STREAM_BLOCK:])
    on_card = torch.from_numpy(chunk).to(dev)

    def to_card():
        torch.from_numpy(chunk).to(dev)
        torch.cuda.synchronize()

    push = {"push_ms": host_ms(lambda: ems.push(chunk), n=N_TIMED),
            "to_card_ms": host_ms(to_card, n=N_TIMED),
            "to_host_ms": host_ms(lambda: on_card.cpu().numpy(),
                                  n=N_TIMED)}
    push["copies_share"] = ((push["to_card_ms"] + push["to_host_ms"])
                            / push["push_ms"])
    log(f"StreamingEMS.push of (22, {STREAM_CHUNK}) on the host clock: "
        f"{push['push_ms']:.4f} ms, of which the copies to the card "
        f"{push['to_card_ms']:.4f} and back {push['to_host_ms']:.4f} "
        f"({100 * push['copies_share']:.1f}%)")
    return {"sm_clock_ghz": clock, "by_n": rows, "push": push}


def _stream_client(np, url, sid, x, start=0, open_session=True) -> dict:
    """Open ``sid`` (unless resuming) and push ``x[:, start:]`` in raw f32
    chunks of STREAM_CHUNK as fast as the server answers; the decisions,
    the push round trips and the pushes that ran the EMS carry."""
    if open_session:
        status, opened = _post(url + "/session/open", json.dumps(
            dict(STREAM_OPEN, session=sid)).encode(), "application/json")
        check(status == 200 and not opened["resumed"],
              f"/session/open {sid}: {status} {opened}")
    decisions, push_ms, seeded_pushes = [], [], 0
    for pos in range(start, x.shape[1], STREAM_CHUNK):
        body = np.ascontiguousarray(
            x[:, pos:pos + STREAM_CHUNK]).astype("<f4").tobytes()
        t0 = time.perf_counter()
        status, reply = _post(f"{url}/session/{sid}/samples", body,
                              "application/octet-stream")
        push_ms.append((time.perf_counter() - t0) * 1000.0)
        check(status == 200, f"{sid} push at {pos}: {status} {reply}")
        decisions.extend(reply["decisions"])
        seeded_pushes += bool(reply["seeded"])
    return {"decisions": decisions, "push_ms": push_ms,
            "seeded_pushes": seeded_pushes}


def _offline(torch, np, engine, x, dev):
    """The offline pipeline: one-shot ``scan`` on the card, the same
    windows, the engine; ``(preds, m, v)``."""
    from eegnetreplication_tpu_torch.ops.ems import scan_with_carry

    std, m, v = scan_with_carry(torch.from_numpy(x).to(dev),
                                init_block_size=STREAM_BLOCK)
    std = std.cpu().numpy()
    wins = np.stack([std[:, k * STREAM_HOP:k * STREAM_HOP + STREAM_WINDOW]
                     for k in range(n_windows(x.shape[1]))])
    return engine.infer(wins), m.cpu().numpy(), v.cpu().numpy()


def _exported_carry(np, url, sid):
    from eegnetreplication_tpu_torch.serve.sessions.store import (
        unpack_session,
    )

    got, state = unpack_session(_get_bytes(f"{url}/session/{sid}/export"))
    check(got == sid, f"export of {sid} names {got}")
    return np.asarray(state["ems/m"]), np.asarray(state["ems/v"])


def _ems_launches(url) -> int:
    status, health = _get(url + "/healthz")
    check(status == 200, f"/healthz answered {status}")
    return health["kernel_launches"]["ems_stream"]


def _live_streams(torch, np, dev, url, engine) -> dict:
    """13c: nine concurrent sessions, one per subject, against one server;
    every gate of the live path."""
    from concurrent.futures import ThreadPoolExecutor

    xs = {f"subject{s:02d}": stream_recording(np, 800 + s)
          for s in range(1, STREAM_SUBJECTS + 1)}
    check(_ems_launches(url) == 0, "ems_stream launched before any push")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(STREAM_SUBJECTS) as pool:
        futs = {sid: pool.submit(_stream_client, np, url, sid, x)
                for sid, x in xs.items()}
        runs = {sid: f.result() for sid, f in futs.items()}
    wall = time.perf_counter() - t0
    launches = _ems_launches(url)
    want_launches = sum(r["seeded_pushes"] for r in runs.values())
    n_pushes = sum(len(r["push_ms"]) for r in runs.values())
    check(launches == want_launches, f"ems_stream launched {launches} "
          f"times; {want_launches} pushes ran the carry")
    lat = []
    for sid, x in xs.items():
        decs = runs[sid]["decisions"]
        n_win = n_windows(x.shape[1])
        check(len(decs) == n_win and [d["window"] for d in decs]
              == list(range(n_win)), f"{sid}: {len(decs)} decisions in "
              f"order, want {n_win}")
        check(all(d["status"] == "ok" for d in decs),
              f"{sid}: statuses {sorted({d['status'] for d in decs})}")
        preds, m, v = _offline(torch, np, engine, x, dev)
        got = np.asarray([d["pred"] for d in decs])
        check(np.array_equal(got, preds), f"{sid}: "
              f"{int((got != preds).sum())} decisions differ from the "
              "offline pipeline")
        em, ev = _exported_carry(np, url, sid)
        check(np.array_equal(em, m) and np.array_equal(ev, v),
              f"{sid}: the exported carry differs from the one-shot "
              "kernel's final carry")
        status, closed = _post(f"{url}/session/{sid}/close", b"{}",
                               "application/json")
        check(status == 200 and closed["preds"] == got.tolist(),
              f"{sid}: close answered {status} with other predictions")
        lat.extend(d["latency_ms"] for d in decs)
    lat = np.asarray(lat)
    push = np.concatenate([r["push_ms"] for r in runs.values()])
    row = {
        "sessions": len(xs), "windows": int(lat.size), "pushes": n_pushes,
        "ems_stream_launches": launches, "wall_s": wall,
        "window_ms": {f"p{q}": float(np.percentile(lat, q))
                      for q in (50, 95, 99)},
        "push_ms": {f"p{q}": float(np.percentile(push, q))
                    for q in (50, 95, 99)},
        "windows_per_s": lat.size / wall, "pushes_per_s": n_pushes / wall,
    }
    check(row["window_ms"]["p95"] < HOP_MS, f"p95 window latency "
          f"{row['window_ms']['p95']:.1f} ms is not under the {HOP_MS:.0f} "
          "ms hop interval")
    log(f"live streams: {len(xs)} sessions x {n_windows(STREAM_SAMPLES)} "
        f"windows, all ok and equal to the offline pipeline, carries "
        f"bitwise; {launches} ems_stream launches = pushes from the seed "
        f"on; window latency p50/p95/p99 "
        + "/".join(f"{row['window_ms'][k]:.2f}" for k in ("p50", "p95",
                                                          "p99"))
        + f" ms; push p50/p95 {row['push_ms']['p50']:.2f}/"
        f"{row['push_ms']['p95']:.2f} ms; {row['windows_per_s']:.1f} "
        f"windows/s, {row['pushes_per_s']:.1f} pushes/s over {wall:.2f} s")
    return row


def _kill_and_resume(torch, np, dev, url, proc, args, work, env,
                     engine) -> dict:
    """13d: SIGKILL mid-stream, relaunch with --resume, replay from the
    acked cursor; then a SIGTERM leg on the relaunched server."""
    x = stream_recording(np, 900)
    total = n_windows(STREAM_SAMPLES)
    sid = "killed"
    status, _ = _post(url + "/session/open", json.dumps(
        dict(STREAM_OPEN, session=sid)).encode(), "application/json")
    check(status == 200, f"/session/open {sid}: {status}")
    told, pos = [], 0
    while len(told) < total // 2:
        body = np.ascontiguousarray(
            x[:, pos:pos + STREAM_CHUNK]).astype("<f4").tobytes()
        status, reply = _post(f"{url}/session/{sid}/samples", body,
                              "application/octet-stream")
        check(status == 200, f"{sid} push at {pos}: {status}")
        told.extend(reply["decisions"])
        pos += STREAM_CHUNK
    proc.kill()
    proc.wait(timeout=60)
    proc2, url2, stderr2 = _start_server(args + ["--resume"], work, env,
                                         "serve_resumed")
    try:
        status, state = _get(f"{url2}/session/{sid}/state")
        acked, restored = state["acked"], state["windows"]
        check(status == 200 and 0 < acked <= pos
              and 0 < restored <= len(told),
              f"restored cursor {acked} / {restored} windows past what was "
              f"pushed ({pos}) or told ({len(told)})")
        status, reopened = _post(url2 + "/session/open", json.dumps(
            dict(STREAM_OPEN, session=sid)).encode(), "application/json")
        check(reopened["resumed"] and reopened["acked"] == acked,
              f"re-open after --resume: {reopened}")
        replay = _stream_client(np, url2, sid, x, start=acked,
                                open_session=False)
        again = {d["window"]: d for d in replay["decisions"]}
        redecided = list(range(restored, len(told)))
        check(all(again[w]["pred"] == told[w]["pred"] for w in redecided),
              "a window decided again after the resume differs from what "
              "the client was told before the kill")
        status, closed = _post(f"{url2}/session/{sid}/close", b"{}",
                               "application/json")
        preds, _, _ = _offline(torch, np, engine, x, dev)
        check(status == 200 and closed["preds"] == preds.tolist(),
              "the resumed decision stream differs from the uninterrupted "
              "one")
        # SIGTERM: the drain snapshots the open session and exits 75.
        term = _stream_client(np, url2, "drained", x[:, :2000])
        launches = _ems_launches(url2)
        check(launches == replay["seeded_pushes"] + term["seeded_pushes"],
              f"resumed server: {launches} ems_stream launches for "
              f"{replay['seeded_pushes'] + term['seeded_pushes']} pushes")
        proc2.send_signal(signal.SIGTERM)
        rc = proc2.wait(timeout=120)
        check(rc == 75, f"resumed server exited {rc} after SIGTERM")
    finally:
        if proc2.poll() is None:
            proc2.kill()
            proc2.wait()
        stderr2.close()
    snap = Path(args[args.index("--sessionsDir") + 1]) / "sessions.npz"
    with np.load(snap) as npz:
        meta = json.loads(bytes(npz["__meta__"]).decode())
        check(meta["sessions"] == ["drained"]
              and "s/drained/ems/m" in npz.files,
              f"the SIGTERM drain left {meta['sessions']} in {snap}")
    row = {"pushed_before_kill": pos, "told_before_kill": len(told),
           "acked": acked, "restored_windows": restored,
           "redecided": len(redecided),
           "replay_pushes": len(replay["push_ms"]),
           "drained_sessions": meta["sessions"],
           "ems_stream_launches": launches}
    log(f"kill and resume: SIGKILL after {len(told)} of {total} windows "
        f"({pos} samples); --resume restored acked {acked}, {restored} "
        f"windows; {len(redecided)} windows decided again as told; the "
        f"stream equals the uninterrupted one; SIGTERM -> 75 with "
        f"{meta['sessions']} in {snap.name}")
    return row


def _zoo_session(torch, np, dev, url, zoo_dir) -> dict:
    """13e: one session against a ``--zoo`` server classifies under the
    default tenant."""
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    status, health = _get(url + "/healthz")
    check(status == 200 and health["stacked"] is True,
          f"zoo /healthz: {status}, stacked {health.get('stacked')}")
    default = health["zoo"]["default"]
    engine = InferenceEngine(load_model_from_checkpoint(
        zoo_dir / f"{default}.npz", device=dev), device=dev)
    x = stream_recording(np, 950)
    run = _stream_client(np, url, "zoo", x)
    preds, _, _ = _offline(torch, np, engine, x, dev)
    got = [d["pred"] for d in run["decisions"]]
    check(all(d["status"] == "ok" for d in run["decisions"])
          and got == preds.tolist(), "the zoo session differs from the "
          f"offline pipeline through the default tenant {default}")
    launches = _ems_launches(url)
    check(launches == run["seeded_pushes"], f"zoo server: {launches} "
          f"ems_stream launches for {run['seeded_pushes']} pushes")
    log(f"zoo session: {len(got)} windows under the default tenant "
        f"{default}, equal to its engine's offline pipeline")
    return {"default": default, "windows": len(got),
            "ems_stream_launches": launches}


def phase_streams(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 13: K2s against its plain version and chunk invariance on the
    card, live sessions through ``serve`` (nine at once, kill -> --resume,
    SIGTERM, a zoo), and the times of K2s."""
    from concurrent.futures import ThreadPoolExecutor

    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    t_phase = time.perf_counter()
    ckpt = _save_seeded(torch, work / "stream.npz", 1500)
    zoo_dir = work / "zoo"
    zoo_dir.mkdir(parents=True)
    for z in range(N_TENANTS):
        _save_seeded(torch, zoo_dir / f"subject_{z + 1:02d}_best_model.npz",
                     1600 + z)

    def server_args(name, *extra):
        return [*extra, "--sessionsDir", str(work / f"sess_{name}"),
                "--metricsDir", str(work / f"obs_{name}")]

    kill_flags = ("--sessionSnapshotEvery", str(KILL_SNAPSHOT_EVERY))
    args = {"live": server_args("live", "--checkpoint", str(ckpt)),
            "kill": server_args("kill", "--checkpoint", str(ckpt),
                                *kill_flags),
            "zoo": server_args("zoo", "--zoo", str(zoo_dir))}
    servers: dict = {}
    errors = []
    try:
        # The servers start while K2s is checked in this process.
        with ThreadPoolExecutor(len(args)) as pool:
            futs = {name: pool.submit(_start_server, a, work, env,
                                      f"serve_{name}")
                    for name, a in args.items()}
            try:
                result: dict = {"k2s": _k2s_against_plain(torch, np, dev)}
                _k2s_invariance(torch, np, dev)
            finally:
                for name, fut in futs.items():
                    try:
                        servers[name] = fut.result()
                    except Exception as exc:  # noqa: BLE001 — raised below
                        errors.append(exc)
        if errors:
            raise errors[0]
        engine = InferenceEngine(load_model_from_checkpoint(
            ckpt, device=dev), device=dev)
        result["live"] = _live_streams(torch, np, dev, servers["live"][1],
                                       engine)
        # The relaunch keeps the killed server's sessions and journals
        # apart from it.
        proc, url, stderr = servers.pop("kill")
        stderr.close()
        resumed_args = [*args["kill"][:-2], "--metricsDir",
                        str(work / "obs_resumed")]
        result["kill_resume"] = _kill_and_resume(
            torch, np, dev, url, proc, resumed_args, work, env, engine)
        result["zoo"] = _zoo_session(torch, np, dev, servers["zoo"][1],
                                     zoo_dir)
        for name, (proc, _, _) in servers.items():
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
            check(rc == 75, f"{name} server exited {rc} after SIGTERM")
    finally:
        for proc, _, stderr in servers.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            stderr.close()

    events = _journal(np, work / "obs_live", "ok")
    kinds = [e["event"] for e in events]
    for kind in ("session_start", "session_window", "session_snapshot",
                 "session_end"):
        check(kind in kinds, f"the live server's journal has no {kind}")
    check(kinds.count("session_window") == result["live"]["windows"],
          f"{kinds.count('session_window')} session_window events for "
          f"{result['live']['windows']} windows")
    end = [e for e in events if e["event"] == "serve_end"][-1]
    check(end["sessions"] == STREAM_SUBJECTS
          and end["session_windows"] == result["live"]["windows"],
          f"serve_end counts sessions {end['sessions']}, windows "
          f"{end['session_windows']}")
    resumed = _journal(np, work / "obs_resumed", "ok")
    check(any(e["event"] == "session_resume" for e in resumed),
          "the resumed server journaled no session_resume")
    result["journal"] = {"events": len(events),
                         "session_snapshots": end["session_snapshots"]}
    log(f"journals read back clean: {len(events)} events, "
        f"{end['session_snapshots']} session snapshots, run_end ok; the "
        "resumed server's session_resume")
    result["launches"] = (result["live"]["ems_stream_launches"]
                          + result["kill_resume"]["ems_stream_launches"]
                          + result["zoo"]["ems_stream_launches"])
    result["times"] = _k2s_times(torch, np, dev)
    result["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 13 in {result['wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# Phase 14: the serving control plane
# --------------------------------------------------------------------------

TUNE_CLIENTS = 8
TUNE_REQ_TRIALS = 40      # the steady 40-trial requests the tuner targets
TUNE_PERIOD_S = 0.1       # one request a client every 100 ms, staggered
TUNE_MAX_S = 30.0         # load until a retune has served, at most this
TUNE_AFTER_S = 3.0        # load kept on after the first applied retune
N_BREAKDOWN = 20          # calls under the profiler per breakdown


def _breakdown_row(torch, fn) -> dict:
    """``infer``'s host ms (median, no profiler) and, under the profiler,
    the device's idle share and device ops per call."""
    from eegnetreplication_tpu_torch.utils import profiling

    row = {"host_ms": host_ms(fn)}
    prof = profiling.breakdown(fn, N_BREAKDOWN)
    row.update({k: prof[k] for k in (
        "wall_ms_per_call", "device_busy_ms_per_call", "device_idle_share",
        "device_ops_per_call")})
    return row


def _graph_phase(torch, np, dev) -> dict:
    """Every bucket of the fp32, int8 and nine-tenant engines: the
    replay's logits equal the eager forward's bit for bit and the plain CPU
    forward's to LOGITS_ATOL/RTOL; capture wall and pool bytes; ``infer``
    eager against graphed."""
    from eegnetreplication_tpu_torch.ops import quant
    from eegnetreplication_tpu_torch.ops import stacked as ops_stacked
    from eegnetreplication_tpu_torch.serve.engine import InferenceEngine
    from eegnetreplication_tpu_torch.serve.zoo import StackedEngine

    gpu = seeded_model(torch, 22, 257, 8, 2, 1500, dev)
    cpu = seeded_model(torch, 22, 257, 8, 2, 1500, "cpu")
    ids = [f"s{z}" for z in range(N_TENANTS)]
    gpu_zoo = [seeded_model(torch, 22, 257, 8, 2, 1510 + z, dev)
               for z in range(N_TENANTS)]
    cpu_zoo = [seeded_model(torch, 22, 257, 8, 2, 1510 + z, "cpu")
               for z in range(N_TENANTS)]
    cpu_int8 = InferenceEngine(cpu, device="cpu", precision="int8")
    cpu_stack = StackedEngine(list(zip(ids, cpu_zoo)), device="cpu")
    kinds = {
        "fp32": (InferenceEngine(gpu, BUCKETS, device=dev),
                 InferenceEngine(gpu, BUCKETS, device=dev),
                 lambda x, idx: cpu.eval()(x)),
        "int8": (InferenceEngine(gpu, BUCKETS, device=dev,
                                 precision="int8"),
                 InferenceEngine(gpu, BUCKETS, device=dev,
                                 precision="int8"),
                 lambda x, idx: quant.quantized_eval_forward_reference(
                     cpu_int8._qpack, x)),
        "zoo": (StackedEngine(list(zip(ids, gpu_zoo)), BUCKETS, device=dev),
                StackedEngine(list(zip(ids, gpu_zoo)), BUCKETS, device=dev),
                lambda x, idx: ops_stacked.stacked_eval_forward_reference(
                    cpu_stack._pack, x, idx)),
    }
    out: dict = {}
    for kind, (graphed, eager, plain) in kinds.items():
        t0 = time.perf_counter()
        graphed.warmup()            # the captures; `eager` is never warmed
        warm_s = time.perf_counter() - t0
        stats = graphed.graph_stats()
        check(sorted(stats) == list(BUCKETS),
              f"{kind}: graphs for buckets {sorted(stats)}")
        worst, rows = 0.0, {}
        for b in BUCKETS:
            x = trials(torch, b, 22, 257, 1600 + b)
            idx = torch.from_numpy(np.random.RandomState(b).randint(
                0, N_TENANTS, b).astype(np.int32))
            args = (x.to(dev),) if kind != "zoo" else (x.to(dev),
                                                       idx.to(dev))
            with torch.inference_mode():
                want = eager.forward(*args).cpu()
                ref = plain(x, idx)
            got = graphed.graph_logits(*args).cpu()
            check(torch.equal(got, want), f"{kind} B={b}: the replay's "
                  "logits differ from the eager forward's")
            err = float((got - ref).abs().max())
            check(torch.allclose(got, ref, atol=LOGITS_ATOL,
                                 rtol=LOGITS_RTOL),
                  f"{kind} B={b}: replay vs the plain CPU forward {err:.3e}")
            worst = max(worst, err)
            host = (x.numpy(),) if kind != "zoo" else (x.numpy(),
                                                       idx.numpy())
            check((graphed.infer(*host) == want.argmax(-1).numpy()).all(),
                  f"{kind} B={b}: graphed infer differs from the eager "
                  "argmax")
            if kind == "fp32" or b in (1, 128):
                rows[b] = {
                    "eager": _breakdown_row(torch,
                                            lambda: eager.infer(*host)),
                    "graphed": _breakdown_row(torch,
                                              lambda: graphed.infer(*host))}
                e, g = rows[b]["eager"], rows[b]["graphed"]
                log(f"{kind} B={b}: infer {e['host_ms']:.3f} -> "
                    f"{g['host_ms']:.3f} ms, device idle "
                    f"{e['device_idle_share']:.2f} -> "
                    f"{g['device_idle_share']:.2f}, device ops "
                    f"{e['device_ops_per_call']:.1f} -> "
                    f"{g['device_ops_per_call']:.1f} per call (eager -> "
                    "graphed)")
        out[kind] = {"max_abs_err_vs_plain": worst, "warmup_s": warm_s,
                     "graphs": {str(b): s for b, s in stats.items()},
                     "infer": {str(b): r for b, r in rows.items()}}
        log(f"{kind}: replay bitwise the eager forward at buckets "
            f"{list(BUCKETS)}, {worst:.3e} from the plain CPU forward; "
            "capture ms / pool MiB per bucket " + ", ".join(
                f"{b}: {s['capture_s'] * 1e3:.2f}/"
                f"{s['pool_bytes'] / 2**20:.1f}" for b, s in stats.items()))
    return out


def _get_text(url, headers=None, timeout=30.0) -> str:
    req = urllib.request.Request(url, headers=headers or {})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read().decode()


def _prom_value(text: str, series: str) -> float:
    for line in text.splitlines():
        if line.startswith(series + " "):
            return float(line.rsplit(" ", 1)[1])
    raise SmokeFailure(f"/metrics text has no series {series}")


def _tuned_server(torch, np, dev, work: Path, env: dict) -> dict:
    """``serve --tuneEveryS 1`` under TUNE_CLIENTS clients of steady
    TUNE_REQ_TRIALS-trial requests: a retune applied under load, no
    request dropped, every answer the predict path's, K1's launches the
    warm runs plus the replays; ``/metrics`` against ``/healthz``;
    ``/profile``'s trace names ``block1_kernel``."""
    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import save_trials
    from eegnetreplication_tpu_torch.obs.metrics import quantile_from_buckets
    from eegnetreplication_tpu_torch.predict import predict_trials
    from eegnetreplication_tpu_torch.serve.engine import (
        load_model_from_checkpoint,
    )

    ckpt = _save_seeded(torch, work / "tuned.npz", 1520)
    x = trials(torch, TUNE_CLIENTS * TUNE_REQ_TRIALS, 22, 257, 1521).numpy()
    y = np.random.RandomState(1522).randint(0, 4, len(x)).astype(np.int64)
    trials_path = save_trials(BCICI2ADataset(X=x, y=y),
                              work / "A01E-trials.npz")
    cli = _spawn_predict(["--checkpoint", str(ckpt), "--input",
                          str(trials_path)], env, work, "predict_tuned")
    want = predict_trials(load_model_from_checkpoint(ckpt, device=dev), x,
                          device=dev)
    obs = work / "obs_tuned"
    proc, url, stderr = _start_server(
        ["--checkpoint", str(ckpt), "--tuneEveryS", "1", "--metricsDir",
         str(obs)], work, env, "serve_tuned")
    result: dict = {}
    try:
        bodies = [_npz_body(np, x[i * TUNE_REQ_TRIALS:
                                  (i + 1) * TUNE_REQ_TRIALS])
                  for i in range(TUNE_CLIENTS)]
        stop = threading.Event()
        answers: list = [[] for _ in range(TUNE_CLIENTS)]
        host, port = url.split("//", 1)[1].rsplit(":", 1)

        def client(i):
            # One kept-alive connection a client, as a streaming client
            # holds it, and one request every TUNE_PERIOD_S: the steady
            # traffic that pads 40-trial forwards up to 128.
            conn = http.client.HTTPConnection(host, int(port), timeout=60)
            due = time.monotonic() + i * TUNE_PERIOD_S / TUNE_CLIENTS
            try:
                while not stop.is_set():
                    time.sleep(max(0.0, due - time.monotonic()))
                    due += TUNE_PERIOD_S
                    try:
                        conn.request("POST", "/predict", bodies[i], {
                            "Content-Type": "application/octet-stream"})
                        resp = conn.getresponse()
                        answers[i].append((resp.status,
                                           json.loads(resp.read())))
                    except Exception as exc:  # noqa: BLE001 — checked
                        answers[i].append((None, repr(exc)))
                        conn.close()
            finally:
                conn.close()

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(TUNE_CLIENTS)]
        batches_0 = _get(url + "/healthz")[1]["batches"]
        t0 = time.monotonic()
        for th in threads:
            th.start()
        first_retune = None
        try:
            while time.monotonic() - t0 < TUNE_MAX_S:
                time.sleep(0.25)
                # A retune that moved the ladder: its graphs were captured
                # while the clients' forwards replayed the old ones.
                ladder = _get(url + "/healthz")[1]["buckets"]
                if ladder != list(BUCKETS) and first_retune is None:
                    first_retune = time.monotonic()
                if first_retune and time.monotonic() - first_retune \
                        >= TUNE_AFTER_S:
                    break
        finally:
            stop.set()
            for th in threads:
                th.join(120)
        load_s = time.monotonic() - t0
        rate = (_get(url + "/healthz")[1]["batches"] - batches_0) / load_s
        stderr.flush()
        server_log = [line for line in (
            work / "serve_tuned.stderr.log").read_text().splitlines()
            if "log_message" not in line]
        check(first_retune is not None, "no ladder_retune moved the "
              f"ladder in {load_s:.0f} s of {TUNE_CLIENTS} clients' load "
              f"({rate:.1f} forwards/s); the server's log ends:\n"
              + "\n".join(server_log[-30:]))
        n_answers = 0
        for i, got in enumerate(answers):
            sl = want[i * TUNE_REQ_TRIALS:(i + 1) * TUNE_REQ_TRIALS]
            for status, reply in got:
                check(status == 200, f"client {i}: a request failed under "
                      f"the tuner: {status} {reply}")
                check(reply["predictions"] == sl.tolist(),
                      f"client {i}: an answer differs from predict_trials")
                n_answers += 1
        served = np.concatenate([np.asarray(got[-1][1]["predictions"])
                                 for got in answers])
        result["predict_cli"] = _check_predict_cli(
            np, cli, work, "predict_tuned", served, y, "predict")
        # /profile under a few requests: its trace names K1.
        status, prof = _post(url + "/profile", json.dumps(
            {"seconds": 1.5}).encode(), "application/json")
        check(status == 202, f"/profile answered {status}: {prof}")
        for _ in range(20):
            _post(url + "/predict", bodies[0], "application/octet-stream")
        trace_path = None
        for _ in range(120):
            time.sleep(0.25)
            found = list(Path(prof["log_dir"]).glob("trace-*.json"))
            if found and found[0].stat().st_size:
                trace_path = found[0]
                break
        check(trace_path is not None, "/profile wrote no trace")
        time.sleep(0.5)
        check("block1_kernel" in trace_path.read_text(),
              "/profile's trace does not name block1_kernel inside the "
              "graph replays")
        # The counts, /healthz against /metrics, with no traffic left.
        status, health = _get(url + "/healthz")
        check(status == 200 and health["status"] == "ok",
              f"/healthz {status}: {health.get('degraded')}")
        snap = json.loads(_get_text(url + "/metrics"))
        text = _get_text(url + "/metrics", {"Accept": "text/plain"})
        ok_json = next(e["value"] for e in snap["counters"]["requests_total"]
                       if e["labels"] == {"status": "ok"})
        check(ok_json == _prom_value(text, 'requests_total{status="ok"}')
              == n_answers + 20, f"requests_total ok {ok_json} vs "
              f"{n_answers + 20} answered")
        check(_prom_value(text, "ladder_retunes")
              == health["ladder_retunes"] >= 1,
              "ladder_retunes differs between /metrics and /healthz")
        lat = snap["histograms"]["request_latency_ms"][0]
        p50 = quantile_from_buckets(lat["bounds"], lat["buckets"], 0.5,
                                    lo=lat["min"], hi=lat["max"])
        check(abs(p50 - health["latency_ms"]["p50"]) < 1e-9,
              f"p50 {p50} from /metrics vs {health['latency_ms']['p50']}")
        launches = health["kernel_launches"]["block1"]
        replays, batches = health["graph_replays"], health["batches"]
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
        check(rc == 75, f"tuned server exited {rc} after SIGTERM")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        stderr.close()
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    events = _journal(np, obs, "ok")
    retunes = [e for e in events if e["event"] == "ladder_retune"]
    # A failed retune journals nothing (as the JAX tuner): it shows as
    # the tuner's warning in the server's log.
    failed = [line for line in (work / "serve_tuned.stderr.log").read_text(
        ).splitlines() if "Ladder tune pass failed" in line]
    compiles = [e for e in events if e["event"] == "compile"]
    check(retunes and not failed, f"{len(retunes)} ladder_retune, "
          f"{len(failed)} failed: {failed[:1]}")
    # One eager warm run a captured bucket, one launch a replay; each
    # forward is one chunk (the batcher's cap follows the top bucket).
    check(launches == len(compiles) + replays,
          f"K1 launches {launches} != {len(compiles)} warm runs + "
          f"{replays} replays")
    check(replays == batches, f"{replays} replays for {batches} forwards")
    graphs = {}
    for e in compiles:
        graphs.setdefault(e["what"], []).append(
            {"capture_s": e.get("capture_s"),
             "pool_bytes": e.get("pool_bytes")})
    result.update(
        load_s=load_s, forwards_per_s=rate,
        answers=n_answers, launches=launches, replays=replays,
        batches=batches, warm_runs=len(compiles),
        ladders=[r["new_buckets"] for r in retunes],
        reasons=[r["reason"] for r in retunes],
        final_buckets=health["buckets"], graphs=graphs,
        retune_s=[r["elapsed_s"] for r in retunes],
        trace_bytes=trace_path.stat().st_size)
    log(f"tuned server: {n_answers} requests of {TUNE_REQ_TRIALS} trials "
        f"from {TUNE_CLIENTS} clients in {load_s:.1f} s ({rate:.1f} "
        "forwards/s), none failed, every answer "
        f"predict_trials'; retunes {result['reasons']} -> "
        f"{result['ladders']}; K1 {launches} = {len(compiles)} warm runs + "
        f"{replays} replays; /metrics == /healthz; /profile trace names "
        "block1_kernel")
    return result


def _control_legs(torch, np, dev, work: Path) -> dict:
    """The breaker, admission, trace and SLO legs of the CPU tests, on the
    card, each through an in-process server and its own journal."""
    from eegnetreplication_tpu_torch.obs import journal as obs_journal
    from eegnetreplication_tpu_torch.obs import read_events
    from eegnetreplication_tpu_torch.resil import inject
    from eegnetreplication_tpu_torch.serve.service import ServeApp

    ckpt = _save_seeded(torch, work / "control.npz", 1530)
    x = trials(torch, 8, 22, 257, 1531).numpy()
    body = _npz_body(np, x)

    def post(app, headers=None):
        return _post(app.url + "/predict", body, "application/octet-stream",
                     headers=headers)

    def leg(name, **kw):
        kw.setdefault("buckets", (1, 8, 32))
        jr = obs_journal.run(work / f"obs_{name}", config={})
        journal = jr.__enter__()
        app = ServeApp(ckpt, port=0, device=dev, journal=journal,
                       **kw).start()
        return jr, journal, app

    def finish(jr, journal, app):
        app.stop()
        jr.__exit__(None, None, None)
        return read_events(journal.events_path)

    out = {}
    # Breaker: a retried fault answers; a persistent one opens the circuit
    # (fast 503s, /healthz 503), and it closes after the cooldown.
    jr, journal, app = leg("breaker", breaker_threshold=2,
                           breaker_reset_s=0.5)
    try:
        with inject.scoped(*inject.parse_plan("serve.forward:times=1")):
            check(post(app)[0] == 200, "a retried serve.forward fault "
                  "did not answer 200")
        handle = inject.arm("serve.forward", times=0)
        try:
            codes = [post(app)[0] for _ in range(2)]
            check(codes == [500, 500], f"persistent fault answered {codes}")
            status, health = _get_status(app.url + "/healthz")
            check(status == 503 and health["circuit"] == "open",
                  f"/healthz with the circuit open: {status}")
            t0 = time.perf_counter()
            status, reply = post(app)
            fast_ms = (time.perf_counter() - t0) * 1e3
            check(status == 503, f"open circuit answered {status}")
        finally:
            inject.disarm(handle)
        time.sleep(0.6)
        check(post(app)[0] == 200, "the half-open probe did not answer")
        check(_get(app.url + "/healthz")[1]["circuit"] == "closed",
              "the circuit did not close")
    finally:
        events = finish(jr, journal, app)
    states = [e["state"] for e in events if e["event"] == "circuit_state"]
    check(states == ["open", "half_open", "closed"], f"circuit {states}")
    out["breaker"] = {"fast_503_ms": fast_ms, "states": states}

    # Admission: slow forwards, 6 clients of 8 trials under the hard bound
    # of 64; the adaptive limit sheds bulk with 429.
    with inject.scoped(*inject.parse_plan(
            "serve.degrade:slow=0.05:times=0")):
        jr, journal, app = leg("admission", buckets=(1, 8),
                               max_queue_trials=64, admission_target_ms=1.0)
        codes: list = []
        try:
            stop = threading.Event()

            def client():
                while not stop.is_set():
                    status, reply = post(app)
                    codes.append((status, reply.get("shed")))

            threads = [threading.Thread(target=client) for _ in range(6)]
            for th in threads:
                th.start()
            time.sleep(3.0)
            stop.set()
            for th in threads:
                th.join(60)
            adm = _get_status(app.url + "/healthz")[1]["admission"]
        finally:
            events = finish(jr, journal, app)
    check((429, True) in codes and (200, None) in codes
          and set(codes) <= {(200, None), (429, True)},
          f"admission answers {sorted(set(codes), key=str)}")
    out["admission"] = {"shed": adm["shed"], "limit": adm["limit_trials"],
                        "answered": sum(c == 200 for c, _ in codes)}

    # Traces: the client's trace id kept, the spans parented.
    jr, journal, app = leg("trace", trace_sample=1.0)
    tid = "5eed" * 8
    try:
        check(post(app, {"X-Trace-Id": tid, "X-Parent-Span": "ab" * 8,
                         "X-Trace-Sampled": "1"})[0] == 200, "traced request")
    finally:
        events = finish(jr, journal, app)
    spans = {e["name"]: e for e in events
             if e["event"] == "span" and e["trace_id"] == tid}
    check({"replica.request", "http.parse", "queue.wait", "batch.forward",
           "engine.forward", "batch.scatter"} <= set(spans),
          f"spans {sorted(spans)}")
    check(spans["replica.request"]["parent_span_id"] == "ab" * 8
          and spans["engine.forward"]["parent_span_id"]
          == spans["batch.forward"]["span_id"], "span parents")
    out["trace"] = {"spans": sorted(spans)}

    # SLO: an objective no request meets degrades /healthz.
    jr, journal, app = leg("slo", slo_spec="p95_latency_ms<0.001",
                           slo_interval_s=0)
    try:
        check(post(app)[0] == 200, "SLO leg request")
        status, health = _get_status(app.url + "/healthz")
    finally:
        events = finish(jr, journal, app)
    check(status == 503 and health["degraded"] == [
        "slo:p95_latency_ms<0.001"], f"/healthz under the SLO: {status}")
    check(sum(e["event"] == "slo_breach" for e in events) == 1,
          "slo_breach not journaled once")
    out["slo"] = {"degraded": health["degraded"]}
    log(f"control legs on the card: breaker {states} (open circuit "
        f"answers in {fast_ms:.2f} ms), admission shed {adm['shed']} at "
        f"limit {adm['limit_trials']}, trace spans parented, SLO breach "
        "degrades /healthz")
    return out


def _get_status(url, timeout=30.0):
    """GET; ``(status, JSON reply)``, an HTTP error's too."""
    try:
        return _get(url, timeout)
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read().decode())


def phase_control(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 14: the serving control plane on the card."""
    t0 = time.perf_counter()
    result = {"graphs": _graph_phase(torch, np, dev),
              "tuned": _tuned_server(torch, np, dev, work, env),
              "legs": _control_legs(torch, np, dev, work)}
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 14 in {result['wall_s']:.1f} s")
    return result


# --------------------------------------------------------------------------
# Phase 15: online adaptation
# --------------------------------------------------------------------------

ADAPT_STEPS = 60          # the JAX defaults: --adaptSteps, batch 32,
ADAPT_TRIGGER = 16        # --adaptTriggerLabels, the 0.55 floor over
ADAPT_FLOOR = 0.55        # 12 shadow / 8 labeled evals
ADAPT_MIN_SHADOW = 12
ADAPT_MIN_LABELED = 8
LOGIT_ATOL, LOGIT_RTOL = 1e-5, 1e-4


def _candidate_logits(torch, np, dev, checkpoint: str, x) -> float:
    """The promoted candidate's logits on the card (K1) against its plain
    forward on the CPU; returns the largest difference."""
    from eegnetreplication_tpu_torch.serve.engine import (
        InferenceEngine,
        load_model_from_checkpoint,
    )

    card = InferenceEngine(load_model_from_checkpoint(checkpoint,
                                                      device=dev), (1,),
                           device=dev)
    cpu = load_model_from_checkpoint(checkpoint, device="cpu")
    with torch.inference_mode():
        got = card.forward(torch.from_numpy(x).to(dev)).cpu()
        want = cpu(torch.from_numpy(x))
    check(torch.allclose(got, want, atol=LOGIT_ATOL, rtol=LOGIT_RTOL),
          f"the candidate's card logits differ from its CPU forward by "
          f"{float((got - want).abs().max()):.3g}")
    check(torch.equal(got.argmax(-1), want.argmax(-1)),
          "the candidate's card argmax differs from its CPU forward")
    return float((got - want).abs().max())


def _repeat_fine_tune(torch, np, dev, work: Path, record: dict) -> dict:
    """Two card fine-tunes from the baseline checkpoint on the drifted
    windows the client labeled, one seed: bitwise equal candidates.  Their
    walls and steps/s."""
    from eegnetreplication_tpu_torch.adapt import (
        AdaptationWorker,
        ReplayBuffer,
    )
    from eegnetreplication_tpu_torch.utils import adapt_drill

    rec = record["recovery"]
    cue = adapt_drill.CueStream(22, 257, 7)
    x, y = adapt_drill.drifted_windows(cue, rec["promote_seen"],
                                       rec["drift_start"], device=dev)
    buf = ReplayBuffer()
    for k in range(rec["drift_start"], rec["promote_seen"]):
        buf.observe("adapted", "s", k, x[k])
        buf.label("adapted", "s", k, int(y[k]))
    runs = []
    for i in range(2):
        worker = AdaptationWorker(buf, work / f"repeat{i}",
                                  steps=ADAPT_STEPS, batch_size=32,
                                  seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cand = worker.fine_tune("adapted", work / "drill" / "baseline.npz")
        wall = time.perf_counter() - t0
        runs.append((cand, wall, cand.path.read_bytes()))
    (a, wall_a, bytes_a), (b, wall_b, bytes_b) = runs
    check(a.digest == b.digest and bytes_a == bytes_b,
          f"two card fine-tunes differ: {a.digest[:12]} vs {b.digest[:12]}")
    return {"digest": a.digest, "n_labeled": a.n_labeled,
            "wall_s": [wall_a, wall_b],
            "steps_per_s": [ADAPT_STEPS / wall_a, ADAPT_STEPS / wall_b],
            "loss": a.loss, "fit_accuracy": a.fit_accuracy}


def phase_adapt(torch, np, dev, work: Path, env: dict) -> dict:
    """Phase 15: online adaptation on the card (``utils/adapt_drill.py``):
    drift, labels, fine-tune, shadow, promotion, recovery, and a rollback
    under 8 ``/predict`` clients, at the product width."""
    from eegnetreplication_tpu_torch.utils import adapt_drill

    t0 = time.perf_counter()
    record = adapt_drill.run_drill(
        work / "drill", env, n_channels=22, window=257, F1=8, D=2,
        n_tenants=N_TENANTS, trigger_labels=ADAPT_TRIGGER,
        adapt_steps=ADAPT_STEPS, min_shadow=ADAPT_MIN_SHADOW,
        min_labeled=ADAPT_MIN_LABELED, accuracy_floor=ADAPT_FLOOR,
        probe_interval_s=0.2, device=dev)
    drill_s = time.perf_counter() - t0
    events = record["events"]
    base, rec = record["baseline"], record["recovery"]
    check(record["baseline_rc"] == record["adapt_rc"] == 75,
          f"servers exited {record['baseline_rc']}, {record['adapt_rc']} "
          "after SIGTERM")
    check(record["model"]["holdout_accuracy"] >= 0.7,
          f"the baseline learned the cue stream to only "
          f"{record['model']['holdout_accuracy']}")
    check(record["order"]["ordered"],
          f"journal order violated: {record['order']}")
    decisions = [e for e in events if e["event"] == "promotion"]
    refusals = [e for e in decisions if e["action"] == "refused"]
    steps = [e for e in decisions if e["action"] != "refused"]
    seen = [(e["action"], e.get("stage")) for e in decisions]
    check([(e["action"], e.get("stage")) for e in steps]
          == [("error", "reload"), ("promote", None), ("rollback", None)],
          f"promotion events: {seen}")
    err, prom, roll = steps
    i_err, i_prom = events.index(err), events.index(prom)
    swaps = [e for e in events[i_err:i_prom] if e["event"] == "model_swap"]
    check(len(swaps) == 1 and swaps[0]["previous_digest"]
          == record["prior_digest"] == prom["previous_digest"],
          "the failed promotion (adapt.promote) did not leave the prior "
          f"digest serving: {swaps}")
    check(roll["digest"] == record["prior_digest"]
          == record["counts_end"]["digest"],
          "the rollback did not restore the prior digest")
    rb = record["rollback"]
    check(rb["status"] == 200 and rb["failed"] == 0,
          f"rollback under load: {rb['status']}, {rb['failed']} of "
          f"{rb['requests']} requests failed")
    check(rec["failed"] == 0 and base["failed"] == 0,
          f"{rec['failed']} + {base['failed']} session pushes, windows or "
          "labels failed")
    pre, drifted = rec["pre_drift_accuracy"], rec["drifted_accuracy"]
    recovered = rec["recovered_accuracy"]
    log(f"accuracy: pre-drift {pre}, drifted {drifted}, after promotion "
        f"{recovered}; no-adaptation control {base['drifted_accuracy']}")
    check(drifted < pre, f"the drift cost no accuracy ({pre} -> {drifted})")
    check(recovered is not None and recovered > drifted,
          f"no recovery: drifted {drifted}, after promotion {recovered}")
    # Probes: ok while the model they pinned serves; outside
    # requests_total.
    probes = [e for e in events if e["event"] == "probe"]
    lo, hi = swaps[0]["t"] - 1.0, roll["t"] + 1.0
    check(probes and all(e["status"] == "ok" for e in probes
                         if not lo <= e["t"] <= hi)
          and {e["status"] for e in probes} <= {"ok", "mismatch"},
          f"probe statuses: {sorted({e['status'] for e in probes})}")
    end = next(e for e in events if e["event"] == "serve_end")
    n_user = len(record["predict_records"]) + rb["requests"]
    check(end["n_requests"] == n_user and end["probes"] == len(probes),
          f"serve_end counts {end['n_requests']} requests and "
          f"{end['probes']} probes; sent {n_user} and {len(probes)}")
    counters = record["metrics"]["counters"]
    check(sum(e["value"] for e in counters["requests_total"])
          <= n_user, "probes reached requests_total")
    launches = adapt_drill.expected_launches(record)
    check(launches["got"] == launches["want"],
          f"launch counts: got {launches['got']}, want {launches['want']}")
    # The promoted candidate on the card against its CPU forward, and two
    # card fine-tunes.
    cue = adapt_drill.CueStream(22, 257, 7)
    x, _ = adapt_drill.drifted_windows(cue, 32, 8, device=dev)
    max_err = _candidate_logits(torch, np, dev, prom["checkpoint"], x)
    repeat = _repeat_fine_tune(torch, np, dev, work, record)
    cand = next(e for e in events if e["event"] == "adaptation_candidate")
    shadow_compile = [e for e in events if e["event"] == "compile"
                      and e["what"] == "serve_forward_b1"]
    swap = swaps[0]
    result = {
        "drill_s": drill_s,
        "model": record["model"],
        "accuracy": {"pre_drift": pre, "drifted": drifted,
                     "recovered": recovered,
                     "no_adaptation_control": base["drifted_accuracy"]},
        "windows": {"baseline": base["windows_decided"],
                    "adapt": rec["windows_decided"],
                    "drift_start": rec["drift_start"],
                    "promote_seen": rec["promote_seen"],
                    "labels": rec["labels_posted"]},
        "refusals": len(refusals),
        "fine_tune_server": {"elapsed_s": cand["elapsed_s"],
                             "steps": cand["steps"],
                             "steps_per_s": cand["steps"]
                             / cand["elapsed_s"],
                             "n_labeled": cand["n_labeled"],
                             "fit_accuracy": cand["fit_accuracy"]},
        "fine_tune_repeat": repeat,
        "shadow_capture_s": [e.get("capture_s") for e in shadow_compile],
        "shadow_compile_s": [e["elapsed_s"] for e in shadow_compile],
        "adapt_warmup_s": next(e for e in events
                               if e["event"] == "serve_start"
                               )["adapt_warmup_s"],
        "promotion_s": prom["elapsed_s"],
        "promotion_reload_s": swap["elapsed_s"],
        "rollback": {k: rb[k] for k in ("status", "wall_s", "requests",
                                        "failed")},
        "latency": record["latency"],
        "launches": launches,
        "probes": {"n": len(probes),
                   "statuses": sorted({e["status"] for e in probes})},
        "candidate_max_abs_err": max_err,
    }
    result["wall_s"] = time.perf_counter() - t0
    log(f"phase 15 in {result['wall_s']:.1f} s: fine-tune "
        f"{cand['elapsed_s']} s in the server, repeat "
        f"{repeat['wall_s'][0]:.3f}/{repeat['wall_s'][1]:.3f} s; shadow "
        f"capture {result['shadow_capture_s']}; promotion reload "
        f"{swap['elapsed_s']} s; latency {record['latency']}")
    return result


def _mfu_fields(row: dict) -> dict:
    """GFLOP/s and MFU of a fold-epochs/s row at the product width, from
    the port's FLOP count (``utils/flops.py``) and the card's FP32 peak."""
    from types import SimpleNamespace

    import torch

    from eegnetreplication_tpu_torch.config import DEFAULT_TRAINING
    from eegnetreplication_tpu_torch.utils import flops

    model = SimpleNamespace(n_channels=22, n_times=257, F1=8, D=2,
                            n_classes=4)
    batch = DEFAULT_TRAINING.batch_size
    per_fe = (row["train_steps"] * flops.train_step_flops(model, batch)
              + row["val_steps"] * flops.eval_step_flops(model, batch))
    rate = row["fold_epochs_per_s"] * per_fe
    peak, label = flops.assumed_peak_flops(torch.cuda.get_device_name(0))
    return {"fold_epoch_gflop": per_fe / 1e9, "gflops_per_s": rate / 1e9,
            "mfu": None if peak is None else rate / peak, "peak": label}


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

    env = dict(os.environ, PYTHONUNBUFFERED="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    from eegnetreplication_tpu_torch.utils.device import select_device

    t_start = time.perf_counter()
    try:
        card = phase_device(torch)
        dev = select_device()
        build_s = phase_build()
        k1_err = phase_k1(torch, dev)
        k1s_err = phase_k1_stacked(torch, dev)
        fwd_err = phase_forward(torch, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            serve = phase_serve(torch, np, dev, Path(tmp), env)
        timer_floor = phase_timer_floor(torch, dev)
        times = phase_times(torch, np, dev)
        k1s_times = phase_k1_stacked_times(torch, dev)
        k2_err, k2_vs_methods = phase_k2(torch, np, dev)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
            dataset = phase_dataset(torch, np, dev, Path(tmp), env)
            k2_times = phase_k2_times(torch, np, dev,
                                      Path(dataset["raw_session"]), Path(tmp))
            train = phase_train(torch, np, dev, Path(tmp) / "train", env,
                                Path(tmp) / "cli")
            cs = phase_cross_subject(torch, np, dev, Path(tmp) / "cs", env,
                                     Path(tmp) / "cli")
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
            zoo = phase_serving_zoo(torch, np, dev, Path(tmp), env)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_streams_") \
                as tmp:
            streams = phase_streams(torch, np, dev, Path(tmp), env)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_control_") \
                as tmp:
            control = phase_control(torch, np, dev, Path(tmp), env)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_adapt_") as tmp:
            adapt = phase_adapt(torch, np, dev, Path(tmp), env)
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
        # the serve phase's server, the int8 server of phase 12, the
        # tuned server of phase 14 (graph replays counted per replay) and
        # the adapting server of phase 15 (the shadow's replays, the stack
        # gates' references)
        "launches": (serve["launches"] + zoo["int8"]["k1_launches"]
                     + control["tuned"]["launches"]
                     + adapt["launches"]["got"]["block1"]),
        "max_abs_err": k1_err,
        "ms": top["ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
    }, {
        "name": "block1_stacked",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/block1_stacked.cu",
        "replaces": "eegnetreplication_tpu/ops/fused_eegnet.py:134",
        # the counted runs of the training phases (10 and 11), the zoo
        # server's counted chunks (phase 12) and the adapting server of
        # phase 15 (its chunks, fit accuracies and restacks)
        "launches": (train["launches"] + cs["launches_one_group"]
                     + cs["launches_groups"]
                     + zoo["zoo"]["k1_stacked_launches"]
                     + adapt["launches"]["got"]["block1_stacked"]),
        "max_abs_err": k1s_err,
        # at the 90-fold cross-subject validation batch, (5760, 22, 257)
        "ms": k1s_times[5760]["ms"],
        "plain_ms": k1s_times[5760]["plain_ms"],
        "bound_ms": k1s_times[5760]["bound_ms"],
        "bound_by": k1s_times[5760]["bound_by"],
        "library_ms": k1s_times[5760]["library_ms"],
        # at the zoo's 128-trial chunk mixed over nine tenants
        "zoo_chunk": {k: zoo["k1_stacked_zoo_chunk"][k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
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
    }, {
        "name": "ems_stream",
        "route": "cuda",
        "source": "eegnetreplication_tpu_torch/ops/csrc/ems_stream.cu",
        "replaces": ("eegnetreplication_tpu/ops/ems.py:244 (_stream_chunk, "
                     "lax.scan, not Pallas)"),
        # the three session servers of phase 13 and the drifting
        # session of phase 15
        "launches": (streams["launches"]
                     + adapt["launches"]["got"]["ems_stream"]),
        "max_abs_err": streams["k2s"]["max_abs_err"],
        # at a push of 25 samples, (22, 25)
        **{k: streams["times"]["by_n"][STREAM_CHUNK][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None,   # no single PyTorch call computes the carry
        "chain_ms": streams["times"]["by_n"][STREAM_CHUNK]["chain_ms"],
        "by_n": {str(n): {k: row[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "chain_ms")}
            for n, row in streams["times"]["by_n"].items()},
    }]}
    record = {
        "card": card, "build_s": build_s, "k1_max_abs_err": k1_err,
        "forward_max_abs_err": fwd_err, "serve": serve,
        "timer_floor": timer_floor,
        "times_by_bucket": times, "k2_max_abs_err": k2_err,
        "k2_vs_methods_max_abs_err": k2_vs_methods, "dataset": dataset,
        "k2_times": k2_times, "k1_stacked_max_abs_err": k1s_err,
        "k1_stacked_times": k1s_times, "train": train, "cross_subject": cs,
        "serving_zoo": zoo, "streams": streams, "control": control,
        "adapt": adapt,
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
