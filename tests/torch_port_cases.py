"""Shared inputs for the torch port's parity tests (``test_torch_*.py``).

Every input is drawn with numpy from a seed and handed to both packages:
the JAX package's EEGNet variables (flax names and layouts, numpy leaves)
and the same weights carried into the port's ``EEGNet`` through
``training/checkpoint.py::from_jax_variables``.  The tree is drawn directly
rather than through ``model.init`` (which compiles): ``test_torch_model``
pins that it has exactly the structure and shapes ``model.init`` makes.

Importing this module caps torch's intra-op threads at one per process.
The tier-1 run puts six test workers on eight cores, and a full thread pool
in each port worker slows every other worker; the port's tests run at a
small size, where one thread costs them little.  Every
``tests/test_torch_*.py`` imports this module, and the CLI processes they
start get ``OMP_NUM_THREADS=1`` (:func:`child_env`).  The JAX package is
imported only where a case needs it, so ``test_torch_gpu.py`` can import
this module on the card's machine, which has no JAX.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.training.checkpoint import from_jax_variables

torch.set_num_threads(1)


def child_env(base=None, **extra) -> dict:
    """The environment of a CLI process a port test starts: ``base``
    (default ``os.environ``) with one OpenMP thread and ``extra``."""
    env = dict(os.environ if base is None else base)
    env.update(OMP_NUM_THREADS="1", **extra)
    return env

# (C, T, F1, D): the product width, an even T, the wide width, a small one.
PRODUCT = (22, 257, 8, 2)
GEOMETRIES = {
    "product": PRODUCT,
    "t256": (22, 256, 8, 2),
    "wide": (22, 257, 16, 4),
    "small": (8, 64, 8, 2),
}
N_CLASSES = 4


def jax_model(c, t, f1, d):
    from eegnetreplication_tpu.models import EEGNet as JaxEEGNet

    return JaxEEGNet(n_channels=c, n_times=t, F1=f1, D=d)


def jax_variables(c, t, f1, d, *, seed=0, perturb_bn=True):
    """``(params, batch_stats)`` of the JAX EEGNet with numpy leaves.

    Kernels and the classifier bias ~ U(+-1/sqrt(fan_in)) (the model's own
    init); BatchNorm at identity, or with ``perturb_bn`` moved off it so
    every folding path is exercised.
    """
    rng = np.random.RandomState(seed)
    f2 = f1 * d
    fan_in_cls = f2 * (t // 32)

    def uniform(shape, fan_in):
        bound = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    def bn(n):
        if not perturb_bn:
            return ({"scale": np.ones(n, np.float32),
                     "bias": np.zeros(n, np.float32)},
                    {"mean": np.zeros(n, np.float32),
                     "var": np.ones(n, np.float32)})
        return ({"scale": (0.8 + 0.4 * rng.rand(n)).astype(np.float32),
                 "bias": (0.2 * rng.randn(n)).astype(np.float32)},
                {"mean": (0.3 * rng.randn(n)).astype(np.float32),
                 "var": (0.5 + rng.rand(n)).astype(np.float32)})

    params, batch_stats = {}, {}
    params["temporal_conv"] = {"kernel": uniform((1, 32, 1, f1), 32)}
    params["temporal_bn"], batch_stats["temporal_bn"] = bn(f1)
    params["spatial_conv"] = {"kernel": uniform((c, 1, 1, f2), c)}
    params["spatial_bn"], batch_stats["spatial_bn"] = bn(f2)
    params["separable_depthwise"] = {"kernel": uniform((1, 16, 1, f2), 16)}
    params["separable_pointwise"] = {"kernel": uniform((1, 1, f2, f2), f2)}
    params["block2_bn"], batch_stats["block2_bn"] = bn(f2)
    params["classifier"] = {
        "kernel": uniform((fan_in_cls, N_CLASSES), fan_in_cls),
        "bias": uniform((N_CLASSES,), fan_in_cls)}
    return params, batch_stats


def port_model(params, batch_stats, c, t, f1, d) -> EEGNet:
    """The port's eval-mode EEGNet on the CPU with the JAX weights."""
    model = EEGNet(c, t, F1=f1, D=d, device="cpu")
    model.load_state_dict(from_jax_variables(params, batch_stats))
    return model


def trials(n, c, t, seed=1) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, c, t).astype(np.float32)


# --- The model layer: ShallowConvNet and DeepConvNet ------------------------

# name -> (C, T) of the small parity sizes: Shallow needs T >= 47, Deep's
# four blocks need T >= ~80.
BASELINES = {"shallow_convnet": (6, 60), "deep_convnet": (6, 96)}


@functools.lru_cache(maxsize=None)
def _jax_baseline_init(name, c, t, dropout_rate):
    """A JAX baseline and its jitted ``init`` (one compile per geometry)."""
    import jax

    from eegnetreplication_tpu.models import get_model as jax_get_model

    model = jax_get_model(name, n_channels=c, n_times=t,
                          dropout_rate=dropout_rate)
    return model, jax.jit(model.init)


def jax_baseline(name, c, t, *, seed=0, dropout_rate=0.0, perturb_bn=True):
    """``(model, params, batch_stats)`` of a JAX baseline, its variables
    from ``model.init`` as numpy, BatchNorm moved off the identity with
    ``perturb_bn``."""
    import jax
    import jax.numpy as jnp

    model, init = _jax_baseline_init(name, c, t, dropout_rate)
    variables = init(jax.random.PRNGKey(seed), jnp.zeros((1, c, t)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    if perturb_bn:
        rng = np.random.RandomState(seed + 100)
        for layer, bn in stats.items():
            n = bn["mean"].shape[0]
            params[layer] = {
                "scale": (0.8 + 0.4 * rng.rand(n)).astype(np.float32),
                "bias": (0.2 * rng.randn(n)).astype(np.float32)}
            stats[layer] = {"mean": (0.3 * rng.randn(n)).astype(np.float32),
                            "var": (0.5 + rng.rand(n)).astype(np.float32)}
    return model, params, stats


def port_baseline(name, params, batch_stats, c, t, **kw):
    """The port's model of registry ``name`` on the CPU with the JAX
    weights."""
    from eegnetreplication_tpu_torch.models import get_model

    model = get_model(name, n_channels=c, n_times=t, device="cpu", **kw)
    model.load_state_dict(from_jax_variables(params, batch_stats))
    return model


def labelled_pool(n, c, t, seed=0):
    """A pool of ``n`` trials in which each of the 4 classes adds its own
    rhythm: ``(x, y)``."""
    rng = np.random.RandomState(seed)
    y = rng.randint(0, N_CLASSES, n)
    x = (0.7 * rng.randn(n, c, t)).astype(np.float32)
    tt = np.arange(t) / 64.0
    for k in range(N_CLASSES):
        x[y == k] += np.sin(2 * np.pi * (4 + 4 * k) * tt).astype(np.float32)
    return x, y


# --- Preprocessing slice ---------------------------------------------------

# EMS inputs of tests/test_ems.py: name -> (shape, kwargs, seed, constant).
EMS_CASES = {
    "signal_4x3000": ((4, 3000), {}, 0, None),
    "ragged_3x700": ((3, 700), {}, 7, None),
    "single_1x500_init100": ((1, 500), {"init_block_size": 100}, 2, None),
    "short_2x50_init_past_T": ((2, 50), {}, 3, None),
    "constant_3x400": ((3, 400), {"init_block_size": 100}, 0, 5.0),
}


def ems_input(name) -> tuple[np.ndarray, dict]:
    """``(x, kwargs)`` of one EMS case, drawn with numpy from its seed."""
    shape, kwargs, seed, constant = EMS_CASES[name]
    if constant is not None:
        return np.full(shape, constant, np.float32), dict(kwargs)
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if name == "signal_4x3000":
        x = x * 5.0 + 2.0
    return x.astype(np.float32), dict(kwargs)


def numpy_ems_reference(x, factor_new=1e-3, init_block_size=1000,
                        eps=1e-10):
    """Sequential float64 evaluation of the EMS recurrences (the ground
    truth of tests/test_ems.py)."""
    x = np.asarray(x, dtype=np.float64)
    out = np.zeros_like(x)
    mean = np.mean(x[..., :init_block_size], axis=-1)
    var = np.var(x[..., :init_block_size], axis=-1)
    a = factor_new
    for t in range(x.shape[-1]):
        mean = (1 - a) * mean + a * x[..., t]
        var = (1 - a) * var + a * (x[..., t] - mean) ** 2
        out[..., t] = (x[..., t] - mean) / np.sqrt(var + eps)
    return out


def write_raw_tree(write_gdf, raw, subjects=(1, 4), seconds=40,
                   n_trials=8, seed=0):
    """The small synthetic competition tree of tests/test_data_pipeline.py
    under ``raw``, written with the given package's ``write_gdf``:
    25-channel 250 Hz sessions, cues 769-772 in Train and 783 in Eval, and
    ``TrueLabels/A0sE.mat``."""
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    sfreq = 250.0
    n = int(sfreq * seconds)
    for s in subjects:
        for mode in ("Train", "Eval"):
            sig = rng.uniform(-0.5, 0.5, (25, n)).astype(np.float32)
            pos = (np.arange(n_trials) * 1100 + 300).astype(np.int64)
            if mode == "Train":
                typ = np.array([769, 770, 771, 772] * (n_trials // 4))
            else:
                typ = np.full(n_trials, 783)
            sess = "T" if mode == "Train" else "E"
            write_gdf(raw / mode / f"A{s:02d}{sess}.gdf", sig, sfreq,
                      event_pos=pos, event_typ=typ)
            if mode == "Eval":
                tl = raw / "TrueLabels"
                tl.mkdir(parents=True, exist_ok=True)
                savemat(tl / f"A{s:02d}E.mat",
                        {"classlabel": rng.randint(1, 5, n_trials)})


MOABB_CLASSES = ("left_hand", "right_hand", "feet", "tongue")


def write_moabb_tree(write_fake_fif, moabb_dir, *, subject=1, runs=2,
                     cues=4, seconds=40.0, seed=0) -> dict:
    """The run layout ``fetch --src moabb`` writes for BNCI2014-001 under
    ``moabb_dir``: ``{Train,Eval}/A0sT_run_k.fif`` (``.npz`` payloads of
    ``tests/fake_mne.py`` under ``.fif`` names), each run 22 EEG and 3 EOG
    channels at 250 Hz in volts, its cues 8 s apart from 3 s on, named by
    class as moabb names them, beside one unlabelled ``break`` mark.
    Returns each session's labels (0..3) in run order."""
    from pathlib import Path

    from eegnetreplication_tpu_torch.config import (
        EEG_CHANNEL_NAMES,
        EOG_CHANNEL_NAMES,
    )

    sfreq = 250.0
    n = int(seconds * sfreq)
    t = np.arange(n) / sfreq
    names = list(EEG_CHANNEL_NAMES + EOG_CHANNEL_NAMES)
    types = ["eeg"] * 22 + ["eog"] * 3
    labels = {}
    for mode in ("Train", "Eval"):
        stem = f"A{subject:02d}{mode[0]}"
        classes = []
        for k in range(runs):
            rng = np.random.RandomState(seed + 100 * k + (mode == "Eval"))
            cls = rng.permutation(np.arange(cues) % 4)
            f = rng.uniform(6.0, 30.0, (25, 1))
            x = (20.0 * np.sin(2 * np.pi * f * t + rng.uniform(0, 6, (25, 1)))
                 + 5.0 * rng.randn(25, n) + 10.0) * 1e-6
            onsets = [1.0] + [3.0 + 8.0 * j for j in range(cues)]
            descs = ["break"] + [MOABB_CLASSES[c] for c in cls]
            out = Path(moabb_dir) / mode / f"{stem}_run_{k}.fif"
            out.parent.mkdir(parents=True, exist_ok=True)
            write_fake_fif(out, x, sfreq, names, onsets, descs,
                           ch_types=types)
            classes.append(cls)
        labels[stem] = np.concatenate(classes).astype(np.int64)
    return labels


def recording_with_nan(c=25, t=5000, seed=5) -> tuple[np.ndarray, np.ndarray,
                                                       np.ndarray]:
    """``(signals, event_pos, event_typ)`` of a 250 Hz recording with a NaN
    span, like the competition's artifact marks."""
    rng = np.random.RandomState(seed)
    sig = (rng.randn(c, t) * 10.0 + 3.0).astype(np.float32)
    sig[2, 1000:1200] = np.nan
    pos = np.array([300, 1301, 2602, 3903], np.int64)
    typ = np.array([769, 770, 771, 772], np.int64)
    return sig, pos, typ


def write_processed_tree(root, subjects=(1, 2), n_trials=24, nan_in=None,
                         n_channels=4, n_times=64):
    """``-trials.npz`` files of ``tests/synthetic.py``'s separable subjects
    (C=4, T=64 by default) under ``<root>/data/processed/{Train,Eval}``,
    what the train CLI reads with ``EEGTPU_DATA_ROOT=<root>``; ``nan_in=s``
    puts a NaN in four of subject ``s``'s Train trials (from the middle
    on)."""
    from pathlib import Path

    from synthetic import make_loader

    from eegnetreplication_tpu_torch.data.containers import BCICI2ADataset
    from eegnetreplication_tpu_torch.data.io import (
        save_trials,
        trials_filename,
    )

    loader = make_loader(n_trials=n_trials, n_channels=n_channels,
                         n_times=n_times, class_sep=1.5)
    for s in subjects:
        for mode in ("Train", "Eval"):
            ds = loader(s, mode)
            x = ds.X.copy()
            if s == nan_in and mode == "Train":
                x[len(x) // 2:len(x) // 2 + 4, 0, 0] = np.nan
            save_trials(BCICI2ADataset(X=x, y=ds.y),
                        Path(root) / "data" / "processed" / mode
                        / trials_filename(s, mode))


def train_over_a_mesh(argv, root) -> None:
    """The train CLI in a child process (its launcher forks the ranks) on
    a one-subject tree under ``root``: it must exit 0 and write the
    subject's models."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(root)
    write_processed_tree(root, subjects=(1,))
    env = child_env({k: v for k, v in os.environ.items()
                     if k != "PYTHONPATH"})
    env.update(EEGTPU_PLATFORM="cpu", EEGTPU_DATA_ROOT=str(root),
               EEGTPU_NO_LOG_FILE="1",
               PYTHONPATH=str(Path(__file__).resolve().parents[1]))
    out = subprocess.run(
        [sys.executable, "-m", "eegnetreplication_tpu_torch.train", *argv,
         "--epochs", "1", "--subjects", "1"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    for suffix in (".npz", ".pth"):
        assert (root / "models" / f"subject_01_best_model{suffix}"
                ).is_file()


# ---------------------------------------------------------------------------
# The replica fleet: a scripted replica, a fake clock, and both packages'
# fleet modules side by side, for the twin runs of tests/test_torch_fleet.py,
# test_torch_gray.py and test_torch_autoscale.py.


class FakeReplica:
    """A scriptable serving-replica double: ``/healthz``, ``/predict``,
    ``/reload`` and the ``/session/*`` routes a fleet forwards.

    A copy of ``tests/test_fleet.py``'s double (with the session routes
    added), so the port's tests do not import a JAX test module.  Its
    knobs are plain attributes, changed mid-test to degrade, slow, break
    or kill (``stop()``) the replica.  It speaks HTTP/1.0 (one connection
    per request), so a stopped double looks dead, as a SIGKILLed process
    does.
    """

    def __init__(self, digest: str = "d-old", port: int = 0):
        import json
        import threading
        import time
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.digest = digest
        self.healthz_digest = None           # override what /healthz shows
        self.precision = "fp32"
        self.buckets = (1, 8, 32)
        self.queue_depth = 0
        self.degraded: list[str] = []        # non-empty -> healthz 503
        self.predict_status = 200
        self.predict_delay = 0.0             # gray knob: slow, not dead
        self.predictions = [0, 1, 2]
        self.reload_fn = lambda ck: (200, "d-new")
        self.slo_breached: list[str] = []
        self.zoo = None
        self.log: list[tuple[str, bytes]] = []
        self.headers_log: list[dict] = []
        self.sessions: dict[str, int] = {}
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):  # noqa: A003 — quiet
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                if self.path == "/healthz":
                    self._reply(503 if fake.degraded else 200, {
                        "status": "degraded" if fake.degraded else "ok",
                        "degraded": fake.degraded,
                        "variables_digest": (fake.healthz_digest
                                             or fake.digest),
                        "precision": fake.precision,
                        "buckets": list(fake.buckets),
                        "slo": {"breached": list(fake.slo_breached)},
                        "zoo": fake.zoo,
                        "queue_depth_requests": fake.queue_depth,
                        "queue_depth_trials": fake.queue_depth})
                    return
                parts = self.path.strip("/").split("/")
                if len(parts) == 3 and parts[0] == "session":
                    if parts[1] not in fake.sessions:
                        self._reply(404, {"error": "unknown session"})
                        return
                    self._reply(200, {"session": parts[1],
                                      "pushes": fake.sessions[parts[1]]})
                    return
                self._reply(404, {})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n) if n else b""
                fake.log.append((self.path, body))
                if self.path == "/predict":
                    fake.headers_log.append(dict(self.headers.items()))
                    if fake.predict_delay:
                        time.sleep(fake.predict_delay)
                    if fake.predict_status != 200:
                        self._reply(fake.predict_status,
                                    {"error": "scripted"})
                        return
                    self._reply(200, {"predictions": fake.predictions,
                                      "n": len(fake.predictions),
                                      "model_digest": fake.digest})
                    return
                if self.path == "/reload":
                    ck = json.loads(body.decode()).get("checkpoint")
                    status, result = fake.reload_fn(ck)
                    if status == 200:
                        fake.digest = result
                        self._reply(200, {"status": "ok",
                                          "model_digest": result})
                    else:
                        self._reply(status, {"error": result})
                    return
                parts = self.path.strip("/").split("/")
                if parts[0] == "session":
                    self._session(parts, body)
                    return
                self._reply(404, {})

            def _session(self, parts, body):
                if parts[1] in ("open", "import"):
                    sid = json.loads(body.decode() or "{}").get("session")
                    if sid in fake.sessions:
                        self._reply(409, {"error": "session exists"})
                        return
                    fake.sessions[sid] = 0
                    self._reply(200, {"session": sid})
                    return
                sid = parts[1]
                if sid not in fake.sessions:
                    self._reply(404, {"error": "unknown session"})
                    return
                if parts[2] in ("close", "discard"):
                    pushes = fake.sessions.pop(sid)
                    self._reply(200, {"session": sid, "pushes": pushes})
                    return
                fake.sessions[sid] += 1
                self._reply(200, {"session": sid,
                                  "pushes": fake.sessions[sid]})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    def predict_count(self) -> int:
        return sum(1 for path, _ in self.log if path == "/predict")

    def reload_checkpoints(self) -> list[str]:
        import json

        return [json.loads(body.decode()).get("checkpoint")
                for path, body in self.log if path == "/reload"]

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


class FakeClock:
    """A monotonic clock a test moves by hand (``t``, or ``sleep(s)``)."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, seconds: float) -> None:
        self.t += seconds


def fleet_packages() -> dict:
    """``{"jax": ns, "port": ns}``: each package's fleet modules and the
    obs, resilience and serve modules they stand on, under the same names,
    so one scenario runs unchanged against either package."""
    import importlib
    from types import SimpleNamespace

    names = {
        "journal": "obs.journal", "schema": "obs.schema",
        "trace": "obs.trace", "inject": "resil.inject",
        "breaker": "resil.breaker", "supervise": "resil.supervise",
        "admission": "serve.admission", "service": "serve.service",
        "ms": "serve.fleet.membership", "router": "serve.fleet.router",
        "outlier": "serve.fleet.outlier", "canary": "serve.fleet.canary",
        "autoscaler": "serve.fleet.autoscaler",
        "fleet": "serve.fleet.service",
    }
    out = {}
    for key, root in (("jax", "eegnetreplication_tpu"),
                      ("port", "eegnetreplication_tpu_torch")):
        out[key] = SimpleNamespace(name=key, **{
            attr: importlib.import_module(f"{root}.{mod}")
            for attr, mod in names.items()})
    return out


# Fields of a journal event that vary from run to run (clocks, process
# ids, ports, ids drawn at random): a twin run compares everything else.
VOLATILE_FIELDS = frozenset({
    "t", "run_id", "wall_s", "latency_ms", "delay_ms", "hedge_wait_ms",
    "pid", "url", "host", "port", "waited_s", "joining_s", "age_s",
    "dur_ms", "start", "span_id", "trace_id", "parent_span_id", "p95_ms",
    "fleet_p50_ms", "threshold_ms", "elapsed_s", "cmd", "replicas",
    "git_sha", "config", "platform", "device_kind", "n_devices",
    "schema_version", "mesh_shape",
})


def journal_sequence(events: list[dict], kinds: tuple[str, ...] | None
                     = None, volatile=VOLATILE_FIELDS) -> list[tuple]:
    """A journal as ``(event, sorted keys, stable fields)`` tuples: the
    event names in order, each event's key set, and the values of the
    fields that do not vary between runs (``volatile`` excluded).
    ``kinds`` keeps only those events.  A duration printed into a reason
    (``heartbeat_stale:serve_idle:3600.0s``) reads as ``<s>``."""
    import re

    out = []
    for e in events:
        if kinds is not None and e["event"] not in kinds:
            continue
        stable = tuple(sorted(
            (k, re.sub(r"\d+\.\d+s\b", "<s>", v) if k == "reason"
             and isinstance(v, str) else repr(v))
            for k, v in e.items() if k not in volatile))
        out.append((e["event"], tuple(sorted(e)), stable))
    return out


def journal_views(sequence: list[tuple],
                  member_keys=("replica", "child")) -> dict:
    """The order-stable views of a :func:`journal_sequence`: one member's
    events in order (a membership poll asks every replica or cell at once,
    so the events of two members in one poll interleave by chance), the
    other events in order, and the whole sequence as a multiset.  An
    event's member is the first of ``member_keys`` it carries."""
    from collections import Counter

    per_member: dict[str, list[tuple]] = {}
    rest = []
    for item in sequence:
        fields = dict(item[2])
        member = next((fields[k] for k in member_keys if fields.get(k)),
                      None)
        if member is None:
            rest.append(item)
        else:
            per_member.setdefault(member, []).append(item)
    return {"members": per_member, "rest": rest,
            "all": Counter(sequence)}


# ---------------------------------------------------------------------------
# The cell tier: a scripted cell, a real session state, and both packages'
# cell modules, for the twin runs of tests/test_torch_cells.py and
# tests/test_torch_ha.py.


def session_state(sid: str = "s1", acked: int = 160) -> dict:
    """A small but real session state (the export wire format is built
    from exactly this): the port's ``StreamSession`` on the CPU, 2
    channels, fed ``acked`` seeded samples."""
    from eegnetreplication_tpu_torch.serve.sessions.session import (
        StreamSession,
        WindowDecision,
    )

    session = StreamSession(sid, n_channels=2, window=16, hop=8,
                            ems_init_block_size=8, device="cpu")
    x = np.random.RandomState(7).randn(2, acked).astype(np.float32)
    for idx, start, _ in session.ingest(x):
        session.record(WindowDecision(index=idx, start=start, pred=1,
                                      status="ok", latency_ms=1.0))
    return session.state_arrays()


def tamper_payload_array(payload: bytes, name: str) -> bytes:
    """Flip one byte in the middle of ``name``'s compressed data inside a
    packed session export (a real array entry, so the content digest must
    refuse it)."""
    import io
    import struct
    import zipfile

    zi = zipfile.ZipFile(io.BytesIO(payload)).getinfo(name)
    # Local file header: the data starts after the 30-byte fixed header,
    # the file name and the extra field (lengths at offsets 26 and 28).
    n, m = struct.unpack(
        "<HH", payload[zi.header_offset + 26:zi.header_offset + 30])
    data_off = zi.header_offset + 30 + n + m
    bad = bytearray(payload)
    bad[data_off + zi.compress_size // 2] ^= 0xFF
    return bytes(bad)


class FakeCell:
    """A scriptable cell double: the serve protocol's ``/healthz`` and
    ``/predict`` and the ``/session/*`` surface a cell front forwards to,
    export and import included.

    A copy of ``tests/test_cells.py``'s double, so the port's tests do not
    import a JAX test module; sessions are packed and restored with the
    port's session store (either package's front reads the format).  Its
    knobs are plain attributes changed mid-test.  It speaks HTTP/1.0, so a
    stopped double looks dead.
    """

    def __init__(self, port: int = 0, digest: str = "d0"):
        import json
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from eegnetreplication_tpu_torch.serve.sessions import (
            store as session_store,
        )
        from eegnetreplication_tpu_torch.serve.sessions.session import (
            StreamSession,
        )

        self.digest = digest
        self.degraded: list[str] = []       # non-empty -> healthz 503
        self.slo_any_breached = False
        self.queue_depth = 0
        self.predictions = [0, 1, 2]
        self.predict_status = 200
        self.sessions: dict[str, int] = {}  # sid -> acked advert
        self.export_payload: bytes | None = None
        self.import_status: int | None = None  # None = real behavior
        self.imports: list[bytes] = []
        self.log: list[tuple[str, bytes]] = []
        self.headers_log: list[tuple[str, dict]] = []
        fake = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.0"

            def log_message(self, *a):  # noqa: A003 — quiet
                pass

            def _reply(self, code, payload):
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _reply_octets(self, code, body):
                self.send_response(code)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802
                parts = self.path.strip("/").split("/")
                if self.path == "/healthz":
                    self._reply(503 if fake.degraded else 200, {
                        "status": "degraded" if fake.degraded else "ok",
                        "degraded": fake.degraded,
                        "variables_digest": fake.digest,
                        "queue_depth_requests": fake.queue_depth,
                        "sessions": len(fake.sessions),
                        "slo": {"breached": [],
                                "any_breached": fake.slo_any_breached}})
                    return
                if len(parts) == 3 and parts[0] == "session":
                    sid = parts[1]
                    if sid not in fake.sessions:
                        self._reply(404, {"error": "unknown session"})
                        return
                    if parts[2] == "state":
                        self._reply(200, {"session": sid,
                                          "acked": fake.sessions[sid],
                                          "windows": 0})
                        return
                    if parts[2] == "export":
                        payload = fake.export_payload
                        if payload is None:
                            payload = session_store.pack_session(
                                sid, session_state(sid))
                        self._reply_octets(200, payload)
                        return
                self._reply(404, {})

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length", 0) or 0)
                body = self.rfile.read(n) if n else b""
                fake.log.append((self.path, body))
                fake.headers_log.append((self.path,
                                         dict(self.headers.items())))
                parts = self.path.strip("/").split("/")
                if self.path == "/predict":
                    if fake.predict_status != 200:
                        self._reply(fake.predict_status,
                                    {"error": "scripted"})
                        return
                    self._reply(200, {"predictions": fake.predictions,
                                      "n": len(fake.predictions),
                                      "model_digest": fake.digest})
                    return
                if self.path == "/session/open":
                    payload = json.loads(body.decode() or "{}")
                    sid = payload.get("session") or "anon"
                    resumed = sid in fake.sessions
                    fake.sessions.setdefault(sid, 0)
                    self._reply(200, {"session": sid,
                                      "acked": fake.sessions[sid],
                                      "windows": 0, "resumed": resumed})
                    return
                if self.path == "/session/import":
                    fake.imports.append(body)
                    if fake.import_status is not None:
                        self._reply(fake.import_status,
                                    {"error": "scripted"})
                        return
                    try:
                        sid, state = session_store.unpack_session(body)
                    except Exception as exc:  # noqa: BLE001
                        self._reply(400, {"error": str(exc)})
                        return
                    if sid in fake.sessions:
                        self._reply(409, {"error": "already open"})
                        return
                    restored = StreamSession.from_state(sid, state,
                                                        device="cpu")
                    fake.sessions[sid] = restored.acked
                    self._reply(200, {"session": sid,
                                      "acked": restored.acked,
                                      "imported": True})
                    return
                if len(parts) == 3 and parts[0] == "session":
                    sid = parts[1]
                    if sid not in fake.sessions:
                        self._reply(404, {"error": "unknown session"})
                        return
                    if parts[2] == "samples":
                        self._reply(200, {"session": sid,
                                          "acked": fake.sessions[sid],
                                          "decisions": []})
                        return
                    if parts[2] in ("close", "discard"):
                        fake.sessions.pop(sid, None)
                        self._reply(200, {"session": sid, "windows": 0,
                                          "expired": 0, "acked": 0,
                                          "preds": []})
                        return
                self._reply(404, {})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://127.0.0.1:{self.port}"
        # A short poll interval: stop() returns within 50 ms, not 500.
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        args=(0.05,), daemon=True)
        self._thread.start()

    def posts(self, path_suffix: str) -> list[bytes]:
        return [b for p, b in self.log if p.endswith(path_suffix)]

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()


def cells_packages() -> dict:
    """:func:`fleet_packages` with each package's cell tier and session
    modules added (``cms``, ``front``, ``ha``, ``cells``, ``store``,
    ``session``, ``agg``)."""
    import importlib

    names = {"cms": "serve.cells.membership", "front": "serve.cells.front",
             "ha": "serve.cells.ha", "cells": "serve.cells.service",
             "store": "serve.sessions.store",
             "session": "serve.sessions.session", "agg": "obs.agg"}
    out = fleet_packages()
    for key, root in (("jax", "eegnetreplication_tpu"),
                      ("port", "eegnetreplication_tpu_torch")):
        for attr, mod in names.items():
            setattr(out[key], attr,
                    importlib.import_module(f"{root}.{mod}"))
    return out
