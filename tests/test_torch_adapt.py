"""Online adaptation (``adapt/``) of the torch port against the JAX package
on the CPU, at a small width (C=4, T=64, F1=4, D=2).

- ``PromotionGate.decide`` equals JAX's on seeded grids of stats, and its
  ``config()`` and refusals are JAX's.
- ``ReplayBuffer``: one seeded observe/label/relabel/evict/clear sequence
  gives byte-equal ``dataset()``, equal ``stats()`` and equal lookups.
- ``AdaptationWorker.fine_tune`` from one base checkpoint and buffer at
  dropout 0 (10 steps of 8): candidate parameters and loss within 2e-3 of
  JAX's, the fit accuracy equal, each candidate loading in the other
  package with its digest; ``adapt.train``'s corrupt action makes
  ``register_shadow`` raise in both.
- ``shadow_infer`` equals JAX's on one candidate; a shadow is not a
  tenant.
- The controller on a two-tenant zoo, driven by one seeded sequence of
  windows, labels and tees in both packages (with a drain after every
  hook, so the order is fixed): the same adaptation events in the same
  order, the same gate decisions, the same final ``status()`` up to the
  candidates' digests; rollback restores the prior digest.
- ``session.drift`` transforms a chunk as JAX's does.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch_port_cases import jax_variables

from eegnetreplication_tpu.adapt import buffer as jax_buffer
from eegnetreplication_tpu.adapt import controller as jax_controller
from eegnetreplication_tpu.adapt import gate as jax_gate
from eegnetreplication_tpu.adapt import worker as jax_worker
from eegnetreplication_tpu.resil import inject as jax_inject
from eegnetreplication_tpu.serve import engine as jax_engine
from eegnetreplication_tpu.serve import registry as jax_registry
from eegnetreplication_tpu_torch.adapt import buffer, controller, gate, worker
from eegnetreplication_tpu_torch.resil import inject
from eegnetreplication_tpu_torch.serve import engine as port_engine
from eegnetreplication_tpu_torch.serve import registry as port_registry
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.utils import adapt_drill

C, T, F1, D = 4, 64, 4, 2
TOL = 2e-3
META = {"model": "eegnet", "n_channels": C, "n_times": T, "F1": F1, "D": D}


class Recorder:
    """A journal that keeps its events (the surface both packages use)."""

    class _Metrics:
        def inc(self, *a, **k):
            pass

        set = observe = inc

    def __init__(self):
        self.events = []
        self.metrics = self._Metrics()

    def event(self, name, **fields):
        self.events.append(dict(fields, event=name))
        return fields


# --- the gate -----------------------------------------------------------------

GATE_CONFIGS = [
    {},
    {"min_samples": 4, "min_labeled": 2, "accuracy_floor": 0.7,
     "agreement_floor": 0.3},
    {"min_samples": 1, "min_labeled": 1, "accuracy_floor": 0.0},
    {"min_samples": 20, "min_labeled": 15, "accuracy_floor": 1.0,
     "agreement_floor": 1.0},
]


def _stats_grid(seed: int, n: int = 240):
    """Stats as the evaluator reports them: a rate is None exactly when its
    count is 0; values on and around the floors."""
    rng = np.random.default_rng(seed)
    grid = []
    for _ in range(n):
        n_trials = int(rng.integers(0, 30))
        labeled_n = int(rng.integers(0, min(n_trials, 20) + 1))
        agreement = float(rng.choice([0.0, 0.3, 0.55, 0.7, 1.0,
                                      rng.random()]))
        accuracy = float(rng.choice([0.0, 0.55, 0.7, 1.0, rng.random()]))
        grid.append({"n_trials": n_trials, "labeled_n": labeled_n,
                     "agreement": agreement if n_trials else None,
                     "accuracy": accuracy if labeled_n else None})
    grid += [{}, {"n_trials": None, "labeled_n": None}]
    return grid


@pytest.mark.parametrize("config", GATE_CONFIGS)
def test_gate_decides_as_jax_on_a_seeded_grid(config):
    port, ref = gate.PromotionGate(**config), jax_gate.PromotionGate(**config)
    grid = _stats_grid(len(str(config)))
    assert len(grid) >= 200
    actions = set()
    for stats in grid:
        got, want = port.decide(stats), ref.decide(stats)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), stats
        actions.add(got.action)
    assert "wait" in actions


def test_gate_config_round_trips_and_refuses_as_jax():
    assert gate.DEFAULT_MIN_SAMPLES == jax_gate.DEFAULT_MIN_SAMPLES
    assert gate.DEFAULT_MIN_LABELED == jax_gate.DEFAULT_MIN_LABELED
    assert gate.DEFAULT_ACCURACY_FLOOR == jax_gate.DEFAULT_ACCURACY_FLOOR
    assert gate.DEFAULT_AGREEMENT_FLOOR == jax_gate.DEFAULT_AGREEMENT_FLOOR
    for config in GATE_CONFIGS:
        got = gate.PromotionGate(**config).config()
        assert got == jax_gate.PromotionGate(**config).config()
        assert gate.PromotionGate(**got).config() == got
    assert [f.name for f in dataclasses.fields(gate.GateDecision)] == \
        [f.name for f in dataclasses.fields(jax_gate.GateDecision)]
    for bad in ({"min_samples": 0}, {"min_labeled": 0},
                {"accuracy_floor": 1.5}, {"agreement_floor": -0.1}):
        with pytest.raises(ValueError) as port_err:
            gate.PromotionGate(**bad)
        with pytest.raises(ValueError) as jax_err:
            jax_gate.PromotionGate(**bad)
        assert str(port_err.value) == str(jax_err.value)


# --- the replay buffer --------------------------------------------------------

def _drive_buffer(module, seed: int):
    """One seeded sequence of buffer operations; the log of what each
    returned."""
    rng = np.random.default_rng(seed)
    buf = module.ReplayBuffer(window_capacity=12, labeled_capacity=9)
    log = []
    for _ in range(400):
        op = int(rng.integers(0, 20))
        tenant = ("a", "b")[int(rng.integers(0, 2))]
        sid, idx = f"s{int(rng.integers(0, 3))}", int(rng.integers(0, 30))
        if op < 9:
            buf.observe(tenant, sid, idx,
                        rng.standard_normal((C, T)).astype(np.float32))
        elif op < 17:
            log.append(("label", buf.label(tenant, sid, idx,
                                           int(rng.integers(0, 4)))))
        elif op < 19:
            win = buf.window_for(tenant, sid, idx)
            log.append(("window", None if win is None else win.tobytes()))
        else:
            buf.clear(tenant)
        log.append(("n", buf.n_labeled(tenant)))
    return buf, log


def test_replay_buffer_equals_jax_on_a_seeded_sequence():
    port, port_log = _drive_buffer(buffer, 5)
    ref, ref_log = _drive_buffer(jax_buffer, 5)
    assert port_log == ref_log
    assert any(entry == ("label", True) for entry in port_log)
    assert any(entry == ("label", False) for entry in port_log)
    for tenant in ("a", "b", "none"):
        (px, py), (jx, jy) = port.dataset(tenant), ref.dataset(tenant)
        assert px.dtype == jx.dtype and py.dtype == jy.dtype
        assert px.shape == jx.shape and px.tobytes() == jx.tobytes()
        assert py.tobytes() == jy.tobytes()
        assert port.stats(tenant) == ref.stats(tenant)
    assert buffer.DEFAULT_WINDOW_CAPACITY == jax_buffer.DEFAULT_WINDOW_CAPACITY
    assert buffer.DEFAULT_LABELED_CAPACITY == \
        jax_buffer.DEFAULT_LABELED_CAPACITY


# --- the fine-tune --------------------------------------------------------------

def _base_checkpoint(path):
    params, bs = jax_variables(C, T, F1, D, seed=9, perturb_bn=True)
    return ckpt_lib.save_checkpoint(
        path, ckpt_lib.from_jax_variables(params, bs), metadata=dict(META))


def _windows(n: int = 24, seed: int = 4):
    """Standardized cue windows: a drifted stream's decided windows."""
    cue = adapt_drill.CueStream(C, T, seed)
    return adapt_drill.drifted_windows(cue, n, n // 3, device="cpu")


def _fill(buf_module, x, y, tenant="a"):
    buf = buf_module.ReplayBuffer()
    for k, (win, label) in enumerate(zip(x, y)):
        buf.observe(tenant, "s", k, win)
        buf.label(tenant, "s", k, int(label))
    return buf


def _no_dropout(mp):
    """Both packages' checkpoint loaders hand the worker a model at dropout
    0: the JAX PRNG's masks and torch's are not comparable."""
    jax_load = jax_engine.load_model_from_checkpoint
    port_load = port_engine.load_model_from_checkpoint

    def jax_at_zero(path):
        model, params, bs = jax_load(path)
        return model.clone(dropout_rate=0.0), params, bs

    def port_at_zero(path, **kw):
        model = port_load(path, **kw)
        model.dropout_rate = 0.0
        return model

    mp.setattr(jax_engine, "load_model_from_checkpoint", jax_at_zero)
    mp.setattr(port_engine, "load_model_from_checkpoint", port_at_zero)


@pytest.fixture(scope="module")
def tuned(tmp_path_factory):
    root = tmp_path_factory.mktemp("fine_tune")
    base = _base_checkpoint(root / "base.npz")
    x, y = _windows()
    jrec, prec = Recorder(), Recorder()
    jw = jax_worker.AdaptationWorker(_fill(jax_buffer, x, y), root / "jax",
                                     steps=10, batch_size=8, seed=3,
                                     journal=jrec)
    pw = worker.AdaptationWorker(_fill(buffer, x, y), root / "port",
                                 steps=10, batch_size=8, seed=3,
                                 journal=prec, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        jc = jw.fine_tune("a", base)
        pc = pw.fine_tune("a", base)
    return {"root": root, "base": base, "x": x, "y": y, "jax": jc,
            "port": pc, "jax_events": jrec.events,
            "port_events": prec.events}


def test_fine_tune_tracks_the_jax_worker(tuned):
    jc, pc = tuned["jax"], tuned["port"]
    (jsd, jmeta), (psd, pmeta) = (ckpt_lib.load_checkpoint(jc.path),
                                  ckpt_lib.load_checkpoint(pc.path))
    assert set(jsd) == set(psd)
    base_sd, _ = ckpt_lib.load_checkpoint(tuned["base"])
    moved = 0.0
    for name in psd:
        # The temporal BatchNorm's scale and bias have a true gradient of
        # 0, so Adam moves them by rounding noise: up to the learning rate
        # a step in either package (ROADMAP.md, "Traps, not faults").
        tol = 10 * 1e-3 if name.startswith("temporal.1.") else TOL
        torch.testing.assert_close(psd[name], jsd[name], rtol=TOL, atol=tol,
                                   msg=name)
        moved = max(moved, float((psd[name] - base_sd[name]).abs().max()))
    assert moved > 10 * TOL            # the fine-tune did move the weights
    assert abs(pc.loss - jc.loss) <= TOL + TOL * abs(jc.loss)
    assert pc.fit_accuracy == jc.fit_accuracy
    assert (pc.steps, pc.n_labeled, pc.model_id) == \
        (jc.steps, jc.n_labeled, jc.model_id)
    assert pmeta == {**jmeta, "adapted_from": str(tuned["base"])}
    assert pc.path.name == jc.path.name == "a.candidate.npz"
    assert worker.CANDIDATE_KEEP == jax_worker.CANDIDATE_KEEP
    for evs in (tuned["jax_events"], tuned["port_events"]):
        assert [e["event"] for e in evs] == ["adaptation_start",
                                             "adaptation_candidate"]
    assert {k for k in tuned["port_events"][1]} == \
        {k for k in tuned["jax_events"][1]}


def test_candidates_load_in_the_other_package(tuned):
    jc, pc = tuned["jax"], tuned["port"]
    _, params, bs = jax_engine.load_model_from_checkpoint(pc.path)
    assert jax_engine.variables_digest(params, bs) == pc.digest
    model = port_engine.load_model_from_checkpoint(jc.path, device="cpu")
    assert port_engine.model_digest(model) == jc.digest


def test_candidate_generations_rotate(tuned, tmp_path):
    x, y = tuned["x"], tuned["y"]
    pw = worker.AdaptationWorker(_fill(buffer, x, y), tmp_path, steps=1,
                                 batch_size=4, journal=Recorder(),
                                 device="cpu")
    for _ in range(4):
        pw.fine_tune("a", tuned["base"])
    names = sorted(p.name for p in tmp_path.iterdir())
    assert names == ["a.candidate.npz", "a.candidate.npz.gen1",
                     "a.candidate.npz.gen2"]
    empty = worker.AdaptationWorker(buffer.ReplayBuffer(), tmp_path,
                                    journal=Recorder(), device="cpu")
    with pytest.raises(ValueError, match="no labeled replay data"):
        empty.fine_tune("b", tuned["base"])


def _zoos(base, buckets=(1, 8)):
    jz = jax_registry.ModelZoo({"a": str(base)}, buckets=buckets,
                               stack=False, journal=Recorder())
    pz = port_registry.ModelZoo({"a": str(base)}, buckets=buckets,
                                stack=False, journal=Recorder(),
                                device="cpu")
    return jz, pz


def test_shadow_infer_equals_jax(tuned):
    jz, pz = _zoos(tuned["base"])
    cand = tuned["port"].path
    assert pz.register_shadow("a", cand) == jz.register_shadow("a", cand) \
        == tuned["port"].digest
    assert pz.shadow_digest("a") == jz.shadow_digest("a")
    x = np.concatenate([tuned["x"], np.random.RandomState(2).randn(
        5, C, T).astype(np.float32)])
    got = np.concatenate([pz.shadow_infer("a", w[None]) for w in x])
    want = np.concatenate([jz.shadow_infer("a", w[None]) for w in x])
    np.testing.assert_array_equal(got, want)
    # Not a tenant: unaddressable, and the tenant still serves the base.
    assert pz.tenant_ids == ["a"] and pz.digest_for("a") != \
        pz.shadow_digest("a")
    assert pz.snapshot()["shadows"] == jz.snapshot()["shadows"]
    assert pz.drop_shadow("a") and not pz.drop_shadow("a")
    assert pz.shadow_digest("a") is None
    with pytest.raises(KeyError):
        pz.shadow_infer("a", x[:1])


def test_a_corrupt_candidate_is_refused_by_both_shadow_loads(tuned,
                                                             tmp_path):
    x, y = tuned["x"], tuned["y"]
    jz, pz = _zoos(tuned["base"])
    jw = jax_worker.AdaptationWorker(_fill(jax_buffer, x, y),
                                     tmp_path / "jax", steps=2,
                                     batch_size=4, journal=Recorder())
    pw = worker.AdaptationWorker(_fill(buffer, x, y), tmp_path / "port",
                                 steps=2, batch_size=4, journal=Recorder(),
                                 device="cpu")
    with jax_inject.scoped(jax_inject.FaultSpec(site="adapt.train")), \
            inject.scoped(inject.FaultSpec(site="adapt.train")):
        jc = jw.fine_tune("a", tuned["base"])
        pc = pw.fine_tune("a", tuned["base"])
    with pytest.raises(Exception) as jax_err:
        jz.register_shadow("a", jc.path)
    with pytest.raises(Exception) as port_err:
        pz.register_shadow("a", pc.path)
    assert type(port_err.value).__name__ == type(jax_err.value).__name__
    assert pz.shadow_digest("a") is None and jz.shadow_digest("a") is None
    # action=raise aborts the fine-tune: no candidate is handed on.
    with inject.scoped(inject.FaultSpec(site="adapt.train",
                                        action="raise")):
        with pytest.raises(OSError, match="adapt.train"):
            pw.fine_tune("a", tuned["base"])


# --- the controller ---------------------------------------------------------------

ADAPT_EVENTS = ("adaptation_start", "adaptation_candidate", "shadow_eval",
                "promotion")


def _drive_controller(pkg, zoo, root, x, y):
    """One seeded sequence through an AdaptationController with a drain
    after every hook; returns (controller, journal, the prior digest)."""
    rec = Recorder()
    ctl = pkg.AdaptationController(
        zoo, root, trigger_labels=8, sample_every=2,
        gate=(gate if pkg is controller else jax_gate).PromotionGate(
            min_samples=5, min_labeled=3, accuracy_floor=0.5),
        learning_rate=1e-3, steps=40, batch_size=8, seed=1, journal=rec)
    prior = zoo.digest_for("a")
    live = [int(p) for p in zoo.infer(x, np.zeros(len(x), np.int32))]
    try:
        for k in range(len(x)):
            ctl.observe_window("a", "s", k, x[k], live[k])
            ctl.observe_window("b", "s", k, x[k], live[k])
            assert ctl.drain(timeout=60)
            if k % 4 != 3:        # a few windows stay unlabeled
                ctl.on_label("a", "s", k, int(y[k]), live_pred=live[k])
                assert ctl.drain(timeout=120)
            ctl.tee_predictions("a", x[k:k + 1], live[k:k + 1])
            ctl.tee_predictions("b", x[k:k + 1], live[k:k + 1])
            assert ctl.drain(timeout=60)
    finally:
        ctl.close()
    return ctl, rec, prior


def _two_tenant_zoos(root, a=None):
    a = a or _base_checkpoint(root / "a.npz")
    params, bs = jax_variables(C, T, F1, D, seed=11)
    b = ckpt_lib.save_checkpoint(root / "b.npz",
                                 ckpt_lib.from_jax_variables(params, bs),
                                 metadata=dict(META))
    spec = {"a": str(a), "b": str(b)}
    return (jax_registry.ModelZoo(spec, buckets=(1, 8), journal=Recorder()),
            port_registry.ModelZoo(spec, buckets=(1, 8), journal=Recorder(),
                                   device="cpu"))


@pytest.fixture(scope="module", params=["trained", "untrained"])
def driven(request, tmp_path_factory):
    """The controller sequence in both packages.  ``trained``: tenant "a"
    learned the clean cue stream (the drill's baseline), so the drift costs
    it accuracy and each fine-tune wins it back (promotions); ``untrained``:
    a drawn model whose candidates stay under the floor (refusals)."""
    root = tmp_path_factory.mktemp(f"controller_{request.param}")
    a = None
    if request.param == "trained":
        a, _ = adapt_drill.train_baseline_checkpoint(
            root / "a.npz", C, T, steps=150, init_block=T, F1=F1, D=D,
            device="cpu")
    jz, pz = _two_tenant_zoos(root, a)
    x, y = _windows(n=40, seed=8)
    with pytest.MonkeyPatch.context() as mp:
        _no_dropout(mp)
        jctl, jrec, jprior = _drive_controller(jax_controller, jz,
                                               root / "jax", x, y)
        pctl, prec, pprior = _drive_controller(controller, pz,
                                               root / "port", x, y)
    return {"case": request.param, "jax": (jctl, jrec, jprior, jz),
            "port": (pctl, prec, pprior, pz)}


def _adapt_events(rec):
    return [e for e in rec.events if e["event"] in ADAPT_EVENTS]


def test_controller_journals_the_jax_sequence(driven):
    (_, jrec, _, _), (_, prec, _, _) = driven["jax"], driven["port"]
    got, want = _adapt_events(prec), _adapt_events(jrec)
    assert [(e["event"], e.get("action")) for e in got] == \
        [(e["event"], e.get("action")) for e in want]
    decisions = {e["action"] for e in got if e["event"] == "promotion"}
    assert decisions == ({"promote"} if driven["case"] == "trained"
                         else {"refused"})
    for g, w in zip(got, want):
        if g["event"] == "shadow_eval":
            keys = ("model", "n_trials", "agree", "shadow_pred",
                    "live_pred", "label", "correct", "live_correct")
        elif g["event"] == "promotion":
            keys = ("model", "action", "reason", "stage", "n_trials",
                    "labeled_n", "agreement", "accuracy", "min_samples",
                    "min_labeled", "accuracy_floor", "agreement_floor")
        else:
            keys = ("model", "n_labeled", "steps")
        assert {k: g.get(k) for k in keys} == {k: w.get(k) for k in keys}


def test_controller_status_equals_jax(driven):
    (jctl, _, _, _), (pctl, _, _, _) = driven["jax"], driven["port"]

    def masked(status):
        for m in status["models"].values():
            if m["shadow"] is not None:
                m["shadow"] = {k: v for k, v in m["shadow"].items()
                               if k not in ("digest", "mean_latency_ms")}
            m["candidate_digest"] = m["candidate_digest"] is not None
        return status

    got, want = masked(pctl.status()), masked(jctl.status())
    assert got == want
    loop = got["models"]["a"]
    if driven["case"] == "trained":
        assert loop["promotions"] >= 2 and loop["rollback_depth"] >= 2
    else:
        assert loop["promotions"] == 0 and loop["refusals"] >= 2
    assert "b" not in got["models"]       # observed, never labeled


def test_rollback_restores_the_prior_digest(driven):
    for pkg in ("jax", "port"):
        ctl, rec, prior, zoo = driven[pkg]
        depth = ctl.status()["models"]["a"]["rollback_depth"]
        if driven["case"] == "untrained":
            assert depth == 0 and zoo.digest_for("a") == prior
        digests = []
        for _ in range(depth):
            out = ctl.rollback("a")
            assert out["digest"] == zoo.digest_for("a")
            assert rec.events[-1]["event"] == "promotion" \
                and rec.events[-1]["action"] == "rollback"
            digests.append(out["digest"])
        assert zoo.digest_for("a") == prior
        assert len(set(digests)) == len(digests)
        with pytest.raises(LookupError, match="no promotion to roll back"):
            ctl.rollback(None)
    pctl = driven["port"][0]
    promoted = [p.name for p in pctl.adapt_dir.iterdir()
                if ".promoted." in p.name]
    assert len(promoted) == depth


def test_controller_refuses_a_corrupt_candidate_as_jax(tmp_path):
    jz, pz = _two_tenant_zoos(tmp_path)
    x, y = _windows(n=8, seed=6)
    out = {}
    for name, pkg, plan in (("jax", jax_controller, jax_inject),
                            ("port", controller, inject)):
        zoo = jz if name == "jax" else pz
        rec = Recorder()
        ctl = pkg.AdaptationController(zoo, tmp_path / name,
                                       trigger_labels=4, steps=2,
                                       batch_size=4, journal=rec)
        with plan.scoped(plan.FaultSpec(site="adapt.train")):
            for k in range(4):
                ctl.observe_window("a", "s", k, x[k], 0)
                ctl.on_label("a", "s", k, int(y[k]), live_pred=0)
            assert ctl.drain(timeout=120)
        ctl.close()
        promotion = [e for e in rec.events if e["event"] == "promotion"]
        out[name] = (promotion[0]["action"], promotion[0]["stage"],
                     ctl.status()["models"]["a"]["refusals"])
    assert out["port"] == out["jax"] == ("refused", "shadow_load", 1)


def test_controller_refuses_bad_settings_as_jax(tmp_path):
    with pytest.raises(ValueError) as port_err:
        controller.AdaptationController(object(), tmp_path / "p",
                                        trigger_labels=0)
    with pytest.raises(ValueError) as jax_err:
        jax_controller.AdaptationController(object(), tmp_path / "j",
                                            trigger_labels=0)
    assert str(port_err.value) == str(jax_err.value)
    assert controller.DEFAULT_TRIGGER_LABELS == \
        jax_controller.DEFAULT_TRIGGER_LABELS


# --- session.drift ----------------------------------------------------------------

@pytest.mark.parametrize("plan", ["session.drift:times=1",
                                  "session.drift:times=1:scale=0.5:"
                                  "offset=-1.25"])
def test_session_drift_transforms_a_chunk_as_jax(plan):
    chunk = np.random.RandomState(3).randn(C, 25).astype(np.float32)
    got = []
    for module in (inject, jax_inject):
        with module.scoped(*module.parse_plan(plan)):
            with pytest.raises(module.DriftInjected) as drift:
                module.fire("session.drift", session="s", n_samples=25)
            module.fire("session.drift", session="s", n_samples=25)
        d = drift.value
        got.append((chunk * d.scale + d.offset, d.scale, d.offset, str(d)))
    (px, ps, po, pm), (jx, js, jo, jm) = got
    np.testing.assert_array_equal(px, jx)
    assert (ps, po, pm) == (js, jo, jm)
    assert (inject.DEFAULT_DRIFT_SCALE, inject.DEFAULT_DRIFT_OFFSET) == \
        (jax_inject.DEFAULT_DRIFT_SCALE, jax_inject.DEFAULT_DRIFT_OFFSET)


@pytest.mark.parametrize("bad", ["scale=0", "scale=-1", "scale=nan",
                                 "offset=inf", "scale=x"])
def test_drift_magnitudes_are_refused_at_parse_time_as_jax(bad):
    plan = f"session.drift:{bad}"
    with pytest.raises(ValueError) as port_err:
        inject.parse_plan(plan)
    with pytest.raises(ValueError) as jax_err:
        jax_inject.parse_plan(plan)
    assert str(port_err.value) == str(jax_err.value)
