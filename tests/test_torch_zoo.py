"""The zoo: stacked weights, the mixed-tenant forward, the stack gate and
the registry, against the JAX package on the CPU.

The same numpy-drawn tenants go to both packages.  The mixed-tenant
forward (block 1 through ``block1_stacked``'s plain version here, block 2
on per-trial gathered weights) must agree with JAX's
``stacked_eval_forward`` / ``stacked_quantized_eval_forward`` within atol
1e-5 / rtol 1e-4 with equal argmax; the stack gate must give JAX's
per-tenant agreement; the addressing helpers and the evictions under a
program budget must be JAX's; only incongruent trees turn the zoo to
per-model serving, and a K1 failure raises.
"""

import threading

import numpy as np
import pytest
import torch
from torch_port_cases import (
    GEOMETRIES,
    jax_model,
    jax_variables,
    port_model,
    trials,
)

from eegnetreplication_tpu_torch.ops import quant
from eegnetreplication_tpu_torch.ops import stacked as ops_stacked
from eegnetreplication_tpu_torch.ops.fused_eegnet import (
    block1_stacked_reference,
)
from eegnetreplication_tpu_torch.serve import registry as port_registry
from eegnetreplication_tpu_torch.serve import zoo as port_zoo
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib

ATOL, RTOL = 1e-5, 1e-4
N_TENANTS = 3


class Recorder:
    """A journal that keeps its events (the surface both zoos use)."""

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

    def of(self, name):
        return [e for e in self.events if e["event"] == name]


def _tenants(geometry="product", n=N_TENANTS, seed=20):
    return [jax_variables(*GEOMETRIES[geometry], seed=seed + z)
            for z in range(n)]


def _save(tmp_path, tenants, geometry="product", names=None):
    c, t, f1, d = GEOMETRIES[geometry]
    names = names or [f"subject_{z + 1:02d}_best_model"
                      for z in range(len(tenants))]
    paths = {}
    for name, (p, b) in zip(names, tenants):
        paths[name] = ckpt_lib.save_checkpoint(
            tmp_path / f"{name}.npz", ckpt_lib.from_jax_variables(p, b),
            metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                      "F1": f1, "D": d})
    return paths


# --- stacking -------------------------------------------------------------

def test_stacking_helpers_match_jax():
    from eegnetreplication_tpu.ops import stacked as jax_stacked

    trees = [p for p, _ in _tenants("small")]
    assert ops_stacked.congruent(trees) == jax_stacked.congruent(trees)
    got, want = ops_stacked.stack_trees(trees), jax_stacked.stack_trees(trees)
    for (pg, g), (pw, w) in zip(ops_stacked.tree_leaves_with_paths(got),
                                jax_stacked.tree_leaves_with_paths(want)):
        assert pg == pw and np.array_equal(g, w)
    for z in range(N_TENANTS):
        back = ops_stacked.tenant_slice(got, z)
        for (_, a), (_, b) in zip(
                ops_stacked.tree_leaves_with_paths(back),
                ops_stacked.tree_leaves_with_paths(trees[z])):
            assert np.array_equal(a, b)
    idx = np.array([2, 0, 2], np.int64)
    gathered = ops_stacked.gather_tree(got, idx)
    assert np.array_equal(gathered["classifier"]["bias"],
                          want["classifier"]["bias"][idx])
    wide = jax_variables(*GEOMETRIES["wide"], seed=1)[0]
    assert ops_stacked.congruent(trees + [wide]) == \
        jax_stacked.congruent(trees + [wide])
    assert ops_stacked.congruent([]) == jax_stacked.congruent([])


def test_incongruent_trees_raise_their_own_value_error():
    trees = [p for p, _ in _tenants("small", n=1)]
    trees.append(jax_variables(*GEOMETRIES["wide"], seed=1)[0])
    with pytest.raises(ops_stacked.IncongruentTrees, match="not stackable"):
        ops_stacked.stack_trees(trees)
    assert issubclass(ops_stacked.IncongruentTrees, ValueError)
    # K1-stacked's own refusal of an index out of range is a ValueError
    # that is NOT the incongruence the zoo turns into per-model serving.
    x = torch.zeros((1, 8, 64))
    S, W, A, B = (torch.zeros((1, 16, 8)), torch.zeros((1, 16, 32)),
                  torch.zeros((1, 16)), torch.zeros((1, 16)))
    with pytest.raises(ValueError) as exc:
        block1_stacked_reference(x, S, W, A, B,
                                 torch.tensor([1], dtype=torch.int32))
    assert not isinstance(exc.value, ops_stacked.IncongruentTrees)


@pytest.mark.parametrize("precision", ["fp32", "int8"])
@pytest.mark.parametrize("batch", [1, 8])
def test_mixed_tenant_forward_matches_jax(precision, batch):
    import jax.numpy as jnp

    from eegnetreplication_tpu.ops import quant as jax_quant
    from eegnetreplication_tpu.ops import stacked as jax_stacked

    c, t, f1, d = GEOMETRIES["product"]
    tenants = _tenants()
    sp = jax_stacked.stack_trees([p for p, _ in tenants])
    sb = jax_stacked.stack_trees([b for _, b in tenants])
    x = trials(batch, c, t, seed=30 + batch)
    idx = np.random.RandomState(batch).randint(0, N_TENANTS, batch).astype(
        np.int32)
    model = jax_model(c, t, f1, d)
    xt, it = torch.from_numpy(x), torch.from_numpy(idx)
    if precision == "fp32":
        want = jax_stacked.stacked_eval_forward(model, sp, sb,
                                                jnp.asarray(x),
                                                jnp.asarray(idx))
        pack = ops_stacked.fold_stacked_eegnet(ops_stacked.stack_trees(
            [ckpt_lib.from_jax_variables(p, b) for p, b in tenants]))
        got = ops_stacked.stacked_eval_forward(pack, xt, it)
        plain = ops_stacked.stacked_eval_forward_reference(pack, xt, it)
    else:
        want = jax_stacked.stacked_quantized_eval_forward(
            model, jax_quant.quantize_params(sp, stacked=True), sb,
            jnp.asarray(x), jnp.asarray(idx))
        pack = quant.fold_quantized_eegnet(
            quant.quantize_params(ops_stacked.stack_trees(
                [p for p, _ in tenants]), stacked=True),
            ops_stacked.stack_trees([b for _, b in tenants]))
        got = ops_stacked.stacked_quantized_eval_forward(pack, xt, it)
        plain = ops_stacked.stacked_quantized_eval_forward_reference(
            pack, xt, it)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
    np.testing.assert_array_equal(plain.numpy(), got)


# --- addressing -----------------------------------------------------------

def _zoo_dir(tmp_path):
    d = tmp_path / "zoo"
    d.mkdir()
    for name in ("subject_02_best_model.npz", "subject_01_best_model.pth",
                 "notes.txt"):
        (d / name).write_bytes(b"")
    (tmp_path / "empty").mkdir()
    return d


@pytest.mark.parametrize("spec", [
    "a=x.npz,b=y.npz", " a = x.npz , b=y.npz ,", "DIR", "EMPTY", "a",
    "a=x.npz,a=y.npz", "=x.npz", "a=", "", {"m": "x.npz"}])
def test_parse_zoo_spec_matches_jax(spec, tmp_path):
    from eegnetreplication_tpu.serve import zoo as jax_zoo

    d = _zoo_dir(tmp_path)
    spec = {"DIR": str(d), "EMPTY": str(tmp_path / "empty")}.get(spec, spec) \
        if isinstance(spec, str) else spec

    def outcome(fn):
        try:
            return fn(spec)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert outcome(port_zoo.parse_zoo_spec) == outcome(jax_zoo.parse_zoo_spec)


@pytest.mark.parametrize("spec", [
    None, "", "default", "b", "deadbeef", "deadbeefcafe", "0123abcd",
    "zz", "DEADBEEF", "abc"])
def test_resolve_model_id_matches_jax(spec):
    from eegnetreplication_tpu.serve import zoo as jax_zoo

    ids = ["a", "b", "c"]
    digests = {"a": "deadbeef01", "b": "deadbeef02", "c": None}

    def outcome(fn):
        try:
            return fn(ids, spec, "a", digests)
        except KeyError as exc:
            return ("KeyError", str(exc))

    assert outcome(port_zoo.resolve_model_id) == \
        outcome(jax_zoo.resolve_model_id)
    assert port_zoo.looks_like_digest(spec or "") == \
        jax_zoo.looks_like_digest(spec or "")


# --- the stack gate -------------------------------------------------------

@pytest.mark.parametrize("precision", ["fp32", "int8"])
def test_stack_gate_gives_the_jax_per_tenant_agreement(precision):
    from eegnetreplication_tpu.serve import engine as jax_engine
    from eegnetreplication_tpu.serve import zoo as jax_zoo

    c, t, f1, d = GEOMETRIES["small"]
    tenants = _tenants("small", seed=40)
    ids = [f"t{z}" for z in range(N_TENANTS)]
    gate_set = [("A01E", trials(16, c, t, seed=41)),
                ("A02E", trials(16, c, t, seed=42))]
    jm = jax_model(c, t, f1, d)
    jax_members = [(mid, jm, p, b) for mid, (p, b) in zip(ids, tenants)]
    want = jax_zoo.run_stack_gate(
        {mid: jax_engine.InferenceEngine(jm, p, b, (16,))
         for mid, _, p, b in jax_members},
        jax_zoo.StackedEngine.from_members(jax_members, (16,),
                                           precision=precision),
        gate_set, journal=Recorder())
    members = [(mid, port_model(p, b, c, t, f1, d))
               for mid, (p, b) in zip(ids, tenants)]
    journal = Recorder()
    got = port_zoo.run_stack_gate(
        {mid: port_zoo.InferenceEngine(m, (16,), device="cpu")
         for mid, m in members},
        port_zoo.StackedEngine(members, (16,), precision=precision,
                               device="cpu"), gate_set, journal=journal)
    assert got.per_tenant == want.per_tenant
    assert (got.outcome, got.agreement, got.floor) == \
        (want.outcome, want.agreement, want.floor)
    (event,) = journal.of("stack_gate")
    assert event["n_tenants"] == N_TENANTS and event["outcome"] == got.outcome


def test_stacked_engine_pads_with_the_last_tenant_and_checks_indices():
    c, t, f1, d = GEOMETRIES["small"]
    members = [(f"t{z}", port_model(p, b, c, t, f1, d))
               for z, (p, b) in enumerate(_tenants("small"))]
    engine = port_zoo.StackedEngine(members, (1, 8), device="cpu")
    x = trials(5, c, t, seed=50)
    idx = np.array([2, 0, 1, 1, 2], np.int32)
    got = engine.infer(x, idx)
    for z, (_, model) in enumerate(members):
        solo = port_zoo.InferenceEngine(model, (1, 8), device="cpu")
        mask = idx == z
        np.testing.assert_array_equal(got[mask], solo.infer(x[mask]))
    with pytest.raises(ValueError, match="tenant index out of range"):
        engine.infer(x, 3)


# --- the registry and the zoo ---------------------------------------------

def test_model_evict_order_under_the_budget_matches_jax(tmp_path):
    from eegnetreplication_tpu.serve import registry as jax_registry

    paths = _save(tmp_path, _tenants("small", n=4), "small",
                  names=["a", "b", "c", "d"])
    sequence = ["b", "c", "a", "d", "b", "a", "c"]
    orders = {}
    for name, cls, kw in (
            ("jax", jax_registry.ModelZoo, {}),
            ("port", port_registry.ModelZoo, {"device": "cpu"})):
        journal = Recorder()
        zoo = cls(dict(paths), buckets=(1,), stack=False, max_programs=2,
                  warm=False, journal=journal, **kw)
        for mid in sequence:
            zoo.materialize(mid)
        orders[name] = ([e["model"] for e in journal.of("model_load")],
                        [e["model"] for e in journal.of("model_evict")])
    assert orders["port"] == orders["jax"]
    assert orders["port"][1]   # the budget evicted something


@pytest.fixture
def zoo_paths(tmp_path):
    return _save(tmp_path, _tenants("small", seed=60), "small")


def test_zoo_stacks_and_serves_every_tenant_as_its_own_engine(zoo_paths):
    journal = Recorder()
    zoo = port_registry.ModelZoo(dict(zoo_paths), buckets=(1, 8),
                                 journal=journal, device="cpu")
    assert zoo.stacked is not None and zoo.restacks == 1
    (restack,) = journal.of("zoo_restack")
    assert restack["outcome"] == "pass"
    assert journal.of("stack_gate")[0]["outcome"] == "pass"
    c, t = zoo.geometry
    x = trials(12, c, t, seed=61)
    idx = np.arange(12, dtype=np.int32) % N_TENANTS
    got = zoo.infer(x, idx)
    for z, mid in enumerate(zoo.tenant_ids):
        solo = zoo.materialize(mid)
        np.testing.assert_array_equal(got[idx == z], solo.infer(x[idx == z]))
    assert zoo.resolve(zoo.digest_for("subject_02_best_model")[:12]) == \
        "subject_02_best_model"
    snap = zoo.snapshot()
    assert snap["stacked"]["n_tenants"] == N_TENANTS
    assert [e["model"] for e in snap["tenants"]] == zoo.tenant_ids


def test_only_incongruent_tenants_turn_the_zoo_per_model(tmp_path):
    paths = _save(tmp_path, _tenants("small", n=2), "small")
    c, t, _, _ = GEOMETRIES["small"]
    p, b = jax_variables(c, t, 16, 2, seed=70)     # same (C, T), F1=16
    paths["wide"] = ckpt_lib.save_checkpoint(
        tmp_path / "wide.npz", ckpt_lib.from_jax_variables(p, b),
        metadata={"model": "eegnet", "n_channels": c, "n_times": t,
                  "F1": 16, "D": 2})
    journal = Recorder()
    zoo = port_registry.ModelZoo(paths, buckets=(1, 8), journal=journal,
                                 device="cpu")
    assert zoo.stacked is None
    assert journal.of("zoo_restack")[0]["outcome"] == "unstackable"
    x = trials(4, c, t, seed=71)
    assert zoo.infer(x, np.array([0, 1, 2, 2], np.int32)).shape == (4,)


@pytest.mark.parametrize("error", [
    RuntimeError("block1: K1 launch failed with CUDA error 700"),
    ValueError("block1_stacked: idx spans [0, 9], outside [0, 3)")],
    ids=["launch", "index"])
def test_a_k1_failure_raises_and_never_becomes_per_model_serving(
        zoo_paths, monkeypatch, error):
    def broken(*args, **kwargs):
        raise error

    monkeypatch.setattr(ops_stacked, "block1_stacked", broken)
    journal = Recorder()
    with pytest.raises(type(error), match=str(error)[:12]):
        port_registry.ModelZoo(dict(zoo_paths), buckets=(1, 8),
                               journal=journal, device="cpu")
    (restack,) = journal.of("zoo_restack")
    assert restack["outcome"] == "error"
    assert not journal.of("model_load")     # no per-model fallback


def test_reload_of_one_tenant_restacks_and_a_corrupt_file_keeps_it(
        zoo_paths, tmp_path):
    journal = Recorder()
    zoo = port_registry.ModelZoo(dict(zoo_paths), buckets=(1, 8),
                                 journal=journal, device="cpu")
    mid = "subject_02_best_model"
    old = zoo.digest_for(mid)
    (new_path,) = _save(tmp_path / "new", _tenants("small", n=1, seed=80),
                        "small").values()
    bad = tmp_path / "corrupt.npz"
    bad.write_bytes(new_path.read_bytes()[:200])
    with pytest.raises(Exception):
        zoo.reload(mid, bad)
    assert zoo.digest_for(mid) == old and zoo.swaps == 0
    digest = zoo.reload(mid, new_path)
    assert digest != old and zoo.digest_for(mid) == digest
    assert zoo.stacked is not None and zoo.restacks == 2
    assert [e["outcome"] for e in journal.of("zoo_restack")] == ["pass"] * 2
    (swap,) = journal.of("model_swap")
    assert swap["previous_digest"] == old and swap["digest"] == digest
    c, t = zoo.geometry
    x = trials(6, c, t, seed=81)
    solo = port_zoo.InferenceEngine(
        port_model(*_tenants("small", n=1, seed=80)[0],
                   *GEOMETRIES["small"]), (1, 8), device="cpu")
    np.testing.assert_array_equal(zoo.infer(x, 1), solo.infer(x))


@pytest.mark.parametrize("kind", ["registry", "zoo"])
def test_reload_during_concurrent_infer_drops_nothing(zoo_paths, tmp_path,
                                                      kind):
    paths = list(zoo_paths.values())
    if kind == "registry":
        target = port_registry.ModelRegistry((1, 8), journal=Recorder(),
                                             device="cpu")
        target.load(paths[0])

        def call(x):
            return target.infer(x)

        def reload():
            return target.reload(paths[1]).digest
    else:
        target = port_registry.ModelZoo(dict(zoo_paths), buckets=(1, 8),
                                        journal=Recorder(), device="cpu")

        def call(x):
            return target.infer(x, np.arange(len(x)) % N_TENANTS)

        def reload():
            return target.reload(target.tenant_ids[0], paths[1])
    c, t, _, _ = GEOMETRIES["small"]
    x = trials(8, c, t, seed=90)
    errors, answers = [], []
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                answers.append(call(x))
            except Exception as exc:  # noqa: BLE001 — counted below
                errors.append(exc)

    threads = [threading.Thread(target=client) for _ in range(4)]
    for th in threads:
        th.start()
    try:
        digest = reload()
    finally:
        stop.set()
        for th in threads:
            th.join(60)
    assert not errors and answers
    assert all(a.shape == (8,) for a in answers)
    assert digest and target.swaps == 1
