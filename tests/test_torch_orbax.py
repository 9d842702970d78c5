"""Orbax checkpoint directories in the port (``training/orbax_io.py`` over
``training/ocdbt.py`` and ``utils/zstd.py``), held against tensorstore and
the JAX package's Orbax module on the CPU.

- OCDBT stores tensorstore writes with small nodes and inline limits (so
  interior nodes, indirect values and data files appear), several
  transactions, both manifest kinds, uncompressed nodes and version tree
  nodes list the same keys and read the same bytes in the port; a
  damaged manifest or node fails its CRC-32C.
- Directories the JAX ``save_orbax_checkpoint`` writes (OCDBT, zstd) load
  in the port with exactly the JAX loader's arrays and
  ``variables_digest``: EEGNet at the product width and a narrow one
  (with ``jax.Array`` and with numpy leaves), ShallowConvNet and
  DeepConvNet; their eval logits are within the stated tolerance of the
  JAX forward.
- Directories the port writes load in the JAX ``load_orbax_checkpoint``
  with the same digest, and its Adam state and step in the JAX
  ``load_orbax_train_state``.
- The twins of ``tests/test_orbax_io.py`` (round trip, resume, a
  weights-only save, a background save, a missing ``metadata.json``) and
  of the bound on pending saves in ``tests/test_shard_async.py``; a
  failed background save stays pending; the drain hook commits.
- The committed fixture (``tests/orbax_fixture.py``) is the seeded
  variables for the JAX loader and the port; ``train --ckptFormat
  orbax`` writes directories the JAX loader reads, and ``predict`` on one
  (and ``--zoo name=<dir>``, and ``/reload`` to one) answers as the
  ``.npz`` run does.
"""

import json
import sys
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch
from orbax_fixture import FIXTURE, METADATA, seeded_variables
from torch_port_cases import (
    BASELINES,
    GEOMETRIES,
    jax_baseline,
    jax_model,
    jax_variables,
    port_model,
    trials,
    write_processed_tree,
)

from eegnetreplication_tpu.serve.engine import (
    variables_digest as jax_digest,
)
from eegnetreplication_tpu.training import orbax_io as jax_orbax
from eegnetreplication_tpu.training.steps import make_optimizer
from eegnetreplication_tpu_torch import train as train_cli
from eegnetreplication_tpu_torch.models import EEGNet
from eegnetreplication_tpu_torch.predict import main as predict_main
from eegnetreplication_tpu_torch.resil import preempt
from eegnetreplication_tpu_torch.serve import service
from eegnetreplication_tpu_torch.serve.engine import (
    load_model_from_checkpoint,
    model_digest,
)
from eegnetreplication_tpu_torch.serve.engine import (
    variables_digest as port_digest,
)
from eegnetreplication_tpu_torch.training import checkpoint as ckpt_lib
from eegnetreplication_tpu_torch.training import orbax_io, steps
from eegnetreplication_tpu_torch.training.ocdbt import OcdbtError, OcdbtStore

# EEGNet's eval logits in the two packages' CPU forwards differ by at most
# 1.5e-7 here; ShallowConvNet's and DeepConvNet's by up to 4.8e-7 and
# 3.0e-7 (whatever the checkpoint format: the weights load bitwise).
LOGIT_TOL = {"eegnet": 2.4e-7, "shallow_convnet": 1e-6, "deep_convnet": 1e-6}


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            yield from _leaves(tree[key], prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(tree[key])


def _assert_trees_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=str(key))


# --------------------------------------------------------------------------
# OCDBT against tensorstore
# --------------------------------------------------------------------------

OCDBT_CASES = {
    # small nodes and inline limit: interior nodes, indirect values
    "small_nodes": ({"max_decoded_node_bytes": 200,
                     "max_inline_value_bytes": 16}, 6),
    "uncompressed": ({"max_decoded_node_bytes": 300,
                      "max_inline_value_bytes": 24, "compression": None}, 4),
    "numbered": ({"manifest_kind": "numbered",
                  "max_decoded_node_bytes": 256}, 4),
    # arity 2: older generations move into version tree nodes
    "version_nodes": ({"version_tree_arity_log2": 1,
                       "max_inline_value_bytes": 8}, 13),
}


def _write_store(path, config, commits, seed=0):
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                          "config": config}).result()
    rng = np.random.RandomState(seed)
    for t in range(commits):
        txn = ts.Transaction()
        for i in range(rng.randint(3, 15)):
            key = f"a{rng.randint(3)}/{t:02d}/k{i:03d}/.zarray"
            kv.with_transaction(txn)[key] = rng.bytes(rng.randint(0, 60))
        txn.commit_async().result()
        if t == 1:  # a later commit deletes and overwrites
            victim = sorted(kv.list().result())[0]
            del kv[victim]
            kv[sorted(kv.list().result())[-1]] = b"rewritten"
    return kv


@pytest.mark.parametrize("case", sorted(OCDBT_CASES))
def test_ocdbt_stores_read_as_tensorstore_reads_them(tmp_path, case):
    config, commits = OCDBT_CASES[case]
    kv = _write_store(tmp_path, config, commits)
    keys = sorted(k.decode() for k in kv.list().result())
    store = OcdbtStore(tmp_path)
    assert store.list() == keys
    for key in keys:
        assert store.read(key) == kv[key], key
    assert store.list("a1/") == [k for k in keys if k.startswith("a1/")]
    with pytest.raises(KeyError):
        store.read("absent")
    if case == "small_nodes":
        assert store.height >= 2
        assert any(not isinstance(v, bytes) for v in store._values.values())
        assert len(list((tmp_path / "d").iterdir())) > 1


def test_an_emptied_store_lists_nothing(tmp_path):
    kv = ts.KvStore.open({"driver": "ocdbt",
                          "base": f"file://{tmp_path}"}).result()
    kv["x"] = b"1"
    del kv["x"]
    store = OcdbtStore(tmp_path)
    assert store.list() == [] and store.height is None


@pytest.mark.parametrize("target", ["manifest", "node"])
def test_a_damaged_manifest_or_node_fails_its_crc(tmp_path, target):
    _write_store(tmp_path, {"max_decoded_node_bytes": 200}, 2)
    # a bit of the body just before the CRC: a commit writes its root
    # node last, at the end of its data file
    paths = ([tmp_path / "manifest.ocdbt"] if target == "manifest"
             else list((tmp_path / "d").iterdir()))
    for path in paths:
        data = bytearray(path.read_bytes())
        data[-5] ^= 0x40
        path.write_bytes(bytes(data))
    with pytest.raises(OcdbtError, match="CRC-32C"):
        OcdbtStore(tmp_path)


def test_orbax_data_files_resolve_through_the_merged_manifest(tmp_path):
    # Orbax's top-level tree names its data as ocdbt.process_0/d/...
    store = OcdbtStore(FIXTURE / "eegnet.orbax")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": "file://" + str(
        FIXTURE / "eegnet.orbax")}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    assert store.list() == keys and "params.classifier.kernel/0.0" in keys
    for key in keys:
        assert store.read(key) == kv[key]


# --------------------------------------------------------------------------
# JAX-written directories in the port
# --------------------------------------------------------------------------

def _jax_model_and_variables(name):
    if name in ("product", "small"):
        c, t, f1, d = GEOMETRIES[name]
        params, bs = jax_variables(c, t, f1, d, seed=11)
        meta = {"model": "eegnet", "n_channels": c, "n_times": t, "F1": f1,
                "D": d}
        return "eegnet", jax_model(c, t, f1, d), params, bs, meta, (c, t)
    c, t = BASELINES[name]
    model, params, bs = jax_baseline(name, c, t, seed=12)
    return (name, model, params, bs,
            {"model": name, "n_channels": c, "n_times": t}, (c, t))


@pytest.mark.parametrize("name", ["product", "small", "shallow_convnet",
                                  "deep_convnet"])
def test_jax_written_directories_load_exactly(tmp_path, name):
    arch, model, params, bs, meta, (c, t) = _jax_model_and_variables(name)
    if name == "product":  # jax.Array leaves, as a trainer's device state
        params, bs = (jax.tree_util.tree_map(jnp.asarray, x)
                      for x in (params, bs))
    path = jax_orbax.save_orbax_checkpoint(tmp_path / "ck", params, bs, meta)
    assert (path / "manifest.ocdbt").is_file()
    want_p, want_b, want_meta = jax_orbax.load_orbax_checkpoint(path)
    tree = orbax_io.read_tree(path)
    _assert_trees_equal(tree["params"], want_p)
    _assert_trees_equal(tree["batch_stats"], want_b)
    sd, got_meta = orbax_io.load_orbax_checkpoint(path)
    assert got_meta == want_meta == meta
    assert port_digest(*ckpt_lib.to_jax_variables(sd)) == \
        jax_digest(want_p, want_b)
    port = load_model_from_checkpoint(path, device="cpu")
    assert model_digest(port) == jax_digest(want_p, want_b)
    x = trials(8, c, t, seed=13)
    want = np.asarray(model.apply({"params": want_p, "batch_stats": want_b},
                                  jnp.asarray(x), train=False))
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_TOL[arch])


# --------------------------------------------------------------------------
# Port-written directories in the JAX package
# --------------------------------------------------------------------------

def _port_state_dict(name):
    _, _, params, bs, meta, _ = _jax_model_and_variables(name)
    return ckpt_lib.from_jax_variables(params, bs), meta


def _moments(sd, seed):
    rng = np.random.RandomState(seed)
    return {k: torch.from_numpy(rng.randn(*v.shape).astype(np.float32))
            for k, v in sd.items()
            if not k.endswith(("running_mean", "running_var",
                               "num_batches_tracked"))}


@pytest.mark.parametrize("name", ["small", "deep_convnet"])
def test_port_written_directories_load_in_the_jax_package(tmp_path, name):
    sd, meta = _port_state_dict(name)
    path = orbax_io.save_orbax_checkpoint(tmp_path / "ck", sd, meta)
    meta_json = json.loads((path / "_METADATA").read_text())
    assert meta_json["use_ocdbt"] is False
    params, bs, got_meta = jax_orbax.load_orbax_checkpoint(path)
    assert got_meta == meta
    want_p, want_b = ckpt_lib.to_jax_variables(sd)
    _assert_trees_equal(params, want_p)
    _assert_trees_equal(bs, want_b)
    assert jax_digest(params, bs) == port_digest(want_p, want_b)
    for chunk in path.glob("*/0*"):
        assert chunk.read_bytes()[:4] == b"\x28\xb5\x2f\xfd"


def test_port_adam_state_restores_in_the_jax_package(tmp_path):
    sd, meta = _port_state_dict("small")
    mu, nu = _moments(sd, 1), {k: v.abs() for k, v in _moments(sd, 2).items()}
    path = orbax_io.save_orbax_checkpoint(
        tmp_path / "ck", sd, meta, opt_state={"count": 7, "mu": mu, "nu": nu},
        step=7)
    state, step, got_meta = jax_orbax.load_orbax_train_state(
        path, make_optimizer())
    assert step == 7 and got_meta == meta
    adam = state.opt_state[0]
    assert int(adam.count) == 7 and np.asarray(adam.count).dtype == np.int32
    want_mu, _ = ckpt_lib.to_jax_variables({**sd, **mu})
    want_nu, _ = ckpt_lib.to_jax_variables({**sd, **nu})
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, adam.mu), want_mu)
    _assert_trees_equal(jax.tree_util.tree_map(np.asarray, adam.nu), want_nu)
    # and back: the JAX moments in the port's names
    _, opt, step2, _ = orbax_io.load_orbax_train_state(path)
    assert step2 == 7 and opt["count"] == 7
    for k in mu:
        assert torch.equal(opt["mu"][k], mu[k]) and torch.equal(
            opt["nu"][k], nu[k]), k


def test_jax_adam_state_restores_in_the_port(tmp_path):
    c, t, f1, d = GEOMETRIES["small"]
    params, bs = jax_variables(c, t, f1, d, seed=5)
    tx = make_optimizer()
    opt_state = tx.init(params)
    opt_state = jax.tree_util.tree_map(
        lambda x: x + 0.5 if jnp.issubdtype(x.dtype, jnp.floating) else x + 4,
        opt_state)
    path = jax_orbax.save_orbax_checkpoint(
        tmp_path / "ck", params, bs, {"model": "eegnet"},
        opt_state=opt_state, step=4)
    sd, opt, step, meta = orbax_io.load_orbax_train_state(path)
    assert step == 4 and opt["count"] == 4 and meta == {"model": "eegnet"}
    want, _ = ckpt_lib.to_jax_variables({**sd, **opt["mu"]})
    _assert_trees_equal(want, jax.tree_util.tree_map(np.asarray,
                                                     opt_state[0].mu))


# --------------------------------------------------------------------------
# The twins of tests/test_orbax_io.py
# --------------------------------------------------------------------------

SMALL = GEOMETRIES["small"]


@pytest.fixture
def small_net():
    c, t, f1, d = SMALL
    params, bs = jax_variables(c, t, f1, d, seed=0)
    return port_model(params, bs, c, t, f1, d).eval()


def test_roundtrip_and_metadata(tmp_path, small_net):
    meta = {"model": "eegnet", "n_times": 64}
    p = orbax_io.save_orbax_checkpoint(tmp_path / "ck_orbax",
                                       small_net.state_dict(), meta)
    sd, metadata = orbax_io.load_orbax_checkpoint(p)
    assert metadata == meta
    for k, v in small_net.state_dict().items():
        assert torch.equal(sd[k], v), k
    restored = EEGNet(8, 64, device="cpu")
    restored.load_state_dict(sd)
    x = torch.from_numpy(trials(2, 8, 64))
    with torch.no_grad():
        assert torch.equal(small_net(x), restored.eval()(x))


def test_matches_npz_format(tmp_path, small_net):
    npz = ckpt_lib.save_checkpoint(tmp_path / "ck.npz",
                                   small_net.state_dict(), {"m": 1})
    orb = orbax_io.save_orbax_checkpoint(tmp_path / "ck_orbax",
                                         small_net.state_dict(), {"m": 1})
    sd_npz, meta_npz = ckpt_lib.load_checkpoint(npz)
    sd_orb, meta_orb = orbax_io.load_orbax_checkpoint(orb)
    assert meta_npz == meta_orb and sd_npz.keys() == sd_orb.keys()
    for k in sd_npz:
        assert torch.equal(sd_npz[k], sd_orb[k]), k


def test_a_save_replaces_an_existing_directory(tmp_path, small_net):
    sd = small_net.state_dict()
    p = orbax_io.save_orbax_checkpoint(tmp_path / "ck", sd, {"v": 1})
    sd2 = {k: v + 1 if v.is_floating_point() else v for k, v in sd.items()}
    orbax_io.save_orbax_checkpoint(p, sd2, {"v": 2})
    got, meta = orbax_io.load_orbax_checkpoint(p)
    assert meta == {"v": 2}
    assert torch.equal(got["classifier.bias"], sd2["classifier.bias"])
    assert [q.name for q in tmp_path.iterdir()] == ["ck"]


def _stacked(sd):
    return {k: v[None] for k, v in sd.items()}


def test_train_state_resumes_identically(tmp_path):
    c, t, f1, d = SMALL
    params, bs = jax_variables(c, t, f1, d, seed=1, perturb_bn=False)
    model = EEGNet(c, t, F1=f1, D=d, dropout_rate=0.0, device="cpu")
    layout = steps.StateLayout.of(model)
    state = steps.TrainState.create(
        layout, _stacked(ckpt_lib.from_jax_variables(params, bs)))
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 16, c, t).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 4, (1, 16)))
    w = torch.ones(1, 16)

    def step(s):
        return steps.train_step(model, s, x, y, w, learning_rate=1e-3,
                                adam_eps=1e-7)

    for _ in range(3):  # non-trivial Adam moments
        state, _, _ = step(state)
    opt_state = {"count": int(state.count[0]),
                 "mu": {k: v[0] for k, v in
                        layout.params.views(state.mu).items()},
                 "nu": {k: v[0] for k, v in
                        layout.params.views(state.nu).items()}}
    p = orbax_io.save_orbax_checkpoint(
        tmp_path / "resume_orbax", state.state_dict(0), {"model": "eegnet"},
        opt_state=opt_state, step=3)
    sd, opt, step_n, meta = orbax_io.load_orbax_train_state(p)
    assert step_n == 3 and meta["model"] == "eegnet"
    restored = steps.TrainState(
        layout, layout.params.flatten(_stacked(sd)),
        layout.stats.flatten(_stacked(sd)),
        layout.params.flatten(_stacked(opt["mu"])),
        layout.params.flatten(_stacked(opt["nu"])),
        torch.tensor([opt["count"]], dtype=torch.int32))
    next_a, loss_a, _ = step(state)
    next_b, loss_b, _ = step(restored)
    assert float(loss_a[0]) == float(loss_b[0])
    for field in ("params", "stats", "mu", "nu", "count"):
        assert torch.equal(getattr(next_a, field), getattr(next_b, field))


def test_weights_only_is_not_resumable(tmp_path, small_net):
    p = orbax_io.save_orbax_checkpoint(tmp_path / "wo_orbax",
                                       small_net.state_dict())
    with pytest.raises(ValueError, match="not resumable"):
        orbax_io.load_orbax_train_state(p)


def test_background_save_commits_after_wait(tmp_path, small_net):
    p = orbax_io.save_orbax_checkpoint(
        tmp_path / "async_orbax", small_net.state_dict(), {"bg": True},
        background=True)
    orbax_io.wait_for_async_saves()
    sd, meta = orbax_io.load_orbax_checkpoint(p)
    assert meta == {"bg": True}
    assert torch.equal(sd["classifier.weight"],
                       small_net.state_dict()["classifier.weight"])


def test_background_save_snapshots_before_returning(tmp_path, small_net):
    sd = {k: v.clone() for k, v in small_net.state_dict().items()}
    want = sd["classifier.bias"].clone()
    p = orbax_io.save_orbax_checkpoint(tmp_path / "snap", sd, {},
                                       background=True)
    sd["classifier.bias"].add_(100.0)  # the caller's next step
    orbax_io.wait_for_async_saves()
    assert torch.equal(orbax_io.load_orbax_checkpoint(p)[0]["classifier.bias"],
                       want)


def test_missing_metadata_rejected_loudly(tmp_path, small_net):
    p = orbax_io.save_orbax_checkpoint(tmp_path / "torn",
                                       small_net.state_dict(),
                                       {"n_times": 64})
    (p / "metadata.json").unlink()
    with pytest.raises(FileNotFoundError, match="interrupted"):
        orbax_io.load_orbax_checkpoint(p)


def test_pending_set_is_bounded(tmp_path, monkeypatch, small_net):
    monkeypatch.setattr(orbax_io, "MAX_ASYNC_PENDING", 2)
    try:
        for i in range(5):
            orbax_io.save_orbax_checkpoint(
                tmp_path / f"ck{i}", small_net.state_dict(), {"i": i},
                background=True)
            assert orbax_io._pending_count() <= 2
    finally:
        orbax_io.wait_for_async_saves()
    assert orbax_io._pending_count() == 0
    for i in range(5):
        assert orbax_io.load_orbax_checkpoint(tmp_path / f"ck{i}")[1] == \
            {"i": i}


def test_concurrent_savers_keep_the_bound(tmp_path, monkeypatch, small_net):
    monkeypatch.setattr(orbax_io, "MAX_ASYNC_PENDING", 2)
    sd = small_net.state_dict()
    seen = []
    errors = []

    def saver(w):
        try:
            for i in range(3):
                orbax_io.save_orbax_checkpoint(
                    tmp_path / f"w{w}_{i}", sd, {"w": w, "i": i},
                    background=True)
                with orbax_io._ASYNC_LOCK:
                    seen.append(len(orbax_io._ASYNC_PENDING)
                                + orbax_io._ASYNC_RESERVED)
        except Exception as exc:  # noqa: BLE001 — asserted below
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=saver, args=(w,))
                   for w in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
        orbax_io.wait_for_async_saves()
    assert not errors and max(seen) <= 2
    for w in range(12):
        for i in range(3):
            assert orbax_io.load_orbax_checkpoint(
                tmp_path / f"w{w}_{i}")[1] == {"w": w, "i": i}


def test_a_failed_background_save_stays_pending(tmp_path, monkeypatch,
                                                small_net):
    real = orbax_io._write_dir

    def flaky(path, leaves):
        if path.name == "bad":
            raise OSError("disk full")
        return real(path, leaves)

    monkeypatch.setattr(orbax_io, "_write_dir", flaky)
    sd = small_net.state_dict()
    try:
        orbax_io.save_orbax_checkpoint(tmp_path / "bad", sd, {},
                                       background=True)
        orbax_io.save_orbax_checkpoint(tmp_path / "good", sd, {"ok": 1},
                                       background=True)
        with pytest.raises(RuntimeError, match="disk full") as exc:
            orbax_io.wait_for_async_saves()
        assert "still pending" in str(exc.value)
        assert orbax_io._pending_count() == 1
        assert orbax_io.load_orbax_checkpoint(tmp_path / "good")[1] == \
            {"ok": 1}
        assert not (tmp_path / "bad").exists()
    finally:
        with orbax_io._ASYNC_LOCK:
            orbax_io._ASYNC_PENDING.clear()


def test_the_drain_hook_commits_pending_saves(tmp_path, small_net):
    preempt.clear()
    try:
        p = orbax_io.save_orbax_checkpoint(tmp_path / "drained",
                                           small_net.state_dict(), {"d": 1},
                                           background=True)
        preempt.run_drain_hooks()
        assert orbax_io._pending_count() == 0
        assert json.loads((p / "metadata.json").read_text()) == {"d": 1}
    finally:
        preempt.clear()


# --------------------------------------------------------------------------
# The committed fixture
# --------------------------------------------------------------------------

def test_the_fixture_is_the_seeded_variables():
    params, bs = seeded_variables()
    got_p, got_b, meta = jax_orbax.load_orbax_checkpoint(
        FIXTURE / "eegnet.orbax")
    assert meta == METADATA
    _assert_trees_equal(got_p, params)
    _assert_trees_equal(got_b, bs)
    assert (FIXTURE / "eegnet.orbax" / "manifest.ocdbt").is_file()


def test_the_fixture_loads_in_the_port_as_its_npz_twin():
    orb = load_model_from_checkpoint(FIXTURE / "eegnet.orbax", device="cpu")
    npz = load_model_from_checkpoint(FIXTURE / "eegnet.npz", device="cpu")
    assert model_digest(orb) == model_digest(npz) == jax_digest(
        *seeded_variables())
    x = torch.from_numpy(trials(4, 22, 257, seed=3))
    with torch.no_grad():
        assert torch.equal(orb(x), npz(x))


# --------------------------------------------------------------------------
# The entry points
# --------------------------------------------------------------------------

def _train(root, fmt, monkeypatch):
    write_processed_tree(root, subjects=(1,))
    monkeypatch.setenv("EEGTPU_PLATFORM", "cpu")
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(root))
    monkeypatch.chdir(root)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    assert train_cli.main(["--ckptFormat", fmt, "--epochs", "1",
                           "--subjects", "1"]) == 0
    return root / "models"


def _predict(capsys, argv):
    capsys.readouterr()
    assert predict_main(argv + ["--subject", "1"]) in (0, None)
    return [line for line in capsys.readouterr().out.splitlines()
            if line.startswith(("predicted", "accuracy"))]


def test_train_orbax_writes_what_the_jax_loader_and_predict_read(
        tmp_path, monkeypatch, capsys):
    npz_models = _train(tmp_path / "npz", "npz", monkeypatch)
    models = _train(tmp_path / "orbax", "orbax", monkeypatch)
    ck = models / "subject_01_best_model.orbax"
    params, bs, meta = jax_orbax.load_orbax_checkpoint(ck)
    npz = npz_models / "subject_01_best_model.npz"
    assert meta == json.loads(bytes(np.load(npz)["__metadata__"]).decode())
    assert jax_digest(params, bs) == model_digest(
        load_model_from_checkpoint(npz, device="cpu"))
    want = _predict(capsys, ["--checkpoint", str(npz)])
    assert want and _predict(capsys, ["--checkpoint", str(ck)]) == want
    assert _predict(capsys, ["--zoo", f"a={ck},b={npz}", "--model",
                             "a"]) == want


def test_reload_to_an_orbax_directory(tmp_path):
    c, t, f1, d = SMALL
    meta = {"model": "eegnet", "n_channels": c, "n_times": t, "F1": f1,
            "D": d}
    first = ckpt_lib.save_checkpoint(
        tmp_path / "a.npz",
        ckpt_lib.from_jax_variables(*jax_variables(c, t, f1, d, seed=30)),
        meta)
    sd = ckpt_lib.from_jax_variables(*jax_variables(c, t, f1, d, seed=31))
    second = orbax_io.save_orbax_checkpoint(tmp_path / "b.orbax", sd, meta)
    twin = ckpt_lib.save_checkpoint(tmp_path / "b.npz", sd, meta)
    app = service.ServeApp(first, port=0, buckets=(1, 8),
                           device="cpu").start()
    try:
        req = urllib.request.Request(
            app.url + "/reload", method="POST",
            data=json.dumps({"checkpoint": str(second)}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            reply = json.loads(resp.read().decode())
        with urllib.request.urlopen(app.url + "/healthz", timeout=60) as r:
            health = json.loads(r.read().decode())
    finally:
        app.stop()
    want = model_digest(load_model_from_checkpoint(twin, device="cpu"))
    assert reply["model_digest"] == health["model_digest"] == want
    assert health["variables_digest"] == want
