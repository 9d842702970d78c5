"""The port's ``fetch`` against the JAX package's, over in-process doubles.

Neither ``kagglehub`` nor ``moabb`` is installed here, and no test reaches
the network: the doubles are the ones ``tests/test_fetch_doubles.py``
builds (exactly the API slice each fetcher touches), and both packages'
fetchers run against them side by side:

- the kaggle mirror: the same tree (names and bytes) under ``data/raw``;
- a re-fetch over a stale tree, with a file where the cache has a
  directory and a directory where it has a file, and a stale entry the
  cache does not name (kept);
- an orphaned ``.raw.old.<dead pid>`` tree (a fetch killed between its two
  renames) restored the same way, and a dead staging tree cleared;
- the moabb layout: the same per-run ``.fif`` names and bytes, one pacing
  sleep per run;
- the same errors for a missing package, an unknown moabb dataset and an
  unknown ``--src``;
- ``fetch.download`` armed ``times=1``: the first download raises, the
  retry fetches, and both make the same attempts and journal the same
  ``fault_injected`` and ``retry`` rows.
"""

import dataclasses
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import pytest
from torch_port_cases import journal_sequence

from eegnetreplication_tpu import config as jax_config
from eegnetreplication_tpu import fetch as jax_fetch
from eegnetreplication_tpu.obs import journal as jax_journal
from eegnetreplication_tpu.obs import schema as jax_schema
from eegnetreplication_tpu.resil import inject as jax_inject
from eegnetreplication_tpu_torch import config, fetch
from eegnetreplication_tpu_torch.obs import journal, schema
from eegnetreplication_tpu_torch.resil import inject

PKGS = {
    "jax": types.SimpleNamespace(fetch=jax_fetch, Paths=jax_config.Paths,
                                 journal=jax_journal, schema=jax_schema,
                                 inject=jax_inject),
    "port": types.SimpleNamespace(fetch=fetch, Paths=config.Paths,
                                  journal=journal, schema=schema,
                                  inject=inject),
}


def tree(root: Path) -> dict:
    """Every entry under ``root``: directories as None, files as bytes."""
    return {p.relative_to(root).as_posix(): (None if p.is_dir()
                                             else p.read_bytes())
            for p in sorted(root.rglob("*"))}


def kagglehub(cache: Path, calls: list):
    mod = types.ModuleType("kagglehub")

    def dataset_download(dataset):
        calls.append(dataset)
        return str(cache)

    mod.dataset_download = dataset_download
    return mock.patch.dict(sys.modules, {"kagglehub": mod})


def moabb(subjects=(1,), runs=("run_0",)):
    saved: list[str] = []

    class FakeRaw:
        def __init__(self, subject, session, run):
            self.body = f"raw-fif {subject} {session} {run}".encode()

        def save(self, path, overwrite=False):
            assert overwrite is True
            Path(path).write_bytes(self.body)
            saved.append(Path(path).name)

    class FakeBNCI2014001:
        subject_list = list(subjects)

        def get_data(self, subjects):
            (subject,) = subjects
            return {subject: {s: {r: FakeRaw(subject, s, r) for r in runs}
                              for s in ("0train", "1test")}}

    datasets_mod = types.ModuleType("moabb.datasets")
    datasets_mod.BNCI2014001 = FakeBNCI2014001
    moabb_mod = types.ModuleType("moabb")
    moabb_mod.datasets = datasets_mod
    return mock.patch.dict(sys.modules, {
        "moabb": moabb_mod, "moabb.datasets": datasets_mod}), saved


def write_cache(cache: Path) -> None:
    for rel, body in (("Train/A01T.gdf", b"gdf-T"), ("Eval/A01E.gdf",
                                                     b"gdf-E"),
                      ("TrueLabels/A01E.mat", b"mat"), ("README", b"doc")):
        (cache / rel).parent.mkdir(parents=True, exist_ok=True)
        (cache / rel).write_bytes(body)


def _reaped_pid() -> int:
    """The pid of a process that has exited (an orphan's dead owner)."""
    proc = subprocess.Popen(["true"])
    proc.wait()
    return proc.pid


def test_the_constants_and_the_retry_budget_equal_jax():
    assert (config.KAGGLE_DATASET, config.MOABB_DATASET) \
        == (jax_config.KAGGLE_DATASET, jax_config.MOABB_DATASET)
    assert [f.name for f in dataclasses.fields(config.Paths)] \
        == [f.name for f in dataclasses.fields(jax_config.Paths)]
    port, ref = (config.Paths.from_root(Path("/r")),
                 jax_config.Paths.from_root(Path("/r")))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    fields = ("max_attempts", "base_delay_s", "multiplier", "max_delay_s",
              "jitter", "retry_on", "deadline_s")
    assert {f: getattr(fetch.DOWNLOAD_RETRY, f) for f in fields} \
        == {f: getattr(jax_fetch.DOWNLOAD_RETRY, f) for f in fields}
    assert list(fetch.FETCHERS) == list(jax_fetch.FETCHERS) \
        == ["kaggle", "moabb"]


def test_kaggle_mirrors_the_same_tree(tmp_path):
    cache = tmp_path / "cache"
    write_cache(cache)
    out = {}
    for key, pkg in PKGS.items():
        paths = pkg.Paths.from_root(tmp_path / key)
        calls = []
        with kagglehub(cache, calls):
            got = pkg.fetch.fetch_from_kaggle(paths=paths)
        assert got == paths.data_raw
        out[key] = (calls, tree(paths.data_raw))
    assert out["port"] == out["jax"]
    assert out["port"][0] == [config.KAGGLE_DATASET]
    assert out["port"][1]["Train/A01T.gdf"] == b"gdf-T"


def _stale_tree(raw: Path) -> None:
    """A previous mirror that disagrees with the cache in every way."""
    (raw / "Train").mkdir(parents=True)
    (raw / "Train" / "orphan.gdf").write_bytes(b"old")     # dir replaced
    (raw / "TrueLabels").write_bytes(b"a file, now a dir")  # file -> dir
    (raw / "README").mkdir()                                # dir -> file
    (raw / "README" / "inner").write_bytes(b"x")
    (raw / "keep.txt").write_bytes(b"not in the cache")     # kept


def test_a_refetch_over_a_stale_tree_ends_the_same(tmp_path):
    cache = tmp_path / "cache"
    write_cache(cache)
    out = {}
    for key, pkg in PKGS.items():
        paths = pkg.Paths.from_root(tmp_path / key)
        _stale_tree(paths.data_raw)
        with kagglehub(cache, []):
            pkg.fetch.fetch_from_kaggle(paths=paths)
        out[key] = (tree(paths.data_raw),
                    sorted(p.name for p in paths.data_raw.parent.iterdir()))
    assert out["port"] == out["jax"]
    got = out["port"][0]
    assert "Train/orphan.gdf" not in got and got["keep.txt"] \
        == b"not in the cache"
    assert got["TrueLabels"] is None and got["README"] == b"doc"
    assert out["port"][1] == ["raw"]   # no staging or retired tree left


def test_an_orphaned_retired_tree_is_restored_the_same_way(tmp_path):
    cache = tmp_path / "cache"
    write_cache(cache)
    pid = _reaped_pid()
    out = {}
    for key, pkg in PKGS.items():
        paths = pkg.Paths.from_root(tmp_path / key)
        parent = paths.data_raw.parent
        old = parent / f".raw.old.{pid}"
        (old / "Train").mkdir(parents=True)
        (old / "Train" / "A09T.gdf").write_bytes(b"previous mirror")
        (old / "previous.txt").write_bytes(b"kept from the old tree")
        staging = parent / f".raw.staging.{pid}"
        (staging / "half").mkdir(parents=True)
        with kagglehub(cache, []):
            pkg.fetch.fetch_from_kaggle(paths=paths)
        out[key] = (tree(paths.data_raw), sorted(p.name for p in
                                                 parent.iterdir()))
    assert out["port"] == out["jax"]
    got, left = out["port"]
    assert got["previous.txt"] == b"kept from the old tree"
    assert "Train/A09T.gdf" not in got     # the cache's Train replaced it
    assert got["Train/A01T.gdf"] == b"gdf-T"
    assert left == ["raw"]


def test_moabb_writes_the_same_per_run_files(tmp_path):
    out = {}
    for key, pkg in PKGS.items():
        paths = pkg.Paths.from_root(tmp_path / key)
        patcher, saved = moabb(subjects=(1, 3), runs=("run_0", "run_5"))
        sleeps: list = []
        with patcher, mock.patch.object(pkg.fetch, "time") as t:
            t.sleep = sleeps.append
            got = pkg.fetch.fetch_from_moabb(paths=paths)
        assert got == paths.data_moabb
        out[key] = (tree(paths.data_moabb), saved, sleeps)
    assert out["port"] == out["jax"]
    files, saved, sleeps = out["port"]
    assert sorted(saved) == sorted(
        f"A0{s}{m}_{r}.fif" for s in (1, 3) for m in "TE"
        for r in ("run_0", "run_5"))
    assert files["Train/A03T_run_5.fif"] == b"raw-fif 3 0train run_5"
    assert files["Eval/A01E_run_0.fif"] == b"raw-fif 1 1test run_0"
    assert sleeps == [1] * 8


def _error(fn):
    with pytest.raises(Exception) as exc:
        fn()
    return type(exc.value), str(exc.value)


def test_the_same_errors(tmp_path, monkeypatch):
    errors = {}
    for key, pkg in PKGS.items():
        paths = pkg.Paths.from_root(tmp_path / key)
        with mock.patch.dict(sys.modules, {"kagglehub": None}):
            no_kaggle = _error(lambda: pkg.fetch.fetch_from_kaggle(
                paths=paths))
        with mock.patch.dict(sys.modules, {"moabb": None,
                                           "moabb.datasets": None}):
            no_moabb = _error(lambda: pkg.fetch.fetch_from_moabb(
                paths=paths))
        patcher, _ = moabb()
        with patcher:
            unknown = _error(lambda: pkg.fetch.fetch_from_moabb(
                dataset="NotADataset", paths=paths))
        monkeypatch.setattr(sys, "argv", ["fetch", "--src", "physionet"])
        src = _error(pkg.fetch.main)
        errors[key] = (no_kaggle, no_moabb, unknown, src)
    assert errors["port"] == errors["jax"]
    (k, _), (m, _), unknown, src = errors["port"]
    assert k is m is ImportError
    assert unknown == (ValueError, "Unknown moabb dataset: NotADataset")
    assert src == (ValueError, "Unknown source: physionet")
    assert "kagglehub" in errors["port"][0][1]
    assert "moabb" in errors["port"][1][1]


def test_the_port_cli_takes_argv(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    write_cache(cache)
    monkeypatch.setenv("EEGTPU_DATA_ROOT", str(tmp_path / "root"))
    with kagglehub(cache, []):
        fetch.main(["--src", "kaggle"])
    assert tree(tmp_path / "root" / "data" / "raw") == tree(cache)


@pytest.mark.parametrize("src", ["kaggle", "moabb"])
def test_an_injected_download_fault_is_retried_as_in_jax(src, tmp_path,
                                                         monkeypatch):
    cache = tmp_path / "cache"
    write_cache(cache)
    out = {}
    for key, pkg in PKGS.items():
        # The same budget without the waits (the backoff curve is pinned
        # equal above).
        monkeypatch.setattr(pkg.fetch, "DOWNLOAD_RETRY", dataclasses.replace(
            pkg.fetch.DOWNLOAD_RETRY, base_delay_s=0.0, jitter=0.0))
        paths = pkg.Paths.from_root(tmp_path / key)
        calls = []
        patcher, saved = moabb()
        pkg.inject.arm("fetch.download", times=1)
        try:
            with pkg.journal.run(tmp_path / f"{key}-obs", config={}) as jr, \
                    kagglehub(cache, calls), patcher, \
                    mock.patch.object(pkg.fetch, "time"):
                pkg.fetch.FETCHERS[src](paths=paths)
        finally:
            pkg.inject.disarm_all()
        events = pkg.schema.read_events(jr.events_path, complete=False)
        assert not any("_schema_error" in e for e in events), events
        rows = journal_sequence(events, ("fault_injected", "retry"))
        out[key] = (calls, sorted(saved), rows,
                    tree(paths.data_raw if src == "kaggle"
                         else paths.data_moabb))
    assert out["port"] == out["jax"]
    calls, saved, rows, files = out["port"]
    assert [r[0] for r in rows] == ["fault_injected", "retry"]
    retry = dict(rows[1][2])
    assert retry["site"] == "'fetch.download'"
    assert retry["attempt"] == "1" and retry["max_attempts"] == "4"
    assert retry["classification"] == "'transient'"
    if src == "kaggle":
        # One download reached the transport: the injected one never did.
        assert calls == [config.KAGGLE_DATASET] and files == tree(cache)
    else:
        assert saved == ["A01E_run_0.fif", "A01T_run_0.fif"]


@pytest.mark.parametrize("deadline_s, attempts", [(None, 4), (0.0, 1)])
def test_the_retry_deadline_stops_retries_as_in_jax(deadline_s, attempts):
    """``DOWNLOAD_RETRY``'s ``deadline_s``: no attempt starts past it, in
    both packages' ``resil.retry.call``."""
    from eegnetreplication_tpu.resil import retry as jax_retry
    from eegnetreplication_tpu_torch.resil import retry

    counts = {}
    for key, mod in (("jax", jax_retry), ("port", retry)):
        policy = mod.RetryPolicy(max_attempts=4, base_delay_s=0.0,
                                 jitter=0.0, deadline_s=deadline_s,
                                 retry_on=(mod.TRANSIENT,))
        calls = []

        def flaky():
            calls.append(1)
            raise ConnectionError("down")

        with pytest.raises(ConnectionError):
            mod.call(flaky, policy=policy, site="fetch.download")
        counts[key] = len(calls)
    assert counts == {"jax": attempts, "port": attempts}
