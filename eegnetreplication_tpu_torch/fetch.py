"""Fetch CLI: ``python -m eegnetreplication_tpu_torch.fetch``.

The port's copy of ``eegnetreplication_tpu/fetch.py`` (stdlib only; no
tensor is touched).  Flag-compatible with the reference CLI
(``src/eegnet_repl/fetch.py:96-109``): ``--src kaggle|moabb``.  Both
network backends are optional dependencies; each fetcher degrades to a
clear error naming the missing package, so the rest of the framework works
in hermetic environments (data can also be placed under ``data/raw/``
manually).

Resilience (``resil/``): downloads run under the shared retry policy
(network hiccups back off and retry instead of killing a multi-GB fetch;
site ``fetch.download`` is chaos-armable), and :func:`_mirror_into` stages
the new tree through a same-directory temp dir swapped in by rename — an
interrupted fetch can never leave a half-mirrored ``data_raw``.
"""

from __future__ import annotations

import argparse
import os
import shutil
import time
from pathlib import Path

from eegnetreplication_tpu_torch.config import (
    KAGGLE_DATASET,
    MOABB_DATASET,
    Paths,
)
from eegnetreplication_tpu_torch.resil import heartbeat, inject
from eegnetreplication_tpu_torch.resil import retry as resil_retry
from eegnetreplication_tpu_torch.utils.logging import logger

# Download retry budget: a dataset fetch is minutes of wall, so a few
# spaced attempts are cheap relative to restarting the whole mirror; the
# deadline bounds pathological flapping.
DOWNLOAD_RETRY = resil_retry.RetryPolicy(max_attempts=4, base_delay_s=1.0,
                                         max_delay_s=30.0, deadline_s=600.0,
                                         retry_on=(resil_retry.TRANSIENT,))


def _pid_alive(pid: int) -> bool:
    """Whether ``pid`` is a live process (EPERM counts as alive: it exists,
    we just may not signal it)."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except OSError:
        return True
    return True


def _mirror_into(cache_path: Path, dest: Path) -> None:
    """Copy a downloaded cache tree's entries into ``dest`` (stale replaced).

    A stale destination entry is removed whatever its shape: a re-fetch
    must win even when a plain file now sits where a directory was, or
    vice versa.

    The merge is built in a same-directory staging tree (existing ``dest``
    entries preserved by hardlink — same filesystem by construction, so no
    byte is re-copied — cache entries overlaid) and swapped in with two
    renames.  A fetch that fails mid-copy leaves the previous ``dest``
    untouched; a failure between the two renames restores it from the
    retired tree, so only a hard kill inside that microsecond window can
    strand ``dest`` (recoverable from ``.{dest}.old.*``), never a
    half-mirrored tree.
    """
    dest.parent.mkdir(parents=True, exist_ok=True)
    staging = dest.parent / f".{dest.name}.staging.{os.getpid()}"
    retired = dest.parent / f".{dest.name}.old.{os.getpid()}"
    # Leftovers from a killed prior run almost always carry a DIFFERENT
    # pid, so clean up by glob, not by this run's names — but only trees
    # whose owning pid is dead (a tree with a live owner belongs to a
    # concurrent fetch mid-swap; deleting its retired dir would destroy
    # the copy its rollback depends on).  A stranded dest (owner killed
    # inside the rename window) is first restored from the newest orphaned
    # retired tree — it is the complete previous mirror — before the rest
    # is cleared (renaming onto a non-empty dir would raise anyway).
    def orphaned(prefix: str) -> list[Path]:
        out = []
        for p in dest.parent.glob(f".{dest.name}.{prefix}.*"):
            pid = p.name.rsplit(".", 1)[-1]
            if pid.isdigit() and _pid_alive(int(pid)):
                continue
            try:
                out.append((p.stat().st_mtime, p))
            except OSError:
                continue  # a racing fetch's cleanup already reaped it
        return [p for _, p in sorted(out)]

    stale_retired = orphaned("old")
    if not dest.exists() and stale_retired:
        recovered = stale_retired.pop()
        logger.warning("Restoring %s from interrupted-fetch leftover %s",
                       dest, recovered)
        try:
            recovered.replace(dest)
        except OSError:
            pass  # a racing fetch recovered or reaped it first
    for stale in (*orphaned("staging"), *stale_retired):
        shutil.rmtree(stale, ignore_errors=True)

    def link_or_copy(src, dst, **kw):
        try:
            os.link(src, dst)
        except OSError:  # cross-device/unsupported: fall back to copying
            shutil.copy2(src, dst, **kw)

    try:
        if dest.exists():
            shutil.copytree(dest, staging, symlinks=True,
                            copy_function=link_or_copy)
        else:
            staging.mkdir()
        for entry in cache_path.iterdir():
            target = staging / entry.name
            if target.is_dir() and not target.is_symlink():
                shutil.rmtree(target)
            elif target.exists() or target.is_symlink():
                target.unlink()
            if entry.is_dir():
                shutil.copytree(entry, target)
            else:
                shutil.copy2(entry, target)
        if dest.exists():
            dest.replace(retired)
        staging.replace(dest)
    except BaseException:
        if not dest.exists() and retired.exists():
            retired.replace(dest)  # the complete old tree comes back
        shutil.rmtree(staging, ignore_errors=True)
        raise
    shutil.rmtree(retired, ignore_errors=True)


def fetch_from_kaggle(dataset: str = KAGGLE_DATASET,
                      paths: Paths | None = None) -> Path:
    """Download the kaggle mirror into ``data/raw/``.

    Twin of ``fetch_from_kaggle`` (``fetch.py:20-45``): kagglehub downloads to
    its cache; the cache contents are copied into the project's raw dir.
    """
    try:
        import kagglehub
    except ImportError as e:
        raise ImportError(
            "Fetching from kaggle requires the `kagglehub` package. Install "
            "it, or place the BCI-IV-2a files under data/raw/ manually "
            "(Train/*.gdf, Eval/*.gdf, TrueLabels/*.mat)."
        ) from e

    paths = paths or Paths.from_here()

    def download() -> str:
        heartbeat.beat("fetch", src="kaggle")
        inject.fire("fetch.download", src="kaggle", dataset=dataset)
        return kagglehub.dataset_download(dataset)

    cache = resil_retry.call(download, policy=DOWNLOAD_RETRY,
                             site="fetch.download")
    _mirror_into(Path(cache), paths.data_raw)
    logger.info("Copied kaggle dataset into %s", paths.data_raw)
    return paths.data_raw


def _run_fif_name(subject: int, is_train: bool, run_name: str) -> str:
    """Per-run .fif filename in the reference's moabb layout."""
    return f"A0{subject}{'T' if is_train else 'E'}_{run_name}.fif"


def fetch_from_moabb(dataset: str = MOABB_DATASET,
                     paths: Paths | None = None) -> Path:
    """Download BNCI2014_001 via moabb into ``data/moabb/{Train,Eval}``.

    Twin of ``fetch_from_moabb`` (``fetch.py:47-94``), including the per-run
    ``.fif`` layout and 1 s politeness sleep.  The reference README marks the
    downstream moabb pipeline "Non-functional" (quirk Q3); fetching works,
    further processing lives in ``data/moabb.py`` (repaired here).
    """
    try:
        from moabb.datasets import BNCI2014001
    except ImportError as e:
        raise ImportError(
            "Fetching from moabb requires the `moabb` package (and MNE). "
            "Use --src kaggle instead."
        ) from e

    if dataset != MOABB_DATASET:
        logger.error("Unknown moabb dataset specified: %s", dataset)
        raise ValueError(f"Unknown moabb dataset: {dataset}")

    paths = paths or Paths.from_here()
    session_dirs = {True: paths.data_moabb / "Train",
                    False: paths.data_moabb / "Eval"}
    for d in session_dirs.values():
        d.mkdir(parents=True, exist_ok=True)

    source = BNCI2014001()
    for subject in source.subject_list:
        logger.info("Fetching data for subject: %s", subject)

        def download(subject=subject):
            heartbeat.beat("fetch", src="moabb", subject=subject)
            inject.fire("fetch.download", src="moabb", subject=subject)
            return source.get_data(subjects=[subject])[subject]

        # Per-subject retry: one flaky subject download backs off and
        # retries without re-fetching the subjects already saved.
        per_session = resil_retry.call(download, policy=DOWNLOAD_RETRY,
                                       site="fetch.download")
        for session, runs in per_session.items():
            is_train = session == "0train"
            for run_name, raw in runs.items():
                out_path = (session_dirs[is_train]
                            / _run_fif_name(subject, is_train, run_name))
                raw.save(out_path, overwrite=True)
                logger.info("Saved subject=%s session=%s run=%s to %s",
                            subject, session, run_name, out_path)
                time.sleep(1)  # be polite to the server
    return paths.data_moabb


FETCHERS = {"kaggle": fetch_from_kaggle, "moabb": fetch_from_moabb}


def main(argv=None) -> None:
    """CLI entrypoint (flags as in ``fetch.py:96-109``)."""
    parser = argparse.ArgumentParser(
        description="Fetch BCI Competition IV Dataset 2a from source.")
    parser.add_argument("--src", default="kaggle",
                        help="Specify source (options: kaggle, moabb).")
    args = parser.parse_args(argv)

    logger.info("Fetching data from source: %s", args.src)
    fetcher = FETCHERS.get(args.src)
    if fetcher is None:
        logger.error("Unknown source specified: %s", args.src)
        raise ValueError(f"Unknown source: {args.src}")
    fetcher()


if __name__ == "__main__":
    main()
