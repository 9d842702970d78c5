"""Application logger.

The port's copy of ``eegnetreplication_tpu/utils/logging.py``: a root
logger at DEBUG with a file sink and a console sink in the reference's exact
format (``LOG_FORMAT``), so log-scraping consumers see identical lines from
either package.  Configured lazily and idempotently: a process that already
has root handlers (a test runner, the JAX package in the same process) keeps
them.  ``EEGTPU_NO_LOG_FILE=1`` skips the file sink, ``EEGTPU_LOG_FILE``
names it, and ``EEGTPU_DATA_ROOT`` moves the default
``<root>/reports/logs/app-<pid>.log``.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

LOG_FORMAT = "%(asctime)s - %(filename)s - %(funcName)s - %(levelname)s - %(message)s"

# How many per-pid log files survive in the default sink directory.
LOG_KEEP = 20

_configured = False


def default_log_file() -> str:
    """``EEGTPU_LOG_FILE`` when set, else
    ``<data root>/reports/logs/app-<pid>.log``."""
    explicit = os.environ.get("EEGTPU_LOG_FILE")
    if explicit:
        return explicit
    env_root = os.environ.get("EEGTPU_DATA_ROOT")
    root = Path(env_root) if env_root \
        else Path(__file__).resolve().parents[2]
    return str(root / "reports" / "logs" / f"app-{os.getpid()}.log")


def _prune_old_logs(log_dir: Path, keep: int = LOG_KEEP) -> None:
    """Best-effort: drop all but the ``keep`` newest ``app-*.log`` files."""
    try:
        logs = sorted(log_dir.glob("app-*.log"),
                      key=lambda p: p.stat().st_mtime, reverse=True)
        for stale in logs[keep:]:
            stale.unlink(missing_ok=True)
    except OSError:
        pass


def configure(log_file: str | None = None,
              level: int = logging.DEBUG) -> logging.Logger:
    """Configure the root logger once; return it."""
    global _configured
    root = logging.getLogger()
    if _configured:
        return root
    if not root.handlers:
        handlers: list[logging.Handler] = [logging.StreamHandler()]
        if not os.environ.get("EEGTPU_NO_LOG_FILE"):
            path = Path(log_file or default_log_file())
            try:
                path.parent.mkdir(parents=True, exist_ok=True)
                if not os.environ.get("EEGTPU_LOG_FILE"):
                    _prune_old_logs(path.parent)
                handlers.insert(0, logging.FileHandler(path))
            except OSError:
                pass  # read-only tree: console-only logging
        formatter = logging.Formatter(LOG_FORMAT)
        for h in handlers:
            h.setFormatter(formatter)
            root.addHandler(h)
        root.setLevel(level)
    for noisy in ("asyncio", "urllib3"):
        logging.getLogger(noisy).setLevel(logging.WARNING)
    _configured = True
    return root


logger = configure()
