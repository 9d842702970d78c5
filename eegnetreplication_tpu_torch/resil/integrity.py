"""Checkpoint content integrity: embedded sha256 digests.

The port's copy of ``eegnetreplication_tpu/resil/integrity.py``.  The digest
is byte-identical to the JAX package's for the same entries, so a checkpoint
written by either package verifies in the other, and the serving identity
(``serve/engine.py::variables_digest``) agrees across them.

Every native checkpoint embeds a sha256 of its array payload (the
``__sha256__`` npz entry); loaders verify it and raise
:class:`IntegrityError` on mismatch.  The digest covers every entry except
``__signature__`` and itself.
"""

from __future__ import annotations

import hashlib
from typing import Mapping

import numpy as np

DIGEST_KEY = "__sha256__"
_EXCLUDED = (DIGEST_KEY, "__signature__")


class IntegrityError(ValueError):
    """A checkpoint's content does not match its embedded digest."""


def content_digest(flat: Mapping[str, np.ndarray]) -> str:
    """sha256 over the sorted (key, dtype, shape, bytes) of every entry
    outside the excluded set."""
    h = hashlib.sha256()
    for key in sorted(flat):
        if key in _EXCLUDED:
            continue
        arr = np.ascontiguousarray(np.asarray(flat[key]))
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def stamp(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Embed the content digest into ``flat`` (in place; returned for
    chaining)."""
    flat[DIGEST_KEY] = np.frombuffer(
        content_digest(flat).encode(), dtype=np.uint8)
    return flat


def stored_digest(flat: Mapping[str, np.ndarray]) -> str | None:
    """The embedded digest, or ``None`` for pre-integrity legacy files."""
    if DIGEST_KEY not in flat:
        return None
    return bytes(np.asarray(flat[DIGEST_KEY])).decode()


def verify(flat: Mapping[str, np.ndarray], what: str = "checkpoint") -> None:
    """Raise :class:`IntegrityError` when ``flat`` carries a digest that
    does not match its content.  Digest-less (legacy) files pass."""
    stored = stored_digest(flat)
    if stored is None:
        return
    actual = content_digest(flat)
    if actual != stored:
        raise IntegrityError(
            f"{what}: content digest mismatch (stored {stored[:12]}..., "
            f"recomputed {actual[:12]}...) — the file is corrupt or was "
            "modified after save")
