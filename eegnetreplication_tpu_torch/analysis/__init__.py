"""eegtpu-lint: AST-based contract linter for the port's string seams.

The port's copy of ``eegnetreplication_tpu/analysis``, reading
``eegnetreplication_tpu_torch/`` and ``chip_smoke.py``; it imports neither
torch nor the code it lints.  The framework is stitched together by
string-keyed contracts — journal event types (``obs/schema.py``
``EVENT_REQUIRED``), chaos-inject sites (``resil/inject.py`` ``SITES``),
the pinned ``PASSTHROUGH_HEADERS`` set (``serve/service.py``),
child-process CLI flags resolved by argparse, and the ``*_locked`` method
convention — and every review round of the JAX package caught a drift bug
in exactly these seams.  This package makes that bug class a
tier-1 test failure instead of a postmortem: stdlib-``ast`` passes (no
new dependencies, no imports of the linted code) check every literal call
site against the single-sourced contract tables, statically.

Passes (see each module's docstring for the precise rules):

- :mod:`.journal_events` — ``*.event("type", ...)`` call sites vs
  ``EVENT_REQUIRED`` (unknown types, missing required kwargs, declared
  types nobody emits / documents / summarizes);
- :mod:`.inject_sites`  — ``fire``/``arm``/``FaultSpec``/chaos-plan site
  literals vs ``SITES`` (unknown sites, unknown plan options, declared
  sites no probe fires);
- :mod:`.spawn_args`    — literal ``--flags`` on child command lines vs
  the target entry point's ``add_argument`` set (the ``--resume``
  argparse-exit bug class);
- :mod:`.lock_discipline` — ``*_locked`` methods called outside a
  ``with self._lock:`` block / non-``*_locked`` caller;
- :mod:`.jit_purity`    — code a CUDA graph captures (a
  ``capture_begin``/``capture_end`` window, a ``torch.cuda.graph`` body,
  ``make_graphed_callables``' callable) must not journal, log, read wall
  clocks, touch the metrics registry, or use Python-level RNG;
- :mod:`.single_source` — hand-spelled copies of the pinned header set
  (the dropped-``X-Model`` bug class).

Run via ``python -m eegnetreplication_tpu_torch.analysis.cli`` (text or
``--json``, ``--baseline`` for grandfathered findings that must only
shrink; the default baseline is this package's ``lint_baseline.json``),
or programmatically through :func:`run_all`.
"""

from eegnetreplication_tpu_torch.analysis.core import (  # noqa: F401
    Contracts,
    Finding,
    Project,
    apply_baseline,
    load_baseline,
)
from eegnetreplication_tpu_torch.analysis.runner import (  # noqa: F401
    PASSES,
    run_all,
)
