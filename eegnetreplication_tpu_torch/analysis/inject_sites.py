"""Pass 2 — inject sites: every site literal vs ``resil/inject.py SITES``.

Rules:

- ``inject-site-unknown``      — a literal site passed to ``fire``/``arm``
  (first positional arg) or ``FaultSpec(site=...)`` is not in ``SITES``.
- ``chaos-plan-unknown-site``  — a chaos-plan string literal (the value
  after a literal ``"--chaos"`` in a command list, a literal ``chaos=``
  kwarg, or a literal ``parse_plan(...)`` argument) names a site outside
  ``SITES``.
- ``chaos-plan-unknown-option``— a plan string uses an option key that is
  not a ``FaultSpec`` field (``sleeep=5`` fails at lint time, not when
  the drill is minutes in).
- ``inject-site-unprobed``     — a declared site that no ``fire(...)``
  call (positional or ``site=`` keyword literal) and no probe wrapper's
  ``site="..."`` parameter default ever probes: dead chaos surface.

Alias resolution is import-aware per file: only calls that resolve to
the port's ``resil.inject`` count, so an unrelated local ``arm()`` never
trips the pass.  The port's copy of
``eegnetreplication_tpu/analysis/inject_sites.py``.
"""

from __future__ import annotations

import ast

from eegnetreplication_tpu_torch.analysis.core import (
    PACKAGE,
    Contracts,
    Finding,
    Project,
    SourceFile,
    dotted_name,
    str_const,
)

RULE_UNKNOWN = "inject-site-unknown"
RULE_PLAN_SITE = "chaos-plan-unknown-site"
RULE_PLAN_OPTION = "chaos-plan-unknown-option"
RULE_UNPROBED = "inject-site-unprobed"

RULE_CONTRACT = "contract-missing"

RULES = (RULE_UNKNOWN, RULE_PLAN_SITE, RULE_PLAN_OPTION, RULE_UNPROBED,
         RULE_CONTRACT)

_INJECT_MODULE = f"{PACKAGE}.resil.inject"
_INJECT_FUNCS = ("fire", "arm", "scoped", "parse_plan", "FaultSpec")


def _inject_aliases(sf: SourceFile) -> tuple[set[str], dict[str, str]]:
    """(module aliases, local func name -> inject func name) for one file."""
    modules: set[str] = set()
    funcs: dict[str, str] = {}
    for node in sf.nodes():
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == _INJECT_MODULE:
                    modules.add(alias.asname or alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.module == _INJECT_MODULE:
                for alias in node.names:
                    if alias.name in _INJECT_FUNCS:
                        funcs[alias.asname or alias.name] = alias.name
            elif node.module.endswith(".resil") or node.module == "resil":
                for alias in node.names:
                    if alias.name == "inject":
                        modules.add(alias.asname or "inject")
    # The defining module itself calls its own functions bare.
    if sf.rel.endswith("resil/inject.py"):
        for fn in _INJECT_FUNCS:
            funcs.setdefault(fn, fn)
    return modules, funcs


def _resolve_call(node: ast.Call, modules: set[str],
                  funcs: dict[str, str]) -> str | None:
    """The inject function name this call resolves to, or None."""
    if isinstance(node.func, ast.Name):
        return funcs.get(node.func.id)
    dn = dotted_name(node.func)
    if dn is None:
        return None
    head, _, tail = dn.rpartition(".")
    if head in modules and tail in _INJECT_FUNCS:
        return tail
    return None


def _check_plan(plan: str, sf: SourceFile, line: int,
                contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    if plan.startswith("@"):
        return findings  # file plans are validated when parsed
    valid_options = contracts.faultspec_fields - {"site"}
    for chunk in plan.split(","):
        chunk = chunk.strip()
        if not chunk:
            continue
        site, *opts = chunk.split(":")
        if site not in contracts.sites:
            findings.append(Finding(
                rule=RULE_PLAN_SITE, file=sf.rel, line=line, symbol=site,
                message=f"chaos plan names unknown site {site!r} "
                        f"(SITES in {contracts.inject_rel})"))
        for opt in opts:
            key = opt.split("=", 1)[0]
            if valid_options and key not in valid_options:
                findings.append(Finding(
                    rule=RULE_PLAN_OPTION, file=sf.rel, line=line,
                    symbol=f"{site}:{key}",
                    message=f"chaos plan option {key!r} is not a FaultSpec "
                            f"field (valid: "
                            f"{', '.join(sorted(valid_options))})"))
    return findings


def _body_fires_param(fn: ast.AST, param: str, modules: set[str],
                      funcs: dict[str, str]) -> bool:
    """True when ``fn``'s body passes the ``param`` name to inject
    ``fire(...)`` (positionally or as ``site=``)."""
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call)
                and _resolve_call(node, modules, funcs) == "fire"):
            continue
        candidates = list(node.args[:1]) + [kw.value for kw in node.keywords
                                            if kw.arg == "site"]
        if any(isinstance(c, ast.Name) and c.id == param
               for c in candidates):
            return True
    return False


def check(project: Project, contracts: Contracts) -> list[Finding]:
    findings: list[Finding] = []
    probed: set[str] = set()
    if not contracts.sites:
        # Same guard as journal-events: a non-literal SITES refactor
        # breaks extraction; report that once instead of flagging every
        # fire()/plan literal in the tree as unknown.
        return [Finding(
            rule=RULE_CONTRACT, file=contracts.inject_rel, line=1,
            symbol="SITES",
            message="SITES could not be extracted as a pure literal "
                    "tuple; the inject-sites pass cannot run")]
    if not contracts.faultspec_fields:
        # Plan-option validation keys off FaultSpec's annotated fields;
        # losing them (rename, base-class move) must be loud, or the
        # "sleeep=5 fails at lint time" promise silently dies.
        findings.append(Finding(
            rule=RULE_CONTRACT, file=contracts.inject_rel, line=1,
            symbol="FaultSpec",
            message="FaultSpec field annotations could not be extracted; "
                    "the chaos-plan-unknown-option rule cannot run"))

    def check_site(site: str, sf: SourceFile, line: int) -> None:
        if site not in contracts.sites:
            findings.append(Finding(
                rule=RULE_UNKNOWN, file=sf.rel, line=line, symbol=site,
                message=f"unknown fault-injection site {site!r} "
                        f"(SITES in {contracts.inject_rel})"))

    for sf in project.python_files():
        modules, funcs = _inject_aliases(sf)
        for node in sf.nodes():
            if isinstance(node, ast.Call):
                resolved = _resolve_call(node, modules, funcs)
                if resolved in ("fire", "arm"):
                    # Positional or keyword form: fire("x") / fire(site="x").
                    site = str_const(node.args[0]) if node.args else None
                    if site is None:
                        for kw in node.keywords:
                            if kw.arg == "site":
                                site = str_const(kw.value)
                    if site is not None:
                        check_site(site, sf, node.lineno)
                        if resolved == "fire":
                            probed.add(site)
                elif resolved == "FaultSpec":
                    site = None
                    if node.args:
                        site = str_const(node.args[0])
                    for kw in node.keywords:
                        if kw.arg == "site":
                            site = str_const(kw.value)
                    if site is not None:
                        check_site(site, sf, node.lineno)
                elif resolved == "parse_plan" and node.args:
                    plan = str_const(node.args[0])
                    if plan is not None:
                        findings.extend(_check_plan(plan, sf, node.lineno,
                                                    contracts))
                # chaos="..." keyword literals anywhere (drill helpers
                # that thread a plan string down to a child --chaos).
                if resolved != "parse_plan":
                    for kw in node.keywords:
                        if kw.arg == "chaos":
                            plan = str_const(kw.value)
                            if plan is not None:
                                findings.extend(_check_plan(
                                    plan, sf, kw.value.lineno, contracts))
                # NOTE: a site= kwarg on an arbitrary (non-inject) call is
                # deliberately NOT probe credit — retry policies and
                # journal events carry site= labels too, and crediting
                # them would mask dead-site detection.  Probe wrappers
                # earn credit through their `site="..."` parameter
                # default (below), which is what configures the fire().
            elif isinstance(node, (ast.List, ast.Tuple)):
                # "--chaos", "<plan>" inside a literal command line.
                elts = node.elts
                for i, el in enumerate(elts[:-1]):
                    if str_const(el) == "--chaos":
                        plan = str_const(elts[i + 1])
                        if plan is not None:
                            findings.extend(_check_plan(
                                plan, sf, elts[i + 1].lineno, contracts))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                # def _armed_dispatch(jitted, site: str = "train.step"):
                # the default is a probe ONLY when the body fire()s that
                # parameter — retry policies and journal emitters use a
                # `site=` *label* parameter from a different namespace
                # and must be neither credited nor flagged.
                args = node.args
                all_params = args.posonlyargs + args.args + args.kwonlyargs
                defaults = ([None] * (len(args.posonlyargs + args.args)
                                      - len(args.defaults))
                            + list(args.defaults) + list(args.kw_defaults))
                for param, default in zip(all_params, defaults):
                    if param.arg == "site" and default is not None:
                        site = str_const(default)
                        if site is not None \
                                and _body_fires_param(node, param.arg,
                                                      modules, funcs):
                            # A typo'd probe-wrapper default is a dead
                            # probe: flag it, don't drop the credit.
                            check_site(site, sf, default.lineno)
                            if site in contracts.sites:
                                probed.add(site)

    for site in contracts.sites:
        if site not in probed:
            findings.append(Finding(
                rule=RULE_UNPROBED, file=contracts.inject_rel,
                line=contracts.site_decl_lines.get(site, 1), symbol=site,
                message=f"site {site!r} is declared in SITES but no "
                        f"fire(...) probe in the scanned tree ever fires "
                        f"it (dead chaos surface)"))
    return findings
