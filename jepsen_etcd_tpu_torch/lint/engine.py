"""graftlint engine: module parsing, suppressions, baseline, runner.

The engine is pure ``ast`` + ``tokenize`` — it never imports the code
it scans (importing ops/ would pull in torch; importing workloads would
pull in the whole harness), so it runs in milliseconds under tier-1.

Suppression grammar (tokenized, so strings can't false-match)::

    expr  # graftlint: ignore[RULE1,RULE2] reason text

A standalone comment line applies to the next source line. The rule
list accepts exact ids (``COL001``) or families (``COL``). A
suppression must carry a reason (else LINT002), must suppress
something (else LINT001 orphan), and a baseline entry must still match
a live finding (else LINT004) — the grandfather inventory can only
shrink.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Any, Iterable, Optional

from .callgraph import CallGraph, MODULE_SCOPE
from .policy import Policy

#: engine-level findings (the meta-rules)
META_RULES = {
    "LINT000": "file does not parse",
    "LINT001": "orphan suppression: its rule no longer fires here",
    "LINT002": "suppression without a reason",
    "LINT004": "stale baseline entry: finding no longer exists",
}

_SUPPRESS_RE = re.compile(
    r"graftlint:\s*ignore\[([A-Za-z0-9_,\s]+)\]\s*(.*)")

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")


@dataclass
class Finding:
    rule: str
    path: str            # repo-relative posix path
    line: int
    col: int
    message: str
    snippet: str = ""    # stripped source line (baseline identity)
    suppressed: bool = False
    baselined: bool = False

    def fingerprint(self) -> str:
        ident = f"{self.rule}|{self.path}|{self.snippet}"
        return hashlib.sha1(ident.encode()).hexdigest()[:16]

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message,
                "snippet": self.snippet, "fingerprint": self.fingerprint(),
                "suppressed": self.suppressed,
                "baselined": self.baselined}


@dataclass
class Suppression:
    line: int            # the source line the suppression covers
    rules: tuple         # rule ids and/or families, upper-cased
    reason: str
    comment_line: int    # where the comment itself lives
    used: bool = False

    def covers(self, f: Finding) -> bool:
        if f.line != self.line:
            return False
        fam = f.rule.rstrip("0123456789")
        return f.rule in self.rules or fam in self.rules


class SourceModule:
    """One parsed file: tree, parent links, imports, suppressions."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.modname = relpath[:-3].replace("/", ".") \
            if relpath.endswith(".py") else relpath.replace("/", ".")
        self.tree = ast.parse(text)   # SyntaxError handled by caller
        self._parents: dict = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self._parents[child] = node
        self.imports = self._collect_imports()
        self.suppressions = self._collect_suppressions()

    # -- structure -----------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def enclosing_functions(self, node: ast.AST) -> list:
        """Enclosing function defs, innermost first."""
        out = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(cur)
            cur = self._parents.get(cur)
        return out

    def enclosing_loops(self, node: ast.AST) -> list:
        """For/While statements this node sits inside (within the same
        function — a loop outside the innermost def doesn't count, the
        def body runs once per call)."""
        out = []
        cur = self._parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                break
            if isinstance(cur, (ast.For, ast.AsyncFor, ast.While)):
                out.append(cur)
            cur = self._parents.get(cur)
        return out

    def snippet_at(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(rule=rule, path=self.relpath, line=line, col=col,
                       message=message, snippet=self.snippet_at(line))

    # -- imports -------------------------------------------------------------
    def _collect_imports(self) -> dict:
        """Local name -> dotted origin, e.g. ``wall_time`` -> ``time``,
        ``np`` -> ``numpy``, ``perf_counter`` -> ``time.perf_counter``."""
        out: dict[str, str] = {}
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    out[a.asname or a.name.split(".")[0]] = a.name
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    out[a.asname or a.name] = f"{node.module}.{a.name}"
        return out

    def origin(self, node: ast.AST) -> Optional[str]:
        """Dotted origin of a Name/Attribute chain via the import
        table: ``wall_time.time`` -> ``time.time``; None when the root
        isn't an import."""
        parts = []
        cur = node
        while isinstance(cur, ast.Attribute):
            parts.append(cur.attr)
            cur = cur.value
        if not isinstance(cur, ast.Name):
            return None
        root = self.imports.get(cur.id)
        if root is None:
            return None
        return ".".join([root] + list(reversed(parts)))

    # -- suppressions --------------------------------------------------------
    def _collect_suppressions(self) -> list[Suppression]:
        out = []
        try:
            toks = tokenize.generate_tokens(io.StringIO(self.text).readline)
            for tok in toks:
                if tok.type != tokenize.COMMENT:
                    continue
                m = _SUPPRESS_RE.search(tok.string)
                if not m:
                    continue
                rules = tuple(r.strip().upper()
                              for r in m.group(1).split(",") if r.strip())
                reason = m.group(2).strip()
                cline = tok.start[0]
                standalone = self.lines[cline - 1].lstrip().startswith("#")
                out.append(Suppression(
                    line=cline + 1 if standalone else cline,
                    rules=rules, reason=reason, comment_line=cline))
        except tokenize.TokenError:
            pass
        return out


@dataclass
class Report:
    findings: list = field(default_factory=list)
    files: int = 0
    rules_run: tuple = ()

    @property
    def errors(self) -> list:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    def to_dict(self) -> dict:
        return {"files": self.files,
                "rules": list(self.rules_run),
                "errors": len(self.errors),
                "suppressed": sum(f.suppressed for f in self.findings),
                "baselined": sum(f.baselined for f in self.findings),
                "findings": [f.to_dict() for f in self.findings]}


# -- baseline ----------------------------------------------------------------

def load_baseline(path: str) -> dict:
    """fingerprint -> entry dict; {} for a missing/empty file."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {e["fp"]: e for e in data.get("entries", [])}


def write_baseline(path: str, findings: Iterable[Finding],
                   old: Optional[dict] = None) -> dict:
    """Write non-suppressed findings as the new baseline, preserving
    reasons already recorded for surviving fingerprints."""
    old = old or {}
    entries = []
    seen = set()
    for f in findings:
        if f.suppressed:
            continue
        fp = f.fingerprint()
        if fp in seen:
            continue
        seen.add(fp)
        entries.append({"fp": fp, "rule": f.rule, "path": f.path,
                        "line": f.line, "snippet": f.snippet,
                        "reason": old.get(fp, {}).get(
                            "reason", "TODO: justify or fix")})
    data = {"version": 1, "entries": sorted(
        entries, key=lambda e: (e["path"], e["rule"], e["line"]))}
    with open(path, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    return {e["fp"]: e for e in data["entries"]}


# -- registry extraction (TEL002 source) -------------------------------------

def extract_tel_registry(module: SourceModule) -> Optional[dict]:
    """Pull the literal REGISTRY assignment out of the telemetry module
    without importing it."""
    for node in module.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "REGISTRY":
                    try:
                        return ast.literal_eval(node.value)
                    except ValueError:
                        return None
    return None


# -- the runner --------------------------------------------------------------

class LintContext:
    """What every rule sees: policy, call graph, all modules."""

    def __init__(self, policy: Policy, graph: CallGraph,
                 modules: list[SourceModule]):
        self.policy = policy
        self.graph = graph
        self.modules = modules

    def reachable(self, module: SourceModule, node: ast.AST) -> bool:
        """Is the innermost def holding this node entry-reachable?
        Module-level code counts as reachable (import side effects run
        everywhere)."""
        encl = module.enclosing_functions(node)
        if not encl:
            return True
        qual = self.graph.qual_of_node.get(encl[0])
        if qual is None:
            return True
        return self.graph.reachable(qual)


def _iter_files(paths: Iterable[str], policy: Policy,
                root: str) -> list[tuple[str, str]]:
    out = []
    for p in paths:
        ap = os.path.abspath(p)
        if os.path.isfile(ap):
            rel = os.path.relpath(ap, root).replace(os.sep, "/")
            if not policy.excluded(_strip_pkg(rel)):
                out.append((ap, rel))
            continue
        for dirpath, dirnames, filenames in os.walk(ap):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d != "__pycache__"]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                fp = os.path.join(dirpath, fn)
                rel = os.path.relpath(fp, root).replace(os.sep, "/")
                if policy.excluded(_strip_pkg(rel)):
                    continue
                out.append((fp, rel))
    return out


def _strip_pkg(rel: str) -> str:
    """Policy patterns are package-relative (``ops/wgl.py``); strip the
    leading ``jepsen_etcd_tpu_torch/`` when scanning from the repo root."""
    prefix = "jepsen_etcd_tpu_torch/"
    return rel[len(prefix):] if rel.startswith(prefix) else rel


def run_lint(paths: Optional[Iterable[str]] = None,
             rules: Optional[Iterable[str]] = None,
             baseline_path: Optional[str] = DEFAULT_BASELINE,
             policy: Optional[Policy] = None,
             root: Optional[str] = None) -> Report:
    """Run the analyzer. ``rules`` filters by family or exact id
    (None = all). Returns a Report; ``report.errors`` is the gate."""
    from . import rules as rules_pkg

    policy = policy or Policy()
    root = root or _default_root()
    if paths is None:
        paths = [os.path.join(root, "jepsen_etcd_tpu_torch")]

    selected = rules_pkg.select(rules)
    report = Report(rules_run=tuple(sorted(
        r for fam in selected for r in fam.RULES)))

    modules: list[SourceModule] = []
    for fp, rel in _iter_files(paths, policy, root):
        try:
            with open(fp, encoding="utf-8") as f:
                text = f.read()
            modules.append(SourceModule(fp, _strip_pkg(rel), text))
        except SyntaxError as e:
            report.findings.append(Finding(
                rule="LINT000", path=_strip_pkg(rel),
                line=e.lineno or 1, col=e.offset or 0,
                message=f"file does not parse: {e.msg}"))
    report.files = len(modules)

    graph = CallGraph()
    for m in modules:
        graph.add_module(m.modname, m.tree)
    roots = [q for quals in graph.defs.values() for q in quals
             if policy.entry_point(q)]
    # a def no scanned code calls is externally callable — in a
    # partial scan (say, two kernel modules alone) its real
    # callers are simply outside the module set. Rooting it keeps
    # reachability over-approximate, the strict direction.
    called: set = set()
    for names in graph.calls.values():
        called |= names
    roots += [q for name, quals in graph.defs.items()
              if name not in called for q in quals]
    if roots:
        graph.compute_reachable(roots)

    if policy.tel_registry is None:
        for m in modules:
            if policy.registry_module(m.relpath):
                policy.tel_registry = extract_tel_registry(m)

    ctx = LintContext(policy, graph, modules)
    families_run = {fam.FAMILY for fam in selected}
    for m in modules:
        for fam in selected:
            report.findings.extend(fam.check(m, ctx))

    # suppressions: mark covered findings, flag reasonless + orphans
    for m in modules:
        for sup in m.suppressions:
            for f in report.findings:
                if f.path == m.relpath and sup.covers(f):
                    f.suppressed = True
                    sup.used = True
            if not sup.reason:
                report.findings.append(Finding(
                    rule="LINT002", path=m.relpath, line=sup.comment_line,
                    col=0, message="suppression without a reason",
                    snippet=m.snippet_at(sup.comment_line)))
            elif not sup.used and any(
                    r.rstrip("0123456789") in families_run or
                    r in families_run for r in sup.rules):
                report.findings.append(Finding(
                    rule="LINT001", path=m.relpath, line=sup.comment_line,
                    col=0,
                    message="orphan suppression: "
                            f"{','.join(sup.rules)} no longer fires here",
                    snippet=m.snippet_at(sup.comment_line)))

    # baseline: grandfather matching fingerprints, flag stale entries
    baseline = load_baseline(baseline_path) if baseline_path else {}
    if baseline:
        live = set()
        for f in report.findings:
            if f.suppressed:
                continue
            fp = f.fingerprint()
            if fp in baseline:
                f.baselined = True
                live.add(fp)
        for fp, entry in baseline.items():
            if fp not in live:
                report.findings.append(Finding(
                    rule="LINT004", path=entry.get("path", "?"),
                    line=entry.get("line", 1), col=0,
                    message="stale baseline entry "
                            f"({entry.get('rule')}): finding no longer "
                            "exists — remove it",
                    snippet=entry.get("snippet", "")))

    report.findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return report


def _default_root() -> str:
    """Repo root: the directory holding the ``jepsen_etcd_tpu_torch``
    package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
