"""detlint engine: file discovery, AST parse, rule dispatch, pragma
suppression, and baseline matching.

Finding identity is (rule, file, context, line_text) — deliberately NOT
the line number, so a baseline entry survives unrelated edits shifting
code up or down.  ``context`` is the dotted class/function path
(``TallyEngine._build``) or ``<module>`` for top-level code.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
PACKAGE = "stellar_core_tpu_torch"
BASELINE_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "baseline.json")

# consensus-critical module prefixes (relative to the package root):
# nondeterminism here forks validators (ISSUE 3).  Entries may be
# nested ("simulation/fuzz"): a path is covered when its leading
# components match every component of the entry — the fuzzer's
# schedule IR and executor must stay deterministic (same-seed replay
# identity is the repro contract) without dragging all of simulation/
# into the consensus ruleset.
CONSENSUS_DIRS = ("scp", "herder", "ledger", "bucket", "transactions",
                  "xdr", "crypto", "apply", "catchup", "history", "work",
                  "simulation/fuzz")
# device-kernel modules: host-side effects inside jax.jit break
# trace/replay determinism
KERNEL_DIRS = ("ops",)

_PRAGMA_RE = re.compile(r"#\s*detlint:\s*allow\(([^)]*)\)")
_GUARDED_BY_RE = re.compile(r"#\s*guarded-by:\s*([A-Za-z_][A-Za-z0-9_.]*)")


def path_under(path: str, dirs: Sequence[str]) -> bool:
    """Is ``path`` (repo-relative, '/'-separated) inside one of the
    package-relative ``dirs``?  Entries may themselves contain slashes
    ("simulation/fuzz") and match a leading component sequence."""
    parts = path.split("/")
    if PACKAGE not in parts:
        return False
    rest = parts[parts.index(PACKAGE) + 1:]
    for d in dirs:
        want = d.split("/")
        if rest[:len(want)] == want:
            return True
    return False


def dotted_name(node: ast.AST) -> Optional[str]:
    """'a.b.c' for Name/Attribute chains, else None (shared by the
    determinism and lock rule modules)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass(frozen=True)
class Finding:
    rule: str
    file: str          # repo-relative path
    line: int
    col: int
    context: str       # dotted class/function path
    message: str
    line_text: str     # stripped source of the flagged line

    def identity(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.file, self.context, self.line_text)

    def render(self) -> str:
        return (f"{self.file}:{self.line}:{self.col}: {self.rule}: "
                f"{self.message} [{self.context}]")


@dataclass
class FileInfo:
    """Parsed per-file input handed to every rule module."""
    path: str                      # repo-relative, '/'-separated
    source: str
    tree: ast.AST
    lines: List[str]
    pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    # line -> lock name for "# guarded-by: <lock>" annotations
    guards: Dict[int, str] = field(default_factory=dict)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def in_consensus(self) -> bool:
        return self._under(CONSENSUS_DIRS)

    def in_kernels(self) -> bool:
        return self._under(KERNEL_DIRS)

    def _under(self, dirs: Sequence[str]) -> bool:
        return path_under(self.path, dirs)


class ContextVisitor(ast.NodeVisitor):
    """Base visitor tracking the dotted class/function context."""

    def __init__(self, info: FileInfo):
        self.info = info
        self.stack: List[str] = []
        self.findings: List[Finding] = []

    @property
    def context(self) -> str:
        return ".".join(self.stack) if self.stack else "<module>"

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_func(self, node) -> None:
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    def add(self, rule: str, node: ast.AST, message: str) -> None:
        line = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        self.findings.append(Finding(
            rule=rule, file=self.info.path, line=line, col=col,
            context=self.context, message=message,
            line_text=self.info.line_text(line)))


def _scan_comments(info: FileInfo) -> None:
    for i, raw in enumerate(info.lines, start=1):
        m = _PRAGMA_RE.search(raw)
        if m:
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            info.pragmas[i] = rules
        g = _GUARDED_BY_RE.search(raw)
        if g:
            info.guards[i] = g.group(1)


def _suppressed(info: FileInfo, f: Finding) -> bool:
    """A pragma suppresses a finding on its own line or the line above
    (for statements whose flagged line has no room for a comment)."""
    for line in (f.line, f.line - 1):
        rules = info.pragmas.get(line)
        if rules and (f.rule in rules or "*" in rules):
            return True
    return False


def _parse_file(relpath: str, source: str) -> Optional[FileInfo]:
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    info = FileInfo(path=relpath.replace(os.sep, "/"), source=source,
                    tree=tree, lines=source.splitlines())
    _scan_comments(info)
    return info


#: native kernel sources audited by tools/lint/native.py
NATIVE_EXTS = (".cpp", ".c")


def discover_files(root: str = REPO) -> List[str]:
    """Repo-relative paths of every package .py file under analysis,
    plus the native kernel sources (.cpp/.c) the native auditor lexes."""
    out: List[str] = []
    pkg_root = os.path.join(root, PACKAGE)
    for dirpath, dirnames, filenames in os.walk(pkg_root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py") or name.endswith(NATIVE_EXTS):
                full = os.path.join(dirpath, name)
                out.append(os.path.relpath(full, root))
    return sorted(out)


def light_info(relpath: str, source: str) -> FileInfo:
    """A tree-less FileInfo carrying only lines + pragmas — enough for
    line_text rendering and suppression of findings that land in a file
    the current run did not (re)parse (the --changed cache path)."""
    info = FileInfo(path=relpath.replace(os.sep, "/"), source=source,
                    tree=None, lines=source.splitlines())
    _scan_comments(info)
    return info


def _lockstep_involved(paths: Iterable[str]) -> bool:
    """Should a scoped run diff the lockstep manifest?  Yes whenever any
    kernel source or any Python twin named in the manifest is in scope
    (missing counterparts are read from disk)."""
    from .native import MANIFEST_PATH, load_manifest

    try:
        manifest = load_manifest(MANIFEST_PATH)
    except (OSError, ValueError, KeyError, TypeError):
        # unreadable manifest: RUN the pass so check_lockstep reports
        # the broken manifest — never degrade to silence
        return True
    involved = set()
    for e in manifest:
        involved.add(e["cpp"]["file"])
        if e.get("py"):
            involved.add(e["py"]["file"])
    return bool(involved & set(paths))


def check_py_file(info: FileInfo) -> List[Finding]:
    """Every rule family computable from ONE parsed .py file — the
    single dispatch list shared by the cold run (lint_sources) and the
    --changed cache (cache.py), so a new per-file rule module cannot be
    added to one path and silently missed by the other."""
    from . import determinism, locks, safety

    findings = determinism.check(info)
    findings.extend(safety.check(info))
    findings.extend(locks.check([info]))
    return findings


def lint_sources(sources: Dict[str, str],
                 root: Optional[str] = None) -> List[Finding]:
    """Analyze {repo-relative-path: source}; the seam tests use to lint
    injected/mutated source without touching the working tree.  .py
    files run the AST rule families (determinism, safety, locks) plus
    the whole-program interprocedural taint pass; .cpp/.c files run the
    native auditor.  ``root`` (set by lint_paths/lint_repo) additionally
    enables the filesystem-backed srchash sidecar audit."""
    from . import concurrency, interproc, native

    infos: List[FileInfo] = []
    native_infos: List["native.NativeInfo"] = []
    findings: List[Finding] = []
    for relpath, source in sorted(sources.items()):
        if relpath.endswith(NATIVE_EXTS):
            native_infos.append(native.parse_native(relpath, source))
            continue
        info = _parse_file(relpath, source)
        if info is not None:
            infos.append(info)
        else:
            # an unparseable file must go RED, never read as clean —
            # same verdict the --changed path gives (cache.py)
            findings.append(Finding(
                rule="parse-error", file=relpath.replace(os.sep, "/"),
                line=1, col=0, context="<module>",
                message="file does not parse — fix before linting",
                line_text=""))
    for info in infos:
        findings.extend(check_py_file(info))
    findings.extend(interproc.check(infos))
    conc_findings, exonerated = concurrency.check(infos)
    findings.extend(conc_findings)
    findings.extend(native.check(
        native_infos,
        py_sources={i.path: i.source for i in infos},
        root=root,
        run_lockstep=bool(native_infos) or _lockstep_involved(sources)))
    by_path: Dict[str, object] = {i.path: i for i in infos}
    by_path.update({i.path: i for i in native_infos})
    out = []
    for f in findings:
        info = by_path.get(f.file)
        if info is not None and _suppressed(info, f):
            continue
        if concurrency.exonerates(f, exonerated):
            # the thread model proved the lock held on entry from every
            # resolved caller — the v1 lexical miss is discharged
            continue
        out.append(f)
    return sorted(out, key=lambda f: (f.file, f.line, f.col, f.rule))


def lint_paths(relpaths: Iterable[str], root: str = REPO) -> List[Finding]:
    """Lint specific repo-relative files; raises FileNotFoundError on an
    unreadable path — a scoped run must never silently report a file it
    never analyzed as clean."""
    sources: Dict[str, str] = {}
    missing: List[str] = []
    for rel in relpaths:
        full = os.path.join(root, rel)
        try:
            with open(full, encoding="utf-8") as fh:
                sources[rel] = fh.read()
        except OSError:
            missing.append(rel)
    if missing:
        raise FileNotFoundError(
            f"cannot read: {', '.join(missing)}")
    return lint_sources(sources, root=root)


def lint_repo(root: str = REPO) -> List[Finding]:
    return lint_paths(discover_files(root), root)


# -- baseline ---------------------------------------------------------------

def load_baseline(path: str = BASELINE_PATH) -> List[dict]:
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except OSError:
        return []
    return data.get("findings", [])


def match_baseline(findings: Sequence[Finding],
                   baseline: Sequence[dict]
                   ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """Split into (unbaselined, baselined, stale_entries).

    An entry matches any number of findings with the same
    (rule, file, context, line_text) — several identical metric-timer
    lines in one function are one entry.  Entries matching nothing are
    stale (reported, not fatal: the finding was fixed)."""
    table: Dict[Tuple[str, str, str, str], dict] = {}
    for entry in baseline:
        key = (entry.get("rule", ""), entry.get("file", ""),
               entry.get("context", ""), entry.get("line_text", ""))
        table[key] = entry
    used: Set[Tuple[str, str, str, str]] = set()
    fresh: List[Finding] = []
    pinned: List[Finding] = []
    for f in findings:
        if f.identity() in table:
            pinned.append(f)
            used.add(f.identity())
        else:
            fresh.append(f)
    stale = [e for k, e in table.items() if k not in used]
    return fresh, pinned, stale


def baseline_entry(f: Finding, justification: str) -> dict:
    return {"rule": f.rule, "file": f.file, "context": f.context,
            "line_text": f.line_text, "justification": justification}
