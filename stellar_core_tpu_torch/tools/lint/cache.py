"""Incremental (``--changed``) runs: a content-hash cache so the dev
loop pays only for the files it touched while keeping FULL-run
accuracy.

``.detlint-cache.json`` (repo root, gitignored) stores, per analyzed
file: its sha256, the per-file findings (determinism/safety/locks for
.py, GIL/NULL audits for .cpp/.c — everything computable from that file
alone, post-pragma), and the call-graph summaries the interprocedural
pass needs.  A ``--changed`` run hashes every discovered file (~150
small files, milliseconds), replays cached results for hash hits,
(re)parses only the misses, then recomputes the cheap global passes —
interprocedural taint binding+propagation over the merged summaries,
the lockstep manifest diff, the srchash audit — from scratch.  The
result is bit-identical to a cold full run (``--strict`` on
``--changed`` is sound); only the wall time differs.  Pragmas live in
the same file as their findings, so caching post-suppression findings
is safe: editing a pragma changes the hash and invalidates the entry.

verify_green and the tier-1 test keep the cold full run on purpose —
the cache is a dev-loop convenience, never the gate's source of truth.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Tuple

from . import callgraph, threadmodel
from .engine import (
    NATIVE_EXTS, REPO, FileInfo, Finding, _parse_file, _suppressed,
    discover_files, light_info,
)
# (per-file rule dispatch lives in engine.check_py_file /
# native.check_native_file — ONE list for cold and cached paths)

CACHE_VERSION = 1
CACHE_BASENAME = ".detlint-torch-cache.json"


def cache_path(root: str = REPO) -> str:
    return os.path.join(root, CACHE_BASENAME)


def _tools_fingerprint() -> str:
    """sha256 over the analyzer's own sources (rule modules + lockstep
    manifest).  Cached per-file findings were computed BY these rules —
    pulling a commit that changes a rule must invalidate every entry,
    or '--changed --strict' could stay green where a cold run goes red.
    baseline.json is excluded: it affects matching, not findings."""
    h = hashlib.sha256()
    lint_dir = os.path.dirname(os.path.abspath(__file__))
    for name in sorted(os.listdir(lint_dir)):
        if name == "baseline.json" or \
                not name.endswith((".py", ".json")):
            continue
        with open(os.path.join(lint_dir, name), "rb") as fh:
            h.update(name.encode("utf-8"))
            h.update(fh.read())
    return h.hexdigest()


def _empty_cache(tools_sha: str) -> dict:
    return {"version": CACHE_VERSION, "tools_sha256": tools_sha,
            "files": {}}


def _load(path: str, tools_sha: str) -> dict:
    try:
        with open(path, encoding="utf-8") as fh:
            data = json.load(fh)
    except (OSError, ValueError):
        return _empty_cache(tools_sha)
    if data.get("version") != CACHE_VERSION or \
            data.get("tools_sha256") != tools_sha or \
            not isinstance(data.get("files"), dict):
        return _empty_cache(tools_sha)
    return data


def _finding_to_json(f: Finding) -> dict:
    return {"rule": f.rule, "file": f.file, "line": f.line, "col": f.col,
            "context": f.context, "message": f.message,
            "line_text": f.line_text}


def _per_file_findings(info: FileInfo) -> List[Finding]:
    from .engine import check_py_file

    return [f for f in check_py_file(info) if not _suppressed(info, f)]


def _per_native_findings(ninfo) -> List[Finding]:
    from .native import check_native_file

    return [f for f in check_native_file(ninfo)
            if not _suppressed(ninfo, f)]


def lint_changed(root: str = REPO,
                 path: Optional[str] = None
                 ) -> Tuple[List[Finding], dict]:
    """Incremental full-accuracy run.  Returns (findings, stats) where
    stats = {"changed": [...], "reused": n}."""
    from . import concurrency, interproc, native

    cpath = path or cache_path(root)
    tools_sha = _tools_fingerprint()
    cache = _load(cpath, tools_sha)
    old_files: Dict[str, dict] = cache["files"]
    new_files: Dict[str, dict] = {}

    relpaths = discover_files(root)
    texts: Dict[str, str] = {}
    changed: List[str] = []
    findings: List[Finding] = []
    parsed_py: List[FileInfo] = []
    aux_infos: List[FileInfo] = []
    summaries: Dict[str, List[callgraph.FuncSummary]] = {}
    conc_map: Dict[str, threadmodel.FileConc] = {}
    native_infos = []

    for rel in relpaths:
        with open(os.path.join(root, rel), encoding="utf-8") as fh:
            text = fh.read()
        texts[rel] = text
        digest = hashlib.sha256(text.encode("utf-8")).hexdigest()
        ent = old_files.get(rel)
        usable = ent is not None and ent.get("sha256") == digest and \
            (rel.endswith(NATIVE_EXTS) or ent.get("conc") is not None)
        if usable:
            findings.extend(Finding(**f) for f in ent["findings"])
            if not rel.endswith(NATIVE_EXTS):
                summaries[rel] = [callgraph.FuncSummary.from_json(s)
                                  for s in ent.get("summaries", [])]
                conc_map[rel] = threadmodel.FileConc.from_json(
                    ent["conc"])
                aux_infos.append(light_info(rel, text))
            else:
                aux_infos.append(native.parse_native(rel, text))
            new_files[rel] = ent
            continue
        changed.append(rel)
        if rel.endswith(NATIVE_EXTS):
            ninfo = native.parse_native(rel, text)
            native_infos.append(ninfo)
            file_findings = _per_native_findings(ninfo)
            entry = {"sha256": digest,
                     "findings": [_finding_to_json(f)
                                  for f in file_findings]}
        else:
            info = _parse_file(rel, text)
            if info is None:
                # unparseable: surface it, never cache silence
                findings.append(Finding(
                    rule="parse-error", file=rel, line=1, col=0,
                    context="<module>",
                    message="file does not parse — fix before linting",
                    line_text=""))
                continue
            parsed_py.append(info)
            file_findings = _per_file_findings(info)
            entry = {"sha256": digest,
                     "findings": [_finding_to_json(f)
                                  for f in file_findings],
                     "summaries": [s.to_json() for s in
                                   callgraph.summarize_file(info)],
                     "conc": threadmodel.summarize_conc(
                         info).to_json()}
        findings.extend(file_findings)
        new_files[rel] = entry

    # global passes, always recomputed (cheap against summaries/regex)
    global_findings: List[Finding] = []
    global_findings.extend(
        interproc.check(parsed_py, summaries, tuple(aux_infos)))
    conc_findings, exonerated = concurrency.check(
        parsed_py, conc_map, tuple(aux_infos))
    global_findings.extend(conc_findings)
    global_findings.extend(native.check_lockstep(texts, root=root))
    global_findings.extend(native.check_srchash(root))

    # the interprocedural held-on-entry proof discharges cached v1
    # lock-unguarded-write findings too — same verdict as a cold run
    findings = [f for f in findings
                if not concurrency.exonerates(f, exonerated)]

    by_path = {i.path: i for i in parsed_py}
    by_path.update({i.path: i for i in native_infos})
    by_path.update({i.path: i for i in aux_infos
                    if i.path not in by_path})
    for f in global_findings:
        info = by_path.get(f.file)
        if info is not None and _suppressed(info, f):
            continue
        findings.append(f)

    cache = {"version": CACHE_VERSION, "tools_sha256": tools_sha,
             "files": new_files}
    tmp = f"{cpath}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        json.dump(cache, fh)
    os.replace(tmp, cpath)

    findings.sort(key=lambda f: (f.file, f.line, f.col, f.rule))
    stats = {"changed": changed,
             "reused": len(relpaths) - len(changed)}
    return findings, stats
