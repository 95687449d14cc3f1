"""CLI: ``python -m stellar_core_tpu_torch.tools.lint [--strict] [--json] [paths...]``.

Exit codes: 0 clean (or non-strict), 1 unbaselined findings in
--strict, 2 usage/internal error.  ``--write-baseline`` regenerates
baseline.json from the current findings, preserving justifications of
entries that still match and stamping new ones ``TODO: justify`` —
the PR author must replace every TODO before the gate goes green
(tests/test_detlint.py enforces this).
"""
from __future__ import annotations

import argparse
import json
import sys

from .engine import (
    BASELINE_PATH, REPO, baseline_entry, lint_paths, lint_repo,
    load_baseline, match_baseline,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m stellar_core_tpu_torch.tools.lint",
        description="detlint: consensus-determinism & lock-discipline "
                    "static analyzer")
    ap.add_argument("paths", nargs="*",
                    help="repo-relative files to lint (default: the "
                         "whole stellar_core_tpu_torch package)")
    ap.add_argument("--strict", action="store_true",
                    help="exit 1 on any unbaselined finding")
    ap.add_argument("--changed", action="store_true",
                    help="incremental run: reuse .detlint-cache.json "
                         "for files whose content hash is unchanged, "
                         "re-analyze the rest, recompute the global "
                         "passes — full-run-identical findings in "
                         "dev-loop time")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--baseline", default=BASELINE_PATH,
                    help="baseline file (default: tools/lint/baseline.json)")
    ap.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    ap.add_argument("--write-baseline", action="store_true",
                    help="regenerate the baseline from current findings")
    ap.add_argument("--threads", action="store_true",
                    help="dump the inferred thread model (root "
                         "inventory + per-context function counts) "
                         "instead of linting")
    args = ap.parse_args(argv)

    if args.threads:
        return _dump_threads(args)

    if args.write_baseline and args.paths:
        print("detlint: --write-baseline requires a full-repo run — a "
              "scoped run would truncate the baseline to the given "
              "paths' findings", file=sys.stderr)
        return 2
    if args.changed and args.paths:
        print("detlint: --changed and explicit paths are mutually "
              "exclusive (--changed scopes itself by content hash)",
              file=sys.stderr)
        return 2
    if args.paths:
        try:
            findings = lint_paths(args.paths, args.root)
        except FileNotFoundError as e:
            print(f"detlint: {e}", file=sys.stderr)
            return 2
    elif args.changed:
        from .cache import lint_changed

        findings, stats = lint_changed(args.root)
        if not args.as_json:
            print(f"detlint: --changed re-analyzed "
                  f"{len(stats['changed'])} files, reused "
                  f"{stats['reused']} cached")
    else:
        findings = lint_repo(args.root)
    baseline = load_baseline(args.baseline)
    fresh, pinned, stale = match_baseline(findings, baseline)
    if args.paths:
        # a scoped run cannot see findings outside its paths — staleness
        # is only meaningful against the full repo
        stale = []

    if args.write_baseline:
        old = {(e["rule"], e["file"], e["context"], e["line_text"]):
               e.get("justification", "") for e in baseline}
        entries, seen = [], set()
        for f in findings:
            if f.identity() in seen:
                continue
            seen.add(f.identity())
            entries.append(baseline_entry(
                f, old.get(f.identity()) or "TODO: justify"))
        with open(args.baseline, "w", encoding="utf-8") as fh:
            json.dump({"findings": entries}, fh, indent=1, sort_keys=False)
            fh.write("\n")
        print(f"detlint: wrote {len(entries)} baseline entries to "
              f"{args.baseline}")
        return 0

    if args.as_json:
        print(json.dumps({
            "unbaselined": [f.__dict__ for f in fresh],
            "baselined": [f.__dict__ for f in pinned],
            "stale_baseline_entries": stale,
        }, indent=1))
    else:
        for f in fresh:
            print(f.render())
        for e in stale:
            print(f"detlint: stale baseline entry (finding fixed? remove "
                  f"it): {e['file']} [{e['context']}] {e['rule']}: "
                  f"{e['line_text']!r}")
        print(f"detlint: {len(findings)} findings "
              f"({len(fresh)} unbaselined, {len(pinned)} baselined, "
              f"{len(stale)} stale baseline entries)")

    if args.strict and fresh:
        if not args.as_json:
            print("detlint: STRICT FAILURE — fix the findings above, add "
                  "a '# detlint: allow(<rule>)' pragma with a reason, or "
                  "baseline them with a justification", file=sys.stderr)
        return 1
    return 0


def _dump_threads(args) -> int:
    """The thread-root inventory and runs-on context histogram the
    concurrency rules are judging against (COVERAGE.md documents the
    model; this prints the live one)."""
    from .concurrency import build_model_for
    from .engine import _parse_file, discover_files
    import os

    infos = []
    for rel in discover_files(args.root):
        if not rel.endswith(".py"):
            continue
        with open(os.path.join(args.root, rel), encoding="utf-8") as fh:
            info = _parse_file(rel, fh.read())
        if info is not None:
            infos.append(info)
    m = build_model_for(infos)
    if args.as_json:
        print(json.dumps({
            "roots": m.roots,
            "contexts": {k: sorted(v) for k, v in
                         sorted(m.contexts.items()) if v},
        }, indent=1))
        return 0
    print("thread roots:")
    for r in m.roots:
        status = ", ".join(r["resolved"]) if r["resolved"] \
            else "UNRESOLVED"
        print(f"  {r['file']}:{r['line']}: {r['ctx']} <- "
              f"{r['target']} ({status})")
    hist = {}
    for ctxs in m.contexts.values():
        label = "+".join(sorted(ctxs)) if ctxs else "<unreached>"
        hist[label] = hist.get(label, 0) + 1
    print("runs-on histogram (functions per context set):")
    for label in sorted(hist):
        print(f"  {hist[label]:4d}  {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
