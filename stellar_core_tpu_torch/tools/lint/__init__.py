"""detlint v2: consensus-determinism, lock-discipline, interprocedural
taint & native-kernel lockstep static analyzer.

The reproduction's value proposition is that the TPU/native hot paths
stay bit-identical to the CPU reference — detlint is the mechanical
guard that keeps PRs from quietly breaking that.  Five rule families:

* determinism rules (determinism.py) over the consensus-critical
  modules: wall-clock/random/env reads, unsorted dict-view/set
  iteration feeding hashes/serialization/tallies, float arithmetic on
  ledger values, host-side effects inside jax.jit kernels;
* lock-discipline rules (locks.py) for the threaded subsystems:
  ``# guarded-by: <lock>`` annotated fields mutated outside a
  ``with <lock>:`` scope, and inconsistent lock-acquisition order;
* interprocedural determinism taint (callgraph.py + interproc.py):
  nondeterministic values (time/RNG/env/``id()``/unsorted iteration/
  float ledger math) propagated through up to MAX_TAINT_DEPTH call
  edges — across modules, including non-consensus helpers — into
  consensus hash/serialize/tally scopes, reported with the full
  source->sink call chain;
* native-kernel auditor (native.py + lockstep.json): C++/Python
  protocol-constant lockstep diffed against an explicit manifest,
  CPython API calls inside ``Py_BEGIN/END_ALLOW_THREADS`` regions,
  unchecked Py-allocator NULLs, and ``.srchash`` sidecar currency for
  every committed kernel ``.so``;
* exception-safety & resource rules (safety.py): silently-swallowing
  broad excepts in consensus scope, non-context-managed fd/mmap opens
  in ``bucket/``, mutable default arguments in consensus functions.

Pre-existing intentional findings live in tools/lint/baseline.json
(one-line justification each; EMPTY and pinned at zero since r09);
point cases carry an inline ``# detlint: allow(<rule>)`` pragma
(``// detlint: allow(<rule>)`` in C/C++).  ``python -m tools.lint
--strict`` exits nonzero on any unbaselined finding and is wired into
tools/verify_green.py ahead of pytest (``--lint-only`` for the fast
CI-style gate), plus tests/test_detlint.py as a tier-1 test — the gate
self-enforces on every PR.  ``python -m tools.lint --changed`` is the
<1s dev loop: a content-hash cache (.detlint-cache.json) replays
per-file results for untouched files and recomputes the global passes,
bit-identical to a cold full run.
"""
from .engine import (  # noqa: F401
    Finding, lint_paths, lint_repo, lint_sources, load_baseline,
    match_baseline,
)
