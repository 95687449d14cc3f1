"""``ContractorProbe``: the device tier of the quorum-intersection checker
timed chunk by chunk on the card, and held to a host fixpoint.

While active, every ``contract_shared`` chunk of the checker's
``_Contractor`` is timed by CUDA events, its trips counted and its bound
computed from its shapes, and every device evaluation's rows are checked
against ``numpy_fixpoint`` of the same rows.  ``chip_smoke.py``'s
``quorum_intersection`` phase and ``tools/quorum_tier_bench`` read it.
"""
import time

import numpy as np
import torch

FP32_OPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def numpy_fixpoint_form(scc, qmap):
    """The 2-level qsets of the nodes ``scc`` restricted to ``scc`` as
    float64 arrays, each distinct (threshold, members) element once: the
    members (U, N), thresholds (U,), how often each node lists each
    element (U, N) and the top thresholds (N,).  A validator listed twice
    counts once, an inner set listed twice twice, as in the dense form."""
    col = {v: i for i, v in enumerate(scc)}
    elems: dict = {}
    listings = []
    top = np.zeros(len(scc))
    for i, node in enumerate(scc):
        qset = qmap[node]
        top[i] = qset.threshold
        keys = [(1, (c,)) for c in sorted({col[v.value] for v in
                                           qset.validators
                                           if v.value in col})]
        keys += [(s.threshold, tuple(sorted({col[v.value]
                                             for v in s.validators
                                             if v.value in col})))
                 for s in qset.innerSets]
        listings += [(elems.setdefault(k, len(elems)), i) for k in keys]
    mem = np.zeros((max(len(elems), 1), len(scc)))
    thr = np.ones(mem.shape[0])
    for (t, cols), e in elems.items():
        thr[e] = t
        mem[e, list(cols)] = 1
    use = np.zeros_like(mem)
    for e, i in listings:
        use[e, i] += 1
    return mem, thr, use, top


def numpy_fixpoint(form, m):
    """Greatest-fixpoint contraction of the bool rows ``m`` (B, N) on the
    host: node i stays while its listed elements satisfied inside the row
    reach its top threshold."""
    mem, thr, use, top = form
    while True:
        sat = (m.astype(np.float64) @ mem.T >= thr) & (thr > 0)
        nxt = m & (sat.astype(np.float64) @ use >= top)
        if (nxt == m).all():
            return nxt
        m = nxt


def chunk_bound_ms(rows: int, n: int, u: int, trips: int) -> float:
    """Least time the H100 could take for one ``contract_shared`` chunk of
    ``rows`` rows over N nodes and U distinct elements that ran ``trips``
    trips: the larger of its products' float32 operations (2·rows·N·U for
    the counts and as many for the listings, a trip) over 67 TFLOP/s and
    its bytes (the float32 element members and listings and thresholds
    read once, the bool rows read and written once) over 3.35 TB/s."""
    ops = trips * 4 * rows * n * u
    nbytes = 4 * (2 * u * n + u + n) + 2 * rows * n
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3


class ContractorProbe:
    """While active, wraps the checker's ``_Contractor._eval`` and the
    quorum ops' ``contract_shared`` / ``_shared_trip``: every device
    chunk is timed by CUDA events, its trips counted and its bound
    computed, and every device evaluation's rows are held to
    ``numpy_fixpoint`` of the same rows (mismatching rows counted).  The
    package has no timers of its own."""

    def __init__(self, qi, quorum_ops):
        self.qi, self.ops = qi, quorum_ops
        self._saved: dict = {}
        self._forms: dict = {}
        self.reset()

    def reset(self) -> None:
        self.evals = self.rows = self.mismatches = 0
        self.chunk_ms: list = []
        self.chunk_trips: list = []
        self.chunk_rows: list = []
        self.chunk_bound_ms: list = []
        self.devices: set = set()
        self.widths: set = set()   # (N, K dense inner slots, U elements)
        self.check_seconds = 0.0
        self._trips = 0

    def stats(self) -> dict:
        ms = self.chunk_ms
        return {"evals": self.evals, "rows": self.rows,
                "chunks": len(ms), "chunk_rows_max": max(self.chunk_rows,
                                                          default=0),
                "ms_per_chunk": sum(ms) / len(ms) if ms else None,
                "ms_per_chunk_max": max(ms, default=None),
                "trips_per_chunk": (sum(self.chunk_trips) / len(ms)
                                    if ms else None),
                "trips_per_chunk_max": max(self.chunk_trips, default=None),
                "bound_ms_per_chunk": (sum(self.chunk_bound_ms) / len(ms)
                                       if ms else None),
                "share_of_bound": (sum(self.chunk_bound_ms) / sum(ms)
                                   if ms else None),
                "device_ms": sum(ms), "devices": sorted(self.devices),
                "n_k_u": sorted(self.widths),
                "mismatched_rows": self.mismatches,
                "check_seconds": self.check_seconds}

    def __enter__(self):
        cls, ops = self.qi._Contractor, self.ops
        real_eval, real_chunk = cls._eval, ops.contract_shared
        real_trip = ops._shared_trip
        self._saved = {(cls, "_eval"): real_eval,
                       (ops, "contract_shared"): real_chunk,
                       (ops, "_shared_trip"): real_trip}

        def trip(ss, m):
            self._trips += 1
            return real_trip(ss, m)

        def chunk(ss, members):
            self._trips = 0
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = real_chunk(ss, members)
            end.record()
            end.synchronize()
            self.chunk_ms.append(start.elapsed_time(end))
            self.chunk_trips.append(self._trips)
            self.chunk_rows.append(int(members.shape[0]))
            self.chunk_bound_ms.append(chunk_bound_ms(
                int(members.shape[0]), ss.mem.shape[1], ss.mem.shape[0],
                self._trips))
            return out

        def evaluate(contractor, m):
            out = real_eval(contractor, m)
            if contractor.use_device:
                t0 = time.perf_counter()
                self.evals += 1
                self.rows += m.shape[0]
                self.devices.add(str(contractor.device))
                self.widths.add((contractor.n, contractor.inner_mem.shape[1],
                                 contractor._shared.mem.shape[0]))
                key = id(contractor)
                if key not in self._forms:
                    self._forms[key] = (contractor, numpy_fixpoint_form(
                        contractor.scc, contractor.qmap))
                want = numpy_fixpoint(self._forms[key][1], m)
                self.mismatches += int((out != want).any(axis=1).sum())
                self.check_seconds += time.perf_counter() - t0
            return out

        cls._eval, ops.contract_shared, ops._shared_trip = (evaluate, chunk,
                                                            trip)
        return self

    def __exit__(self, *exc):
        for (owner, name), real in self._saved.items():
            setattr(owner, name, real)
        self._saved.clear()
        self._forms.clear()
