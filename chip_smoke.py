"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one JSON line):
  1. card    — name and power limit; exits non-zero before building
               anything when no CUDA device is present;
  2. build   — nvcc builds every hand-written kernel from csrc/ in this
               run; ptxas's registers, spills (any spill fails) and stack
               frame, and the main path's launch shape;
  3. compare — the ed25519 kernel against its plain torch version, both on
               the card, on the 26 libsodium edge vectors plus 4,096 seeded
               rows (1/8 forged), and 256 rows against the spec; the
               kernel's test-only double-scalar entry against the spec on
               the special scalars;
  4. main    — ``admission_step`` on a 100,000-signature TxSetFrame batch
               (BASELINE config #2) padded to 131,072, and
               ``multi_validator_tally`` on a 64-validator 2-level FBA
               topology (BASELINE config #5); verdicts exact against the
               known forged mask and a recursive host oracle; every kernel
               must have been launched during this phase;
  5. times   — CUDA-event times (warm-up excluded) with the card's name
               and power limit, and the verify kernel's bound from the
               work that this run's rows need.
Then the per-kernel JSON line, the nvidia-smi line and, last,
``{"ok": true, "device": {...}}``.  Any failed check raises.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS = 100_000      # TxSetFrame signatures (BASELINE config #2)
N_TRIPLES = 4096      # distinct signed triples, tiled to N_ROWS
N_KEYS = 64
N_ORGS, ORG_SIZE = 16, 4   # 64 validators (BASELINE config #5)
TOP_THR, INNER_THR = 11, 3
N_CANDIDATES = 64
REPS = 5
SEED = 20260601
L = 2**252 + 27742317777372353535851937790883648493

# Scalars below 2^253 (every h, and every s that can be accepted) at the
# edges of the kernel's signed radix-16 recoding.
SPECIAL_SCALARS = {
    "0": 0, "1": 1, "8": 8, "15": 15, "16": 16, "L-1": L - 1,
    "2^252": 2**252, "2^253-1": 2**253 - 1,
    "nibbles_8": int("8" * 63, 16),
    "alt_0f_f0": int.from_bytes(bytes([0x0F, 0xF0] * 15 + [0x0F, 0x10]),
                                "little"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = REPS) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls, by CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def edge_vectors(ref, sha256):
    """The 26 libsodium edge vectors (valid, bad-sig, 10 small-order A,
    10 small-order R, non-canonical A and R, malleable s, off-curve A)."""
    seed, msg = sha256(b"edge0"), sha256(b"edge-msg0")
    pk, sig = ref.public_from_seed(seed), ref.sign(seed, msg)
    out = [(pk, sig, msg), (pk, sig[:-1] + bytes([sig[-1] ^ 1]), msg)]
    out += [(enc, sig, msg) for enc in ref.SMALL_ORDER_ENCODINGS]
    out += [(pk, enc + sig[32:], msg) for enc in ref.SMALL_ORDER_ENCODINGS]
    nc = int.to_bytes(ref.P + 1, 32, "little")
    out += [(nc, sig, msg), (pk, nc + sig[32:], msg)]
    s = int.from_bytes(sig[32:], "little")
    out.append((pk, sig[:32] + int.to_bytes(s + ref.L, 32, "little"), msg))
    y = 2
    while ref._recover_x(y, 0) is not None:
        y += 1
    out.append((int.to_bytes(y, 32, "little"), sig, msg))
    return [np.frombuffer(b"".join(v[i] for v in out), np.uint8).reshape(
        len(out), w) for i, w in enumerate((32, 64, 32))]


def signed_triples(ref, sha256, rng):
    """N_TRIPLES distinct (pubkey, sig, msg) from N_KEYS keys."""
    seeds = [sha256(b"smoke-key%d" % k) for k in range(N_KEYS)]
    pubs = [np.frombuffer(ref.public_from_seed(s), np.uint8) for s in seeds]
    msgs = rng.integers(0, 256, (N_TRIPLES, 32), dtype=np.uint8)
    pk = np.stack([pubs[i % N_KEYS] for i in range(N_TRIPLES)])
    sg = np.stack([np.frombuffer(ref.sign(seeds[i % N_KEYS], msgs[i].tobytes()),
                                 np.uint8) for i in range(N_TRIPLES)])
    return pk, sg, msgs


def forge(pk, sg, mg, rows):
    """Copies with one flipped byte in the sig (even i) or msg (odd i) of
    each listed row."""
    sg, mg = sg.copy(), mg.copy()
    for i, r in enumerate(rows):
        if i % 2 == 0:
            sg[r, r % 64] ^= 0x01
        else:
            mg[r, r % 32] ^= 0x80
    return pk, sg, mg


def fba_topology():
    """16 orgs x 4 validators; every qset: 11 of the 16 org inner sets,
    each inner set 3 of 4."""
    orgs = [list(range(o * ORG_SIZE, (o + 1) * ORG_SIZE))
            for o in range(N_ORGS)]
    qset = (TOP_THR, [], [(INNER_THR, org) for org in orgs])
    return [qset] * (N_ORGS * ORG_SIZE)


# -- recursive host oracle (plain python, 2-level qsets) ---------------------

def ref_slice(qset, s):
    thr, vals, inners = qset
    hits = sum(1 for v in vals if v in s)
    hits += sum(1 for ithr, ivals in inners
                if ithr > 0 and sum(1 for v in ivals if v in s) >= ithr)
    return hits >= thr


def ref_vblocking(qset, s):
    thr, vals, inners = qset
    if thr == 0:
        return False
    avail = sum(1 for v in vals if v not in s)
    avail += sum(1 for ithr, ivals in inners
                 if ithr > 0 and sum(1 for v in ivals if v not in s) >= ithr)
    return avail < thr


def ref_max_quorum(qsets, members):
    cur = set(members)
    while True:
        nxt = {n for n in cur if ref_slice(qsets[n], cur)}
        if nxt == cur:
            return nxt
        cur = nxt


def oracle_tally(qsets, voted, accepted):
    """(accept, ratify) as (V, C) bool arrays, validator v with qsets[v]."""
    n_val, n_c = len(qsets), voted.shape[0]
    acc = np.zeros((n_val, n_c), np.bool_)
    rat = np.zeros((n_val, n_c), np.bool_)
    for c in range(n_c):
        q = ref_max_quorum(qsets, set(np.nonzero(voted[c] | accepted[c])[0]))
        a_set = set(np.nonzero(accepted[c])[0])
        for v in range(n_val):
            rat[v, c] = bool(q) and ref_slice(qsets[v], q)
            acc[v, c] = rat[v, c] or ref_vblocking(qsets[v], a_set)
    return acc, rat


def special_scalar_cases(ref, rng):
    """(A encoding, s, h) rows: every special scalar as s, as h and as
    both, beside seeded scalars mod L and seeded keys."""
    rows = []
    for k in SPECIAL_SCALARS.values():
        a = ref.public_from_seed(rng.bytes(32))
        other = int.from_bytes(rng.bytes(32), "little") % L
        rows += [(a, k, other), (a, other, k), (a, k, k)]
    return rows


def check_double_scalar(ref, ed25519_cuda, rng, dev) -> int:
    """The kernel's [s]B + [h](-A) against the spec on the special
    scalars; returns the number of rows."""
    rows = special_scalar_cases(ref, rng)
    cols = [np.stack([np.frombuffer(v if isinstance(v, bytes) else
                                    v.to_bytes(32, "little"), np.uint8)
                      for v in col]) for col in zip(*rows)]
    got = ed25519_cuda.double_scalar(
        *(torch.as_tensor(c, device=dev) for c in cols)).cpu().numpy()
    for i, (a, s, h) in enumerate(rows):
        neg_a = ref.point_neg(ref.decode_point(a))
        want = ref.encode_point(ref.double_scalar_mult(s, h, neg_a))
        if got[i].tobytes() != want:
            raise AssertionError(f"double_scalar != spec at s={s}, h={h}")
    return len(rows)


@functools.cache
def decompress_work(ref, a: bytes) -> tuple[int, bool]:
    """Field multiplications of the verify kernel's decompression of A
    (18, and one more for the sqrt(-1) flip; its squarings are always 255),
    and whether A decodes."""
    p, y = ref.P, int.from_bytes(a, "little") & (2**255 - 1)
    u, v = (y * y - 1) % p, (ref.D * y * y + 1) % p
    x = u * pow(v, 3, p) * pow(u * pow(v, 7, p), (p - 5) // 8, p) % p
    flip = (v * x * x + u) % p == 0
    return 18 + flip, ref.decode_point(a) is not None


def zero_digits(k: int) -> int:
    """Digits of 0 among the 64 signed radix-16 digits of k < 2^254 (the
    nibbles of k + 0x88..8 that are 8)."""
    return (k + int("8" * 64, 16)).to_bytes(32, "little").hex().count("8")


def verify_work(ref, a: bytes, sig: bytes, msg: bytes) -> tuple[int, int]:
    """(squarings, multiplications) of the field that the verify kernel
    (csrc/ed25519_verify.cu) does for one row.  A row that the byte checks
    refuse takes none, one whose A is off the curve the decompression
    alone.  Any other takes the decompression, the [1..8](-A) table (65
    M), 64 windows of 4 doublings (16 S + 13 M) with an add of 8 M for
    each nonzero digit of h and one of 6 M for each nonzero digit of s,
    and the encoding (254 S + 13 M)."""
    r, s = sig[:32], int.from_bytes(sig[32:], "little")
    mask = 2**255 - 1
    if (s >= ref.L or int.from_bytes(a, "little") & mask >= ref.P
            or int.from_bytes(r, "little") & mask >= ref.P
            or ref.has_small_order(a) or ref.has_small_order(r)):
        return 0, 0
    mul, decodes = decompress_work(ref, a)
    if not decodes:
        return 255, mul
    h = ref.hram(r, a, msg)
    mul += (65 + 64 * 13 + 8 * (64 - zero_digits(h))
            + 6 * (64 - zero_digits(s)) + 13)
    return 255 + 64 * 16 + 254, mul


def bound_ms_verify(ref, pk, sg, mg) -> tuple[float, str, int]:
    """Least time the H100 could take to verify these rows: the larger of
    the bytes (each input read once, one byte out a row) over 3.35 TB/s
    and the 32x32->64-bit products over 16.7 T/s, the int32 multiply-add
    rate (half the 67 TFLOP/s fp32 FMA rate: 64 vs 128 lanes per SM per
    clock).  Products: 36 a squaring and 64 a multiplication, for the work
    that these rows need (``verify_work``); SHA-512, carries and the
    prologue are not counted, so this stays a lower bound.  Returns the
    ms, what bounds it, and the products."""
    products = 0
    for a, s, m in zip(pk, sg, mg):
        sq, mul = verify_work(ref, a.tobytes(), s.tobytes(), m.tobytes())
        products += 36 * sq + 64 * mul
    ops_ms = products / 16.7e12 * 1e3
    bytes_ms = len(pk) * (32 + 64 + 32 + 1) / 3.35e12 * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", products)


def bound_ms_ref10_count(n: int) -> float:
    """The bound as first counted, for the radix-2^25.5 reference
    algorithm: 3,868 field multiplications of 100 products each per row,
    over the same 16.7 T/s.  Printed beside ``bound_ms_verify`` so that
    shares of it compare with the first kernel's; it counts more than
    twice the work the kernel needs, so it is not the bound."""
    return n * 3868 * 100 / 16.7e12 * 1e3


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    card_line = card()
    dev = torch.device("cuda")
    emit({"phase": "card", "nvidia_smi": card_line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from stellar_core_tpu_torch.crypto import ed25519_ref as ref
    from stellar_core_tpu_torch.crypto.sha import sha256
    from stellar_core_tpu_torch.models import admission as A
    from stellar_core_tpu_torch.ops import ed25519_cuda, ed25519_kernel
    from stellar_core_tpu_torch.ops import quorum as Q
    from stellar_core_tpu_torch.utils.device import pad_signature_batch

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    built = ed25519_cuda.build()
    ptxas = ed25519_cuda.ptxas_stats(built.log)
    shape = ed25519_cuda.launch_shape(pad_signature_batch(N_ROWS))
    emit({"phase": "build", "kernels": [ed25519_cuda.KERNEL],
          "seconds": time.perf_counter() - t0, "nvcc_seconds": built.seconds,
          "ptxas": ptxas, "main_path_launch": shape})
    if ptxas["spill_stores"] or ptxas["spill_loads"]:
        raise AssertionError(f"ed25519_verify_kernel spills: {ptxas}")

    # -- 3. kernel vs plain version, on the card -----------------------------
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    pk, sg, mg = signed_triples(ref, sha256, rng)
    sign_s = time.perf_counter() - t0
    forged = np.arange(7, N_TRIPLES, 8)
    cpk, csg, cmg = forge(pk, sg, mg, forged)
    epk, esg, emg = edge_vectors(ref, sha256)
    cmp_in = [torch.as_tensor(np.concatenate([e, c]), device=dev)
              for e, c in ((epk, cpk), (esg, csg), (emg, cmg))]
    got = ed25519_cuda.verify_batch(*cmp_in)
    want = ed25519_kernel.verify_batch(*cmp_in)
    torch.cuda.synchronize()
    got_np, want_np = got.cpu().numpy(), want.cpu().numpy()
    n_cmp = got_np.shape[0]
    max_abs_err = int(np.abs(got_np.astype(np.int32)
                             - want_np.astype(np.int32)).max())
    if max_abs_err:
        bad = np.nonzero(got_np != want_np)[0][:10].tolist()
        raise AssertionError(f"kernel != plain version at rows {bad}")
    # every edge vector, plus random rows, up to 256
    sample = np.concatenate([np.arange(26), rng.choice(
        np.arange(26, n_cmp), min(230, n_cmp - 26), replace=False)])
    cmp_np = [t.cpu().numpy() for t in cmp_in]
    for r in sample:
        spec = ref.verify(cmp_np[0][r].tobytes(), cmp_np[1][r].tobytes(),
                          cmp_np[2][r].tobytes())
        if bool(got_np[r]) != spec:
            raise AssertionError(f"kernel != spec at row {r}")
    dsm_rows = check_double_scalar(ref, ed25519_cuda, rng, dev)
    emit({"phase": "compare", "rows": n_cmp, "edge_rows": 26,
          "forged_rows": int(forged.size), "accepted": int(got_np.sum()),
          "kernel_eq_plain": True, "spec_sample": int(sample.size),
          "double_scalar_special_rows": dsm_rows,
          "max_abs_err": max_abs_err, "sign_seconds": sign_s})

    # -- 4. main path at full size -------------------------------------------
    idx = np.arange(N_ROWS) % N_TRIPLES
    bad_rows = np.arange(7, N_ROWS, 8)
    tpk, tsg, tmg = forge(pk[idx], sg[idx], mg[idx], bad_rows)
    known = np.ones(N_ROWS, np.bool_)
    known[bad_rows] = False
    padded = pad_signature_batch(N_ROWS)
    pidx = np.arange(padded) % N_ROWS   # repeat real rows (tx_set.py)
    qsets = fba_topology()
    nodes = list(range(len(qsets)))
    qt = Q.build_qset_tensor(qsets, nodes, device=dev)
    rate = rng.uniform(0.3, 1.0, (N_CANDIDATES, 1))
    voted = rng.random((N_CANDIDATES, len(nodes))) < rate
    accepted = rng.random((N_CANDIDATES, len(nodes))) < rate * 0.4
    batch = A.batch_from_numpy(
        tpk[pidx], tsg[pidx], tmg[pidx], [t.cpu().numpy() for t in qt],
        [t[0].cpu().numpy() for t in qt], voted, accepted, dev)
    vt, at = batch.voted, batch.accepted

    torch.cuda.synchronize()
    ed25519_cuda.reset_launches()
    t0 = time.perf_counter()
    sig_ok, accept, ratify = A.admission_step(batch)
    tally_acc, tally_rat = A.multi_validator_tally(qt, vt, at)
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    launches = ed25519_cuda.launches
    if launches < 1:
        raise AssertionError("main path did not launch the ed25519 kernel")

    sig_np = sig_ok.cpu().numpy()
    if sig_np.shape != (padded,) or not np.array_equal(sig_np[:N_ROWS], known):
        raise AssertionError("sig_ok differs from the known forged mask")
    want_acc, want_rat = oracle_tally(qsets, voted, accepted)
    for name, g, w in (("accept", accept, want_acc[0]),
                       ("ratify", ratify, want_rat[0]),
                       ("tally_accept", tally_acc, want_acc),
                       ("tally_ratify", tally_rat, want_rat)):
        if not np.array_equal(g.cpu().numpy(), w):
            raise AssertionError(f"{name} differs from the host oracle")
    emit({"phase": "main", "signatures": N_ROWS, "padded": padded,
          "accepted": int(sig_np[:N_ROWS].sum()), "validators": len(nodes),
          "candidates": N_CANDIDATES, "ratified": int(want_rat[0].sum()),
          "accepted_statements": int(want_acc[0].sum()),
          "launches": {ed25519_cuda.KERNEL: launches},
          "seconds": main_s, "exact": True})

    # -- 5. times ------------------------------------------------------------
    kin = (batch.pubkeys, batch.sigs, batch.msgs)
    kernel_ms = cuda_ms(lambda: ed25519_cuda.verify_batch(*kin))
    plain_full = ed25519_kernel.verify_batch(*kin)
    max_abs_err = max(max_abs_err, int(
        (plain_full.to(torch.int32) - sig_ok.to(torch.int32)).abs().max()))
    if max_abs_err:
        raise AssertionError("plain version differs from the kernel at "
                             f"{padded} rows")
    plain_ms = cuda_ms(lambda: ed25519_kernel.verify_batch(*kin), reps=2)
    small = tuple(t[:N_TRIPLES] for t in kin)
    kernel_ms_4096 = cuda_ms(lambda: ed25519_cuda.verify_batch(*small))
    plain_ms_4096 = cuda_ms(lambda: ed25519_kernel.verify_batch(*small),
                            reps=2)
    step_ms = cuda_ms(lambda: A.admission_step(batch))
    tally_ms = cuda_ms(lambda: A.multi_validator_tally(qt, vt, at))
    t0 = time.perf_counter()
    bound_ms, bound_by, products = bound_ms_verify(
        ref, *(t.cpu().numpy() for t in kin))
    bound_s = time.perf_counter() - t0
    ref10_ms = bound_ms_ref10_count(padded)
    emit({"phase": "times", "card": card_line,
          "verify_kernel_ms": kernel_ms, "verify_rows": padded,
          "verify_sigs_per_s": padded / kernel_ms * 1e3,
          "verify_kernel_ms_4096": kernel_ms_4096,
          "plain_verify_ms": plain_ms, "plain_verify_ms_4096": plain_ms_4096,
          "admission_step_ms": step_ms,
          "admission_real_sigs_per_s": N_ROWS / step_ms * 1e3,
          "multi_validator_tally_ms": tally_ms,
          "verify_bound_ms": bound_ms, "bound_by": bound_by,
          "bound_products": products, "bound_seconds": bound_s,
          "verify_share_of_bound": bound_ms / kernel_ms,
          "verify_bound_ms_ref10_count": ref10_ms,
          "reps": REPS, "plain_reps": 2,
          "total_seconds": time.perf_counter() - t_start})

    emit({"kernels": [{
        "name": ed25519_cuda.KERNEL, "route": "cuda",
        "source": "stellar_core_tpu_torch/csrc/ed25519_verify.cu",
        "replaces": "stellar_core_tpu/ops/ed25519_pallas.py:364",
        "launches": launches, "max_abs_err": max_abs_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "bound_ms_ref10_count": ref10_ms,
        "registers": ptxas["registers"],
        "spill_bytes": ptxas["spill_stores"] + ptxas["spill_loads"],
        "stack_frame_bytes": ptxas["stack_frame_bytes"],
        "blocks_per_sm": shape["blocks_per_sm"]}]})
    print(card_line, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
