"""The CUDA verify kernel's arithmetic, checked on the host: g++ compiles
``csrc/ed25519_verify.cu`` as plain C++ (the carry-chain primitives on
their portable bodies, the kernels and launch functions left out) through
the host program ``csrc/ed25519_host_check.cpp``, under AddressSanitizer and
UBSan, and its results are held against Python ints mod p and the port's
spec copy.  The PTX bodies of the primitives run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Tolerance: exact equality."""
import os
import shutil
import subprocess

import numpy as np
import pytest

import chip_smoke
from chip_smoke import SPECIAL_SCALARS, edge_vectors, forge
from stellar_core_tpu_torch.crypto import ed25519_ref as ref
from stellar_core_tpu_torch.crypto.sha import sha256
from stellar_core_tpu_torch.ops import ed25519_cuda

P, L = ref.P, ref.L
CSRC = os.path.join(os.path.dirname(ed25519_cuda.__file__), os.pardir, "csrc")
M256 = (1 << 256) - 1

# Values at the edges of the lazy range [0, 2^256) and of p.
EDGE_VALUES = [0, 1, 2, 19, 38, P - 1, P, P + 1, P + 18, 2**255 - 1, 2**255,
               2 * P - 1, 2 * P, 2**256 - 39, 2**256 - 38, 2**256 - 1,
               2**32 - 1, 2**224, (1 << 256) // 3]

def _hex(v: int, n: int = 32) -> str:
    return v.to_bytes(n, "little").hex()


def _int(h: str) -> int:
    return int.from_bytes(bytes.fromhex(h), "little")


@pytest.fixture(scope="module")
def host_check(tmp_path_factory):
    """Compile the host program once; returns run(lines) -> output lines."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source as host C++")
    tmp = tmp_path_factory.mktemp("ed25519_host")
    (tmp / "ed25519_consts.h").write_text(ed25519_cuda.consts_header())
    exe = tmp / "host_check"
    subprocess.run(
        [gxx, "-std=c++17", "-O1", "-fsanitize=address,undefined",
         "-fno-sanitize-recover=all", "-I", str(tmp), "-I", CSRC,
         os.path.join(CSRC, "ed25519_host_check.cpp"), "-o", str(exe)],
        check=True, capture_output=True, text=True)

    def run(lines):
        res = subprocess.run(
            [str(exe)], input="\n".join(lines) + "\n", capture_output=True,
            text=True, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
        assert res.returncode == 0, res.stderr
        out = res.stdout.splitlines()
        assert len(out) == len(lines)
        return out

    return run


def _values(seed, n=48):
    rng = np.random.default_rng(seed)
    rand = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    return EDGE_VALUES + rand


OPS = {"add": lambda a, b: a + b, "sub": lambda a, b: a - b,
       "mul": lambda a, b: a * b}


@pytest.mark.parametrize("op", sorted(OPS))
def test_binary_field_ops_match_python_ints(host_check, op):
    vals = _values(1)
    pairs = [(a, b) for a in vals[:12] for b in vals[:12]] + list(
        zip(vals, reversed(vals)))
    out = host_check([f"{op} {_hex(a)} {_hex(b)}" for a, b in pairs])
    for (a, b), o in zip(pairs, out):
        assert _int(o) % P == OPS[op](a, b) % P, (op, a, b)


@pytest.mark.parametrize("op", ["sq", "neg", "frz"])
def test_unary_field_ops_match_python_ints(host_check, op):
    vals = _values(2)
    out = host_check([f"{op} {_hex(a)}" for a in vals])
    for a, o in zip(vals, out):
        want = {"sq": a * a, "neg": -a, "frz": a}[op] % P
        got = _int(o)
        assert got % P == want, (op, a)
        if op == "frz":
            assert got == want   # canonical: below p


@pytest.mark.parametrize("op", ["inv", "pow"])
def test_exponent_chains_match_python_ints(host_check, op):
    vals = [v for v in _values(3, n=16) if v % P]
    out = host_check([f"{op} {_hex(a)}" for a in vals])
    e = P - 2 if op == "inv" else (P - 5) // 8
    for a, o in zip(vals, out):
        assert _int(o) % P == pow(a, e, P), (op, a)


def test_decompress_matches_spec(host_check):
    rng = np.random.default_rng(4)
    encs = [ref.public_from_seed(rng.bytes(32)) for _ in range(24)]
    encs += list(ref.SMALL_ORDER_ENCODINGS)
    encs += [v.to_bytes(32, "little") for v in (2, 5, 9, (1 << 255) | 1)]
    out = host_check([f"dec {e.hex()}" for e in encs])
    for e, o in zip(encs, out):
        ok, x, y = o.split()
        pt = ref.decode_point(e)
        assert (ok == "1") == (pt is not None), e.hex()
        if pt is not None:
            assert (_int(x), _int(y)) == (pt[0], pt[1]), e.hex()


@pytest.mark.parametrize("name", sorted(SPECIAL_SCALARS) + ["seeded"])
def test_recoding_gives_signed_digits_of_the_scalar(host_check, name):
    """64 digits in [-8, 7] whose radix-16 value is the scalar."""
    if name == "seeded":
        rng = np.random.default_rng(6)
        ks = [int.from_bytes(rng.bytes(32), "little") >> 3 for _ in range(32)]
    else:
        ks = [SPECIAL_SCALARS[name]]
    out = host_check([f"rec {_hex(k)}" for k in ks])
    for k, o in zip(ks, out):
        d = [int(x) for x in o.split()]
        assert len(d) == 64 and all(-8 <= x <= 7 for x in d)
        assert sum(x << (4 * i) for i, x in enumerate(d)) == k


def _neg_a(enc: bytes):
    return ref.point_neg(ref.decode_point(enc))


@pytest.mark.parametrize("name", sorted(SPECIAL_SCALARS))
def test_double_scalar_special_scalars_match_spec(host_check, name):
    """The special scalar as s (with a seeded h) and as h (with a seeded
    s), and as both."""
    k = SPECIAL_SCALARS[name]
    assert k < 2**253 and chip_smoke.L == L
    rng = np.random.default_rng(5)
    a = ref.public_from_seed(rng.bytes(32))
    other = int.from_bytes(rng.bytes(32), "little") % L
    cases = [(k, other), (other, k), (k, k)]
    out = host_check([f"dsm {a.hex()} {_hex(s)} {_hex(h)}" for s, h in cases])
    for (s, h), o in zip(cases, out):
        want = ref.encode_point(ref.double_scalar_mult(s, h, _neg_a(a)))
        assert bytes.fromhex(o) == want, (name, s, h)


@pytest.mark.parametrize("s", [L, L + 1, 2**253, 2**255 - 1, 2**255,
                               M256 - L, M256])
def test_out_of_range_s_is_refused_without_stray_reads(host_check, s):
    """s >= L is refused; up to 2^256 - 1 it reads nothing out of range
    (the binary runs under AddressSanitizer)."""
    seed, msg = sha256(b"host-s"), sha256(b"host-s-msg")
    pk, sig = ref.public_from_seed(seed), ref.sign(seed, msg)
    bad = sig[:32] + s.to_bytes(32, "little")
    (o,) = host_check([f"ver {pk.hex()} {bad.hex()} {msg.hex()}"])
    assert o == "0" and not ref.verify(pk, bad, msg)


def _verdict_lines(pk, sg, mg):
    return [f"ver {pk[i].tobytes().hex()} {sg[i].tobytes().hex()} "
            f"{mg[i].tobytes().hex()}" for i in range(pk.shape[0])]


def test_verdicts_on_edge_vectors_match_spec(host_check):
    pk, sg, mg = edge_vectors(ref, sha256)
    assert pk.shape[0] == 26
    out = host_check(_verdict_lines(pk, sg, mg))
    want = [ref.verify(pk[i].tobytes(), sg[i].tobytes(), mg[i].tobytes())
            for i in range(26)]
    assert [o == "1" for o in out] == want
    assert want[0] and sum(want) == 1


@pytest.mark.parametrize("seed", [0, 1])
def test_verdicts_on_seeded_rows_match_spec(host_check, seed):
    """128 signed rows per seed from 16 keys, every 8th forged."""
    rng = np.random.default_rng(100 + seed)
    seeds = [sha256(b"host-key%d-%d" % (seed, k)) for k in range(16)]
    mg = rng.integers(0, 256, (128, 32), dtype=np.uint8)
    pk = np.stack([np.frombuffer(ref.public_from_seed(seeds[i % 16]),
                                 np.uint8) for i in range(128)])
    sg = np.stack([np.frombuffer(ref.sign(seeds[i % 16], mg[i].tobytes()),
                                 np.uint8) for i in range(128)])
    pk, sg, mg = forge(pk, sg, mg, np.arange(7, 128, 8))
    out = host_check(_verdict_lines(pk, sg, mg))
    want = [ref.verify(pk[i].tobytes(), sg[i].tobytes(), mg[i].tobytes())
            for i in range(128)]
    assert [o == "1" for o in out] == want
    assert sum(want) == 128 - 16


def _work_rows(kind):
    """(pk, sig, msg) byte rows: the edge vectors, seeded signed rows (1/8
    forged), or rows whose s is a special scalar (zero digits), with a
    seeded R and msg."""
    if kind == "edge":
        cols = edge_vectors(ref, sha256)
        return [tuple(c[i].tobytes() for c in cols)
                for i in range(cols[0].shape[0])]
    rng = np.random.default_rng(200)
    seeds = [rng.bytes(32) for _ in range(8)]
    if kind == "seeded":
        rows = []
        for i in range(64):
            msg = rng.bytes(32)
            sig = bytearray(ref.sign(seeds[i % 8], msg))
            if i % 8 == 7:
                sig[i % 64] ^= 1
            rows.append((ref.public_from_seed(seeds[i % 8]), bytes(sig), msg))
        return rows
    return [(ref.public_from_seed(seeds[i % 8]),
             ref.public_from_seed(seeds[(i + 1) % 8]) + k.to_bytes(32, "little"),
             rng.bytes(32))
            for i, k in enumerate(SPECIAL_SCALARS.values())]


@pytest.mark.parametrize("kind", ["edge", "seeded", "special"])
def test_bound_counts_the_work_the_kernel_does(host_check, kind):
    """chip_smoke.verify_work, the work that the kernel's bound counts,
    equals the field squarings and multiplications that the kernel source
    does on each row: none for rows the byte checks refuse, the
    decompression alone for an A off the curve, and the zero digits of h
    and s skipped."""
    rows = _work_rows(kind)
    out = host_check([f"work {a.hex()} {s.hex()} {m.hex()}"
                      for a, s, m in rows])
    works = [chip_smoke.verify_work(ref, *row) for row in rows]
    assert [tuple(int(x) for x in o.split()) for o in out] == works
    full = [w for w in works if w[0] == 1533]
    assert full and all(w[1] <= 1825 for w in full)
    if kind == "special":   # s = 0: 64 zero digits, no B add at all
        assert works[list(SPECIAL_SCALARS).index("0")][1] <= 1825 - 64 * 6
