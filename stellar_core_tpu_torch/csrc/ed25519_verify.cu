// Batched ed25519 verify for Hopper (sm_90a): one thread per signature.
//
// Replaces the JAX package's Pallas TPU kernel
// stellar_core_tpu/ops/ed25519_pallas.py::_verify_kernel together with the
// XLA prologue of its verify_batch wrapper (SHA-512(R||A||M), reduction mod
// L, window digits, s < L, y < p for A and R, the small-order blacklist):
// all of it is fused here.  In: three uint8 tensors (N,32) (N,64) (N,32).
// Out: one byte 0/1 per row.  Verdicts are those of the spec
// (crypto/ed25519_ref.py: libsodium crypto_sign_verify_detached).
//
// What bounds it on this card: integer instructions.  Per signature the
// ladder, the decompression of A and the inversion of Z take about 1,530
// field squarings and 1,820 multiplications; the bytes moved (128 in and 1
// out a row: 16.9 MB, 0.005 ms of HBM time, for 131,072 rows) are nothing.
// So the design spends registers and instructions, not bandwidth, and each
// step below cuts one of them (PERF.md has the time after each step):
//
// 1. Field: 8 limbs of 32 bits (radix 2^32), lazily reduced: every value
//    stays below 2^256 and folds with 2^256 = 38 mod p.  fe_mul is 64
//    products in carry chains (mad.lo.cc / madc.hi.cc, inline PTX behind
//    the small primitives below), fe_sq 36; fe_freeze makes the canonical
//    value only where one is needed (zero test, parity, encoding).  A field
//    element is 8 registers with no 64-bit accumulators.  Each chain runs
//    over one parity of limbs, so that a product's low and high halves are
//    neighbours, into one of two accumulators (products at even word pairs,
//    products at odd ones) that each keep one register pairing: ptxas then
//    fuses a product into one IMAD.WIDE.U32.X.  Separate low and high
//    chains cost an IMAD, an IMAD.HI and two IADD3.X a product, and one
//    shared accumulator costs register moves.  ref10's radix 2^25.5 in
//    this design spilled and ran slower (PERF.md).
// 2. Points in ref10's systems: doublings in projective (X:Y:Z) at 4S + 3M
//    with no T; T is made only by the doubling before an add (p1p1 -> p3);
//    the -A table is in cached form (Y+X, Y-X, Z, 2dT) and the B table in
//    affine niels form (y+x, y-x, 2dxy), made at build time, so a B add is
//    a mixed add.
// 3. Signed radix-16 digits of s and h read straight from u = k + 0x88..8
//    (digit = nibble - 8), 8 registers a scalar and no digit array; tables
//    of [1..8], negated by swapping Y+X and Y-X.  A zero digit skips its
//    add for its own thread only: a warp runs an add when any lane needs
//    it, which is also why the windows are fixed and not sliding.
// 4. Tables: [1..8](-A) (1 KB a thread) in local memory: 2, 4 or all 8
//    entries in shared memory, laid out [entry][word][thread] so that any
//    choice of entries is conflict-free, measured no faster (all 8 cost
//    occupancy); [1..8]B (768 B) is copied into each block's shared memory.
// 5. Launch: __launch_bounds__(512, 1), so ptxas keeps a thread within 128
//    registers (16 warps an SM); no spills, because R is read again after
//    the ladder instead of being held and p1p1 -> p3 lets its inputs die
//    early.  Launches of 65,536 rows or more take blocks of 512, smaller
//    ones blocks of 128, which spread over more SMs.  Rows are read as
//    16-byte vectors; a row refused by the byte checks or by decompression
//    skips the rest (verify is variable-time on public data, as
//    libsodium's is).
//
// Not used: tensor cores (wgmma / mma), since both operands of every
// product belong to one signature and there is no shared matrix operand;
// TMA / cp.async, since there are no bytes to hide; batch inversion of Z
// (Montgomery's trick), since a warp's one inversion already serves its 32
// rows, so batching over a block saves at most 3/4 of an inversion a warp
// (about 6% of the work) for a serial chain of products.
//
// Constants come from the generated header ed25519_consts.h, written at
// build time from the port's own spec copy (ops/ed25519_cuda.py).
//
// Host check: with ED25519_HOST_CHECK defined (and the CUDA qualifiers
// defined away, see ed25519_host_check.cpp) this file compiles as plain
// C++: the carry-chain primitives take their portable bodies and the
// kernels and launch functions drop out.

#ifndef ED25519_HOST_CHECK
#include <cuda_runtime.h>
#endif
#include <stdint.h>

#include "ed25519_consts.h"

// Launch shape: blocks of ED_THREADS threads, one resident on an SM, which
// caps the registers a thread at 65536 / ED_THREADS = 128.  A launch of
// ED_WIDE_ROWS rows or more takes blocks of ED_THREADS, a smaller one
// blocks of ED_NARROW_THREADS, so that a small batch spreads over more SMs.
#define ED_THREADS 512
#define ED_NARROW_THREADS 128
#define ED_WIDE_ROWS 65536

// The host check counts field squarings and multiplications (the work
// that chip_smoke.py's bound counts); the CUDA build counts nothing.
#ifdef ED25519_HOST_CHECK
static unsigned long ed_n_sq, ed_n_mul;
#define ED_COUNT(n) ((n)++)
#else
#define ED_COUNT(n) ((void)0)
#endif

// ---------------------------------------------------------------------------
// carry-chain primitives: PTX add/sub/mad with the carry flag (CC.CF).  A
// chain is a run of these calls with nothing between them that touches the
// flag; the asm statements are volatile so they keep their order.
// ---------------------------------------------------------------------------

#ifdef ED25519_HOST_CHECK
static uint32_t ed_cf;  // the carry (or borrow) flag of the chain
static inline uint32_t ed_set(uint64_t s) { ed_cf = (uint32_t)(s >> 32) & 1; return (uint32_t)s; }
static inline uint32_t add_cc(uint32_t a, uint32_t b) { return ed_set((uint64_t)a + b); }
static inline uint32_t addc_cc(uint32_t a, uint32_t b) { return ed_set((uint64_t)a + b + ed_cf); }
static inline uint32_t addc(uint32_t a, uint32_t b) { return a + b + ed_cf; }
static inline uint32_t sub_cc(uint32_t a, uint32_t b) { return ed_set((uint64_t)a - b); }
static inline uint32_t subc_cc(uint32_t a, uint32_t b) { return ed_set((uint64_t)a - b - ed_cf); }
static inline uint32_t subc(uint32_t a, uint32_t b) { return a - b - ed_cf; }
static inline uint32_t mul_hi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
static inline uint32_t madlo_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(a * b, c); }
static inline uint32_t madclo_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(a * b, c); }
static inline uint32_t madhi_cc(uint32_t a, uint32_t b, uint32_t c) { return add_cc(mul_hi(a, b), c); }
static inline uint32_t madchi_cc(uint32_t a, uint32_t b, uint32_t c) { return addc_cc(mul_hi(a, b), c); }
static inline uint32_t madchi(uint32_t a, uint32_t b, uint32_t c) { return addc(mul_hi(a, b), c); }
#else
#define ED_PTX2(name, op)                                                       \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b) {          \
        uint32_t r;                                                             \
        asm volatile(op " %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));             \
        return r;                                                               \
    }
#define ED_PTX3(name, op)                                                       \
    __device__ __forceinline__ uint32_t name(uint32_t a, uint32_t b, uint32_t c) { \
        uint32_t r;                                                             \
        asm volatile(op " %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c)); \
        return r;                                                               \
    }
ED_PTX2(add_cc, "add.cc.u32")
ED_PTX2(addc_cc, "addc.cc.u32")
ED_PTX2(addc, "addc.u32")
ED_PTX2(sub_cc, "sub.cc.u32")
ED_PTX2(subc_cc, "subc.cc.u32")
ED_PTX2(subc, "subc.u32")
ED_PTX3(madlo_cc, "mad.lo.cc.u32")
ED_PTX3(madclo_cc, "madc.lo.cc.u32")
ED_PTX3(madhi_cc, "mad.hi.cc.u32")
ED_PTX3(madchi_cc, "madc.hi.cc.u32")
ED_PTX3(madchi, "madc.hi.u32")
#undef ED_PTX2
#undef ED_PTX3
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) { return __umulhi(a, b); }
#endif

// ---------------------------------------------------------------------------
// field: 8 limbs of 32 bits, little-endian, any value below 2^256 standing
// for itself mod p = 2^255 - 19 (2^256 = 38 mod p).  Every operation takes
// and returns such values; fe_freeze gives the canonical one.
// ---------------------------------------------------------------------------

struct fe {
    uint32_t v[8];
};

__device__ __forceinline__ fe fe_add(const fe& a, const fe& b) {
    fe r;
    r.v[0] = add_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r.v[i] = addc_cc(a.v[i], b.v[i]);
    const uint32_t c = addc(0, 0);
    r.v[0] = add_cc(r.v[0], 38 * c);
#pragma unroll
    for (int i = 1; i < 8; i++) r.v[i] = addc_cc(r.v[i], 0);
    // a carry here leaves r < 38: adding 38 cannot carry again
    r.v[0] += 38 * addc(0, 0);
    return r;
}

__device__ __forceinline__ fe fe_sub(const fe& a, const fe& b) {
    fe r;
    r.v[0] = sub_cc(a.v[0], b.v[0]);
#pragma unroll
    for (int i = 1; i < 8; i++) r.v[i] = subc_cc(a.v[i], b.v[i]);
    const uint32_t bw = subc(0, 0);  // 0 or all ones: wrapped by 2^256 = 38
    r.v[0] = sub_cc(r.v[0], bw & 38);
#pragma unroll
    for (int i = 1; i < 8; i++) r.v[i] = subc_cc(r.v[i], 0);
    // a borrow here leaves r >= 2^256 - 38: subtracting 38 cannot borrow
    r.v[0] -= subc(0, 0) & 38;
    return r;
}

__device__ __forceinline__ fe fe_neg(const fe& a) {
    fe z;
#pragma unroll
    for (int i = 0; i < 8; i++) z.v[i] = 0;
    return fe_sub(z, a);
}

// Adds x * y[j] << 32 (at + j) into t for j = j0, j0 + 2, ..., j1 as one
// chain in which the low and high halves of each product are neighbours
// (the products of one parity land on disjoint word pairs, and ptxas fuses
// each pair into one IMAD.WIDE.U32.X).  With carry_out the chain's carry
// is written to t[at + j1 + 2], which must hold 0; without, it must be 0.
__device__ __forceinline__ void mad_pairs(uint32_t* t, int at, uint32_t x, const uint32_t* y,
                                          int j0, int j1, bool carry_out) {
#pragma unroll
    for (int j = j0; j <= j1; j += 2) {
        if (j == j0) t[at + j] = madlo_cc(x, y[j], t[at + j]);
        else t[at + j] = madclo_cc(x, y[j], t[at + j]);
        if (j == j1 && !carry_out) t[at + j + 1] = madchi(x, y[j], t[at + j + 1]);
        else t[at + j + 1] = madchi_cc(x, y[j], t[at + j + 1]);
    }
    if (carry_out) t[at + j1 + 2] = addc(0, 0);
}

// t (16 words, < 2^512) -> lo + 38 hi, folded twice to below 2^256.
__device__ __forceinline__ fe fe_reduce(const uint32_t t[16]) {
    uint32_t r[9];
#pragma unroll
    for (int j = 0; j < 8; j++) r[j] = t[j];
    mad_pairs(r, 0, 38, t + 8, 0, 6, true);   // r8 <= 1
    mad_pairs(r, 0, 38, t + 8, 1, 7, false);  // r8 <= 38: the sum is below 39 * 2^256
    fe o;
    o.v[0] = madlo_cc(r[8], 38, r[0]);
#pragma unroll
    for (int j = 1; j < 8; j++) o.v[j] = addc_cc(r[j], 0);
    o.v[0] += 38 * addc(0, 0);  // a carry leaves o < 38 * 38
    return o;
}

// Adds the products gathered at odd word pairs (o, words 1..15) to those
// at even ones (e), in place.
__device__ __forceinline__ void add_halves(uint32_t e[16], const uint32_t o[16]) {
    e[1] = add_cc(e[1], o[1]);
#pragma unroll
    for (int k = 2; k < 15; k++) e[k] = addc_cc(e[k], o[k]);
    e[15] = addc(e[15], o[15]);
}

// Operand scanning with two accumulators: the products a_j b_i with i + j
// even land on the word pairs (2k, 2k + 1) of e, the others on the pairs
// (2k + 1, 2k + 2) of o, so that each accumulator keeps one register
// pairing for ptxas's IMAD.WIDE.U32.X.  Row i adds to each one chain; the
// chain that ends at j = 6 (word i + 7) carries into word i + 8, still 0
// before the row, and the one that ends at j = 7 has no carry out (after
// row i each accumulator is below 2^(256 + 32 (i + 1))).
__device__ __forceinline__ fe fe_mul(const fe& a, const fe& b) {
    ED_COUNT(ed_n_mul);
    uint32_t e[16], o[16];
#pragma unroll
    for (int k = 0; k < 16; k++) e[k] = o[k] = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const int p = i & 1;  // the first j of e's chain in this row
        mad_pairs(e, i, b.v[i], a.v, p, p + 6, p == 0);
        mad_pairs(o, i, b.v[i], a.v, 1 - p, 7 - p, p == 1);
    }
    add_halves(e, o);
    return fe_reduce(e);
}

// The 28 cross products a_i a_j (i < j) by rows into e and o as in
// fe_mul, summed and doubled, plus the 8 squares.
__device__ __forceinline__ fe fe_sq(const fe& a) {
    ED_COUNT(ed_n_sq);
    uint32_t e[16], o[16];
#pragma unroll
    for (int k = 0; k < 16; k++) e[k] = o[k] = 0;
#pragma unroll
    for (int i = 0; i < 7; i++) {
        const int p = i & 1;
        // e: j = i + 2, i + 4, ... up to 6 + p; o: j = i + 1, i + 3, ... up to 7 - p
        if (i + 2 <= 6 + p) mad_pairs(e, i, a.v[i], a.v, i + 2, 6 + p, p == 0);
        mad_pairs(o, i, a.v[i], a.v, i + 1, 7 - p, p == 1);
    }
    add_halves(e, o);
    uint32_t* t = e;
    t[1] = add_cc(t[1], t[1]);
#pragma unroll
    for (int j = 2; j < 15; j++) t[j] = addc_cc(t[j], t[j]);
    t[15] = addc(t[15], t[15]);
    t[0] = madlo_cc(a.v[0], a.v[0], t[0]);
    t[1] = madchi_cc(a.v[0], a.v[0], t[1]);
#pragma unroll
    for (int i = 1; i < 7; i++) {
        t[2 * i] = madclo_cc(a.v[i], a.v[i], t[2 * i]);
        t[2 * i + 1] = madchi_cc(a.v[i], a.v[i], t[2 * i + 1]);
    }
    t[14] = madclo_cc(a.v[7], a.v[7], t[14]);
    t[15] = madchi(a.v[7], a.v[7], t[15]);
    return fe_reduce(t);
}

// The canonical value: fold bit 255 (v < 2^255 + 19), then subtract p
// when v + 19 reaches 2^255.
__device__ __forceinline__ fe fe_freeze(const fe& a) {
    fe r, s;
    r.v[0] = add_cc(a.v[0], 19 * (a.v[7] >> 31));
#pragma unroll
    for (int i = 1; i < 7; i++) r.v[i] = addc_cc(a.v[i], 0);
    r.v[7] = addc(a.v[7] & 0x7fffffffu, 0);
    s.v[0] = add_cc(r.v[0], 19);
#pragma unroll
    for (int i = 1; i < 7; i++) s.v[i] = addc_cc(r.v[i], 0);
    s.v[7] = addc(r.v[7], 0);
    const bool ge = (s.v[7] >> 31) != 0;
    s.v[7] &= 0x7fffffffu;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = ge ? s.v[i] : r.v[i];
    return r;
}

__device__ __forceinline__ bool fe_iszero(const fe& a) {
    const fe f = fe_freeze(a);
    uint32_t any = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) any |= f.v[i];
    return any == 0;
}

__device__ __forceinline__ uint32_t fe_parity(const fe& a) { return fe_freeze(a).v[0] & 1; }

// Bits 0..254 of a little-endian word string.
__device__ __forceinline__ fe fe_from_words(const uint32_t w[8]) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = w[i];
    r.v[7] &= 0x7fffffffu;
    return r;
}

// The canonical value as little-endian words.
__device__ __forceinline__ void fe_to_words(const fe& a, uint32_t w[8]) {
    const fe f = fe_freeze(a);
#pragma unroll
    for (int i = 0; i < 8; i++) w[i] = f.v[i];
}

__device__ __noinline__ fe fe_sqn(fe f, int n) {
#pragma unroll 1
    for (int i = 0; i < n; i++) f = fe_sq(f);
    return f;
}

__device__ __forceinline__ fe fe_const(const uint32_t* c) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = c[i];
    return r;
}

__device__ __forceinline__ fe fe_small(uint32_t x) {
    fe r;
#pragma unroll
    for (int i = 0; i < 8; i++) r.v[i] = 0;
    r.v[0] = x;
    return r;
}

__device__ __forceinline__ void fe_cswap(fe& a, fe& b, bool swap) {
#pragma unroll
    for (int i = 0; i < 8; i++) {
        const uint32_t x = a.v[i], y = b.v[i];
        a.v[i] = swap ? y : x;
        b.v[i] = swap ? x : y;
    }
}

// z^(2^250 - 1) and z^11: the shared prefix of the ref10 chains.
__device__ __noinline__ void fe_pow_250_1(const fe& z, fe& z_250_0, fe& z11) {
    fe z2 = fe_sq(z);
    fe z9 = fe_mul(fe_sqn(z2, 2), z);
    z11 = fe_mul(z9, z2);
    fe z_5_0 = fe_mul(fe_sq(z11), z9);
    fe z_10_0 = fe_mul(fe_sqn(z_5_0, 5), z_5_0);
    fe z_20_0 = fe_mul(fe_sqn(z_10_0, 10), z_10_0);
    fe z_40_0 = fe_mul(fe_sqn(z_20_0, 20), z_20_0);
    fe z_50_0 = fe_mul(fe_sqn(z_40_0, 10), z_10_0);
    fe z_100_0 = fe_mul(fe_sqn(z_50_0, 50), z_50_0);
    fe z_200_0 = fe_mul(fe_sqn(z_100_0, 100), z_100_0);
    z_250_0 = fe_mul(fe_sqn(z_200_0, 50), z_50_0);
}

__device__ fe fe_invert(const fe& z) {
    fe z_250_0, z11;
    fe_pow_250_1(z, z_250_0, z11);
    return fe_mul(fe_sqn(z_250_0, 5), z11);
}

__device__ fe fe_pow22523(const fe& z) {
    fe z_250_0, z11;
    fe_pow_250_1(z, z_250_0, z11);
    return fe_mul(fe_sqn(z_250_0, 2), z);
}

// ---------------------------------------------------------------------------
// points: ref10's coordinate systems.  p2 (X:Y:Z) projective; p3 adds T =
// XY/Z (extended); p1p1 is a sum or double before its final products;
// cached (Y+X, Y-X, Z, 2dT) is an addend; niels (y+x, y-x, 2dxy) an affine
// addend with Z = 1, read from the B table.
// ---------------------------------------------------------------------------

struct ge_p2 {
    fe X, Y, Z;
};
struct ge_p3 {
    fe X, Y, Z, T;
};
struct ge_p1p1 {
    fe X, Y, Z, T;
};
struct ge_cached {
    fe YplusX, YminusX, Z, T2d;
};

__device__ __forceinline__ ge_p2 p1p1_to_p2(const ge_p1p1& p) {
    ge_p2 r;
    r.X = fe_mul(p.X, p.T);
    r.Y = fe_mul(p.Y, p.Z);
    r.Z = fe_mul(p.Z, p.T);
    return r;
}

// In this order each input dies at its last product: at most five field
// elements are live around a product.
__device__ __forceinline__ ge_p3 p1p1_to_p3(const ge_p1p1& p) {
    ge_p3 r;
    r.T = fe_mul(p.X, p.Y);
    r.Y = fe_mul(p.Y, p.Z);
    r.X = fe_mul(p.X, p.T);
    r.Z = fe_mul(p.Z, p.T);
    return r;
}

__device__ __forceinline__ ge_cached p3_to_cached(const ge_p3& p) {
    ge_cached r;
    r.YplusX = fe_add(p.Y, p.X);
    r.YminusX = fe_sub(p.Y, p.X);
    r.Z = p.Z;
    r.T2d = fe_mul(p.T, fe_const(ED_D2));
    return r;
}

// 2p at 4S (no T needed or made).
__device__ __forceinline__ ge_p1p1 p2_dbl(const ge_p2& p) {
    ge_p1p1 r;
    r.X = fe_sq(p.X);
    r.Z = fe_sq(p.Y);
    const fe zz = fe_sq(p.Z);
    r.T = fe_add(zz, zz);
    const fe t0 = fe_sq(fe_add(p.X, p.Y));
    r.Y = fe_add(r.Z, r.X);
    r.Z = fe_sub(r.Z, r.X);
    r.X = fe_sub(t0, r.Y);
    r.T = fe_sub(r.T, r.Z);
    return r;
}

// p + q, or p - q when neg, at 4M (-q swaps Y+X and Y-X and negates T).
// The swap picks which field element is read, not copies of both, so that
// an entry of the local-memory table is read as it is used.
__device__ __forceinline__ ge_p1p1 ge_add(const ge_p3& p, const ge_cached& q, bool neg) {
    const fe& qp = neg ? q.YminusX : q.YplusX;
    const fe& qm = neg ? q.YplusX : q.YminusX;
    ge_p1p1 r;
    r.X = fe_add(p.Y, p.X);
    r.Y = fe_sub(p.Y, p.X);
    r.Z = fe_mul(r.X, qp);
    r.Y = fe_mul(r.Y, qm);
    r.T = fe_mul(q.T2d, p.T);
    r.X = fe_mul(p.Z, q.Z);
    const fe t0 = fe_add(r.X, r.X);
    r.X = fe_sub(r.Z, r.Y);
    r.Y = fe_add(r.Z, r.Y);
    r.Z = fe_add(t0, r.T);
    r.T = fe_sub(t0, r.T);
    fe_cswap(r.Z, r.T, neg);
    return r;
}

// p + [k]B, or p - [k]B when neg, for k = 1..8 at 3M, from the niels
// table btab (the block's shared copy of ED_BTAB: y+x, y-x, 2dxy a row).
__device__ __forceinline__ ge_p1p1 ge_madd(const ge_p3& p, const uint32_t* btab, int k, bool neg) {
    const uint32_t* q = btab + (k - 1) * 24;
    ge_p1p1 r;
    r.X = fe_add(p.Y, p.X);
    r.Y = fe_sub(p.Y, p.X);
    r.Z = fe_mul(r.X, fe_const(q + (neg ? 8 : 0)));
    r.Y = fe_mul(r.Y, fe_const(q + (neg ? 0 : 8)));
    r.T = fe_mul(fe_const(q + 16), p.T);
    const fe t0 = fe_add(p.Z, p.Z);
    r.X = fe_sub(r.Z, r.Y);
    r.Y = fe_add(r.Z, r.Y);
    r.Z = fe_add(t0, r.T);
    r.T = fe_sub(t0, r.T);
    fe_cswap(r.Z, r.T, neg);
    return r;
}

// ---------------------------------------------------------------------------
// the prologue: checks on the words, SHA-512 of R||A||M, reduction mod L
// ---------------------------------------------------------------------------

// y (bit 255 cleared) < p = 2^255 - 19
__device__ __forceinline__ bool canonical_y(const uint32_t e[8]) {
    uint32_t all = (e[7] & 0x7fffffffu) ^ 0x7fffffffu;
#pragma unroll
    for (int i = 1; i < 7; i++) all |= ~e[i];
    return all != 0 || e[0] < 0xffffffedu;
}

// s < L, both little-endian words
__device__ __forceinline__ bool scalar_canonical(const uint32_t s[8]) {
    bool lt = false;  // decided below word i: s < L there
#pragma unroll
    for (int i = 0; i < 8; i++) lt = s[i] < ED_L_WORDS[i] || (s[i] == ED_L_WORDS[i] && lt);
    return lt;
}

__device__ __forceinline__ bool small_order(const uint32_t e[8]) {
    bool hit = false;
    for (int k = 0; k < ED_N_SMALL_ORDER; k++) {
        uint32_t diff = 0;
#pragma unroll
        for (int i = 0; i < 8; i++) diff |= e[i] ^ ED_SMALL_ORDER[k][i];
        hit |= diff == 0;
    }
    return hit;
}

__device__ __forceinline__ uint64_t rotr64(uint64_t x, int n) {
    return (x >> n) | (x << (64 - n));
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
    return (x >> 24) | ((x >> 8) & 0xff00u) | ((x << 8) & 0xff0000u) | (x << 24);
}

// Bytes 8j..8j+7 of a little-endian word string, read big-endian.
__device__ __forceinline__ uint64_t be64(const uint32_t w[8], int j) {
    return ((uint64_t)bswap32(w[2 * j]) << 32) | bswap32(w[2 * j + 1]);
}

// SHA-512 of the 96-byte R||A||M: exactly one padded block.
__device__ void sha512_96(const uint32_t r[8], const uint32_t a[8],
                          const uint32_t m[8], uint64_t out[8]) {
    uint64_t W[16];
#pragma unroll
    for (int j = 0; j < 4; j++) {
        W[j] = be64(r, j);
        W[4 + j] = be64(a, j);
        W[8 + j] = be64(m, j);
    }
    W[12] = 0x8000000000000000ULL;
    W[13] = 0;
    W[14] = 0;
    W[15] = 96 * 8;
    uint64_t s[8];
#pragma unroll
    for (int i = 0; i < 8; i++) s[i] = SHA512_IV[i];
#pragma unroll
    for (int t = 0; t < 80; t++) {
        if (t >= 16) {
            const uint64_t w15 = W[(t - 15) & 15], w2 = W[(t - 2) & 15];
            const uint64_t s0 = rotr64(w15, 1) ^ rotr64(w15, 8) ^ (w15 >> 7);
            const uint64_t s1 = rotr64(w2, 19) ^ rotr64(w2, 61) ^ (w2 >> 6);
            W[t & 15] += s0 + W[(t - 7) & 15] + s1;
        }
        const uint64_t e = s[4], a0 = s[0];
        const uint64_t S1 = rotr64(e, 14) ^ rotr64(e, 18) ^ rotr64(e, 41);
        const uint64_t ch = (e & s[5]) ^ (~e & s[6]);
        const uint64_t t1 = s[7] + S1 + ch + SHA512_K[t] + W[t & 15];
        const uint64_t S0 = rotr64(a0, 28) ^ rotr64(a0, 34) ^ rotr64(a0, 39);
        const uint64_t maj = (a0 & s[1]) ^ (a0 & s[2]) ^ (s[1] & s[2]);
        const uint64_t t2 = S0 + maj;
        s[7] = s[6]; s[6] = s[5]; s[5] = s[4]; s[4] = s[3] + t1;
        s[3] = s[2]; s[2] = s[1]; s[1] = s[0]; s[0] = t1 + t2;
    }
#pragma unroll
    for (int i = 0; i < 8; i++) out[i] = s[i] + SHA512_IV[i];
}

// The big-endian digest words, read as a 512-bit little-endian integer,
// mod L -> eight 32-bit limbs.  sum_i byte_i * (2^(8i) mod L) < 2^14 L,
// then conditional subtraction of L << k for k = 13..0.
__device__ void reduce512(const uint64_t H[8], uint32_t out[8]) {
    uint64_t acc[9];
#pragma unroll
    for (int k = 0; k < 9; k++) acc[k] = 0;
#pragma unroll 4
    for (int i = 0; i < 64; i++) {
        const uint64_t byte = (H[i >> 3] >> (56 - 8 * (i & 7))) & 0xff;
#pragma unroll
        for (int k = 0; k < 8; k++) acc[k] += byte * ED_POW8[i][k];
    }
    uint32_t r[9];
#pragma unroll
    for (int k = 0; k < 8; k++) {
        acc[k + 1] += acc[k] >> 32;
        r[k] = (uint32_t)acc[k];
    }
    r[8] = (uint32_t)acc[8];
#pragma unroll 1
    for (int k = 13; k >= 0; k--) {
        uint32_t t[9];
        int64_t borrow = 0;
#pragma unroll
        for (int j = 0; j < 9; j++) {
            const int64_t x = (int64_t)r[j] - (int64_t)ED_LSHIFT[k][j] + borrow;
            t[j] = (uint32_t)x;
            borrow = x >> 32;
        }
        if (borrow == 0) {
#pragma unroll
            for (int j = 0; j < 9; j++) r[j] = t[j];
        }
    }
#pragma unroll
    for (int j = 0; j < 8; j++) out[j] = r[j];
}

// ---------------------------------------------------------------------------
// one row
// ---------------------------------------------------------------------------

// x of the point with encoding A (little-endian words), sign and the spec's
// checks folded into ok; y is returned in *y.
__device__ fe decompress(const uint32_t a[8], fe* y_out, bool* ok) {
    const fe one = fe_small(1);
    const fe y = fe_from_words(a);
    const uint32_t sign = a[7] >> 31;
    const fe yy = fe_sq(y);
    const fe u = fe_sub(yy, one);
    const fe v = fe_add(fe_mul(yy, fe_const(ED_D)), one);
    const fe v3 = fe_mul(fe_sq(v), v);
    const fe v7 = fe_mul(fe_sq(v3), v);
    fe x = fe_mul(fe_mul(u, v3), fe_pow22523(fe_mul(u, v7)));
    const fe vxx = fe_mul(v, fe_sq(x));
    const bool direct = fe_iszero(fe_sub(vxx, u));
    const bool flipped = fe_iszero(fe_add(vxx, u));
    if (flipped) x = fe_mul(x, fe_const(ED_SQRTM1));
    const bool x_zero = fe_iszero(x);
    *ok = (direct || flipped) && !(x_zero && sign == 1);
    if (fe_parity(x) != sign) x = fe_neg(x);
    *y_out = y;
    return x;
}

// Signed radix-16 digits without a digit array: u = k + 0x88...8, and
// digit i is nibble i of u minus 8, in [-8, 7].  Exact for k < 2^254 (u
// then stays below 2^256): h < L, and every s that passed s < L.
__device__ __forceinline__ void recode(const uint32_t k[8], uint32_t u[8]) {
    u[0] = add_cc(k[0], 0x88888888u);
#pragma unroll
    for (int i = 1; i < 7; i++) u[i] = addc_cc(k[i], 0x88888888u);
    u[7] = addc(k[7], 0x88888888u);
}

__device__ __forceinline__ int digit(const uint32_t u[8], int i) {
    return (int)((u[i >> 3] >> (4 * (i & 7))) & 15) - 8;
}

// Encoding of [s]B + [h](-A) for A = (x, y), s and h below 2^254: words
// out[8].  btab: the niels [1..8]B table.
__device__ void double_scalar(const fe& x, const fe& y, const uint32_t s[8],
                              const uint32_t h[8], uint32_t out[8],
                              const uint32_t* btab) {
    uint32_t su[8], hu[8];
    recode(s, su);
    recode(h, hu);

    // --- window table [1..8](-A) in cached form, in local memory ---
    ge_p3 run;
    run.X = fe_neg(x);
    run.Y = y;
    run.Z = fe_small(1);
    run.T = fe_neg(fe_mul(x, y));
    const ge_cached neg_a = p3_to_cached(run);
    ge_cached tab[8];
    tab[0] = neg_a;
#pragma unroll 1
    for (int i = 1; i < 8; i++) {
        run = p1p1_to_p3(ge_add(run, neg_a, false));
        tab[i] = p3_to_cached(run);
    }

    // --- MSB-first shared-doubling ladder over 64 signed digits; a digit
    // of 0 adds nothing ---
    ge_p2 acc;
    acc.X = fe_small(0);
    acc.Y = fe_small(1);
    acc.Z = fe_small(1);
#pragma unroll 1
    for (int i = 63; i >= 0; i--) {
#pragma unroll 1
        for (int d = 0; d < 3; d++) acc = p1p1_to_p2(p2_dbl(acc));
        ge_p3 a3 = p1p1_to_p3(p2_dbl(acc));
        const int hd = digit(hu, i), sd = digit(su, i);
        if (hd != 0) a3 = p1p1_to_p3(ge_add(a3, tab[(hd < 0 ? -hd : hd) - 1], hd < 0));
        if (sd != 0) {
            acc = p1p1_to_p2(ge_madd(a3, btab, sd < 0 ? -sd : sd, sd < 0));
        } else {
            acc.X = a3.X;
            acc.Y = a3.Y;
            acc.Z = a3.Z;
        }
    }

    // --- canonical encoding ---
    const fe zi = fe_invert(acc.Z);
    fe_to_words(fe_mul(acc.Y, zi), out);
    out[7] |= fe_parity(fe_mul(acc.X, zi)) << 31;
}

// The checks of one row, from its 32-byte fields as little-endian words,
// and the encoding of R' = [s]B + [h](-A) in enc; the row is accepted when
// they pass and enc equals the R bytes (encoding_matches).  The caller
// compares with a fresh copy of R, so that R's words are not held in
// registers across the ladder.  Verify is variable-time on public data (as
// libsodium's): a row refused by the byte checks or by decompression skips
// the rest and leaves enc unset.
__device__ bool verify_row(const uint32_t A[8], const uint32_t R[8],
                           const uint32_t S[8], const uint32_t M[8],
                           const uint32_t* btab, uint32_t enc[8]) {
    if (!(scalar_canonical(S) && canonical_y(A) && canonical_y(R) &&
          !small_order(A) && !small_order(R)))
        return false;
    fe y;
    bool ok;
    const fe x = decompress(A, &y, &ok);
    if (!ok) return false;
    uint64_t H[8];
    sha512_96(R, A, M, H);
    uint32_t h[8];
    reduce512(H, h);
    double_scalar(x, y, S, h, enc, btab);
    return true;
}

__device__ __forceinline__ bool encoding_matches(const uint32_t enc[8], const uint32_t R[8]) {
    uint32_t diff = 0;
#pragma unroll
    for (int i = 0; i < 8; i++) diff |= enc[i] ^ R[i];
    return diff == 0;
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

#ifndef ED25519_HOST_CHECK

// One 32-byte field of a row as two 16-byte loads (rows are 16-byte
// aligned: the wrapper passes aligned base pointers).  Volatile, so that a
// second load of the same field is a load and not a register kept alive.
__device__ __forceinline__ void load_row(const uint8_t* p, uint32_t w[8]) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[4]), "=r"(w[5]), "=r"(w[6]), "=r"(w[7]) : "l"(p + 16));
}

// Copies the niels [1..8]B table into the block's shared memory.
__device__ __forceinline__ void load_btab(uint32_t* btab) {
    for (int i = threadIdx.x; i < 8 * 24; i += blockDim.x)
        btab[i] = (&ED_BTAB[0][0][0])[i];
    __syncthreads();
}

__global__ void __launch_bounds__(ED_THREADS, 1)
ed25519_verify_kernel(const uint8_t* __restrict__ pk, const uint8_t* __restrict__ sig,
                      const uint8_t* __restrict__ msg, uint8_t* __restrict__ out, int n) {
    __shared__ uint32_t btab[8 * 24];
    load_btab(btab);
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    uint32_t A[8], R[8], S[8], M[8];
    load_row(pk + (size_t)row * 32, A);
    load_row(sig + (size_t)row * 64, R);
    load_row(sig + (size_t)row * 64 + 32, S);
    load_row(msg + (size_t)row * 32, M);
    uint32_t enc[8];
    bool accept = verify_row(A, R, S, M, btab, enc);
    if (accept) {
        load_row(sig + (size_t)row * 64, R);
        accept = encoding_matches(enc, R);
    }
    out[row] = (uint8_t)accept;
}

// Test-only: the encoding of [s]B + [h](-A) per row (A decoded without the
// verdict's checks), through the verify kernel's own device functions.
__global__ void __launch_bounds__(ED_THREADS, 1)
ed25519_dsm_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ s,
                   const uint8_t* __restrict__ h, uint8_t* __restrict__ out, int n) {
    __shared__ uint32_t btab[8 * 24];
    load_btab(btab);
    const int row = blockIdx.x * blockDim.x + threadIdx.x;
    if (row >= n) return;
    uint32_t A[8], S[8], H[8], enc[8];
    load_row(a + (size_t)row * 32, A);
    load_row(s + (size_t)row * 32, S);
    load_row(h + (size_t)row * 32, H);
    fe y;
    bool ok;
    const fe x = decompress(A, &y, &ok);
    double_scalar(x, y, S, H, enc, btab);
    uint4* o = reinterpret_cast<uint4*>(out + (size_t)row * 32);
    o[0] = make_uint4(enc[0], enc[1], enc[2], enc[3]);
    o[1] = make_uint4(enc[4], enc[5], enc[6], enc[7]);
}

static int launch_threads(int n) {
    return n >= ED_WIDE_ROWS ? ED_THREADS : ED_NARROW_THREADS;
}

template <typename K>
static int launch(K kernel, const void* a, const void* b, const void* c, void* out,
                  int n, void* stream) {
    if (n <= 0) return 0;
    const int threads = launch_threads(n);
    const int blocks = (n + threads - 1) / threads;
    kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)a, (const uint8_t*)b, (const uint8_t*)c, (uint8_t*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int ed25519_verify_launch(const void* pk, const void* sig, const void* msg,
                                     void* out, int n, void* stream) {
    return launch(ed25519_verify_kernel, pk, sig, msg, out, n, stream);
}

extern "C" int ed25519_dsm_launch(const void* a, const void* s, const void* h, void* out,
                                  int n, void* stream) {
    return launch(ed25519_dsm_kernel, a, s, h, out, n, stream);
}

// Threads a block of a launch of n rows, and the blocks of the verify
// kernel resident on one SM at that size (-1 on error).
extern "C" int ed25519_verify_threads(int n) { return launch_threads(n); }

extern "C" int ed25519_verify_blocks_per_sm(int n) {
    int blocks = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, ed25519_verify_kernel,
                                                      launch_threads(n), 0) != cudaSuccess)
        return -1;
    return blocks;
}

#endif  // ED25519_HOST_CHECK
