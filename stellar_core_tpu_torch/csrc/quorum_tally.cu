// One live SCP federated tally (accept or ratify) in one thread block.
//
// Replaces no Pallas kernel: the JAX package's quorum math
// (stellar_core_tpu/ops/quorum.py) is plain jnp, and the port carried it
// over as torch ops (ops/quorum.py).  On the live tally those ops are ~35
// launches a call and a host synchronisation after every contraction trip,
// on a few hundred bytes of membership and a few thousand integer compares.
// Launches and host round trips bound that work, not bytes or operations.
// This kernel runs the whole vote of one call in one block: the
// v-blocking test (accept), the greatest-fixpoint contraction trip after
// trip, and the local slice check, and writes one verdict byte.  Its
// launch function copies the vote rows in and the verdict out on the same
// stream, so that a call is one copy in, one launch, one copy out and the
// caller's one synchronisation.
//
// Inputs are the tally engine's dense QSetTensors as ops/quorum.py lays
// them out: every node's qset (top (N, N) bool, thr (N,) int32, inner
// (N, K, N) bool, ithr (N, K) int32) and the local node's (ltop (N,),
// lthr (), linner (KL, N), lithr (KL,)), and R vote rows of N bools: for
// accept (R = 2) accepted, then voted-or-accepted; for ratify (R = 1)
// voted.  The arithmetic is the JAX einsums', in integers: a set's count
// is its members inside the node-set, an inner set counts toward its
// parent when its count reaches a threshold above 0 (threshold 0 is a
// padding slot: never satisfied, never counted), a node's slice holds when
// its top-level members and satisfied inner sets reach its threshold.  A
// node whose qset is unknown has the qset (1, [], []) and can never stay.
//
// Design: one warp decides one node at a time (warps stride over the N
// nodes); its lanes stride over the N columns and count with a ballot.
// The member set lives in shared memory, twice (this trip's and the
// next), and a trip ends in one __syncthreads and a shared "changed"
// flag: the loop stops at the first trip that drops no node, and after N
// trips at most, as ops/quorum.py::contract_fixpoint does.  The qsets are
// read in place through L1 and L2: staging them in shared memory first
// (tried at N = 1, 21 and 50) made no launch faster.
//
// Host check: with QUORUM_TALLY_HOST_CHECK defined (see
// quorum_tally_host_check.cpp) this file compiles as plain C++: the block
// is one warp of one lane, __syncthreads is a no-op, and a ballot's count
// is a loop, so that the block's logic (the trip loop and its flags, the
// verdict) runs on the host.

#ifndef QUORUM_TALLY_HOST_CHECK
#include <cuda_runtime.h>
#endif
#include <stddef.h>
#include <stdint.h>

// Warps a block, at most: one node each at a time.
#define QT_MAX_WARPS 32

#ifdef QUORUM_TALLY_HOST_CHECK
#define QT_DEVICE static inline
static inline int qt_thread() { return 0; }
static inline int qt_threads() { return 1; }
static inline int qt_warp() { return 0; }
static inline int qt_warps() { return 1; }
static inline int qt_lane() { return 0; }
static inline void qt_sync() {}
#else
#define QT_DEVICE __device__ __forceinline__
QT_DEVICE int qt_thread() { return threadIdx.x; }
QT_DEVICE int qt_threads() { return blockDim.x; }
QT_DEVICE int qt_warp() { return threadIdx.x >> 5; }
QT_DEVICE int qt_warps() { return blockDim.x >> 5; }
QT_DEVICE int qt_lane() { return threadIdx.x & 31; }
QT_DEVICE void qt_sync() { __syncthreads(); }
#endif

// Members of `row` inside `set` (outside it, with `invert`), over n
// columns.  On the card the whole warp calls it and every lane gets the
// count.
QT_DEVICE int warp_count(const uint8_t* row, const uint8_t* set, int n, bool invert) {
    int c = 0;
#ifdef QUORUM_TALLY_HOST_CHECK
    for (int j = 0; j < n; ++j) c += row[j] && ((set[j] != 0) != invert);
#else
    for (int base = 0; base < n; base += 32) {
        const int j = base + qt_lane();
        const bool hit = j < n && row[j] && ((set[j] != 0) != invert);
        c += __popc(__ballot_sync(0xffffffffu, hit));
    }
#endif
    return c;
}

// Top-level members and satisfied inner sets of one qset inside `set`
// (outside it, with `invert`): ops/quorum.py::_hits.
QT_DEVICE int qset_hits(const uint8_t* top, const uint8_t* inner, const int32_t* ithr, int k,
                        int n, const uint8_t* set, bool invert) {
    int h = warp_count(top, set, n, invert);
    for (int s = 0; s < k; ++s) {
        const int32_t t = ithr[s];
        if (t > 0 && warp_count(inner + (size_t)s * n, set, n, invert) >= t) ++h;
    }
    return h;
}

// The qsets as the engine lays them out, in device memory.
struct QSets {
    const uint8_t* top;     // (N, N)
    const int32_t* thr;     // (N,)
    const uint8_t* inner;   // (N, K, N)
    const int32_t* ithr;    // (N, K)
    const uint8_t* ltop;    // (N,)
    const int32_t* lthr;    // ()
    const uint8_t* linner;  // (KL, N)
    const int32_t* lithr;   // (KL,)
    int n, k, kl;
};

struct QTResult {
    int verdict;  // thread 0's
    int trips;    // contraction trips run (0 when v-blocking decided)
};

// The block's whole tally.  `smem` holds 2 * n bytes of shared memory
// (the member set twice); `flags` 4 ints of shared memory.
QT_DEVICE QTResult tally_block(QSets q, const uint8_t* rows, int n_rows, uint8_t* smem,
                               int* flags) {
    const int n = q.n, k = q.k, kl = q.kl;
    const int warp = qt_warp(), warps = qt_warps(), lane = qt_lane();
    uint8_t* cur = smem;
    uint8_t* nxt = smem + n;
    const uint8_t* voted = rows + (size_t)(n_rows - 1) * n;
    for (int i = qt_thread(); i < n; i += qt_threads()) cur[i] = voted[i] != 0;
    if (qt_thread() == 0) flags[0] = flags[1] = flags[2] = flags[3] = 0;
    // flags[3]: the verdict is known (v-blocking accepted set)
    if (n_rows == 2 && warp == 0) {
        const int32_t t = *q.lthr;
        const bool vblock =
            t > 0 && qset_hits(q.ltop, q.linner, q.lithr, kl, n, rows, true) < t;
        if (lane == 0 && vblock) flags[3] = 1;
    }
    qt_sync();
    if (flags[3]) return QTResult{1, 0};

    // flags[trip % 3] is set when trip drops a node; thread 0 clears the
    // next trip's flag, whose last reader finished two barriers ago.
    int trips = 0;
    for (int trip = 0; trip < n; ++trip) {
        int* changed = &flags[trip % 3];
        for (int i = warp; i < n; i += warps) {
            bool stay = false;
            if (cur[i])
                stay = qset_hits(q.top + (size_t)i * n, q.inner + (size_t)i * k * n,
                                 q.ithr + (size_t)i * k, k, n, cur, false) >= q.thr[i];
            if (lane == 0) {
                nxt[i] = stay;
                if (stay != (cur[i] != 0)) *changed = 1;
            }
        }
        if (qt_thread() == 0) flags[(trip + 1) % 3] = 0;
        qt_sync();
        ++trips;
        if (!*changed) break;
        uint8_t* t = cur;
        cur = nxt;
        nxt = t;
    }
    int verdict = 0;
    if (warp == 0) {
        const bool any = warp_count(cur, cur, n, false) > 0;
        verdict = any && qset_hits(q.ltop, q.linner, q.lithr, kl, n, cur, false) >= *q.lthr;
    }
    return QTResult{verdict, trips};
}

#ifndef QUORUM_TALLY_HOST_CHECK

__global__ void __launch_bounds__(32 * QT_MAX_WARPS)
quorum_tally_kernel(QSets q, const uint8_t* __restrict__ rows, int n_rows,
                    uint8_t* __restrict__ out) {
    extern __shared__ uint8_t qt_smem[];
    __shared__ int flags[4];
    const QTResult r = tally_block(q, rows, n_rows, qt_smem, flags);
    if (threadIdx.x == 0) out[0] = (uint8_t)r.verdict;
}

// One tally on `stream`: the R x N vote rows from pinned host memory
// `h_rows` to `d_rows`, the launch, and the verdict byte from `d_out` to
// pinned `h_out`.  Returns the first CUDA error (0: all enqueued); the
// caller synchronises the stream before it reads `h_out`.
extern "C" int quorum_tally_launch(const void* top, const void* thr, const void* inner,
                                   const void* ithr, const void* ltop, const void* lthr,
                                   const void* linner, const void* lithr, int n, int k, int kl,
                                   const void* h_rows, void* d_rows, int n_rows, void* d_out,
                                   void* h_out, void* stream) {
    if (n <= 0 || k < 0 || kl < 0 || (n_rows != 1 && n_rows != 2))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemcpyAsync(d_rows, h_rows, (size_t)n_rows * n,
                                    cudaMemcpyHostToDevice, s);
    if (e != cudaSuccess) return (int)e;
    const QSets q{(const uint8_t*)top,   (const int32_t*)thr,    (const uint8_t*)inner,
                  (const int32_t*)ithr,  (const uint8_t*)ltop,   (const int32_t*)lthr,
                  (const uint8_t*)linner, (const int32_t*)lithr, n, k, kl};
    const int warps = n < QT_MAX_WARPS ? n : QT_MAX_WARPS;
    quorum_tally_kernel<<<1, 32 * warps, 2 * (size_t)n, s>>>(q, (const uint8_t*)d_rows, n_rows,
                                                           (uint8_t*)d_out);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    return (int)cudaMemcpyAsync(h_out, d_out, 1, cudaMemcpyDeviceToHost, s);
}

#endif  // QUORUM_TALLY_HOST_CHECK
