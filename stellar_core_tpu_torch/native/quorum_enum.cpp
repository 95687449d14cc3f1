// Pruned min-quorum enumeration over word-packed node sets — the native
// host tier of the quorum-intersection checker (BASELINE config #3).
//
// Behavioral spec: the reference's MinQuorumEnumerator branch-and-bound
// (ref src/herder/QuorumIntersectionCheckerImpl.cpp:124 — early exits X1
// committed > |SCC|/2, X2 perimeter quorum must extend committed, X3
// committed contracts to a quorum: terminal, minimal ones examined for a
// disjoint complement quorum; split node by in-degree heuristic :59).
// This file is a fresh implementation against that spec: the search is an
// explicit stack (no recursion), the quorum cache is a capped hash map,
// the split heuristic is deterministic (ties -> highest index) so the
// Python/device enumerator in herder/quorum_intersection.py walks the
// *identical* tree and can be differential-tested call-for-call.
//
// Scope: 2-level quorum sets (the production org shape; matches the
// QSetTensor form in ops/quorum.py).  Deeper nesting stays on the Python
// path.  The caller passes node sets restricted to the scan SCC.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

using u64 = uint64_t;

struct Ctx {
    int n = 0;
    int W = 0;  // words per mask
    const int32_t* top_thr = nullptr;
    const u64* top_mem = nullptr;      // n * W
    const int32_t* inner_off = nullptr;  // n + 1
    const int32_t* inner_thr = nullptr;
    const u64* inner_mem = nullptr;    // total * W
    std::vector<u64> succ;             // n * W: all nodes i's qset references
    volatile int32_t* interrupt = nullptr;
    int64_t calls = 0;
    int64_t max_calls = 0;
    // isAQuorum cache keyed by mask words (ref mCachedQuorums :391)
    struct VecHash {
        size_t operator()(const std::vector<u64>& v) const {
            size_t h = 1469598103934665603ull;
            for (u64 w : v) {
                h ^= (size_t)w;
                h *= 1099511628211ull;
            }
            return h;
        }
    };
    std::unordered_map<std::vector<u64>, bool, VecHash> quorum_cache;
};

inline int popcount_and(const u64* a, const u64* b, int W) {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __builtin_popcountll(a[w] & b[w]);
    return c;
}

inline bool get_bit(const u64* m, int i) {
    return (m[i >> 6] >> (i & 63)) & 1;
}

inline void set_bit(u64* m, int i) { m[i >> 6] |= (u64)1 << (i & 63); }
inline void clear_bit(u64* m, int i) { m[i >> 6] &= ~((u64)1 << (i & 63)); }

inline bool any(const u64* m, int W) {
    for (int w = 0; w < W; ++w)
        if (m[w]) return true;
    return false;
}

inline int popcount(const u64* m, int W) {
    int c = 0;
    for (int w = 0; w < W; ++w) c += __builtin_popcountll(m[w]);
    return c;
}

// Does `bs` satisfy node i's quorum slice?  Top-level member count plus
// satisfied inner sets must reach the threshold (2-level only; success /
// fail short-circuits like the reference's containsQuorumSlice :318).
bool contains_slice(const Ctx& c, const u64* bs, int node) {
    int thr = c.top_thr[node];
    if (thr <= 0) return false;
    int hits = popcount_and(bs, c.top_mem + (size_t)node * c.W, c.W);
    if (hits >= thr) return true;
    int lo = c.inner_off[node], hi = c.inner_off[node + 1];
    int need = thr - hits;
    if (need > hi - lo) return false;
    int fail_budget = (hi - lo) - need + 1;
    for (int k = lo; k < hi; ++k) {
        int ithr = c.inner_thr[k];
        bool ok = ithr > 0 &&
                  popcount_and(bs, c.inner_mem + (size_t)k * c.W, c.W) >= ithr;
        if (ok) {
            if (--need == 0) return true;
        } else {
            if (--fail_budget == 0) return false;
        }
    }
    return false;
}

// Greatest fixpoint of f(X) = {i in X | contains_slice(X, i)}
// (ref contractToMaximalQuorum :407).  In-place.
void contract(const Ctx& c, u64* m) {
    bool changed = true;
    while (changed) {
        changed = false;
        for (int i = 0; i < c.n; ++i) {
            if (get_bit(m, i) && !contains_slice(c, m, i)) {
                clear_bit(m, i);
                changed = true;
            }
        }
    }
}

bool is_a_quorum(Ctx& c, const u64* m) {
    std::vector<u64> key(m, m + c.W);
    auto it = c.quorum_cache.find(key);
    if (it != c.quorum_cache.end()) return it->second;
    std::vector<u64> t = key;
    contract(c, t.data());
    bool res = any(t.data(), c.W);
    if (c.quorum_cache.size() < (1u << 20)) c.quorum_cache.emplace(key, res);
    return res;
}

// No single-node removal leaves a subquorum (ref isMinimalQuorum :449).
bool is_minimal_quorum(Ctx& c, const u64* q) {
    std::vector<u64> probe(q, q + c.W);
    for (int i = 0; i < c.n; ++i) {
        if (!get_bit(q, i)) continue;
        clear_bit(probe.data(), i);
        if (is_a_quorum(c, probe.data())) return false;
        set_bit(probe.data(), i);
    }
    return true;
}

// Deterministic in-degree split heuristic (ref pickSplitNode :59,
// derandomized: ties resolve to the highest node index so the Python
// enumerator explores the same tree).
int pick_split(const Ctx& c, const u64* remaining,
               std::vector<int32_t>& indeg) {
    indeg.assign(c.n, 0);
    int max_node = -1;
    for (int i = c.n - 1; i >= 0; --i)
        if (get_bit(remaining, i)) {
            max_node = i;
            break;
        }
    for (int i = 0; i < c.n; ++i) {
        if (!get_bit(remaining, i)) continue;
        const u64* s = c.succ.data() + (size_t)i * c.W;
        for (int w = 0; w < c.W; ++w) {
            u64 bits = s[w] & remaining[w];
            while (bits) {
                int j = (w << 6) + __builtin_ctzll(bits);
                bits &= bits - 1;
                ++indeg[j];
            }
        }
    }
    int best = max_node, best_deg = 0;
    for (int j = 0; j < c.n; ++j) {
        if (!get_bit(remaining, j)) continue;
        if (indeg[j] >= best_deg && indeg[j] > 0) {
            best_deg = indeg[j];
            best = j;  // later index wins ties
        }
    }
    return best;
}

// Search frame.  `extq` carries the maximal quorum of this frame's
// perimeter (committed|remaining), computed incrementally: every quorum
// inside a set is a subset of the set's maximal quorum, so
//   - the include-child's perimeter is unchanged -> extq is inherited;
//   - the exclude-child only re-contracts when the split node was in extq,
//     and then seeds the fixpoint from extq\{split} instead of the whole
//     perimeter;
//   - contract(committed) (exit X3) seeds from committed&extq, and is only
//     re-evaluated on include-children (committed unchanged on exclude).
// This does at most ONE seeded contraction per call where the reference
// does two full ones (ref :159-225) — same tree, same exits.
//
// Frames are POD (fixed-width word arrays): the stack is bounded by tree
// depth (~2n frames), and pushing a child is a memcpy, not three heap
// allocations.
constexpr int W_MAX = 16;  // 1024-node scan ceiling (pubnet SCC is ~100)

struct Frame {
    u64 committed[W_MAX], remaining[W_MAX], extq[W_MAX];
    bool check_committed;
};

}  // namespace

extern "C" {

// Returns 1 = disjoint quorums found (out_q1/out_q2 filled),
//         0 = intersection holds, -1 = interrupted, -2 = call budget hit.
int64_t quorum_enum_check(int32_t n_nodes, const int32_t* top_thr,
                          const u64* top_mem, const int32_t* inner_off,
                          const int32_t* inner_thr, const u64* inner_mem,
                          volatile int32_t* interrupt, int64_t max_calls,
                          u64* out_q1, u64* out_q2, int64_t* out_calls) {
    Ctx c;
    c.n = n_nodes;
    c.W = (n_nodes + 63) / 64;
    c.top_thr = top_thr;
    c.top_mem = top_mem;
    c.inner_off = inner_off;
    c.inner_thr = inner_thr;
    c.inner_mem = inner_mem;
    c.interrupt = interrupt;
    c.max_calls = max_calls;

    // allSuccessors per node (ref QBitSet::getSuccessors)
    c.succ.assign((size_t)c.n * c.W, 0);
    for (int i = 0; i < c.n; ++i) {
        u64* s = c.succ.data() + (size_t)i * c.W;
        const u64* t = c.top_mem + (size_t)i * c.W;
        for (int w = 0; w < c.W; ++w) s[w] |= t[w];
        for (int k = c.inner_off[i]; k < c.inner_off[i + 1]; ++k) {
            const u64* im = c.inner_mem + (size_t)k * c.W;
            for (int w = 0; w < c.W; ++w) s[w] |= im[w];
        }
    }

    if (c.W > W_MAX) {
        *out_calls = 0;
        return -3;  // too many nodes for the native tier; Python handles
    }
    u64 scc[W_MAX] = {0};
    for (int i = 0; i < c.n; ++i) set_bit(scc, i);
    int max_commit = c.n / 2;

    std::vector<Frame> stack;
    stack.reserve(4 * c.n + 8);
    stack.emplace_back();
    {
        Frame& root = stack.back();
        std::memset(&root, 0, sizeof(Frame));
        std::memcpy(root.remaining, scc, c.W * 8);
        // root extq = maximal quorum of the whole SCC (caller guarantees
        // non-empty); committed = {} contracts empty by definition
        std::memcpy(root.extq, scc, c.W * 8);
        contract(c, root.extq);
        root.check_committed = false;
    }
    std::vector<int32_t> indeg;
    u64 tmp[W_MAX];

    while (!stack.empty()) {
        if (interrupt && *interrupt) {
            *out_calls = c.calls;
            return -1;
        }
        if (max_calls > 0 && c.calls >= max_calls) {
            *out_calls = c.calls;
            return -2;
        }
        Frame f = stack.back();
        stack.pop_back();
        ++c.calls;

        // X1: over half committed — complementary branches cover it
        if (popcount(f.committed, c.W) > max_commit) continue;

        // X3: committed contains a quorum — terminal either way.  Only
        // include-children re-evaluate (committed unchanged otherwise),
        // seeding the fixpoint from committed&extq (every quorum inside
        // committed lies inside the perimeter's maximal quorum).
        if (f.check_committed) {
            for (int w = 0; w < c.W; ++w)
                tmp[w] = f.committed[w] & f.extq[w];
            contract(c, tmp);
            if (any(tmp, c.W)) {
                if (is_minimal_quorum(c, tmp)) {
                    u64 comp[W_MAX];
                    for (int w = 0; w < c.W; ++w)
                        comp[w] = scc[w] & ~tmp[w];
                    contract(c, comp);
                    if (any(comp, c.W)) {
                        std::memcpy(out_q1, tmp, c.W * 8);
                        std::memcpy(out_q2, comp, c.W * 8);
                        *out_calls = c.calls;
                        return 1;
                    }
                }
                continue;
            }
        }

        // X2 invariants hold on arrival: extq is this frame's perimeter
        // quorum, already known non-empty and ⊇ committed (checked at
        // push time / for the root above).
        if (!any(f.remaining, c.W)) continue;  // exhausted

        int split = pick_split(c, f.remaining, indeg);

        // exclude child: perimeter loses `split`
        bool excl_ok = true;
        Frame excl = f;
        excl.check_committed = false;
        clear_bit(excl.remaining, split);
        if (get_bit(f.extq, split)) {
            // re-contract seeded from extq\{split}
            clear_bit(excl.extq, split);
            contract(c, excl.extq);
            if (!any(excl.extq, c.W)) {
                excl_ok = false;  // X2.1
            } else {
                for (int w = 0; w < c.W; ++w)
                    if (excl.committed[w] & ~excl.extq[w]) {
                        excl_ok = false;  // X2.2
                        break;
                    }
            }
        }

        // include child: perimeter (and extq) unchanged; committed grows,
        // so X2.2 reduces to `split ∈ extq`
        bool incl_ok = get_bit(f.extq, split);

        // stack order: include-branch popped first (matches the Python
        // enumerator's LIFO expansion).  Pruned children still count a
        // call, mirroring the reference recursing then exiting.
        if (excl_ok)
            stack.push_back(excl);
        else
            ++c.calls;
        if (incl_ok) {
            stack.push_back(f);
            Frame& incl = stack.back();
            std::memcpy(incl.remaining, excl.remaining, c.W * 8);
            set_bit(incl.committed, split);
            incl.check_committed = true;
        } else {
            ++c.calls;
        }
    }
    *out_calls = c.calls;
    return 0;
}

}  // extern "C"
