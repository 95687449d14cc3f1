// Host check of quorum_tally.cu: compiles the kernel's block logic as plain
// C++ (one warp of one lane, __syncthreads a no-op, a ballot's count a
// loop; the kernel and its launch function left out) and runs it on the
// tallies given on stdin, one a line of whitespace-separated integers:
//
//   n k kl r  top[n*n] thr[n] inner[n*k*n] ithr[n*k]
//             ltop[n] lthr linner[kl*n] lithr[kl] rows[r*n]
//
// the tally engine's qsets and local qset as ops/quorum.py lays them out,
// and r vote rows (accept: r = 2, accepted then voted-or-accepted; ratify:
// r = 1, voted).  Prints "verdict trips" a line.  Built and driven by
// tests/test_torch_tally_host.py:
//
//   g++ -std=c++17 -O1 -I csrc quorum_tally_host_check.cpp -o host_check
#include <stdint.h>

#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#define QUORUM_TALLY_HOST_CHECK
#include "quorum_tally.cu"

template <typename T>
static bool read_n(std::istringstream& in, std::vector<T>& out, size_t count) {
    out.resize(count);
    for (size_t i = 0; i < count; ++i) {
        long v;
        if (!(in >> v)) return false;
        out[i] = (T)v;
    }
    return true;
}

int main() {
    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream in(line);
        int n, k, kl, r;
        if (!(in >> n >> k >> kl >> r) || n <= 0 || k < 0 || kl < 0 ||
            (r != 1 && r != 2)) {
            std::cout << "bad header\n";
            continue;
        }
        std::vector<uint8_t> top, inner, ltop, linner, rows;
        std::vector<int32_t> thr, ithr, lthr, lithr;
        const size_t un = n;
        if (!(read_n(in, top, un * un) && read_n(in, thr, un) &&
              read_n(in, inner, un * k * un) && read_n(in, ithr, un * k) &&
              read_n(in, ltop, un) && read_n(in, lthr, 1) && read_n(in, linner, kl * un) &&
              read_n(in, lithr, (size_t)kl) && read_n(in, rows, r * un))) {
            std::cout << "bad body\n";
            continue;
        }
        const QSets q{top.data(),  thr.data(),  inner.data(),  ithr.data(), ltop.data(),
                      lthr.data(), linner.data(), lithr.data(), n,           k,
                      kl};
        // the block's shared memory (the member set twice) and its flags
        std::vector<uint8_t> smem(2 * un);
        int flags[4];
        const QTResult res = tally_block(q, rows.data(), r, smem.data(), flags);
        std::cout << res.verdict << " " << res.trips << "\n";
    }
    return 0;
}
