// Host check of ed25519_verify.cu: compiles the kernel's device functions
// as plain C++ (the CUDA qualifiers defined away, the carry-chain
// primitives on their portable bodies, the kernels and launch functions
// left out) and runs them on inputs given on stdin, one case per line:
//
//   mul A B | sq A | add A B | sub A B | neg A | inv A | pow A | frz A
//       -> the 32-byte result (lazy: any value below 2^256; frz: canonical)
//   dec E     -> "ok x y": decompression of the encoding E
//   rec S     -> the 64 signed radix-16 digits of S, space-separated
//   dsm E S H -> encoding of [S]B + [H](-A) for A decoded from E
//   ver PK SIG MSG -> 0 or 1, the verdict of the row
//   work PK SIG MSG -> "S M": the field squarings and multiplications the
//       row's verify took
//
// Every operand is little-endian hex (32 bytes; SIG 64).  Built and driven
// by tests/test_torch_kernel_host.py:
//
//   g++ -std=c++17 -O1 -I <dir of ed25519_consts.h> -I csrc
//       ed25519_host_check.cpp -o host_check
#include <stdint.h>
#include <stdio.h>
#include <string.h>

#include <iostream>
#include <sstream>
#include <string>
#include <vector>

#define ED25519_HOST_CHECK
#define __device__
#define __constant__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __ldg(p) (*(p))

#include "ed25519_verify.cu"

static bool parse_hex(const std::string& s, uint8_t* out, size_t n) {
    if (s.size() != 2 * n) return false;
    for (size_t i = 0; i < n; i++) {
        unsigned v;
        if (sscanf(s.c_str() + 2 * i, "%2x", &v) != 1) return false;
        out[i] = (uint8_t)v;
    }
    return true;
}

static void words_of(const uint8_t* b, uint32_t w[8]) {
    for (int i = 0; i < 8; i++)
        w[i] = (uint32_t)b[4 * i] | ((uint32_t)b[4 * i + 1] << 8) |
               ((uint32_t)b[4 * i + 2] << 16) | ((uint32_t)b[4 * i + 3] << 24);
}

static std::string hex_of(const uint32_t w[8]) {
    char buf[65];
    for (int i = 0; i < 32; i++)
        snprintf(buf + 2 * i, 3, "%02x", (w[i / 4] >> (8 * (i % 4))) & 0xff);
    return std::string(buf, 64);
}

static void words_hex(const std::string& s, uint32_t w[8], bool* good) {
    uint8_t b[32];
    *good = parse_hex(s, b, 32);
    words_of(b, w);
}

// A field operand: any value below 2^256.
static fe fe_of(const std::string& s, bool* good) {
    fe r;
    words_hex(s, r.v, good);
    return r;
}


int main() {
    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream in(line);
        std::string op;
        std::vector<std::string> args;
        in >> op;
        for (std::string a; in >> a;) args.push_back(a);
        bool g1 = true, g2 = true, g3 = true;
        if (op == "mul" || op == "add" || op == "sub") {
            const fe a = fe_of(args.at(0), &g1), b = fe_of(args.at(1), &g2);
            const fe r = op == "mul" ? fe_mul(a, b) : op == "add" ? fe_add(a, b) : fe_sub(a, b);
            std::cout << hex_of(r.v);
        } else if (op == "sq" || op == "neg" || op == "inv" || op == "pow" || op == "frz") {
            const fe a = fe_of(args.at(0), &g1);
            const fe r = op == "sq" ? fe_sq(a) : op == "neg" ? fe_neg(a)
                       : op == "inv" ? fe_invert(a) : op == "pow" ? fe_pow22523(a)
                       : fe_freeze(a);
            std::cout << hex_of(r.v);
        } else if (op == "dec") {
            uint32_t e[8], xw[8], yw[8];
            words_hex(args.at(0), e, &g1);
            fe y;
            bool ok;
            const fe x = decompress(e, &y, &ok);
            fe_to_words(x, xw);
            fe_to_words(y, yw);
            std::cout << (int)ok << " " << hex_of(xw) << " " << hex_of(yw);
        } else if (op == "rec") {
            uint32_t k[8], u[8];
            words_hex(args.at(0), k, &g1);
            recode(k, u);
            for (int i = 0; i < 64; i++) std::cout << (i ? " " : "") << digit(u, i);
        } else if (op == "dsm") {
            uint32_t e[8], s[8], h[8], enc[8];
            words_hex(args.at(0), e, &g1);
            words_hex(args.at(1), s, &g2);
            words_hex(args.at(2), h, &g3);
            fe y;
            bool ok;
            const fe x = decompress(e, &y, &ok);
            double_scalar(x, y, s, h, enc, &ED_BTAB[0][0][0]);
            std::cout << hex_of(enc);
        } else if (op == "ver" || op == "work") {
            uint8_t sig[64];
            uint32_t a[8], m[8], r[8], s[8];
            words_hex(args.at(0), a, &g1);
            words_hex(args.at(2), m, &g3);
            g2 = parse_hex(args.at(1), sig, 64);
            words_of(sig, r);
            words_of(sig + 32, s);
            uint32_t enc[8];
            ed_n_sq = ed_n_mul = 0;
            const bool ok = verify_row(a, r, s, m, &ED_BTAB[0][0][0], enc);
            if (op == "ver") std::cout << (int)(ok && encoding_matches(enc, r));
            else std::cout << ed_n_sq << " " << ed_n_mul;
        } else {
            std::cerr << "unknown op " << op << "\n";
            return 2;
        }
        if (!(g1 && g2 && g3)) {
            std::cerr << "bad operand in: " << line << "\n";
            return 2;
        }
        std::cout << "\n";
    }
    return 0;
}
