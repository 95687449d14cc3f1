// Native bucket-merge kernel: the sorted two-way merge with
// INIT/LIVE/DEAD shadowing semantics over serialized bucket entries
// (ref src/bucket/Bucket.cpp merge logic + BucketOutputIterator — the
// reference's background worker compute; SURVEY.md §2.7).
//
// The Python tier passes two entry tables as flat arrays:
//   keys:    concatenated key bytes
//   k_off/k_len: per-entry key slices (int64/int32)
//   types:   per-entry BucketEntryType (0=LIVE,1=DEAD,2=INIT per
//            protocol-11+ semantics, matching xdr types)
// and receives, for each surviving output slot, the source side
// (0=newer, 1=older), the source index, and a result type override
// (-1 = keep source entry unchanged; else re-tag to this type, which
// Python applies by rebuilding the entry with the same value).
//
// Merge-case table mirrors stellar_core_tpu/bucket/bucket_list.py
// _merge_entry (itself re-derived from Bucket::mergeCasesWithEqualKeys):
//   DEAD over INIT              -> annihilate
//   LIVE/INIT over INIT         -> INIT with newer value
//   INIT over DEAD              -> LIVE with newer value
//   otherwise                   -> newer entry unchanged
//
// Build: g++ -O2 -shared -fPIC -o _native.so bucket_merge.cpp

#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// lexicographic compare of two byte slices
int cmp_keys(const uint8_t* a, int32_t alen, const uint8_t* b,
             int32_t blen) {
  int32_t n = alen < blen ? alen : blen;
  int c = std::memcmp(a, b, static_cast<size_t>(n));
  if (c != 0) return c;
  if (alen == blen) return 0;
  return alen < blen ? -1 : 1;
}

constexpr int32_t kLive = 0;
constexpr int32_t kDead = 1;
constexpr int32_t kInit = 2;

// ---- CRC-32 (ISO-HDLC, reflected, poly 0xEDB88320) ------------------------
// Bit-identical to Python's zlib.crc32(data, start) so the bloom filters
// built here and the Python fallback tier (bucket/index.py) interoperate:
// a filter persisted by either side answers queries from the other.

struct Crc32Table {
  uint32_t t[256];
  Crc32Table() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k)
        c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      t[i] = c;
    }
  }
};

uint32_t crc32_update(uint32_t start, const uint8_t* data, int32_t len) {
  static const Crc32Table table;
  uint32_t crc = start ^ 0xFFFFFFFFu;
  for (int32_t i = 0; i < len; ++i)
    crc = table.t[(crc ^ data[i]) & 0xFFu] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

// blocked-bloom probe layout shared with bucket/index.py: h1 selects the
// 64-bit block, four 6-bit slices of h2 select bits inside it
constexpr uint32_t kBloomSeed2 = 0x9E3779B9u;

uint64_t bloom_mask(uint32_t h2) {
  uint64_t m = 0;
  for (int shift = 0; shift < 24; shift += 6)
    m |= 1ull << ((h2 >> shift) & 63u);
  return m;
}

// ---- SHA-256 (FIPS 180-4), self-contained so the whole merge --------------
// (compare + copy + bucket hash) runs inside one GIL-free native call.

struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t buf[64];
  size_t buf_used = 0;

  Sha256() {
    static const uint32_t init[8] = {
        0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
        0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
    std::memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) {
    return (x >> n) | (x << (32 - n));
  }

  void block(const uint8_t* p) {
    static const uint32_t K[64] = {
        0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
        0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
        0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
        0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
        0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
        0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
        0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
        0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
        0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
        0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
        0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
        0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
        0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};
    uint32_t w[64];
    for (int i = 0; i < 16; ++i) {
      w[i] = (uint32_t(p[4 * i]) << 24) | (uint32_t(p[4 * i + 1]) << 16) |
             (uint32_t(p[4 * i + 2]) << 8) | uint32_t(p[4 * i + 3]);
    }
    for (int i = 16; i < 64; ++i) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^
                    (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^
                    (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
    uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
    for (int i = 0; i < 64; ++i) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g; g = f; f = e; e = d + t1;
      d = c; c = b; b = a; a = t1 + t2;
    }
    h[0] += a; h[1] += b; h[2] += c; h[3] += d;
    h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
  }

  void update(const uint8_t* p, size_t n) {
    len += n;
    if (buf_used) {
      size_t take = 64 - buf_used;
      if (take > n) take = n;
      std::memcpy(buf + buf_used, p, take);
      buf_used += take;
      p += take;
      n -= take;
      if (buf_used == 64) {
        block(buf);
        buf_used = 0;
      }
    }
    while (n >= 64) {
      block(p);
      p += 64;
      n -= 64;
    }
    if (n) {
      std::memcpy(buf, p, n);
      buf_used = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (buf_used != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; ++i) lenb[i] = uint8_t(bits >> (56 - 8 * i));
    // bypass the length accounting for the trailer
    std::memcpy(buf + 56, lenb, 8);
    block(buf);
    for (int i = 0; i < 8; ++i) {
      out[4 * i] = uint8_t(h[i] >> 24);
      out[4 * i + 1] = uint8_t(h[i] >> 16);
      out[4 * i + 2] = uint8_t(h[i] >> 8);
      out[4 * i + 3] = uint8_t(h[i]);
    }
  }
};

// one side of a streaming merge: serialized entry stream + flat tables
struct Side {
  const uint8_t* stream;
  const int64_t* eoff;
  const int32_t* elen;
  const uint8_t* keys;
  const int64_t* koff;
  const int32_t* klen;
  const int32_t* types;
  int64_t n;
};

// emit entry `idx` of `s` (re-tagged to `type` when >= 0) into the output
// file/hash and the output tables; returns false on I/O error
bool emit(const Side& s, int64_t idx, int32_t type, FILE* out, Sha256& sha,
          int64_t& wbytes, int64_t& kbytes, int64_t w, int64_t* out_eoff,
          int32_t* out_elen, int32_t* out_types, uint8_t* out_keys,
          int64_t* out_koff, int32_t* out_klen) {
  const uint8_t* e = s.stream + s.eoff[idx];
  int32_t n = s.elen[idx];
  int32_t ty = type >= 0 ? type : s.types[idx];
  out_eoff[w] = wbytes;
  out_elen[w] = n;
  out_types[w] = ty;
  out_koff[w] = kbytes;
  out_klen[w] = s.klen[idx];
  std::memcpy(out_keys + kbytes, s.keys + s.koff[idx],
              size_t(s.klen[idx]));
  kbytes += s.klen[idx];
  if (type >= 0 && type != s.types[idx]) {
    // XDR union discriminant: 4-byte big-endian tag, body unchanged
    // (re-tags only occur between LIVE and INIT, whose bodies are the
    // same LedgerEntry encoding)
    uint8_t tag[4] = {uint8_t(uint32_t(ty) >> 24), uint8_t(uint32_t(ty) >> 16),
                      uint8_t(uint32_t(ty) >> 8), uint8_t(uint32_t(ty))};
    sha.update(tag, 4);
    sha.update(e + 4, size_t(n - 4));
    if (out) {
      if (fwrite(tag, 1, 4, out) != 4) return false;
      if (fwrite(e + 4, 1, size_t(n - 4), out) != size_t(n - 4))
        return false;
    }
  } else {
    sha.update(e, size_t(n));
    if (out && fwrite(e, 1, size_t(n), out) != size_t(n)) return false;
  }
  wbytes += n;
  return true;
}

}  // namespace

extern "C" {

// Returns the number of output entries written to out_side/out_idx/
// out_type (capacity must be >= n_new + n_old).
int64_t bucket_merge(
    const uint8_t* new_keys, const int64_t* new_off,
    const int32_t* new_len, const int32_t* new_types, int64_t n_new,
    const uint8_t* old_keys, const int64_t* old_off,
    const int32_t* old_len, const int32_t* old_types, int64_t n_old,
    int32_t* out_side, int64_t* out_idx, int32_t* out_type) {
  int64_t i = 0, j = 0, w = 0;
  while (i < n_new && j < n_old) {
    int c = cmp_keys(new_keys + new_off[i], new_len[i],
                     old_keys + old_off[j], old_len[j]);
    if (c < 0) {
      out_side[w] = 0; out_idx[w] = i; out_type[w] = -1;
      ++w; ++i;
    } else if (c > 0) {
      out_side[w] = 1; out_idx[w] = j; out_type[w] = -1;
      ++w; ++j;
    } else {
      int32_t nt = new_types[i];
      int32_t ot = old_types[j];
      if (nt == kDead && ot == kInit) {
        // annihilate: entry never existed at this level
      } else if ((nt == kLive || nt == kInit) && ot == kInit) {
        out_side[w] = 0; out_idx[w] = i; out_type[w] = kInit; ++w;
      } else if (nt == kInit && ot == kDead) {
        out_side[w] = 0; out_idx[w] = i; out_type[w] = kLive; ++w;
      } else {
        out_side[w] = 0; out_idx[w] = i; out_type[w] = -1; ++w;
      }
      ++i; ++j;
    }
  }
  for (; i < n_new; ++i) {
    out_side[w] = 0; out_idx[w] = i; out_type[w] = -1; ++w;
  }
  for (; j < n_old; ++j) {
    out_side[w] = 1; out_idx[w] = j; out_type[w] = -1; ++w;
  }
  return w;
}

// Full streaming shadow-merge over two serialized BucketEntry streams —
// the FutureBucket worker's compute tier.  Unlike `bucket_merge` above
// (which only plans the merge and leaves copying/hashing to Python),
// this call does EVERYTHING natively: key compare, collision resolution,
// entry byte copy (with XDR discriminant re-tag), output stream write,
// and the bucket's sha256 — so a ctypes caller holds the GIL for none of
// it and background merges genuinely overlap the main thread.
//
// Inputs per side: the serialized stream, per-entry (offset, length)
// into it, the concatenated key bytes with per-entry (offset, length),
// and per-entry BucketEntryType tags.  `out_path` receives the merged
// XDR stream (NULL = hash/tables only).  Output tables (capacity
// n_new+n_old; out_keys capacity = total input key bytes) receive the
// surviving entries' offsets/lengths/types/keys.  out_hash32 gets the
// sha256 of the output stream; *out_bytes its length.
//
// Returns the number of surviving entries, or -1 on I/O error.
int64_t bucket_merge_stream(
    const uint8_t* new_stream, const int64_t* new_eoff,
    const int32_t* new_elen, const uint8_t* new_keys,
    const int64_t* new_koff, const int32_t* new_klen,
    const int32_t* new_types, int64_t n_new,
    const uint8_t* old_stream, const int64_t* old_eoff,
    const int32_t* old_elen, const uint8_t* old_keys,
    const int64_t* old_koff, const int32_t* old_klen,
    const int32_t* old_types, int64_t n_old,
    const char* out_path,
    int64_t* out_eoff, int32_t* out_elen, int32_t* out_types,
    uint8_t* out_keys, int64_t* out_koff, int32_t* out_klen,
    uint8_t* out_hash32, int64_t* out_bytes) {
  Side nw{new_stream, new_eoff, new_elen, new_keys, new_koff, new_klen,
          new_types, n_new};
  Side od{old_stream, old_eoff, old_elen, old_keys, old_koff, old_klen,
          old_types, n_old};
  FILE* out = nullptr;
  if (out_path != nullptr && out_path[0] != '\0') {
    out = fopen(out_path, "wb");
    if (out == nullptr) return -1;
  }
  Sha256 sha;
  int64_t i = 0, j = 0, w = 0, wbytes = 0, kbytes = 0;
  bool ok = true;
  while (ok && i < n_new && j < n_old) {
    int c = cmp_keys(nw.keys + nw.koff[i], nw.klen[i],
                     od.keys + od.koff[j], od.klen[j]);
    if (c < 0) {
      ok = emit(nw, i, -1, out, sha, wbytes, kbytes, w, out_eoff,
                out_elen, out_types, out_keys, out_koff, out_klen);
      ++w; ++i;
    } else if (c > 0) {
      ok = emit(od, j, -1, out, sha, wbytes, kbytes, w, out_eoff,
                out_elen, out_types, out_keys, out_koff, out_klen);
      ++w; ++j;
    } else {
      int32_t nt = nw.types[i];
      int32_t ot = od.types[j];
      if (nt == kDead && ot == kInit) {
        // annihilate
      } else if ((nt == kLive || nt == kInit) && ot == kInit) {
        ok = emit(nw, i, kInit, out, sha, wbytes, kbytes, w, out_eoff,
                  out_elen, out_types, out_keys, out_koff, out_klen);
        ++w;
      } else if (nt == kInit && ot == kDead) {
        ok = emit(nw, i, kLive, out, sha, wbytes, kbytes, w, out_eoff,
                  out_elen, out_types, out_keys, out_koff, out_klen);
        ++w;
      } else {
        ok = emit(nw, i, -1, out, sha, wbytes, kbytes, w, out_eoff,
                  out_elen, out_types, out_keys, out_koff, out_klen);
        ++w;
      }
      ++i; ++j;
    }
  }
  for (; ok && i < n_new; ++i, ++w) {
    ok = emit(nw, i, -1, out, sha, wbytes, kbytes, w, out_eoff, out_elen,
              out_types, out_keys, out_koff, out_klen);
  }
  for (; ok && j < n_old; ++j, ++w) {
    ok = emit(od, j, -1, out, sha, wbytes, kbytes, w, out_eoff, out_elen,
              out_types, out_keys, out_koff, out_klen);
  }
  if (out != nullptr) {
    if (fclose(out) != 0) ok = false;
  }
  if (!ok) return -1;
  sha.final(out_hash32);
  *out_bytes = wbytes;
  return w;
}

// Batched lexicographic lower_bound over a sorted key table — the
// BucketIndex point-lookup core (ref src/bucket/BucketIndexImpl.cpp).
// Writes, per probe, the index of the first key >= probe (or n_keys).
void bucket_lower_bound(
    const uint8_t* keys, const int64_t* k_off, const int32_t* k_len,
    int64_t n_keys,
    const uint8_t* probes, const int64_t* p_off, const int32_t* p_len,
    int64_t n_probes, int64_t* out_pos) {
  for (int64_t p = 0; p < n_probes; ++p) {
    int64_t lo = 0, hi = n_keys;
    const uint8_t* pk = probes + p_off[p];
    int32_t pl = p_len[p];
    while (lo < hi) {
      int64_t mid = lo + (hi - lo) / 2;
      int c = cmp_keys(keys + k_off[mid], k_len[mid], pk, pl);
      if (c < 0) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    out_pos[p] = lo;
  }
}

// Fill a blocked bloom filter over a key table (the per-bucket
// BucketIndex filter, ref src/bucket/BucketIndexImpl.cpp's binary fuse /
// bloom layer).  words must be zeroed, n_blocks 64-bit blocks.
void bloom_fill(const uint8_t* keys, const int64_t* k_off,
                const int32_t* k_len, int64_t n_keys, uint64_t* words,
                int64_t n_blocks) {
  if (n_blocks <= 0) return;
  for (int64_t i = 0; i < n_keys; ++i) {
    const uint8_t* k = keys + k_off[i];
    uint32_t h1 = crc32_update(0, k, k_len[i]);
    uint32_t h2 = crc32_update(kBloomSeed2, k, k_len[i]);
    words[h1 % static_cast<uint64_t>(n_blocks)] |= bloom_mask(h2);
  }
}

// Batched membership check against a blocked bloom filter: out_hit[p]=1
// when the filter MAY contain probe p (0 = definitely absent).
void bloom_check(const uint64_t* words, int64_t n_blocks,
                 const uint8_t* probes, const int64_t* p_off,
                 const int32_t* p_len, int64_t n_probes,
                 int32_t* out_hit) {
  for (int64_t p = 0; p < n_probes; ++p) {
    if (n_blocks <= 0) {
      out_hit[p] = 0;
      continue;
    }
    const uint8_t* k = probes + p_off[p];
    uint32_t h1 = crc32_update(0, k, p_len[p]);
    uint32_t h2 = crc32_update(kBloomSeed2, k, p_len[p]);
    uint64_t m = bloom_mask(h2);
    out_hit[p] =
        (words[h1 % static_cast<uint64_t>(n_blocks)] & m) == m ? 1 : 0;
  }
}

}  // extern "C"
