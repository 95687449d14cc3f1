/* Native GIL-free transaction-apply kernel.
 *
 * PR-5's footprint->cluster->executor stack proved bit-identical
 * parallel apply but lost wall clock to the GIL: cluster workers
 * time-slice one interpreter.  This kernel cashes that machinery in —
 * a cluster whose transactions are all kernel-eligible hands over
 * packed XDR (entries, materialized order-book rows, per-tx
 * descriptors), the kernel applies the whole strip with exact
 * 64/128-bit integer arithmetic while the GIL is RELEASED, and returns
 * entry deltas plus pre-encoded TransactionMeta / TransactionResult
 * bytes that the merge/hash/commit phases consume exactly as they
 * consume the Python workers' output today.
 *
 * Covered op strip (kernel-complete for the op types dominating real
 * Stellar traffic — ISSUE 13 closes the credit/path/modify gap PR 6
 * left open):
 *   - PAYMENT, native AND credit assets (trustline balance edges,
 *     AUTHORIZED gate, issuer-source / issuer-dest mint-burn cases);
 *   - CHANGE_TRUST, classic assets: trustline create (issuer flag
 *     derivation, subentry reserve), limit update, and delete;
 *   - MANAGE_SELL_OFFER, offerID=0 (create) AND offerID!=0
 *     (modify/delete): load the resting offer from the packed
 *     snapshot, release old liabilities, re-run the crossing loop,
 *     re-post or delete; full exchangeV10 crossing mirroring
 *     transactions/offer_exchange.py (adjustOffer, liabilities
 *     acquire/release, price-error thresholds, claim atoms);
 *   - PATH_PAYMENT_STRICT_SEND / _RECEIVE over declared hop pairs:
 *     the multi-hop chain walk with per-hop send/receive propagation,
 *     the strict-send/strict-receive rounding modes, max-path-length
 *     and self-crossing guards.  A LIVE constant-product pool on a hop
 *     is QUOTED in-kernel (book-vs-pool arbitration mirroring
 *     convert_with_offers_and_pools); pool deposit/withdraw stay
 *     host-side.
 *
 * Beyond apply_cluster, charge_fees() batches the whole fee/seqnum
 * phase: one GIL-released call charges every tx's fee against the
 * packed source-account snapshot and returns per-tx pre-encoded
 * feeProcessing LedgerEntryChanges plus final account images.
 *
 * Parity discipline: the kernel implements ONLY the success paths.
 * Any ineligible shape, unexpected entry state, failing check, or
 * arithmetic-path divergence raises KernelDecline and the WHOLE
 * cluster falls back to the Python reference apply — which remains the
 * bit-identical oracle.  Every parsed entry is round-trip re-encoded
 * and compared against its input bytes, so a shape the encoder does
 * not model exactly can never silently produce divergent meta.
 *
 * Interface (dispatch layer: stellar_core_tpu/apply/native_apply.py):
 *   apply_cluster(params, entries, books, txs)
 *     params  = (ledger_seq, close_time, base_fee, base_reserve,
 *                idpool0)
 *     entries = [(key_bytes, entry_bytes|None), ...]
 *     books   = [(selling_asset, buying_asset, [key_bytes, ...]), ...]
 *     txs     = per-tx tuples, see parse_txs()
 *   -> (True, [(key, entry_bytes|None)...], [(meta, result)...], idpool)
 *    | (False, reason, tx_index)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <map>
#include <string>
#include <vector>

typedef __int128 i128;
static const int64_t INT64_MAX_ = 9223372036854775807LL;
static const uint32_t ACCOUNT_SUBENTRY_LIMIT = 1000;
static const int MAX_OFFERS_TO_CROSS = 1000;
/* longest effective conversion chain: 5 path entries + send + dest
 * assets = 6 hops (xdr/types.py VarArray(Asset, 5) path bound) */
static const int MAX_PATH_HOPS = 6;

/* OperationType values (xdr/types.py) */
enum {
    OP_PAYMENT = 1,
    OP_PATH_PAYMENT_STRICT_RECEIVE = 2,
    OP_MANAGE_SELL_OFFER = 3,
    OP_CHANGE_TRUST = 6,
    OP_PATH_PAYMENT_STRICT_SEND = 13,
};
/* LedgerEntryType */
enum { LE_ACCOUNT = 0, LE_TRUSTLINE = 1, LE_OFFER = 2,
       LE_LIQUIDITY_POOL = 5 };
/* LedgerEntryChangeType */
enum { CH_CREATED = 0, CH_UPDATED = 1, CH_REMOVED = 2, CH_STATE = 3 };
/* trustline flags */
static const uint32_t AUTHORIZED_FLAG = 1;
static const uint32_t MAINTAIN_LIABILITIES_FLAG = 2;
static const uint32_t TL_CLAWBACK_FLAG = 4;
/* account flags consulted by changeTrust's new-trustline derivation */
static const uint32_t ACC_AUTH_REQUIRED_FLAG = 1;
static const uint32_t ACC_AUTH_CLAWBACK_FLAG = 8;
/* offer flags */
static const uint32_t PASSIVE_FLAG = 1;
/* TrustLineEntry extension discriminants (liability XDR tags) */
enum { TL_EXT_V1 = 1, TL_V1_EXT_V2 = 2 };
/* AccountEntry extension discriminants (the v1/v2/v3 seqnum chain) */
enum { ACC_EXT_V1 = 1, ACC_EXT_V2 = 2, ACC_EXT_V3 = 3 };
/* liquidity pools: constant-product only; the quote math denominates
 * fees in basis points and the protocol pins the pool fee at 30 bps
 * (types.py LIQUIDITY_POOL_FEE_V18) */
static const int32_t POOL_FEE_V18 = 30;
static const int32_t POOL_MAX_BPS = 10000;
/* fee charge: base_fee scales with max(FEE_OPS_FLOOR, numOperations)
 * (frame.process_fee_seq_num) */
static const int64_t FEE_OPS_FLOOR = 1;
/* ManageOfferEffect */
enum { EFF_CREATED = 0, EFF_UPDATED = 1, EFF_DELETED = 2 };
/* offer_exchange.RoundingType */
enum { ROUND_NORMAL = 0, ROUND_PP_STRICT_RECEIVE = 1,
       ROUND_PP_STRICT_SEND = 2 };

struct Decline {
    std::string reason;
    Decline(const std::string &r) : reason(r) {}
};

static void need(bool ok, const char *why) {
    if (!ok)
        throw Decline(why);
}

/* ---------------------------------------------------------------- xdr io */

struct Rd {
    const uint8_t *p;
    size_t n, pos;
    Rd(const std::string &s)
        : p((const uint8_t *)s.data()), n(s.size()), pos(0) {}
    uint32_t u32() {
        need(pos + 4 <= n, "entry parse: short read");
        uint32_t v = ((uint32_t)p[pos] << 24) | ((uint32_t)p[pos + 1] << 16) |
                     ((uint32_t)p[pos + 2] << 8) | (uint32_t)p[pos + 3];
        pos += 4;
        return v;
    }
    int32_t i32() { return (int32_t)u32(); }
    uint64_t u64() {
        uint64_t hi = u32();
        return (hi << 32) | u32();
    }
    int64_t i64() { return (int64_t)u64(); }
    std::string take(size_t k) {
        need(pos + k <= n, "entry parse: short read");
        std::string out((const char *)p + pos, k);
        pos += k;
        return out;
    }
    std::string opaque_var(size_t maxlen) {
        uint32_t len = u32();
        need(len <= maxlen, "entry parse: opaque too long");
        std::string body = take(len);
        size_t pad = (4 - len % 4) % 4;
        for (size_t i = 0; i < pad; i++)
            need(take(1)[0] == 0, "entry parse: nonzero pad");
        return body;
    }
    bool done() const { return pos == n; }
};

struct Wr {
    std::string out;
    void u32(uint32_t v) {
        char b[4] = {(char)(v >> 24), (char)(v >> 16), (char)(v >> 8),
                     (char)v};
        out.append(b, 4);
    }
    void i32(int32_t v) { u32((uint32_t)v); }
    void u64(uint64_t v) {
        u32((uint32_t)(v >> 32));
        u32((uint32_t)v);
    }
    void i64(int64_t v) { u64((uint64_t)v); }
    void raw(const std::string &s) { out.append(s); }
    void opaque_var(const std::string &s) {
        u32((uint32_t)s.size());
        out.append(s);
        size_t pad = (4 - s.size() % 4) % 4;
        out.append(pad, '\0');
    }
};

/* --------------------------------------------------------------- assets */

static bool asset_is_native(const std::string &a) { return a.size() == 4; }

/* raw 32-byte issuer id of a credit asset (encoding places it last) */
static std::string asset_issuer(const std::string &a) {
    need(a.size() >= 36, "asset parse");
    return a.substr(a.size() - 32);
}

static bool asset_code_char_ok(uint8_t c) {
    return (c >= '0' && c <= '9') || (c >= 'A' && c <= 'Z') ||
           (c >= 'a' && c <= 'z');
}

/* mirror transactions/utils.py is_asset_valid */
static bool asset_valid(const std::string &a) {
    if (a.size() < 4)
        return false;
    uint32_t t = ((uint32_t)(uint8_t)a[0] << 24) |
                 ((uint32_t)(uint8_t)a[1] << 16) |
                 ((uint32_t)(uint8_t)a[2] << 8) | (uint32_t)(uint8_t)a[3];
    if (t == 0)
        return a.size() == 4;
    size_t code_len = (t == 1) ? 4 : 12;
    if ((t != 1 && t != 2) || a.size() != 4 + code_len + 4 + 32)
        return false;
    const uint8_t *code = (const uint8_t *)a.data() + 4;
    size_t body = code_len;
    while (body > 0 && code[body - 1] == 0)
        body--;
    if (body == 0)
        return false;
    for (size_t i = 0; i < body; i++)
        if (!asset_code_char_ok(code[i]))
            return false;
    if (t == 1)
        return body >= 1 && body <= 4;
    return body >= 5 && body <= 12;
}

/* ------------------------------------------------------- entry states */

struct AcctState {
    std::string id; /* raw 32 */
    int64_t balance = 0, seqNum = 0;
    uint32_t numSubEntries = 0, flags = 0;
    std::string homeDomain;
    uint8_t thresholds[4] = {0, 0, 0, 0};
    bool has_v1 = false, has_v2 = false, has_v3 = false;
    int64_t liab_buying = 0, liab_selling = 0;
    uint32_t numSponsored = 0, numSponsoring = 0;
    uint32_t seqLedger = 0;
    uint64_t seqTime = 0;
};

struct TlState {
    std::string account; /* raw 32 */
    std::string asset;   /* TrustLineAsset == Asset bytes */
    int64_t balance = 0, limit = 0;
    uint32_t flags = 0;
    bool has_v1 = false, has_v2 = false;
    int64_t liab_buying = 0, liab_selling = 0;
    int32_t pool_use_count = 0; /* ext v2 liquidityPoolUseCount */
};

struct OfferState {
    std::string seller; /* raw 32 */
    int64_t offerID = 0;
    std::string selling, buying; /* Asset bytes */
    int64_t amount = 0;
    int32_t price_n = 0, price_d = 0;
    uint32_t flags = 0;
};

struct PoolState {
    /* constant-product pool (the only pool body the protocol defines);
     * params are canonical (assetA < assetB, fee = POOL_FEE_V18) */
    std::string pool_id; /* raw 32 */
    std::string assetA, assetB;
    int32_t fee = 0;
    int64_t reserveA = 0, reserveB = 0;
    int64_t totalPoolShares = 0, poolSharesTrustLineCount = 0;
};

enum { K_OTHER = 0, K_ACCT = 1, K_TL = 2, K_OFFER = 3, K_POOL = 4 };

struct Entry {
    int kind = K_OTHER;
    bool exists = false;
    bool supported = false; /* parsed into a state the encoder models */
    bool dirty = false;     /* written/erased by this cluster */
    uint32_t lastModified = 0;
    AcctState acct;
    TlState tl;
    OfferState offer;
    PoolState pool;
    std::string raw; /* original input bytes */
};

struct BookDir {
    /* static materialized rows for one (selling, buying) direction, in
     * (price, offerID) order — mirrors ApplySnapshot.books */
    std::vector<std::string> rows; /* offer key bytes */
};

struct Hop {
    /* one effective conversion step (equal-adjacent assets already
     * collapsed host-side): sell ``selling`` for ``buying``; pool_key
     * is the hop pair's liquidity-pool LedgerKey — declared by the
     * footprint, probed for the decline-if-live guard */
    std::string selling, buying, pool_key;
};

struct Tx {
    int op = 0;
    std::string hash, src; /* raw 32 */
    int64_t seq = 0, fee = 0, fee_charged = 0;
    /* payment / path payments */
    std::string dest;
    int64_t amount = 0;
    std::string asset; /* payment asset / changeTrust line */
    /* offer */
    std::string selling, buying;
    int32_t price_n = 0, price_d = 0;
    int64_t offer_id = 0;
    /* change_trust */
    int64_t limit = 0;
    /* path payments: amount carries sendAmount (strict send) or
     * sendMax (strict receive); amount2 carries destMin / destAmount */
    int64_t amount2 = 0;
    std::string dest_asset;
    std::vector<Hop> hops;
};

struct Ctx {
    uint32_t ledger_seq = 0;
    uint64_t close_time = 0;
    int64_t base_fee = 0, base_reserve = 0;
    int64_t idpool = 0; /* running; idpool0 on entry */
    std::map<std::string, Entry> store;
    std::map<std::pair<std::string, std::string>, BookDir> books;
    std::vector<Tx> txs;
    /* outputs */
    std::vector<std::pair<std::string, std::string>> records;
    /* per-tx touched-state tracking (meta STATE values) */
    std::map<std::string, std::pair<bool, std::string>> pre_touched;
    std::map<std::string, std::pair<bool, std::string>> op_touched;
};

/* ------------------------------------------------------ key encoding */

static std::string account_key(const std::string &id) {
    Wr w;
    w.u32(LE_ACCOUNT);
    w.u32(0);
    w.raw(id);
    return w.out;
}

static std::string trustline_key(const std::string &id,
                                 const std::string &asset) {
    Wr w;
    w.u32(LE_TRUSTLINE);
    w.u32(0);
    w.raw(id);
    w.raw(asset);
    return w.out;
}

static std::string offer_key(const std::string &seller, int64_t offer_id) {
    Wr w;
    w.u32(LE_OFFER);
    w.u32(0);
    w.raw(seller);
    w.i64(offer_id);
    return w.out;
}

/* --------------------------------------------------- entry en/decoding */

static void encode_account(const Entry &e, Wr &w) {
    const AcctState &a = e.acct;
    w.u32(e.lastModified);
    w.u32(LE_ACCOUNT);
    w.u32(0);
    w.raw(a.id);
    w.i64(a.balance);
    w.i64(a.seqNum);
    w.u32(a.numSubEntries);
    w.u32(0); /* inflationDest: absent (eligibility) */
    w.u32(a.flags);
    w.opaque_var(a.homeDomain);
    w.out.append((const char *)a.thresholds, 4);
    w.u32(0); /* signers: none (eligibility) */
    if (!a.has_v1) {
        w.u32(0);
    } else {
        w.u32(ACC_EXT_V1);
        w.i64(a.liab_buying);
        w.i64(a.liab_selling);
        if (!a.has_v2) {
            w.u32(0);
        } else {
            w.u32(ACC_EXT_V2);
            w.u32(a.numSponsored);
            w.u32(a.numSponsoring);
            w.u32(0); /* signerSponsoringIDs: [] */
            if (!a.has_v3) {
                w.u32(0);
            } else {
                w.u32(ACC_EXT_V3);
                w.u32(0); /* ExtensionPoint v0 */
                w.u32(a.seqLedger);
                w.u64(a.seqTime);
            }
        }
    }
    w.u32(0); /* LedgerEntry ext v0 (unsponsored: eligibility) */
}

static void encode_trustline(const Entry &e, Wr &w) {
    const TlState &t = e.tl;
    w.u32(e.lastModified);
    w.u32(LE_TRUSTLINE);
    w.u32(0);
    w.raw(t.account);
    w.raw(t.asset);
    w.i64(t.balance);
    w.i64(t.limit);
    w.u32(t.flags);
    if (!t.has_v1) {
        w.u32(0);
    } else {
        w.u32(TL_EXT_V1);
        w.i64(t.liab_buying);
        w.i64(t.liab_selling);
        if (!t.has_v2) {
            w.u32(0); /* TrustLineEntryV1 ext v0 */
        } else {
            w.u32(TL_V1_EXT_V2);
            w.i32(t.pool_use_count);
            w.u32(0); /* TrustLineEntryExtensionV2 ext v0 */
        }
    }
    w.u32(0); /* LedgerEntry ext v0 */
}

static void encode_offer_value(const OfferState &o, Wr &w) {
    w.u32(0); /* sellerID pk disc */
    w.raw(o.seller);
    w.i64(o.offerID);
    w.raw(o.selling);
    w.raw(o.buying);
    w.i64(o.amount);
    w.i32(o.price_n);
    w.i32(o.price_d);
    w.u32(o.flags);
    w.u32(0); /* OfferEntry ext v0 */
}

static void encode_offer(const Entry &e, Wr &w) {
    w.u32(e.lastModified);
    w.u32(LE_OFFER);
    encode_offer_value(e.offer, w);
    w.u32(0); /* LedgerEntry ext v0 */
}

static void encode_pool(const Entry &e, Wr &w) {
    const PoolState &p = e.pool;
    w.u32(e.lastModified);
    w.u32(LE_LIQUIDITY_POOL);
    w.raw(p.pool_id);
    w.u32(0); /* LIQUIDITY_POOL_CONSTANT_PRODUCT */
    w.raw(p.assetA);
    w.raw(p.assetB);
    w.i32(p.fee);
    w.i64(p.reserveA);
    w.i64(p.reserveB);
    w.i64(p.totalPoolShares);
    w.i64(p.poolSharesTrustLineCount);
    w.u32(0); /* LedgerEntry ext v0 */
}

static std::string encode_entry(const Entry &e) {
    Wr w;
    switch (e.kind) {
    case K_ACCT:
        encode_account(e, w);
        break;
    case K_TL:
        encode_trustline(e, w);
        break;
    case K_OFFER:
        encode_offer(e, w);
        break;
    case K_POOL:
        encode_pool(e, w);
        break;
    default:
        /* untouched passthrough: callers never re-encode K_OTHER */
        return e.raw;
    }
    return w.out;
}

static std::string read_asset(Rd &r) {
    uint32_t t = r.u32();
    Wr w;
    w.u32(t);
    if (t == 0)
        return w.out;
    if (t == 1) {
        w.raw(r.take(4));
    } else if (t == 2) {
        w.raw(r.take(12));
    } else {
        throw Decline("unsupported asset type");
    }
    need(r.u32() == 0, "asset issuer key type");
    w.u32(0);
    w.raw(r.take(32));
    return w.out;
}

/* parse + round-trip verify; unsupported shapes leave supported=false
 * (a decline fires only if a tx actually touches the entry) */
static void parse_entry(Entry &e) {
    e.supported = false;
    try {
        Rd r(e.raw);
        e.lastModified = r.u32();
        uint32_t t = r.u32();
        if (t == LE_ACCOUNT) {
            AcctState a;
            need(r.u32() == 0, "pk type");
            a.id = r.take(32);
            a.balance = r.i64();
            a.seqNum = r.i64();
            a.numSubEntries = r.u32();
            need(r.u32() == 0, "inflationDest present");
            a.flags = r.u32();
            a.homeDomain = r.opaque_var(32);
            std::string th = r.take(4);
            memcpy(a.thresholds, th.data(), 4);
            need(r.u32() == 0, "account has signers");
            uint32_t ext = r.u32();
            if (ext == ACC_EXT_V1) {
                a.has_v1 = true;
                a.liab_buying = r.i64();
                a.liab_selling = r.i64();
                uint32_t e1 = r.u32();
                if (e1 == ACC_EXT_V2) {
                    a.has_v2 = true;
                    a.numSponsored = r.u32();
                    a.numSponsoring = r.u32();
                    need(r.u32() == 0, "signerSponsoringIDs present");
                    uint32_t e2 = r.u32();
                    if (e2 == ACC_EXT_V3) {
                        a.has_v3 = true;
                        need(r.u32() == 0, "extension point");
                        a.seqLedger = r.u32();
                        a.seqTime = r.u64();
                    } else {
                        need(e2 == 0, "account ext v2 arm");
                    }
                } else {
                    need(e1 == 0, "account ext v1 arm");
                }
            } else {
                need(ext == 0, "account ext arm");
            }
            need(r.u32() == 0, "entry sponsored");
            need(r.done(), "trailing entry bytes");
            e.kind = K_ACCT;
            e.acct = a;
        } else if (t == LE_TRUSTLINE) {
            TlState tl;
            need(r.u32() == 0, "pk type");
            tl.account = r.take(32);
            tl.asset = read_asset(r);
            need(!asset_is_native(tl.asset), "native trustline");
            tl.balance = r.i64();
            tl.limit = r.i64();
            tl.flags = r.u32();
            /* AUTHORIZED and MAINTAIN_LIABILITIES are mutually
             * exclusive states; an entry carrying both is corrupt and
             * must never apply natively */
            need(!((tl.flags & AUTHORIZED_FLAG) &&
                   (tl.flags & MAINTAIN_LIABILITIES_FLAG)),
                 "invalid trustline auth state");
            uint32_t ext = r.u32();
            if (ext == TL_EXT_V1) {
                tl.has_v1 = true;
                tl.liab_buying = r.i64();
                tl.liab_selling = r.i64();
                uint32_t e1 = r.u32();
                if (e1 == TL_V1_EXT_V2) {
                    tl.has_v2 = true;
                    tl.pool_use_count = r.i32();
                    need(r.u32() == 0, "trustline ext v2 arm");
                } else {
                    need(e1 == 0, "trustline v1 ext arm");
                }
            } else {
                need(ext == 0, "trustline ext arm");
            }
            need(r.u32() == 0, "entry sponsored");
            need(r.done(), "trailing entry bytes");
            e.kind = K_TL;
            e.tl = tl;
        } else if (t == LE_OFFER) {
            OfferState o;
            need(r.u32() == 0, "pk type");
            o.seller = r.take(32);
            o.offerID = r.i64();
            o.selling = read_asset(r);
            o.buying = read_asset(r);
            o.amount = r.i64();
            o.price_n = r.i32();
            o.price_d = r.i32();
            o.flags = r.u32();
            need(r.u32() == 0, "offer ext arm");
            need(r.u32() == 0, "entry sponsored");
            need(r.done(), "trailing entry bytes");
            e.kind = K_OFFER;
            e.offer = o;
        } else if (t == LE_LIQUIDITY_POOL) {
            PoolState p;
            p.pool_id = r.take(32);
            need(r.u32() == 0, "pool body type");
            p.assetA = read_asset(r);
            p.assetB = read_asset(r);
            p.fee = r.i32();
            p.reserveA = r.i64();
            p.reserveB = r.i64();
            p.totalPoolShares = r.i64();
            p.poolSharesTrustLineCount = r.i64();
            need(r.u32() == 0, "entry sponsored");
            need(r.done(), "trailing entry bytes");
            e.kind = K_POOL;
            e.pool = p;
        } else {
            e.kind = K_OTHER;
            return; /* carried verbatim; touching it declines */
        }
        /* round-trip guard: the encoder must reproduce the input bytes
         * EXACTLY or later STATE/UPDATED meta could silently diverge */
        if (encode_entry(e) != e.raw) {
            e.kind = K_OTHER;
            return;
        }
        e.supported = true;
    } catch (Decline &) {
        e.kind = K_OTHER; /* shape outside the model */
    }
}

/* ------------------------------------------------------ store access */

static Entry *find_entry(Ctx &c, const std::string &key) {
    auto it = c.store.find(key);
    return it == c.store.end() ? nullptr : &it->second;
}

/* The store holds EVERY declared key (absent ones as exists=false), so
 * a map miss provably means an UNDECLARED access.  The Python path
 * raises FootprintEscape there; the kernel must decline, never treat
 * it as "entry missing" — that would apply against wrong state. */
static Entry *declared(Ctx &c, const std::string &key) {
    Entry *e = find_entry(c, key);
    need(e != nullptr, "undeclared key access");
    return e;
}

static Entry &load_acct(Ctx &c, const std::string &id, const char *who) {
    Entry *e = declared(c, account_key(id));
    need(e->exists, who);
    need(e->kind == K_ACCT && e->supported, "unsupported account shape");
    return *e;
}

static Entry *load_acct_opt(Ctx &c, const std::string &id) {
    Entry *e = declared(c, account_key(id));
    if (!e->exists)
        return nullptr;
    need(e->kind == K_ACCT && e->supported, "unsupported account shape");
    return e;
}

static Entry *load_tl_opt(Ctx &c, const std::string &id,
                          const std::string &asset) {
    Entry *e = declared(c, trustline_key(id, asset));
    if (!e->exists)
        return nullptr;
    need(e->kind == K_TL && e->supported, "unsupported trustline shape");
    return e;
}

/* record the pre-image of a key the OP phase is about to write */
static void op_touch(Ctx &c, const std::string &key) {
    if (c.op_touched.count(key))
        return;
    Entry *e = find_entry(c, key);
    if (e != nullptr && e->exists)
        c.op_touched[key] = {true, encode_entry(*e)};
    else
        c.op_touched[key] = {false, std::string()};
}

static void mark_put(Ctx &c, Entry &e, const std::string &key) {
    op_touch(c, key);
    e.lastModified = c.ledger_seq; /* LedgerTxn.put stamps every write */
    e.exists = true;
    e.dirty = true;
}

/* ---------------------------------------------------- account helpers */

static int64_t min_balance(const Ctx &c, const AcctState &a) {
    /* (2 + numSubEntries + numSponsoring - numSponsored) * baseReserve */
    int64_t count = 2 + (int64_t)a.numSubEntries + (int64_t)a.numSponsoring -
                    (int64_t)a.numSponsored;
    return count * c.base_reserve;
}

static int64_t available_balance(const Ctx &c, const AcctState &a) {
    int64_t v = a.balance - min_balance(c, a) - a.liab_selling;
    return v > 0 ? v : 0;
}

static int64_t max_receive(const AcctState &a) {
    return INT64_MAX_ - a.balance - a.liab_buying;
}

/* transactions/utils.py _ensure_v3 (called by set_seq_info and, when
 * ext is v0, by set_account_liabilities) */
static void ensure_v3(AcctState &a) {
    a.has_v1 = true;
    a.has_v2 = true;
    a.has_v3 = true;
}

static void set_seq_info(Ctx &c, AcctState &a, int64_t seq) {
    ensure_v3(a);
    a.seqNum = seq;
    a.seqLedger = c.ledger_seq;
    a.seqTime = c.close_time;
}

static void set_account_liabilities(AcctState &a, int64_t b, int64_t s) {
    if (!a.has_v1)
        ensure_v3(a); /* mirror: _ensure_v3 when ext was v0 */
    a.liab_buying = b;
    a.liab_selling = s;
}

static void set_trustline_liabilities(TlState &t, int64_t b, int64_t s) {
    t.has_v1 = true;
    t.liab_buying = b;
    t.liab_selling = s;
}

static bool tl_authorized(const TlState &t) {
    return (t.flags & AUTHORIZED_FLAG) != 0;
}

/* ----------------------------------------------- exchangeV10 (exact) */

struct ExchRes {
    int64_t wheat_receive = 0, sheep_send = 0;
    bool wheat_stays = false;
};

static int64_t div128(i128 x, i128 c, bool round_up) {
    /* x >= 0, c > 0 in every call site; C++ division truncates toward
     * zero, so ceil needs the explicit additive form */
    i128 res = round_up ? (x + c - 1) / c : x / c;
    need(res >= 0 && res <= (i128)INT64_MAX_, "int64 overflow in division");
    return (int64_t)res;
}

static int64_t big_divide(int64_t a, int64_t b, int64_t c, bool round_up) {
    return div128((i128)a * b, (i128)c, round_up);
}

static i128 offer_value(int64_t pn, int64_t pd, int64_t max_send,
                        int64_t max_receive_) {
    i128 lhs = (i128)max_send * pn;
    i128 rhs = (i128)max_receive_ * pd;
    return lhs < rhs ? lhs : rhs;
}

static ExchRes exchange_v10_wt(int32_t pn, int32_t pd, int64_t mws,
                               int64_t mwr, int64_t mss, int64_t msr,
                               int round_) {
    /* exchangeV10WithoutPriceErrorThresholds — all three rounding
     * modes (offer_exchange.py:78) */
    i128 wheat_value = offer_value(pn, pd, mws, msr);
    i128 sheep_value = offer_value(pd, pn, mss, mwr);
    ExchRes res;
    res.wheat_stays = wheat_value > sheep_value;
    int64_t wheat_receive, sheep_send;
    if (res.wheat_stays) {
        if (round_ == ROUND_PP_STRICT_SEND) {
            wheat_receive = div128(sheep_value, pn, false);
            sheep_send = mss < msr ? mss : msr;
        } else if (pn > pd || round_ == ROUND_PP_STRICT_RECEIVE) {
            wheat_receive = div128(sheep_value, pn, false);
            sheep_send = big_divide(wheat_receive, pn, pd, true);
        } else {
            sheep_send = div128(sheep_value, pd, false);
            wheat_receive = big_divide(sheep_send, pd, pn, false);
        }
    } else {
        if (pn > pd) {
            wheat_receive = div128(wheat_value, pn, false);
            sheep_send = big_divide(wheat_receive, pn, pd, false);
        } else {
            sheep_send = div128(wheat_value, pd, false);
            wheat_receive = big_divide(sheep_send, pd, pn, true);
        }
    }
    int64_t wcap = mwr < mws ? mwr : mws;
    int64_t scap = msr < mss ? msr : mss;
    need(wheat_receive >= 0 && wheat_receive <= wcap,
         "wheatReceive out of bounds");
    need(sheep_send >= 0 && sheep_send <= scap, "sheepSend out of bounds");
    res.wheat_receive = wheat_receive;
    res.sheep_send = sheep_send;
    return res;
}

static bool price_error_ok(int32_t pn, int32_t pd, int64_t wr, int64_t ss,
                           bool can_favor_wheat) {
    /* checkPriceErrorBound */
    i128 lhs = (i128)100 * pn * wr;
    i128 rhs = (i128)100 * pd * ss;
    if (can_favor_wheat && rhs > lhs)
        return true;
    i128 diff = lhs > rhs ? lhs - rhs : rhs - lhs;
    i128 cap = (i128)pn * wr;
    return diff <= cap;
}

static ExchRes exchange_v10(int32_t pn, int32_t pd, int64_t mws, int64_t mwr,
                            int64_t mss, int64_t msr,
                            int round_ = ROUND_NORMAL) {
    ExchRes r = exchange_v10_wt(pn, pd, mws, mwr, mss, msr, round_);
    /* applyPriceErrorThresholds */
    if (r.wheat_receive > 0 && r.sheep_send > 0) {
        i128 wrv = (i128)r.wheat_receive * pn;
        i128 ssv = (i128)r.sheep_send * pd;
        need(!(r.wheat_stays && ssv < wrv), "favored sheep when wheat stays");
        need(!(!r.wheat_stays && ssv > wrv), "favored wheat when sheep stays");
        if (round_ == ROUND_NORMAL) {
            if (!price_error_ok(pn, pd, r.wheat_receive, r.sheep_send,
                                false)) {
                r.wheat_receive = 0;
                r.sheep_send = 0;
            }
        } else {
            need(price_error_ok(pn, pd, r.wheat_receive, r.sheep_send,
                                true),
                 "exceeded price error bound");
        }
    } else {
        if (round_ == ROUND_PP_STRICT_SEND) {
            need(r.sheep_send != 0, "invalid amount of sheep sent");
        } else {
            r.wheat_receive = 0;
            r.sheep_send = 0;
        }
    }
    return r;
}

static int64_t adjust_offer_amount(int32_t pn, int32_t pd, int64_t mws,
                                   int64_t msr) {
    ExchRes r = exchange_v10(pn, pd, mws, INT64_MAX_, INT64_MAX_, msr,
                             ROUND_NORMAL);
    return r.wheat_receive;
}

static int64_t offer_selling_liab(int32_t pn, int32_t pd, int64_t amount) {
    return exchange_v10_wt(pn, pd, amount, INT64_MAX_, INT64_MAX_,
                           INT64_MAX_, ROUND_NORMAL)
        .wheat_receive;
}

static int64_t offer_buying_liab(int32_t pn, int32_t pd, int64_t amount) {
    return exchange_v10_wt(pn, pd, amount, INT64_MAX_, INT64_MAX_,
                           INT64_MAX_, ROUND_NORMAL)
        .sheep_send;
}

/* ------------------------------------------- capacities / transfers */

static int64_t can_sell_at_most(Ctx &c, const std::string &id,
                                const std::string &asset) {
    if (asset_is_native(asset)) {
        Entry *e = load_acct_opt(c, id);
        return e == nullptr ? 0 : available_balance(c, e->acct);
    }
    if (asset_issuer(asset) == id)
        return INT64_MAX_;
    Entry *t = load_tl_opt(c, id, asset);
    if (t == nullptr || !tl_authorized(t->tl))
        return 0;
    int64_t v = t->tl.balance - t->tl.liab_selling;
    return v > 0 ? v : 0;
}

static int64_t can_buy_at_most(Ctx &c, const std::string &id,
                               const std::string &asset) {
    if (asset_is_native(asset)) {
        Entry *e = load_acct_opt(c, id);
        if (e == nullptr)
            return 0;
        int64_t v = max_receive(e->acct);
        return v > 0 ? v : 0;
    }
    if (asset_issuer(asset) == id)
        return INT64_MAX_;
    Entry *t = load_tl_opt(c, id, asset);
    if (t == nullptr || !tl_authorized(t->tl))
        return 0;
    int64_t v = t->tl.limit - t->tl.balance - t->tl.liab_buying;
    return v > 0 ? v : 0;
}

/* offer_exchange._credit (liabilities-aware; reserve NOT checked) */
static void credit(Ctx &c, const std::string &id, const std::string &asset,
                   int64_t delta) {
    if (asset_is_native(asset)) {
        Entry &e = load_acct(c, id, "credit target missing");
        AcctState &a = e.acct;
        int64_t nb = a.balance + delta;
        need(nb >= a.liab_selling && nb <= INT64_MAX_ - a.liab_buying,
             "balance transfer failed");
        mark_put(c, e, account_key(id));
        a.balance = nb;
        return;
    }
    if (asset_issuer(asset) == id)
        return; /* issuers mint/burn freely */
    Entry *t = load_tl_opt(c, id, asset);
    need(t != nullptr, "trustline transfer target missing");
    TlState &tl = t->tl;
    int64_t nb = tl.balance + delta;
    need(nb >= tl.liab_selling && nb <= tl.limit - tl.liab_buying,
         "trustline transfer failed");
    mark_put(c, *t, trustline_key(id, asset));
    tl.balance = nb;
}

/* apply_offer_liabilities(oe, sign): acquire(+1)/release(-1); any bound
 * violation declines (the Python path would fail or raise there) */
static void offer_liabilities(Ctx &c, const OfferState &oe, int sign) {
    for (int leg = 0; leg < 2; leg++) {
        bool is_buy = (leg == 1);
        const std::string &asset = is_buy ? oe.buying : oe.selling;
        int64_t liab = is_buy
                           ? offer_buying_liab(oe.price_n, oe.price_d,
                                               oe.amount)
                           : offer_selling_liab(oe.price_n, oe.price_d,
                                                oe.amount);
        int64_t delta = sign * liab;
        if (delta == 0)
            continue;
        if (asset_is_native(asset)) {
            Entry &e = load_acct(c, oe.seller, "offer owner missing");
            AcctState &a = e.acct;
            int64_t b = a.liab_buying, s = a.liab_selling;
            if (is_buy) {
                b += delta;
                need(b >= 0 && !(sign > 0 && b > INT64_MAX_ - a.balance),
                     "buying liabilities out of bounds");
            } else {
                s += delta;
                need(s >= 0 &&
                         !(sign > 0 && s > a.balance - min_balance(c, a)),
                     "selling liabilities out of bounds");
            }
            mark_put(c, e, account_key(oe.seller));
            set_account_liabilities(a, b, s);
        } else if (asset_issuer(asset) == oe.seller) {
            continue;
        } else {
            Entry *t = load_tl_opt(c, oe.seller, asset);
            need(t != nullptr, "offer owner trustline missing");
            TlState &tl = t->tl;
            int64_t b = tl.liab_buying, s = tl.liab_selling;
            if (is_buy) {
                b += delta;
                need(b >= 0 && !(sign > 0 && b > tl.limit - tl.balance),
                     "buying liabilities out of bounds");
            } else {
                s += delta;
                need(s >= 0 && !(sign > 0 && s > tl.balance),
                     "selling liabilities out of bounds");
            }
            mark_put(c, *t, trustline_key(oe.seller, asset));
            set_trustline_liabilities(tl, b, s);
        }
    }
}

/* _erase_offer: liabilities already released; subentry refund on owner */
static void erase_offer(Ctx &c, Entry &oe_entry, const std::string &key) {
    op_touch(c, key);
    oe_entry.exists = false;
    oe_entry.dirty = true;
    const std::string seller = oe_entry.offer.seller;
    Entry &owner = load_acct(c, seller, "offer owner missing on erase");
    need(owner.acct.numSubEntries >= 1, "invalid account state");
    mark_put(c, owner, account_key(seller));
    owner.acct.numSubEntries -= 1;
}

/* ---------------------------------------------------- best offer scan */

static bool price_less(int32_t an, int32_t ad, int64_t aid, int32_t bn,
                       int32_t bd, int64_t bid) {
    i128 l = (i128)an * bd, r = (i128)bn * ad;
    if (l != r)
        return l < r;
    return aid < bid;
}

/* ClusterView._best_offer: first unshadowed materialized row, then all
 * cluster-dirty offers of the direction; exact-rational min wins */
static Entry *best_offer(Ctx &c, const std::string &wheat,
                         const std::string &sheep, std::string *key_out) {
    auto bit = c.books.find({wheat, sheep});
    need(bit != c.books.end(), "undeclared order-book direction");
    Entry *best = nullptr;
    std::string best_key;
    for (const std::string &kb : bit->second.rows) {
        Entry *e = declared(c, kb); /* book rows ride the cluster keys */
        if (e->dirty)
            continue; /* shadowed by the cluster's own writes */
        need(e->exists && e->kind == K_OFFER && e->supported,
             "unsupported book offer");
        best = e;
        best_key = kb;
        break; /* rows are sorted: first unshadowed row wins... */
    }
    /* ...but a dirty (override) offer may still beat it.  Offer keys
     * all start with the big-endian LE_OFFER discriminant, and the
     * store is byte-ordered — scan only that contiguous range, not the
     * whole cluster (accounts/trustlines dominate large clusters and
     * this runs once per crossing iteration) */
    std::string opfx(4, '\0');
    opfx[3] = (char)LE_OFFER;
    for (auto sit = c.store.lower_bound(opfx);
         sit != c.store.end() && sit->first.compare(0, 4, opfx) == 0;
         ++sit) {
        Entry &e = sit->second;
        if (!e.dirty || !e.exists || e.kind != K_OFFER)
            continue;
        if (e.offer.selling != wheat || e.offer.buying != sheep)
            continue;
        if (best == nullptr ||
            price_less(e.offer.price_n, e.offer.price_d, e.offer.offerID,
                       best->offer.price_n, best->offer.price_d,
                       best->offer.offerID)) {
            best = &e;
            best_key = sit->first;
        }
    }
    if (best != nullptr)
        *key_out = best_key;
    return best;
}

/* --------------------------------------------------- meta assembly */

static void emit_change_entry(Wr &w, uint32_t kind, const std::string &enc) {
    w.u32(kind);
    w.raw(enc);
}

static void emit_changes(
    Wr &w, Ctx &c,
    const std::map<std::string, std::pair<bool, std::string>> &touched) {
    /* LedgerTxn.changes(): sorted by key; STATE(prev)+UPDATED/REMOVED,
     * or CREATED; created+erased in-layer is a no-op */
    uint32_t count = 0;
    Wr body;
    for (auto &kv : touched) {
        const std::string &key = kv.first;
        bool existed = kv.second.first;
        Entry *e = find_entry(c, key);
        bool exists_now = (e != nullptr && e->exists);
        if (existed) {
            emit_change_entry(body, CH_STATE, kv.second.second);
            count++;
            if (exists_now) {
                emit_change_entry(body, CH_UPDATED, encode_entry(*e));
            } else {
                /* REMOVED carries the LedgerKey — the key bytes ARE its
                 * canonical encoding */
                emit_change_entry(body, CH_REMOVED, key);
            }
            count++;
        } else {
            if (!exists_now)
                continue;
            emit_change_entry(body, CH_CREATED, encode_entry(*e));
            count++;
        }
    }
    w.u32(count);
    w.raw(body.out);
}

/* ------------------------------------------------------- validity */

static void common_checks(Ctx &c, const Tx &tx, Entry &src) {
    need(tx.fee >= 0, "negative fee");
    need(tx.fee >= c.base_fee, "insufficient fee");
    AcctState &a = src.acct;
    /* master-only auth: tx LOW + op MEDIUM thresholds met by the master
     * weight alone (signature verdicts pre-checked by the dispatcher) */
    uint8_t mw = a.thresholds[0];
    uint8_t low = a.thresholds[1], med = a.thresholds[2];
    need(mw > 0, "master key disabled");
    need(mw >= (low > 1 ? low : 1), "low threshold unmet");
    need(mw >= (med > 1 ? med : 1), "medium threshold unmet");
    /* sequence: acc.seqNum + 1 == tx.seqNum, not the starting seq */
    need(tx.seq >= 0, "negative seqnum");
    need(a.seqNum < INT64_MAX_, "seqnum saturated");
    need(a.seqNum + 1 == tx.seq, "bad seqnum");
    need(tx.seq != ((int64_t)c.ledger_seq << 32), "starting seqnum");
    /* balance above reserve+liabilities (fee already charged) */
    need(a.balance - a.liab_selling - min_balance(c, a) >= 0,
         "insufficient balance");
}

/* ------------------------------------------------------- payment op */

static void apply_payment(Ctx &c, const Tx &tx) {
    need(tx.amount > 0, "payment amount non-positive");
    need(asset_valid(tx.asset), "payment asset invalid");
    if (asset_is_native(tx.asset)) {
        /* credit destination first (ref updateDestBalance order) */
        Entry *de = load_acct_opt(c, tx.dest);
        need(de != nullptr, "payment destination missing");
        need(max_receive(de->acct) >= tx.amount, "payment line full");
        mark_put(c, *de, account_key(tx.dest));
        de->acct.balance += tx.amount;
        /* debit source, re-reading (self-payment nets to zero) */
        Entry &se = load_acct(c, tx.src, "payment source missing");
        need(tx.amount <= available_balance(c, se.acct),
             "payment underfunded");
        int64_t nb = se.acct.balance - tx.amount;
        need(nb >= 0 && nb <= INT64_MAX_, "payment balance overflow");
        mark_put(c, se, account_key(tx.src));
        se.acct.balance = nb;
        return;
    }
    /* credit asset (ref PaymentOpFrame::doApply via the strict-receive
     * core with an empty path): issuer sides mint/burn freely, the
     * dest-existence check is bypassed when paying the issuer itself */
    std::string issuer = asset_issuer(tx.asset);
    bool bypass_issuer_check = tx.dest == issuer;
    if (!bypass_issuer_check)
        need(load_acct_opt(c, tx.dest) != nullptr,
             "payment destination missing");
    /* -- 1) credit the destination ------------------------------------ */
    if (tx.dest != issuer) {
        Entry *dt = load_tl_opt(c, tx.dest, tx.asset);
        need(dt != nullptr, "payment no trust");
        need(tl_authorized(dt->tl), "payment not authorized");
        TlState &dtl = dt->tl;
        /* trustline_max_receive: limit - balance - buying */
        need(dtl.limit - dtl.balance - dtl.liab_buying >= tx.amount,
             "payment line full");
        mark_put(c, *dt, trustline_key(tx.dest, tx.asset));
        dtl.balance += tx.amount;
    }
    /* -- 2) debit the source (re-read: may be the same trustline) ----- */
    if (tx.src != issuer) {
        Entry *st = load_tl_opt(c, tx.src, tx.asset);
        need(st != nullptr, "payment src no trust");
        need(tl_authorized(st->tl), "payment src not authorized");
        TlState &stl = st->tl;
        int64_t avail = stl.balance - stl.liab_selling;
        need((avail > 0 ? avail : 0) >= tx.amount, "payment underfunded");
        mark_put(c, *st, trustline_key(tx.src, tx.asset));
        stl.balance -= tx.amount;
    }
}

/* opINNER(PAYMENT, PAYMENT_SUCCESS) */
static void payment_result(Wr &w) {
    w.u32(0);          /* opINNER */
    w.u32(OP_PAYMENT); /* OperationResultTr disc */
    w.u32(0);          /* PAYMENT_SUCCESS (void arm) */
}

/* ------------------------------------------------ manage_sell_offer */

struct Atom {
    bool is_pool = false;  /* liquidity-pool atom: pool_id set, no seller */
    std::string pool_id;   /* raw 32 (pool atoms) */
    std::string seller;    /* raw 32 (order-book atoms) */
    int64_t offer_id = 0;
    std::string asset_sold;
    int64_t amount_sold = 0;
    std::string asset_bought;
    int64_t amount_bought = 0;
};

static bool crosses(int32_t book_n, int32_t book_d, int32_t own_n,
                    int32_t own_d, bool own_passive, bool book_passive) {
    i128 lhs = (i128)book_n * own_n;
    i128 rhs = (i128)book_d * own_d;
    if (lhs < rhs)
        return true;
    if (lhs == rhs)
        return !(own_passive || book_passive);
    return false;
}

static void emit_claim_atoms(Wr &w, const std::vector<Atom> &atoms) {
    w.u32((uint32_t)atoms.size());
    for (const Atom &at : atoms) {
        if (at.is_pool) {
            w.u32(2); /* CLAIM_ATOM_TYPE_LIQUIDITY_POOL */
            w.raw(at.pool_id);
            w.raw(at.asset_sold);
            w.i64(at.amount_sold);
            w.raw(at.asset_bought);
            w.i64(at.amount_bought);
            continue;
        }
        w.u32(1); /* CLAIM_ATOM_TYPE_ORDER_BOOK */
        w.u32(0); /* sellerID pk disc */
        w.raw(at.seller);
        w.i64(at.offer_id);
        w.raw(at.asset_sold);
        w.i64(at.amount_sold);
        w.raw(at.asset_bought);
        w.i64(at.amount_bought);
    }
}

struct ConvertOut {
    int64_t sheep_sent = 0, wheat_received = 0;
    std::vector<Atom> atoms;
};

/* convert_with_offers (offer_exchange.py:340): cross book offers
 * selling ``wheat`` for ``sheep`` until limits are exhausted.  Book
 * sellers settle here; the taker's side is the caller's.  The
 * manage-offer own-price filter engages when filter_pn > 0 (its stop
 * is a normal outcome); CROSSED_SELF / TOO_MANY_OFFERS / exchange
 * errors decline — every one is a failure result host-side, and the
 * kernel owns success paths only. */
static ConvertOut convert_with_offers(Ctx &c, const std::string &src,
                                      const std::string &sheep,
                                      int64_t max_sheep_send,
                                      const std::string &wheat,
                                      int64_t max_wheat_receive,
                                      int round_, int32_t filter_pn,
                                      int32_t filter_pd) {
    ConvertOut out;
    int crossed = 0;
    while (max_sheep_send - out.sheep_sent > 0 &&
           max_wheat_receive - out.wheat_received > 0) {
        std::string okey;
        Entry *oe_e = best_offer(c, wheat, sheep, &okey);
        if (oe_e == nullptr)
            break;
        need(crossed < MAX_OFFERS_TO_CROSS, "too many offers crossed");
        OfferState &oe = oe_e->offer;
        if (filter_pn > 0 &&
            !crosses(oe.price_n, oe.price_d, filter_pn, filter_pd, false,
                     (oe.flags & PASSIVE_FLAG) != 0))
            break; /* price filter stop */
        need(oe.seller != src, "crossed self");

        offer_liabilities(c, oe, -1); /* release before measuring */

        int64_t seller_cap = can_sell_at_most(c, oe.seller, wheat);
        int64_t mwso = oe.amount < seller_cap ? oe.amount : seller_cap;
        int64_t msro = can_buy_at_most(c, oe.seller, sheep);
        int64_t adjusted =
            adjust_offer_amount(oe.price_n, oe.price_d, mwso, msro);
        if (adjusted == 0) {
            erase_offer(c, *oe_e, okey);
            crossed++;
            continue;
        }

        ExchRes res = exchange_v10(oe.price_n, oe.price_d, adjusted,
                                   max_wheat_receive - out.wheat_received,
                                   max_sheep_send - out.sheep_sent,
                                   INT64_MAX_, round_);
        crossed++;

        if (res.wheat_receive > 0) {
            credit(c, oe.seller, wheat, -res.wheat_receive);
            credit(c, oe.seller, sheep, res.sheep_send);
            Atom at;
            at.seller = oe.seller;
            at.offer_id = oe.offerID;
            at.asset_sold = wheat;
            at.amount_sold = res.wheat_receive;
            at.asset_bought = sheep;
            at.amount_bought = res.sheep_send;
            out.atoms.push_back(at);
            out.sheep_sent += res.sheep_send;
            out.wheat_received += res.wheat_receive;
        }

        if (res.wheat_stays) {
            int64_t rem = oe.amount - res.wheat_receive;
            int64_t cap2 = can_sell_at_most(c, oe.seller, wheat);
            int64_t new_amount = adjust_offer_amount(
                oe.price_n, oe.price_d, rem < cap2 ? rem : cap2,
                can_buy_at_most(c, oe.seller, sheep));
            if (new_amount == 0) {
                erase_offer(c, *oe_e, okey);
            } else {
                mark_put(c, *oe_e, okey);
                oe.amount = new_amount;
                offer_liabilities(c, oe, 1);
            }
            break; /* taker exhausted */
        }
        erase_offer(c, *oe_e, okey);
    }
    return out;
}

static void apply_manage_sell_offer(Ctx &c, const Tx &tx, Wr &result) {
    const std::string &selling = tx.selling, &buying = tx.buying;
    need(asset_valid(selling) && asset_valid(buying), "invalid asset");
    need(selling != buying, "selling == buying");
    need(tx.price_n > 0 && tx.price_d > 0, "invalid price");
    need(tx.amount >= 0 && tx.offer_id >= 0, "malformed offer");
    need(tx.amount > 0 || tx.offer_id != 0, "malformed offer");

    if (tx.amount == 0) {
        /* delete: no trustline prerequisites (ref checkOfferValid:38
         * "don't bother loading trust lines as we're deleting") */
        std::string okey = offer_key(tx.src, tx.offer_id);
        Entry *oe_e = declared(c, okey);
        need(oe_e->exists, "offer not found");
        need(oe_e->kind == K_OFFER && oe_e->supported,
             "unsupported offer shape");
        offer_liabilities(c, oe_e->offer, -1);
        erase_offer(c, *oe_e, okey);
        result.u32(0);                    /* opINNER */
        result.u32(OP_MANAGE_SELL_OFFER); /* tr disc */
        result.u32(0);                    /* MANAGE_SELL_OFFER_SUCCESS */
        result.u32(0);                    /* offersClaimed: [] */
        result.u32(EFF_DELETED);          /* (void) */
        return;
    }

    /* trustline prerequisites (ref checkOfferValid order) */
    if (!asset_is_native(selling) && asset_issuer(selling) != tx.src) {
        Entry *tl = load_tl_opt(c, tx.src, selling);
        need(load_acct_opt(c, asset_issuer(selling)) != nullptr,
             "sell no issuer");
        need(tl != nullptr, "sell no trust");
        need(tl_authorized(tl->tl), "sell not authorized");
    }
    if (!asset_is_native(buying) && asset_issuer(buying) != tx.src) {
        Entry *tl = load_tl_opt(c, tx.src, buying);
        need(load_acct_opt(c, asset_issuer(buying)) != nullptr,
             "buy no issuer");
        need(tl != nullptr, "buy no trust");
        need(tl_authorized(tl->tl), "buy not authorized");
    }

    bool modify = tx.offer_id != 0;
    uint32_t existing_flags = 0;
    if (modify) {
        /* modify: release old liabilities + erase, but KEEP the
         * subentry reservation (ref doApply v14+: "sellSheepOffer is
         * deleted but sourceAccount is not updated"); the rebuilt
         * offer keeps the loaded offer's flags — sponsored offers
         * decline at entry parse, so no sponsor survives here */
        std::string exkey = offer_key(tx.src, tx.offer_id);
        Entry *ex = declared(c, exkey);
        need(ex->exists, "offer not found");
        need(ex->kind == K_OFFER && ex->supported,
             "unsupported offer shape");
        existing_flags = ex->offer.flags;
        offer_liabilities(c, ex->offer, -1);
        op_touch(c, exkey);
        ex->exists = false;
        ex->dirty = true;
    } else {
        /* new offer: up-front subentry reservation (0-amount dummy
         * through create_entry_with_possible_sponsorship, unsponsored
         * branch) */
        Entry &se = load_acct(c, tx.src, "offer source missing");
        AcctState &a = se.acct;
        need(a.numSubEntries + 1 <= ACCOUNT_SUBENTRY_LIMIT,
             "too many subentries");
        need(available_balance(c, a) >= c.base_reserve, "low reserve");
        mark_put(c, se, account_key(tx.src));
        a.numSubEntries += 1;
    }

    /* full-offer liabilities must fit capacity up front */
    int64_t sell_cap = can_sell_at_most(c, tx.src, selling);
    int64_t buy_cap = can_buy_at_most(c, tx.src, buying);
    need(buy_cap >= offer_buying_liab(tx.price_n, tx.price_d, tx.amount),
         "offer line full");
    need(sell_cap >= offer_selling_liab(tx.price_n, tx.price_d, tx.amount),
         "offer underfunded");

    int64_t max_sheep_send = tx.amount < sell_cap ? tx.amount : sell_cap;
    int64_t max_wheat_receive = buy_cap;

    /* crossing loop (sheep=selling, wheat=buying; own offer is never
     * passive here — CREATE_PASSIVE_SELL_OFFER stays host-side) */
    ConvertOut cv = convert_with_offers(c, tx.src, selling, max_sheep_send,
                                        buying, max_wheat_receive,
                                        ROUND_NORMAL, tx.price_n,
                                        tx.price_d);

    /* settle the taker's side */
    if (cv.sheep_sent > 0)
        credit(c, tx.src, selling, -cv.sheep_sent);
    if (cv.wheat_received > 0)
        credit(c, tx.src, buying, cv.wheat_received);

    /* residual resting amount, re-adjusted post-settle */
    int64_t rem = tx.amount - cv.sheep_sent;
    int64_t cap = can_sell_at_most(c, tx.src, selling);
    int64_t sheep_limit = rem < cap ? rem : cap;
    int64_t wheat_limit = can_buy_at_most(c, tx.src, buying);
    int64_t amount_left =
        adjust_offer_amount(tx.price_n, tx.price_d, sheep_limit, wheat_limit);

    /* result: opINNER(MANAGE_SELL_OFFER, SUCCESS, ManageOfferSuccess) */
    result.u32(0);                    /* opINNER */
    result.u32(OP_MANAGE_SELL_OFFER); /* tr disc */
    result.u32(0);                    /* MANAGE_SELL_OFFER_SUCCESS */
    emit_claim_atoms(result, cv.atoms);

    if (amount_left <= 0) {
        /* nothing rests: give back the subentry reservation — for a
         * modify too (the ghost remove_entry_with_possible_sponsorship
         * on the 0-amount offer) */
        Entry &se = load_acct(c, tx.src, "offer source missing");
        need(se.acct.numSubEntries >= 1, "invalid account state");
        mark_put(c, se, account_key(tx.src));
        se.acct.numSubEntries -= 1;
        result.u32(EFF_DELETED); /* (void) */
        return;
    }

    /* write the resting offer: a modify keeps its id and flags, a
     * create allocates from the id pool */
    int64_t new_id;
    uint32_t flags;
    if (modify) {
        new_id = tx.offer_id;
        flags = existing_flags;
    } else {
        need(c.idpool < INT64_MAX_, "id pool saturated");
        new_id = c.idpool + 1;
        c.idpool = new_id;
        flags = 0;
    }
    OfferState no;
    no.seller = tx.src;
    no.offerID = new_id;
    no.selling = selling;
    no.buying = buying;
    no.amount = amount_left;
    no.price_n = tx.price_n;
    no.price_d = tx.price_d;
    no.flags = flags;
    std::string nkey = offer_key(tx.src, new_id);
    need(find_entry(c, nkey) == nullptr || !c.store[nkey].exists,
         "fresh offer key collision");
    Entry &ne = c.store[nkey];
    ne.kind = K_OFFER;
    ne.supported = true;
    ne.offer = no;
    mark_put(c, ne, nkey);
    offer_liabilities(c, ne.offer, 1);
    result.u32(modify ? EFF_UPDATED : EFF_CREATED);
    encode_offer_value(ne.offer, result);
}

/* ------------------------------------------------------ change_trust */

static void apply_change_trust(Ctx &c, const Tx &tx) {
    const std::string &line = tx.asset;
    need(asset_valid(line) && !asset_is_native(line),
         "change trust malformed");
    std::string issuer = asset_issuer(line);
    need(issuer != tx.src, "change trust self not allowed");
    need(tx.limit >= 0, "change trust malformed");

    std::string tlkey = trustline_key(tx.src, line);
    Entry *t = declared(c, tlkey);
    if (t->exists) {
        need(t->kind == K_TL && t->supported,
             "unsupported trustline shape");
        TlState &tl = t->tl;
        if (tx.limit != 0) {
            /* limit update (ref ChangeTrustOpFrame::doApply) */
            need(tx.limit >= tl.balance + tl.liab_buying,
                 "change trust invalid limit");
            need(load_acct_opt(c, issuer) != nullptr,
                 "change trust no issuer");
            mark_put(c, *t, tlkey);
            tl.limit = tx.limit;
            return;
        }
        /* delete: only an empty, liability-free, pool-free line goes */
        need(tl.balance == 0, "change trust invalid limit");
        need(tl.liab_buying == 0 && tl.liab_selling == 0,
             "change trust cannot delete");
        need(tl.pool_use_count == 0, "change trust cannot delete");
        op_touch(c, tlkey);
        t->exists = false;
        t->dirty = true;
        /* unsponsored remove: the owner's subentry reserve returns */
        Entry &owner = load_acct(c, tx.src, "trust source missing");
        need(owner.acct.numSubEntries >= 1, "invalid account state");
        mark_put(c, owner, account_key(tx.src));
        owner.acct.numSubEntries -= 1;
        return;
    }

    /* new trustline: flags derive from the issuer's account flags */
    need(tx.limit != 0, "change trust invalid limit");
    Entry *ie = load_acct_opt(c, issuer);
    need(ie != nullptr, "change trust no issuer");
    uint32_t flags = 0;
    if (!(ie->acct.flags & ACC_AUTH_REQUIRED_FLAG))
        flags |= AUTHORIZED_FLAG;
    if (ie->acct.flags & ACC_AUTH_CLAWBACK_FLAG)
        flags |= TL_CLAWBACK_FLAG;
    /* unsponsored create: the owner pays the subentry reserve */
    {
        Entry &owner = load_acct(c, tx.src, "trust source missing");
        AcctState &a = owner.acct;
        need(a.numSubEntries + 1 <= ACCOUNT_SUBENTRY_LIMIT,
             "too many subentries");
        need(available_balance(c, a) >= c.base_reserve, "low reserve");
        mark_put(c, owner, account_key(tx.src));
        a.numSubEntries += 1;
    }
    TlState tl;
    tl.account = tx.src;
    tl.asset = line;
    tl.balance = 0;
    tl.limit = tx.limit;
    tl.flags = flags;
    t->kind = K_TL;
    t->supported = true;
    t->tl = tl;
    mark_put(c, *t, tlkey);
}

/* opINNER(CHANGE_TRUST, CHANGE_TRUST_SUCCESS) */
static void change_trust_result(Wr &w) {
    w.u32(0);               /* opINNER */
    w.u32(OP_CHANGE_TRUST); /* OperationResultTr disc */
    w.u32(0);               /* CHANGE_TRUST_SUCCESS (void arm) */
}

/* ---------------------------------------------------- path payments */

/* Constant-product quote twins (transactions/liquidity_pool.py).  The
 * Python reference computes in unbounded ints; the kernel works in
 * i128, and any product that could exceed it DECLINES so the bignum
 * reference adjudicates — it never wraps. */
static const i128 I128_MAX = (i128)(((unsigned __int128)1 << 127) - 1);

/* floor((f*rout*in) / (10000*rin + f*in)), f = 10000 - fee_bps; false
 * mirrors the reference returning None (caller falls back to the book) */
static bool pool_swap_out_given_in(int64_t rin, int64_t rout, int64_t in,
                                   int32_t fee_bps, int64_t *out) {
    if (in <= 0 || rin <= 0 || rout <= 0)
        return false;
    if (in > INT64_MAX_ - rin)
        return false;
    i128 f = POOL_MAX_BPS - fee_bps;
    i128 prod = f * (i128)rout;
    need(prod == 0 || (i128)in <= I128_MAX / prod, "pool math overflow");
    i128 num = prod * (i128)in;
    i128 den = (i128)POOL_MAX_BPS * rin + f * (i128)in;
    i128 o = num / den; /* non-negative operands: trunc == floor */
    if (o == 0)
        return false;
    *out = (int64_t)o; /* o < rout, so it fits */
    return true;
}

/* ceil((10000*rin*out) / ((rout-out)*f)); false mirrors None */
static bool pool_swap_in_given_out(int64_t rin, int64_t rout, int64_t outv,
                                   int32_t fee_bps, int64_t *in) {
    if (outv <= 0 || rin <= 0 || rout <= 0)
        return false;
    if (outv >= rout)
        return false;
    i128 f = POOL_MAX_BPS - fee_bps;
    i128 a = (i128)POOL_MAX_BPS * rin;
    need((i128)outv <= I128_MAX / a, "pool math overflow");
    i128 num = a * (i128)outv;
    i128 den = ((i128)rout - outv) * f; /* > 0 */
    need(num <= I128_MAX - den, "pool math overflow");
    i128 amt = (num + den - 1) / den; /* ceil */
    if (amt > (i128)INT64_MAX_ - rin)
        return false;
    *in = (int64_t)amt;
    return true;
}

/* convert_with_offers_and_pools (offer_exchange.py): quote the hop's
 * declared pool, attempt the book in a child frame, keep whichever
 * side wins — the book only on a strictly better price.  The pool key
 * rides the footprint's book materialization, so it is always
 * declared; an absent pool degrades to the plain book crossing. */
static ConvertOut convert_hop(Ctx &c, const std::string &src,
                              const Hop &hop, int64_t max_sheep_send,
                              int64_t max_wheat_receive, int round_) {
    const std::string &sheep = hop.selling, &wheat = hop.buying;
    Entry *pe = declared(c, hop.pool_key);
    bool have_quote = false;
    bool sheep_is_a = false;
    int64_t to_pool = 0, from_pool = 0;
    if (pe->exists) {
        need(pe->kind == K_POOL && pe->supported,
             "unsupported pool shape");
        const PoolState &p = pe->pool;
        /* compare_assets' total order equals lexicographic order of the
         * canonical asset encodings, so byte compare decides A/B */
        sheep_is_a = sheep < wheat;
        const std::string &ca = sheep_is_a ? sheep : wheat;
        const std::string &cb = sheep_is_a ? wheat : sheep;
        /* the footprint derived this key from (min, max, fee=30); an
         * entry disagreeing with its own key is outside the model */
        need(p.assetA == ca && p.assetB == cb && p.fee == POOL_FEE_V18,
             "pool params mismatch");
        int64_t rin = sheep_is_a ? p.reserveA : p.reserveB;
        int64_t rout = sheep_is_a ? p.reserveB : p.reserveA;
        if (rin > 0 && rout > 0) {
            if (round_ == ROUND_PP_STRICT_SEND) {
                to_pool = max_sheep_send;
                have_quote = pool_swap_out_given_in(rin, rout, to_pool,
                                                    p.fee, &from_pool);
            } else if (round_ == ROUND_PP_STRICT_RECEIVE) {
                from_pool = max_wheat_receive;
                have_quote = pool_swap_in_given_out(rin, rout, from_pool,
                                                    p.fee, &to_pool);
            }
        }
    }
    if (!have_quote)
        return convert_with_offers(c, src, sheep, max_sheep_send, wheat,
                                   max_wheat_receive, round_, 0, 0);

    /* EMPTY book: convert_with_offers would cross nothing (both limits
     * stay slack -> ConvertResult.PARTIAL -> book loses), so the child
     * frame is provably a no-op.  Skip the whole-store snapshot — it is
     * O(cluster) per hop, and a pool-only workload collapses to ONE
     * conflict cluster, so snapshotting would make the close O(n^2).
     * best_offer is a pure read (the store is fully pre-materialized). */
    std::string probe_key;
    if (best_offer(c, wheat, sheep, &probe_key) == nullptr) {
        Entry *pe2 = declared(c, hop.pool_key);
        mark_put(c, *pe2, hop.pool_key);
        PoolState &p = pe2->pool;
        if (sheep_is_a) {
            p.reserveA += to_pool;
            p.reserveB -= from_pool;
        } else {
            p.reserveB += to_pool;
            p.reserveA -= from_pool;
        }
        Atom at;
        at.is_pool = true;
        at.pool_id = p.pool_id;
        at.asset_sold = wheat;
        at.amount_sold = from_pool;
        at.asset_bought = sheep;
        at.amount_bought = to_pool;
        ConvertOut out;
        out.sheep_sent = to_pool;
        out.wheat_received = from_pool;
        out.atoms.push_back(at);
        return out;
    }

    /* book attempt in a child frame (the reference's child LedgerTxn):
     * snapshot the mutable tx-visible state, roll back if the pool wins */
    std::map<std::string, Entry> store_snap = c.store;
    std::map<std::string, std::pair<bool, std::string>> touched_snap =
        c.op_touched;
    int64_t idpool_snap = c.idpool;
    ConvertOut cv = convert_with_offers(c, src, sheep, max_sheep_send,
                                        wheat, max_wheat_receive, round_,
                                        0, 0);
    /* ConvertResult.OK unless BOTH limits kept slack (PARTIAL) */
    bool book_ok = !(max_wheat_receive - cv.wheat_received > 0 &&
                     max_sheep_send - cv.sheep_sent > 0);
    bool use_book =
        book_ok && (i128)to_pool * cv.wheat_received >
                       (i128)from_pool * cv.sheep_sent;
    if (use_book)
        return cv;

    /* pool wins: restore, then trade against the pool */
    c.store = std::move(store_snap);
    c.op_touched = std::move(touched_snap);
    c.idpool = idpool_snap;
    Entry *pe2 = declared(c, hop.pool_key); /* re-locate after restore */
    mark_put(c, *pe2, hop.pool_key);
    PoolState &p = pe2->pool;
    if (sheep_is_a) {
        p.reserveA += to_pool;
        p.reserveB -= from_pool;
    } else {
        p.reserveB += to_pool;
        p.reserveA -= from_pool;
    }
    Atom at;
    at.is_pool = true;
    at.pool_id = p.pool_id;
    at.asset_sold = wheat;
    at.amount_sold = from_pool;
    at.asset_bought = sheep;
    at.amount_bought = to_pool;
    ConvertOut out;
    out.sheep_sent = to_pool;
    out.wheat_received = from_pool;
    out.atoms.push_back(at);
    return out;
}

static void apply_path_payment(Ctx &c, const Tx &tx, Wr &result) {
    bool strict_send = tx.op == OP_PATH_PAYMENT_STRICT_SEND;
    /* tx.amount = sendAmount | sendMax; tx.amount2 = destMin |
     * destAmount (strict send | strict receive) */
    need(tx.amount > 0 && tx.amount2 > 0, "path payment malformed");
    need(asset_valid(tx.asset) && asset_valid(tx.dest_asset),
         "path payment malformed");
    need((int)tx.hops.size() <= MAX_PATH_HOPS, "path too long");
    for (const Hop &h : tx.hops)
        need(asset_valid(h.selling) && asset_valid(h.buying),
             "path payment malformed");

    /* destination existence + dest/src trust gates (every failure is a
     * failure result host-side; the walk never touches the source's
     * own lines — sellers are never the taker — so check placement is
     * not state-visible on success paths) */
    need(load_acct_opt(c, tx.dest) != nullptr, "path no destination");
    if (!asset_is_native(tx.dest_asset) &&
        asset_issuer(tx.dest_asset) != tx.dest) {
        Entry *dt = load_tl_opt(c, tx.dest, tx.dest_asset);
        need(dt != nullptr, "path no trust");
        need(tl_authorized(dt->tl), "path not authorized");
    }
    if (!asset_is_native(tx.asset) && asset_issuer(tx.asset) != tx.src) {
        Entry *st = load_tl_opt(c, tx.src, tx.asset);
        need(st != nullptr, "path src no trust");
        need(tl_authorized(st->tl), "path src not authorized");
    }

    std::vector<Atom> atoms;
    int64_t send_amount, dest_amount;
    if (strict_send) {
        /* forward walk: propagate what each hop yields */
        int64_t have = tx.amount;
        for (size_t i = 0; i < tx.hops.size(); i++) {
            const Hop &hop = tx.hops[i];
            ConvertOut out = convert_hop(c, tx.src, hop, have,
                                         INT64_MAX_,
                                         ROUND_PP_STRICT_SEND);
            need(out.sheep_sent >= have, "too few offers");
            atoms.insert(atoms.end(), out.atoms.begin(),
                         out.atoms.end());
            have = out.wheat_received;
        }
        send_amount = tx.amount;
        dest_amount = have;
        need(dest_amount >= tx.amount2, "under destmin");
    } else {
        /* backward walk: compute what each hop requires */
        int64_t needed = tx.amount2;
        for (size_t i = tx.hops.size(); i-- > 0;) {
            const Hop &hop = tx.hops[i];
            ConvertOut out = convert_hop(c, tx.src, hop, INT64_MAX_,
                                         needed,
                                         ROUND_PP_STRICT_RECEIVE);
            need(out.wheat_received >= needed, "too few offers");
            atoms.insert(atoms.begin(), out.atoms.begin(),
                         out.atoms.end());
            needed = out.sheep_sent;
        }
        send_amount = needed;
        dest_amount = tx.amount2;
        need(send_amount <= tx.amount, "over sendmax");
    }

    if (asset_is_native(tx.asset)) {
        Entry &se = load_acct(c, tx.src, "path source missing");
        need(send_amount <= available_balance(c, se.acct),
             "path underfunded");
    }
    credit(c, tx.src, tx.asset, -send_amount);
    credit(c, tx.dest, tx.dest_asset, dest_amount);

    /* opINNER(type, SUCCESS, {offers, last: SimplePaymentResult}) */
    result.u32(0);                 /* opINNER */
    result.u32((uint32_t)tx.op);   /* OperationResultTr disc */
    result.u32(0);                 /* *_SUCCESS */
    emit_claim_atoms(result, atoms);
    result.u32(0); /* last.destination pk disc */
    result.raw(tx.dest);
    result.raw(tx.dest_asset);
    result.i64(dest_amount);
}

/* -------------------------------------------------------- tx driver */

static void run_tx(Ctx &c, size_t idx) {
    const Tx &tx = c.txs[idx];
    c.pre_touched.clear();
    c.op_touched.clear();

    Entry &src = load_acct(c, tx.src, "tx source missing");
    common_checks(c, tx, src);

    /* pre-ops phase: consume the sequence number (its delta is the
     * meta's txChangesBefore and commits before the op layer opens) */
    std::string src_key = account_key(tx.src);
    c.pre_touched[src_key] = {true, encode_entry(src)};
    need(src.acct.seqNum <= tx.seq, "unexpected sequence number");
    src.lastModified = c.ledger_seq;
    src.dirty = true;
    set_seq_info(c, src.acct, tx.seq);
    /* snapshot txChangesBefore NOW: its UPDATED values are the
     * post-seqnum PRE-op state (the pre layer commits before ops run) */
    Wr before;
    emit_changes(before, c, c.pre_touched);

    /* op phase */
    Wr opres;
    if (tx.op == OP_PAYMENT) {
        apply_payment(c, tx);
        payment_result(opres);
    } else if (tx.op == OP_MANAGE_SELL_OFFER) {
        apply_manage_sell_offer(c, tx, opres);
    } else if (tx.op == OP_CHANGE_TRUST) {
        apply_change_trust(c, tx);
        change_trust_result(opres);
    } else if (tx.op == OP_PATH_PAYMENT_STRICT_SEND ||
               tx.op == OP_PATH_PAYMENT_STRICT_RECEIVE) {
        apply_path_payment(c, tx, opres);
    } else {
        throw Decline("unsupported op type");
    }

    /* TransactionMeta: disc 2 + V2{before, [opmeta], after=[]} */
    Wr meta;
    meta.u32(2);
    meta.raw(before.out);
    meta.u32(1); /* one operation */
    emit_changes(meta, c, c.op_touched);
    meta.u32(0); /* txChangesAfter */

    /* TransactionResult: feeCharged + txSUCCESS[1 op result] + ext v0 */
    Wr result;
    result.i64(tx.fee_charged);
    result.u32(0); /* txSUCCESS */
    result.u32(1);
    result.raw(opres.out);
    result.u32(0); /* ext v0 */

    c.records.push_back({meta.out, result.out});
}

/* ------------------------------------------------------ python glue */

static PyObject *KernelError; /* module-level exception for bad calls */

static int parse_bytes(PyObject *o, std::string &out, const char *what) {
    char *buf;
    Py_ssize_t len;
    /* o may be NULL (short tuple from a caller regression): raise,
     * never hand NULL to PyBytes_AsStringAndSize (segfault) */
    if (!o || PyBytes_AsStringAndSize(o, &buf, &len) < 0) {
        PyErr_Format(KernelError, "%s: expected bytes", what);
        return -1;
    }
    out.assign(buf, (size_t)len);
    return 0;
}

static PyObject *apply_cluster(PyObject *self, PyObject *args) {
    PyObject *params, *entries, *books, *txs;
    if (!PyArg_ParseTuple(args, "OOOO", &params, &entries, &books, &txs))
        return NULL;

    Ctx c;
    {
        long long ls, ct, bf, br, ip;
        if (!PyArg_ParseTuple(params, "LLLLL", &ls, &ct, &bf, &br, &ip))
            return NULL;
        c.ledger_seq = (uint32_t)ls;
        c.close_time = (uint64_t)ct;
        c.base_fee = bf;
        c.base_reserve = br;
        c.idpool = ip;
    }

    /* entries */
    PyObject *seq = PySequence_Fast(entries, "entries must be a sequence");
    if (!seq)
        return NULL;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *kb = PyTuple_GetItem(it, 0);
        PyObject *eb = PyTuple_GetItem(it, 1);
        if (!kb || !eb) {
            Py_DECREF(seq);
            return NULL;
        }
        std::string key;
        if (parse_bytes(kb, key, "entry key") < 0) {
            Py_DECREF(seq);
            return NULL;
        }
        Entry &e = c.store[key];
        if (eb == Py_None) {
            e.exists = false;
        } else {
            if (parse_bytes(eb, e.raw, "entry bytes") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            e.exists = true;
        }
    }
    Py_DECREF(seq);

    /* books */
    seq = PySequence_Fast(books, "books must be a sequence");
    if (!seq)
        return NULL;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        std::string sb, bb;
        if (parse_bytes(PyTuple_GetItem(it, 0), sb, "book selling") < 0 ||
            parse_bytes(PyTuple_GetItem(it, 1), bb, "book buying") < 0) {
            Py_DECREF(seq);
            return NULL;
        }
        PyObject *rows = PySequence_Fast(PyTuple_GetItem(it, 2),
                                         "book rows must be a sequence");
        if (!rows) {
            Py_DECREF(seq);
            return NULL;
        }
        BookDir &bd = c.books[{sb, bb}];
        for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(rows); j++) {
            std::string kb;
            if (parse_bytes(PySequence_Fast_GET_ITEM(rows, j), kb,
                            "book row key") < 0) {
                Py_DECREF(rows);
                Py_DECREF(seq);
                return NULL;
            }
            bd.rows.push_back(kb);
        }
        Py_DECREF(rows);
    }
    Py_DECREF(seq);

    /* txs */
    seq = PySequence_Fast(txs, "txs must be a sequence");
    if (!seq)
        return NULL;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        Tx tx;
        long op = PyLong_AsLong(PyTuple_GetItem(it, 0));
        tx.op = (int)op;
        if (parse_bytes(PyTuple_GetItem(it, 1), tx.hash, "tx hash") < 0 ||
            parse_bytes(PyTuple_GetItem(it, 2), tx.src, "tx source") < 0) {
            Py_DECREF(seq);
            return NULL;
        }
        tx.seq = PyLong_AsLongLong(PyTuple_GetItem(it, 3));
        tx.fee = PyLong_AsLongLong(PyTuple_GetItem(it, 4));
        tx.fee_charged = PyLong_AsLongLong(PyTuple_GetItem(it, 5));
        if (op == OP_PAYMENT) {
            if (parse_bytes(PyTuple_GetItem(it, 6), tx.dest,
                            "payment dest") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            tx.amount = PyLong_AsLongLong(PyTuple_GetItem(it, 7));
            if (parse_bytes(PyTuple_GetItem(it, 8), tx.asset,
                            "payment asset") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
        } else if (op == OP_MANAGE_SELL_OFFER) {
            if (parse_bytes(PyTuple_GetItem(it, 6), tx.selling,
                            "offer selling") < 0 ||
                parse_bytes(PyTuple_GetItem(it, 7), tx.buying,
                            "offer buying") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            tx.amount = PyLong_AsLongLong(PyTuple_GetItem(it, 8));
            tx.price_n = (int32_t)PyLong_AsLong(PyTuple_GetItem(it, 9));
            tx.price_d = (int32_t)PyLong_AsLong(PyTuple_GetItem(it, 10));
            tx.offer_id = PyLong_AsLongLong(PyTuple_GetItem(it, 11));
        } else if (op == OP_CHANGE_TRUST) {
            if (parse_bytes(PyTuple_GetItem(it, 6), tx.asset,
                            "trust line asset") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            tx.limit = PyLong_AsLongLong(PyTuple_GetItem(it, 7));
        } else if (op == OP_PATH_PAYMENT_STRICT_SEND ||
                   op == OP_PATH_PAYMENT_STRICT_RECEIVE) {
            if (parse_bytes(PyTuple_GetItem(it, 6), tx.dest,
                            "path dest") < 0 ||
                parse_bytes(PyTuple_GetItem(it, 7), tx.asset,
                            "path send asset") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            tx.amount = PyLong_AsLongLong(PyTuple_GetItem(it, 8));
            if (parse_bytes(PyTuple_GetItem(it, 9), tx.dest_asset,
                            "path dest asset") < 0) {
                Py_DECREF(seq);
                return NULL;
            }
            tx.amount2 = PyLong_AsLongLong(PyTuple_GetItem(it, 10));
            PyObject *hops = PySequence_Fast(
                PyTuple_GetItem(it, 11), "path hops must be a sequence");
            if (!hops) {
                Py_DECREF(seq);
                return NULL;
            }
            for (Py_ssize_t j = 0; j < PySequence_Fast_GET_SIZE(hops);
                 j++) {
                PyObject *ht = PySequence_Fast_GET_ITEM(hops, j);
                Hop hop;
                if (parse_bytes(PyTuple_GetItem(ht, 0), hop.selling,
                                "hop selling") < 0 ||
                    parse_bytes(PyTuple_GetItem(ht, 1), hop.buying,
                                "hop buying") < 0 ||
                    parse_bytes(PyTuple_GetItem(ht, 2), hop.pool_key,
                                "hop pool key") < 0) {
                    Py_DECREF(hops);
                    Py_DECREF(seq);
                    return NULL;
                }
                tx.hops.push_back(hop);
            }
            Py_DECREF(hops);
        } else {
            Py_DECREF(seq);
            PyErr_SetString(KernelError, "unsupported op type in tx strip");
            return NULL;
        }
        if (PyErr_Occurred()) {
            Py_DECREF(seq);
            return NULL;
        }
        c.txs.push_back(tx);
    }
    Py_DECREF(seq);

    /* GIL-free strip apply: parse entries, run every tx, build deltas.
     * All state is kernel-local, so a Decline discards everything. */
    bool declined = false;
    std::string decline_reason;
    long decline_tx = -1;
    std::vector<std::pair<std::string, bool>> delta_keys;
    std::vector<std::string> delta_bytes;

    Py_BEGIN_ALLOW_THREADS;
    try {
        for (auto &kv : c.store)
            if (kv.second.exists)
                parse_entry(kv.second);
        for (size_t i = 0; i < c.txs.size(); i++) {
            try {
                run_tx(c, i);
            } catch (Decline &d) {
                decline_tx = (long)i;
                throw;
            }
        }
        for (auto &kv : c.store) {
            Entry &e = kv.second;
            if (!e.dirty)
                continue;
            delta_keys.push_back({kv.first, e.exists});
            delta_bytes.push_back(e.exists ? encode_entry(e)
                                           : std::string());
        }
    } catch (Decline &d) {
        declined = true;
        decline_reason = d.reason;
    }
    Py_END_ALLOW_THREADS;

    if (declined) {
        return Py_BuildValue("(Osl)", Py_False, decline_reason.c_str(),
                             decline_tx);
    }

    PyObject *deltas = PyList_New((Py_ssize_t)delta_keys.size());
    if (!deltas)
        return NULL;
    for (size_t i = 0; i < delta_keys.size(); i++) {
        PyObject *key = PyBytes_FromStringAndSize(
            delta_keys[i].first.data(),
            (Py_ssize_t)delta_keys[i].first.size());
        PyObject *val;
        if (delta_keys[i].second)
            val = PyBytes_FromStringAndSize(
                delta_bytes[i].data(), (Py_ssize_t)delta_bytes[i].size());
        else
            val = Py_NewRef(Py_None);
        if (!key || !val) {
            Py_XDECREF(key);
            Py_XDECREF(val);
            Py_DECREF(deltas);
            return NULL;
        }
        PyObject *tup = PyTuple_Pack(2, key, val);
        Py_DECREF(key);
        Py_DECREF(val);
        if (!tup) {
            Py_DECREF(deltas);
            return NULL;
        }
        PyList_SET_ITEM(deltas, (Py_ssize_t)i, tup);
    }

    PyObject *records = PyList_New((Py_ssize_t)c.records.size());
    if (!records) {
        Py_DECREF(deltas);
        return NULL;
    }
    for (size_t i = 0; i < c.records.size(); i++) {
        PyObject *tup = Py_BuildValue(
            "(y#y#)", c.records[i].first.data(),
            (Py_ssize_t)c.records[i].first.size(),
            c.records[i].second.data(),
            (Py_ssize_t)c.records[i].second.size());
        if (!tup) {
            Py_DECREF(deltas);
            Py_DECREF(records);
            return NULL;
        }
        PyList_SET_ITEM(records, (Py_ssize_t)i, tup);
    }

    return Py_BuildValue("(ONNL)", Py_True, deltas, records,
                         (long long)c.idpool);
}

/* charge_fees(params, accounts, txs): the whole fee/seqnum phase as
 * one GIL-released batch (frame.process_fee_seq_num's success path).
 *   params   = (ledger_seq, base_fee)
 *   accounts = [entry_bytes, ...] distinct fee sources, first-appearance
 *              order (every one must exist — the host screens absence)
 *   txs      = [(acct_idx, full_fee, num_ops), ...] in apply order
 * -> (True, [(charged, state_bytes, updated_bytes)...],
 *     [final_entry_bytes...], fee_pool_delta)
 *  | (False, reason)
 * The per-tx change pair mirrors LedgerTxn.changes(): STATE carries the
 * RUNNING pre-image (a repeat source sees the prior tx's post-image,
 * lastModified already restamped), UPDATED the post-charge image. */
static PyObject *charge_fees(PyObject *self, PyObject *args) {
    PyObject *params, *accounts, *txs;
    if (!PyArg_ParseTuple(args, "OOO", &params, &accounts, &txs))
        return NULL;
    long long ls, bf;
    if (!PyArg_ParseTuple(params, "LL", &ls, &bf))
        return NULL;

    std::vector<Entry> accts;
    PyObject *seq = PySequence_Fast(accounts, "accounts must be a sequence");
    if (!seq)
        return NULL;
    accts.resize((size_t)PySequence_Fast_GET_SIZE(seq));
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        if (parse_bytes(PySequence_Fast_GET_ITEM(seq, i),
                        accts[(size_t)i].raw, "fee account bytes") < 0) {
            Py_DECREF(seq);
            return NULL;
        }
        accts[(size_t)i].exists = true;
    }
    Py_DECREF(seq);

    struct FeeTx {
        long acct;
        int64_t full_fee;
        long num_ops;
    };
    std::vector<FeeTx> fts;
    seq = PySequence_Fast(txs, "fee txs must be a sequence");
    if (!seq)
        return NULL;
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(seq, i);
        FeeTx ft;
        ft.acct = PyLong_AsLong(PyTuple_GetItem(it, 0));
        ft.full_fee = PyLong_AsLongLong(PyTuple_GetItem(it, 1));
        ft.num_ops = PyLong_AsLong(PyTuple_GetItem(it, 2));
        if (PyErr_Occurred()) {
            Py_DECREF(seq);
            return NULL;
        }
        fts.push_back(ft);
    }
    Py_DECREF(seq);

    bool declined = false;
    std::string decline_reason;
    std::vector<int64_t> charged(fts.size(), 0);
    std::vector<std::string> state_b(fts.size()), upd_b(fts.size());
    std::vector<std::string> final_b(accts.size());
    int64_t fee_pool = 0;

    Py_BEGIN_ALLOW_THREADS;
    try {
        for (auto &e : accts) {
            parse_entry(e);
            need(e.kind == K_ACCT && e.supported,
                 "unsupported account shape");
        }
        for (size_t i = 0; i < fts.size(); i++) {
            FeeTx &ft = fts[i];
            need(ft.acct >= 0 && (size_t)ft.acct < accts.size(),
                 "fee account index out of range");
            Entry &e = accts[(size_t)ft.acct];
            /* fee = min(full_fee, base_fee * max(1, num_ops)); the
             * product is bounded in i128 and min() with an int64 */
            i128 per_ops = (i128)bf * (ft.num_ops > FEE_OPS_FLOOR
                                           ? ft.num_ops
                                           : FEE_OPS_FLOOR);
            i128 fee = (i128)ft.full_fee < per_ops ? (i128)ft.full_fee
                                                   : per_ops;
            int64_t ch = (int64_t)(fee < (i128)e.acct.balance
                                       ? fee
                                       : (i128)e.acct.balance);
            Wr st;
            st.u32(CH_STATE);
            st.raw(encode_entry(e));
            state_b[i] = st.out;
            e.acct.balance -= ch;
            e.lastModified = (uint32_t)ls;
            Wr up;
            up.u32(CH_UPDATED);
            up.raw(encode_entry(e));
            upd_b[i] = up.out;
            charged[i] = ch;
            need(fee_pool <= INT64_MAX_ - ch, "fee pool overflow");
            fee_pool += ch;
        }
        for (size_t i = 0; i < accts.size(); i++)
            final_b[i] = encode_entry(accts[i]);
    } catch (Decline &d) {
        declined = true;
        decline_reason = d.reason;
    }
    Py_END_ALLOW_THREADS;

    if (declined)
        return Py_BuildValue("(Os)", Py_False, decline_reason.c_str());

    PyObject *rows = PyList_New((Py_ssize_t)fts.size());
    if (!rows)
        return NULL;
    for (size_t i = 0; i < fts.size(); i++) {
        PyObject *tup = Py_BuildValue(
            "(Ly#y#)", (long long)charged[i], state_b[i].data(),
            (Py_ssize_t)state_b[i].size(), upd_b[i].data(),
            (Py_ssize_t)upd_b[i].size());
        if (!tup) {
            Py_DECREF(rows);
            return NULL;
        }
        PyList_SET_ITEM(rows, (Py_ssize_t)i, tup);
    }
    PyObject *finals = PyList_New((Py_ssize_t)accts.size());
    if (!finals) {
        Py_DECREF(rows);
        return NULL;
    }
    for (size_t i = 0; i < accts.size(); i++) {
        PyObject *b = PyBytes_FromStringAndSize(
            final_b[i].data(), (Py_ssize_t)final_b[i].size());
        if (!b) {
            Py_DECREF(rows);
            Py_DECREF(finals);
            return NULL;
        }
        PyList_SET_ITEM(finals, (Py_ssize_t)i, b);
    }
    return Py_BuildValue("(ONNL)", Py_True, rows, finals,
                         (long long)fee_pool);
}

static PyMethodDef Methods[] = {
    {"apply_cluster", apply_cluster, METH_VARARGS,
     "Apply one kernel-eligible cluster strip GIL-free; returns "
     "(True, deltas, records, idpool) or (False, reason, tx_index)."},
    {"charge_fees", charge_fees, METH_VARARGS,
     "Charge the whole fee phase GIL-free; returns (True, rows, "
     "finals, fee_pool_delta) or (False, reason)."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_applykernel",
    "GIL-free native transaction-apply kernel", -1, Methods,
};

PyMODINIT_FUNC PyInit__applykernel(void) {
    PyObject *m = PyModule_Create(&moduledef);
    if (!m)
        return NULL;
    KernelError =
        PyErr_NewException("_applykernel.KernelError", NULL, NULL);
    if (!KernelError || PyModule_AddObject(m, "KernelError", KernelError) <
                            0) {
        Py_DECREF(m);
        return NULL;
    }
    return m;
}
