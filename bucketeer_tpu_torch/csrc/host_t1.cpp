// The host Tier-1 coder: EBCOT context modeling (significance
// propagation, magnitude refinement, cleanup with run-length coding) and
// the MQ arithmetic coder, per 64x64 code-block (T.800 Annex C/D).
//
// Three entries share one coder and one thread pool (run_pool), which
// fans a batch's independent blocks out over std::threads:
// - t1_encode_packed codes the device front-end's packed bit-plane
//   rows (codec/frontend.py mode "rows");
// - t1_encode_blocks codes raw magnitude/sign arrays sliced on the host
//   (the straddling tile grids, codec/encoder.py _legacy_tier1);
// - t1_encode_cxd replays the device CX/D symbol streams through the MQ
//   coder alone (the CX/D split, codec/cxd.py run_cxd).
// Output is bit-exact with codec/t1.py encode_block and with the fused
// device Tier-1. The code is the JAX package's host coder, kept here as
// a copy (tests/test_torch_host.py holds the two equal).
//
// Built by g++ -O3 -std=c++17 -fPIC -shared -pthread at first use
// (kernels/build.py) and bound with ctypes (codec/t1_batch.py).
#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---- MQ encoder (T.800 Annex C.2; mirrors codec/mq.py exactly) ----

struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };

static const QeRow QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int N_CTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNIFORM = 18;

struct MQEnc {
    uint32_t a = 0x8000, c = 0;
    int ct = 12;
    std::vector<uint8_t> buf;
    uint8_t idx[N_CTX];
    uint8_t mps[N_CTX];

    MQEnc() {
        buf.reserve(4096);
        buf.push_back(0);  // dummy pre-byte
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[0] = 4;
        idx[CTX_RL] = 3;
        idx[CTX_UNIFORM] = 46;
    }

    void byteout() {
        if (buf.back() == 0xFF) {
            buf.push_back((c >> 20) & 0xFF);
            c &= 0xFFFFF;
            ct = 7;
        } else if (c < 0x8000000u) {
            buf.push_back((c >> 19) & 0xFF);
            c &= 0x7FFFF;
            ct = 8;
        } else {
            buf.back() += 1;
            if (buf.back() == 0xFF) {
                c &= 0x7FFFFFF;
                buf.push_back((c >> 20) & 0xFF);
                c &= 0xFFFFF;
                ct = 7;
            } else {
                buf.push_back((c >> 19) & 0xFF);
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }

    void renorm() {
        do {
            a = (a << 1) & 0xFFFF;
            c = c << 1;
            if (--ct == 0) byteout();
        } while (!(a & 0x8000));
    }

    void encode(int bit, int ctx) {
        const QeRow& row = QE[idx[ctx]];
        uint32_t qe = row.qe;
        if (bit == mps[ctx]) {
            a -= qe;
            if (!(a & 0x8000)) {
                if (a < qe) a = qe; else c += qe;
                idx[ctx] = row.nmps;
                renorm();
            } else {
                c += qe;
            }
        } else {
            a -= qe;
            if (a < qe) c += qe; else a = qe;
            if (row.sw) mps[ctx] ^= 1;
            idx[ctx] = row.nlps;
            renorm();
        }
    }

    int64_t trunc_length() const {
        return (int64_t)buf.size() - 1 + 4;
    }

    void flush() {
        uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c = c << ct;
        byteout();
        c = c << ct;
        byteout();
        if (buf.size() > 1 && buf.back() == 0xFF) buf.pop_back();
        // buf[0] stays the dummy byte; callers read buf[1..).
    }
};

// ---- Context tables (T.800 Tables D.1-D.4; mirror codec/t1.py) ----

struct Tables {
    uint8_t zc_ll_lh[3][3][5];
    uint8_t zc_hh[3][3][5];
    uint8_t sc_ctx[3][3];
    uint8_t sc_xor[3][3];

    Tables() {
        for (int sh = 0; sh < 3; sh++)
            for (int sv = 0; sv < 3; sv++)
                for (int sd = 0; sd < 5; sd++) {
                    int c;
                    if (sh == 2) c = 8;
                    else if (sh == 1) c = sv >= 1 ? 7 : (sd >= 1 ? 6 : 5);
                    else {
                        if (sv == 2) c = 4;
                        else if (sv == 1) c = 3;
                        else c = sd >= 2 ? 2 : (sd == 1 ? 1 : 0);
                    }
                    zc_ll_lh[sh][sv][sd] = (uint8_t)c;
                    int hv = sh + sv;
                    if (sd >= 3) c = 8;
                    else if (sd == 2) c = hv >= 1 ? 7 : 6;
                    else if (sd == 1) c = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
                    else c = hv >= 2 ? 2 : (hv == 1 ? 1 : 0);
                    zc_hh[sh][sv][sd] = (uint8_t)c;
                }
        // Sign coding (Table D.3), indexed [h+1][v+1].
        for (int h = -1; h <= 1; h++)
            for (int v = -1; v <= 1; v++) {
                int ctx, x;
                if (h == 1)      { ctx = v == 1 ? 13 : (v == 0 ? 12 : 11); x = 0; }
                else if (h == 0) { ctx = v == 0 ? 9 : 10; x = v == -1 ? 1 : 0; }
                else             { ctx = v == 1 ? 11 : (v == 0 ? 12 : 13); x = 1; }
                sc_ctx[h + 1][v + 1] = (uint8_t)ctx;
                sc_xor[h + 1][v + 1] = (uint8_t)x;
            }
    }
};

static const Tables T;

// ---- Block coder (T.800 Annex D; mirrors codec/t1.py) ----

struct PassRec {
    int32_t type;      // 0=sigprop 1=magref 2=cleanup
    int32_t plane;
    int64_t cum_len;
    double dist;
};

struct BlockOut {
    std::vector<uint8_t> data;
    int32_t nbps = 0;
    std::vector<PassRec> passes;
};

// Band class: 0 = LL/LH table, 1 = HH table, 2 = HL (LL/LH with H/V swap).
// fracs: optional FRAC_BITS(=7) fractional magnitude bits below the index
// (quantize_fp), null when indices are exact (reversible path).
// floor: lowest bit-plane to code (0 = all). Planes below the floor are
// simply absent from the pass list — a valid truncation the rate
// allocator would have made anyway (the caller guarantees the floor sits
// below the final PCRD cut); the magnitudes' low bits must already be
// zero there (the packed payload never ships them).
static void encode_block(const uint32_t* mags, const uint8_t* negs,
                         const uint8_t* fracs,
                         int h, int w, int bandcls, int floor,
                         BlockOut& out) {
    uint32_t maxv = 0;
    const int n = h * w;
    for (int i = 0; i < n; i++) maxv = mags[i] > maxv ? mags[i] : maxv;
    int nbps = 0;
    while ((1u << nbps) <= maxv && nbps < 32) nbps++;
    out.nbps = nbps;
    if (nbps == 0) return;

    // Padded state arrays (h+2)x(w+2) kill all bounds checks.
    const int pw = w + 2;
    std::vector<uint8_t> sigma((h + 2) * pw, 0);
    std::vector<uint8_t> pi((h + 2) * pw, 0);
    std::vector<uint8_t> refined((h + 2) * pw, 0);
    std::vector<int8_t> chi((h + 2) * pw, 0);   // 0 / +1 / -1 if significant
    auto P = [pw](int y, int x) { return (y + 1) * pw + (x + 1); };

    const bool swap_hv = bandcls == 2;
    const auto& zc = bandcls == 1 ? T.zc_hh : T.zc_ll_lh;

    MQEnc mq;

    auto nbr_sums = [&](int y, int x, int& sh, int& sv, int& sd) {
        const int p = P(y, x);
        sh = sigma[p - 1] + sigma[p + 1];
        sv = sigma[p - pw] + sigma[p + pw];
        sd = sigma[p - pw - 1] + sigma[p - pw + 1] +
             sigma[p + pw - 1] + sigma[p + pw + 1];
    };

    auto code_sign = [&](int y, int x) {
        const int p = P(y, x);
        int hc = chi[p - 1] + chi[p + 1];
        int vc = chi[p - pw] + chi[p + pw];
        hc = hc > 1 ? 1 : (hc < -1 ? -1 : hc);
        vc = vc > 1 ? 1 : (vc < -1 ? -1 : vc);
        int neg = negs[y * w + x] ? 1 : 0;
        mq.encode(neg ^ T.sc_xor[hc + 1][vc + 1], T.sc_ctx[hc + 1][vc + 1]);
    };

    auto set_sig = [&](int y, int x) {
        const int p = P(y, x);
        sigma[p] = 1;
        chi[p] = negs[y * w + x] ? -1 : 1;
    };

    // True magnitude in index units: coded index + retained fractional
    // bits (quantize_fp; exact when fracs is null — reversible path).
    // Accurate tv matters: PCRD ranks passes by slope, and a fixed +0.5
    // midpoint mis-ranks blocks whose slopes cluster (chroma noise),
    // splitting rate badly across components. Mirrors codec/t1.py.
    // Must match codec/quant.py FRAC_BITS (= 7): fracs carry
    // 2^FRAC_BITS sub-index steps. Checked against the Python coder by
    // tests/test_torch_rows.py.
    constexpr double FRAC_SCALE = 128.0;
    auto true_val = [&](int y, int x) -> double {
        int64_t v = mags[y * w + x];
        return (double)v + (fracs ? fracs[y * w + x] / FRAC_SCALE : 0.0);
    };

    auto sig_dist = [&](int y, int x, int p) -> double {
        int64_t v = mags[y * w + x];
        int64_t vb = (v >> p) << p;
        double tv = true_val(y, x);
        double r = (double)vb + (double)(1ll << p) * 0.5;
        double d = tv - r;
        return tv * tv - d * d;
    };

    auto ref_dist = [&](int y, int x, int p) -> double {
        int64_t v = mags[y * w + x];
        int64_t v1 = (v >> (p + 1)) << (p + 1);
        double r1 = (double)v1 + (double)(1ll << (p + 1)) * 0.5;
        int64_t v0 = (v >> p) << p;
        double r0 = (double)v0 + (double)(1ll << p) * 0.5;
        double tv = true_val(y, x);
        double d1 = tv - r1, d0 = tv - r0;
        return d1 * d1 - d0 * d0;
    };

    auto zc_ctx = [&](int y, int x) -> int {
        int sh, sv, sd;
        nbr_sums(y, x, sh, sv, sd);
        if (swap_hv) { int t = sh; sh = sv; sv = t; }
        return zc[sh][sv][sd];
    };

    double dist;
    for (int p = nbps - 1; p >= floor; p--) {
        const uint32_t bit = 1u << p;
        const bool first_plane = p == nbps - 1;

        if (!first_plane) {
            // Pass 1: significance propagation.
            dist = 0.0;
            for (int y0 = 0; y0 < h; y0 += 4) {
                const int ymax = y0 + 4 < h ? y0 + 4 : h;
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ymax; y++) {
                        if (sigma[P(y, x)]) continue;
                        int sh, sv, sd;
                        nbr_sums(y, x, sh, sv, sd);
                        if (sh + sv + sd == 0) continue;
                        if (swap_hv) { int t = sh; sh = sv; sv = t; }
                        int b = (mags[y * w + x] & bit) ? 1 : 0;
                        mq.encode(b, zc[sh][sv][sd]);
                        pi[P(y, x)] = 1;
                        if (b) {
                            set_sig(y, x);
                            dist += sig_dist(y, x, p);
                            code_sign(y, x);
                        }
                    }
            }
            out.passes.push_back({0, p, mq.trunc_length(), dist});

            // Pass 2: magnitude refinement.
            dist = 0.0;
            for (int y0 = 0; y0 < h; y0 += 4) {
                const int ymax = y0 + 4 < h ? y0 + 4 : h;
                for (int x = 0; x < w; x++)
                    for (int y = y0; y < ymax; y++) {
                        const int pp = P(y, x);
                        if (!sigma[pp] || pi[pp]) continue;
                        int ctx;
                        if (refined[pp]) ctx = 16;
                        else {
                            int sh, sv, sd;
                            nbr_sums(y, x, sh, sv, sd);
                            ctx = (sh + sv + sd) ? 15 : 14;
                        }
                        mq.encode((mags[y * w + x] & bit) ? 1 : 0, ctx);
                        dist += ref_dist(y, x, p);
                        refined[pp] = 1;
                    }
            }
            out.passes.push_back({1, p, mq.trunc_length(), dist});
        }

        // Pass 3: cleanup.
        dist = 0.0;
        for (int y0 = 0; y0 < h; y0 += 4) {
            const int ymax = y0 + 4 < h ? y0 + 4 : h;
            for (int x = 0; x < w; x++) {
                int y = y0;
                if (y0 + 3 < h) {
                    bool rl = true;
                    for (int yy = y0; yy < y0 + 4 && rl; yy++) {
                        const int pp = P(yy, x);
                        if (sigma[pp] || pi[pp]) { rl = false; break; }
                        int sh, sv, sd;
                        nbr_sums(yy, x, sh, sv, sd);
                        if (sh + sv + sd != 0) rl = false;
                    }
                    if (rl) {
                        int k = -1;
                        for (int yy = 0; yy < 4; yy++)
                            if (mags[(y0 + yy) * w + x] & bit) { k = yy; break; }
                        if (k < 0) {
                            mq.encode(0, CTX_RL);
                            continue;
                        }
                        mq.encode(1, CTX_RL);
                        mq.encode((k >> 1) & 1, CTX_UNIFORM);
                        mq.encode(k & 1, CTX_UNIFORM);
                        const int yk = y0 + k;
                        set_sig(yk, x);
                        dist += sig_dist(yk, x, p);
                        code_sign(yk, x);
                        y = yk + 1;
                    }
                }
                for (int yy = y; yy < ymax; yy++) {
                    const int pp = P(yy, x);
                    if (sigma[pp] || pi[pp]) continue;
                    int b = (mags[yy * w + x] & bit) ? 1 : 0;
                    mq.encode(b, zc_ctx(yy, x));
                    if (b) {
                        set_sig(yy, x);
                        dist += sig_dist(yy, x, p);
                        code_sign(yy, x);
                    }
                }
            }
        }
        out.passes.push_back({2, p, mq.trunc_length(), dist});
        std::fill(pi.begin(), pi.end(), 0);
    }

    mq.flush();
    out.data.assign(mq.buf.begin() + 1, mq.buf.end());
    const int64_t total = (int64_t)out.data.size();
    for (auto& pr : out.passes)
        if (pr.cum_len > total) pr.cum_len = total;
}

struct T1Result {
    std::vector<BlockOut> blocks;
};

template <typename F>
void run_pool(int n_blocks, int n_threads, F&& body) {
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n_blocks) break;
            body(i);
        }
    };
    if (n_threads <= 1 || n_blocks <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        int nt = n_threads < n_blocks ? n_threads : n_blocks;
        for (int t = 0; t < nt; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
}

}  // namespace

extern "C" {

// Bumped whenever any exported signature changes. The library's file
// name follows the hash of this source (kernels/build.py), so a stale
// build is never loaded; the version stays for tools that read it.
int32_t t1_abi_version() { return 4; }

T1Result* t1_encode_blocks(int n_blocks,
                           const uint32_t* mags, const uint8_t* negs,
                           const uint8_t* fracs,
                           const int64_t* offsets,
                           const int32_t* hs, const int32_t* ws,
                           const int32_t* bandcls, int n_threads) {
    auto* res = new T1Result();
    res->blocks.resize(n_blocks);
    run_pool(n_blocks, n_threads, [&](int i) {
        encode_block(mags + offsets[i], negs + offsets[i],
                     fracs ? fracs + offsets[i] : nullptr,
                     hs[i], ws[i], bandcls[i], 0, res->blocks[i]);
    });
    return res;
}

// Packed-bitmap entry (the device front-end path, codec/frontend.py).
// payload: concatenated 512-byte rows; block i's rows start at byte
// offsets[i]*512: [sign bitmap][plane nbps[i]-1]...[plane floors[i]].
// Bitmaps are 64x64 LSB-first: sample (y,x) -> byte y*8 + x/8, bit x%8;
// a partial (h,w) block occupies the top-left corner. Blocks with
// nbps <= floors ship no rows and code as empty.
T1Result* t1_encode_packed(int n_blocks, const uint8_t* payload,
                           const int64_t* offsets,
                           const int32_t* nbps, const int32_t* floors,
                           const int32_t* hs, const int32_t* ws,
                           const int32_t* bandcls, int n_threads) {
    auto* res = new T1Result();
    res->blocks.resize(n_blocks);
    run_pool(n_blocks, n_threads, [&](int i) {
        const int nbp = nbps[i], floor = floors[i];
        if (nbp <= floor) return;             // dead block: zero passes
        const int h = hs[i], w = ws[i];
        const uint8_t* rows = payload + offsets[i] * 512;
        uint32_t mags[64 * 64];
        uint8_t negs[64 * 64];
        std::memset(mags, 0, sizeof(uint32_t) * h * w);
        for (int y = 0; y < h; y++)
            for (int x = 0; x < w; x++)
                negs[y * w + x] = (rows[y * 8 + (x >> 3)] >> (x & 7)) & 1;
        for (int j = 0, p = nbp - 1; p >= floor; j++, p--) {
            const uint8_t* bm = rows + (1 + j) * 512;
            for (int y = 0; y < h; y++)
                for (int x = 0; x < w; x++)
                    mags[y * w + x] |=
                        (uint32_t)((bm[y * 8 + (x >> 3)] >> (x & 7)) & 1)
                        << p;
        }
        encode_block(mags, negs, nullptr, h, w, bandcls[i], floor,
                     res->blocks[i]);
    });
    return res;
}

// CX/D replay entry (the device context-modeling path, codec/cxd.py):
// the device already ran significance propagation / magnitude
// refinement / cleanup and shipped the ordered (context, decision)
// symbol stream; the host just replays it through the MQ coder — no
// neighborhood state, no bit-plane walks. payload: 384-byte rows of
// 6-bit symbols, four per little-endian 24-bit group, symbol = ctx
// (low 5 bits) | decision << 5; block i's rows start at
// row_offsets[i]*384. Pass metadata is flat across blocks: block i owns
// passes [pass_offsets[i], pass_offsets[i+1]) with per-pass symbol
// counts, types/planes for the PassInfo table, and the device-computed
// exact distortion reductions passed straight through. nbps[i] is the
// block's coded bit-plane count (the stream itself no longer reveals
// it). Blocks with zero passes code as empty (nbps forced 0, like a
// dead packed block).
T1Result* t1_encode_cxd(int n_blocks, const uint8_t* payload,
                        const int64_t* row_offsets,
                        const int32_t* nbps,
                        const int64_t* pass_offsets,
                        const int32_t* pass_types,
                        const int32_t* pass_planes,
                        const int32_t* pass_nsyms,
                        const double* pass_dists, int n_threads) {
    auto* res = new T1Result();
    res->blocks.resize(n_blocks);
    run_pool(n_blocks, n_threads, [&](int i) {
        BlockOut& out = res->blocks[i];
        const int64_t p0 = pass_offsets[i], p1 = pass_offsets[i + 1];
        if (p1 <= p0) return;               // dead block: zero passes
        const uint8_t* rows = payload + row_offsets[i] * 384;
        MQEnc mq;
        int64_t sym = 0;
        uint32_t word = 0;
        for (int64_t j = p0; j < p1; j++) {
            for (int32_t s = 0; s < pass_nsyms[j]; s++, sym++) {
                const int r = (int)(sym & 3);
                if (r == 0) {       // one load per 4-symbol group
                    const uint8_t* g = rows + (sym >> 2) * 3;
                    word = (uint32_t)g[0] | ((uint32_t)g[1] << 8) |
                           ((uint32_t)g[2] << 16);
                }
                const uint32_t cxd = (word >> (6 * r)) & 63u;
                mq.encode((int)(cxd >> 5), (int)(cxd & 31u));
            }
            out.passes.push_back({pass_types[j], pass_planes[j],
                                  mq.trunc_length(), pass_dists[j]});
        }
        mq.flush();
        out.nbps = nbps[i];
        out.data.assign(mq.buf.begin() + 1, mq.buf.end());
        const int64_t total = (int64_t)out.data.size();
        for (auto& pr : out.passes)
            if (pr.cum_len > total) pr.cum_len = total;
    });
    return res;
}

void t1_block_sizes(T1Result* r, int32_t* nbps, int32_t* npasses,
                    int64_t* nbytes) {
    for (size_t i = 0; i < r->blocks.size(); i++) {
        nbps[i] = r->blocks[i].nbps;
        npasses[i] = (int32_t)r->blocks[i].passes.size();
        nbytes[i] = (int64_t)r->blocks[i].data.size();
    }
}

void t1_block_get(T1Result* r, int i, uint8_t* data, int32_t* ptype,
                  int32_t* pplane, int64_t* plen, double* pdist) {
    const BlockOut& b = r->blocks[i];
    if (!b.data.empty()) std::memcpy(data, b.data.data(), b.data.size());
    for (size_t k = 0; k < b.passes.size(); k++) {
        ptype[k] = b.passes[k].type;
        pplane[k] = b.passes[k].plane;
        plen[k] = b.passes[k].cum_len;
        pdist[k] = b.passes[k].dist;
    }
}

void t1_result_free(T1Result* r) { delete r; }

}  // extern "C"
