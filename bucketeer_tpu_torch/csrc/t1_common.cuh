// EBCOT Tier-1 device functions shared by the Hopper (sm_90a) kernels
// fused_t1.cu, cxd_scan.cu and mq_scan.cu: the MQ arithmetic coder
// (T.800 Annex C), the warp-per-code-block CX/D scan (Annex D) and the
// exact distortion terms.
//
// The scan replaces the per-block body of the TPU kernels fused_pallas
// (bucketeer_tpu/codec/pallas/fused_t1.py:72) and cxd_pallas
// (bucketeer_tpu/codec/pallas/cxd_scan.py:121), cxd._cxd_single.
//
// What binds it: one code-block's coding is a serial chain (each
// decision's context depends on the significance set by the decisions
// before it, each MQ step on the coder registers of the step before).
// At the main path's L=8 group the longest block's chain alone is
// ~110 (cxd_scan) to ~320 (fused_t1) times the launch's bytes bound
// (PERF.md). The design keeps everything off that chain that does
// not have to be on it:
//
// - One warp per code-block scans it (fused_t1 adds a second warp for
//   the MQ coder). Shared memory per block at L=8: scan_words(8) words
//   (7.1 KB) plus the kernel's own ring and results, 8.6-9.9 KB, so 18
//   (fused_t1) to 22 (cxd_scan) thread blocks are resident per SM and a
//   launch group of 1,752 blocks runs in one wave on all 132 SMs.
// - load_block: the warp reads the block's 64x64 int32 slot once, lanes
//   on neighbouring columns (coalesced), and builds in shared memory the
//   sign word of each column and, per plane offset, the magnitude bit
//   word M[off][x] (bit y = bit p of sample (y, x)'s floored magnitude,
//   0 outside the extent). All of the block's planes stay resident:
//   512 B per plane.
// - run_pass: per sigprop or cleanup stripe the helper lanes pack, for
//   every column, a 64-bit descriptor (6-row significance and sign
//   windows of the column and both neighbours, the stripe's plane and
//   coded nibbles, the extent) and a ballot mask of the columns that can
//   code anything; lane 0 alone then walks only those columns and codes
//   them from registers and shared memory, with no global load: the
//   run-length lookahead is the plane nibble and a find-first-set, zero
//   coding one table lookup on an 8-bit neighbour pattern. The helpers
//   then merge the new significance into the column words. Magnitude
//   refinement changes no significance, so all lanes form its symbols
//   at once and a warp scan puts them in coding order.
// - pass_distortion: the samples made significant (sigprop, cleanup) or
//   refined (magref) are left as bit sets; after the pass all lanes sum
//   d4_sig / d4_ref over them in integers from the coefficients (global,
//   off the chain) and reduce across the warp. The sum is exact (two
//   int64 parts, as it can pass 2^63), so its order does not change
//   dist_pair's bits.
// - The MQ coder keeps Qe, both successor indices and the switch flag
//   packed in one context-state word, so a decision costs one dependent
//   shared load, and renormalizes by a leading-zero count instead of a
//   bit at a time.
// - A sink takes the symbols: RingSink here (cxd_scan), FeedSink in
//   fused_t1.cu.
//
// Integer arithmetic that the reference does with int32 wraparound runs
// in uint32 here (signed overflow would be undefined), and shifts that
// may reach 32 or 64 are guarded.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace t1 {

constexpr int CBLK = 64;
constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int NCTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;
constexpr int NQE = 47;
constexpr int SIG_COLS = CBLK + 2;   // one zero column each side

// --- the MQ coder -----------------------------------------------------

// A Qe table entry packed in one word: Qe in bits 0-15, the NMPS index in
// 16-21, the NLPS index in 22-27, SWITCH in bit 28. A context state is
// the packed entry of its current index with its MPS in bit 31.
__device__ __forceinline__ uint32_t qe_pack(const int32_t* row) {
    return static_cast<uint32_t>(row[0]) | (static_cast<uint32_t>(row[1]) << 16)
        | (static_cast<uint32_t>(row[2]) << 22)
        | (static_cast<uint32_t>(row[3]) << 28);
}

// Pack the 47 x 4 Qe table into shared memory (threads t, t + step, ...
// of the thread block; the caller synchronizes).
__device__ __forceinline__ void load_qe(uint32_t* qe, const int32_t* qe_g,
                                        int t, int step) {
    for (int i = t; i < NQE; i += step) qe[i] = qe_pack(qe_g + i * 4);
}

struct Coder {
    uint32_t a, c;
    int ct;
    int cur;          // bytes so far including the dummy pre-byte
    uint32_t last;    // the byte at cur - 1
    int nsym;         // decisions coded
    uint8_t* out;
    int cap;
    uint32_t* ctx;    // context states, context i at ctx[i * cstride]
    int cstride;
};

__device__ __forceinline__ void put(Coder& m, int pos, uint32_t byte) {
    if (pos < m.cap) m.out[pos] = static_cast<uint8_t>(byte);
}

__device__ __forceinline__ void emit(Coder& m, uint32_t byte) {
    put(m, m.cur, byte);
    m.cur += 1;
    m.last = byte;
}

// Coder registers and context states at the start of a block's stream:
// A = 0x8000, CT = 12, the dummy pre-byte 0 at position 0 (T.800 C.2.8
// with the software convention), contexts per Table D.7.
__device__ __forceinline__ void coder_init(Coder& m, uint8_t* out, int cap,
                                           uint32_t* ctx, int cstride,
                                           const uint32_t* qe) {
    m.a = 0x8000u;
    m.c = 0;
    m.ct = 12;
    m.cur = 1;
    m.last = 0;
    m.nsym = 0;
    m.out = out;
    m.cap = cap;
    m.ctx = ctx;
    m.cstride = cstride;
    for (int i = 0; i < NCTX; ++i) ctx[i * cstride] = qe[0];
    ctx[0] = qe[4];                  // the all-zero-neighbourhood ZC ctx
    ctx[CTX_RL * cstride] = qe[3];
    ctx[CTX_UNI * cstride] = qe[46];
    put(m, 0, 0);
}

// T.800 C.2.5 BYTEOUT with bit stuffing and the carry into the last
// byte.
__device__ __forceinline__ void byteout(Coder& m) {
    if (m.last == 0xFFu) {
        emit(m, (m.c >> 20) & 0xFFu);
        m.c &= 0xFFFFFu;
        m.ct = 7;
    } else if (m.c < 0x8000000u) {
        emit(m, (m.c >> 19) & 0xFFu);
        m.c &= 0x7FFFFu;
        m.ct = 8;
    } else {
        m.last += 1;
        put(m, m.cur - 1, m.last);
        if (m.last == 0xFFu) {
            m.c &= 0x7FFFFFFu;
            emit(m, (m.c >> 20) & 0xFFu);
            m.c &= 0xFFFFFu;
            m.ct = 7;
        } else {
            emit(m, (m.c >> 19) & 0xFFu);
            m.c &= 0x7FFFFu;
            m.ct = 8;
        }
    }
}

// T.800 C.2.6 RENORME: shift A and C left until A >= 0x8000, with a
// BYTEOUT whenever CT runs out. A is in [1, 0x7FFF] here, so the shift
// count is its leading-zero count within 16 bits; the shifts are taken
// in runs that end where CT does, which is what the bit-at-a-time loop
// computes.
__device__ __forceinline__ void renorm(Coder& m) {
    int n = __clz(m.a) - 16;
    while (n >= m.ct) {
        m.a <<= m.ct;
        m.c <<= m.ct;
        n -= m.ct;
        byteout(m);
    }
    m.a <<= n;
    m.c <<= n;
    m.ct -= n;
}

// T.800 C.2.2-C.2.3 ENCODE of one decision. An MPS that leaves A >=
// 0x8000 changes no context state.
__device__ __forceinline__ void encode(Coder& m, const uint32_t* qe, int cx,
                                       int bit) {
    uint32_t* sp = m.ctx + cx * m.cstride;
    const uint32_t st = *sp;
    const uint32_t q = st & 0xFFFFu;
    const uint32_t mps = st >> 31;
    m.nsym += 1;
    m.a -= q;
    if (static_cast<uint32_t>(bit) == mps) {
        if (m.a & 0x8000u) {
            m.c += q;
            return;
        }
        if (m.a < q) m.a = q; else m.c += q;
        *sp = qe[(st >> 16) & 63u] | (mps << 31);
    } else {
        if (m.a < q) m.c += q; else m.a = q;
        *sp = qe[(st >> 22) & 63u] | ((mps ^ ((st >> 28) & 1u)) << 31);
    }
    renorm(m);
}

// T.800 C.2.9 FLUSH; returns the data length after the software
// convention's trailing-0xFF drop.
__device__ int flush(Coder& m) {
    uint32_t tempc = m.c + m.a;
    m.c |= 0xFFFFu;
    if (m.c >= tempc) m.c -= 0x8000u;
    m.c <<= m.ct;
    byteout(m);
    m.c <<= m.ct;
    byteout(m);
    return (m.cur - 1) - (m.last == 0xFFu ? 1 : 0);
}

// --- the scan's tables ----------------------------------------------

// The zero-coding context of a sample by band class and 8-bit neighbour
// pattern: bits 0-2 the left column at rows y-1, y, y+1, bits 3-5 the
// right column at the same rows, bit 6 the row above and bit 7 the row
// below. zlut[cls * 256 + pattern]. And the sign-coding table, ctx |
// xor << 5, by (h + 2) * 5 + (v + 2) with the neighbour sums clipped
// to [-1, 1]. Lanes t, t + 32, ... of the warp fill them.
__device__ __forceinline__ void load_scan_tables(uint8_t* zlut, uint8_t* scx,
                                                 const int32_t* zc_g,
                                                 const int32_t* sc_ctx,
                                                 const int32_t* sc_xor,
                                                 int t) {
    for (int i = t; i < 3 * 256; i += WARP) {
        const int pat = i & 255;
        const int h = ((pat >> 1) & 1) + ((pat >> 4) & 1);
        const int v = ((pat >> 6) & 1) + ((pat >> 7) & 1);
        const int d = (pat & 1) + ((pat >> 2) & 1) + ((pat >> 3) & 1)
            + ((pat >> 5) & 1);
        zlut[i] = static_cast<uint8_t>(zc_g[(i >> 8) * 45 + h * 15 + v * 5 + d]);
    }
    for (int i = t; i < 25; i += WARP) {
        int h = min(max(i / 5 - 2, -1), 1) + 1;
        int v = min(max(i % 5 - 2, -1), 1) + 1;
        scx[i] = static_cast<uint8_t>(sc_ctx[h * 3 + v] | (sc_xor[h * 3 + v] << 5));
    }
}

// --- exact distortion -------------------------------------------------

// Floored quantizer-index magnitude of a coefficient.
__device__ __forceinline__ int32_t floored_mag(int32_t c, int frac,
                                               int floor) {
    int32_t a = static_cast<int32_t>(c < 0 ? 0u - static_cast<uint32_t>(c)
                                           : static_cast<uint32_t>(c));
    int32_t idx = a >> frac;
    return static_cast<int32_t>(static_cast<uint32_t>(idx >> floor) << floor);
}

// 4 x significance distortion: A * (4v - A), A = 2*(vb + 2^(p-1)),
// factors rounded to float32 as the reference does.
__device__ __forceinline__ long long d4_sig(int32_t v, int p) {
    uint32_t a = (static_cast<uint32_t>(v >> p) << (p + 1)) + (1u << p);
    uint32_t b = 4u * static_cast<uint32_t>(v) - a;
    long long fa = static_cast<long long>(__int2float_rn(static_cast<int32_t>(a)));
    long long fb = static_cast<long long>(__int2float_rn(static_cast<int32_t>(b)));
    return fa * fb;
}

// 4 x refinement distortion: (C - B) * (4v - B - C), B = 2*r1, C = 2*r0.
__device__ __forceinline__ long long d4_ref(int32_t v, int p) {
    uint32_t hi = (p + 2 >= 32) ? 0u
        : (static_cast<uint32_t>(v >> (p + 1)) << (p + 2));
    uint32_t b = hi + (1u << (p + 1));
    uint32_t c = (static_cast<uint32_t>(v >> p) << (p + 1)) + (1u << p);
    uint32_t u = 4u * static_cast<uint32_t>(v);
    long long fa = static_cast<long long>(__int2float_rn(static_cast<int32_t>(c - b)));
    long long fb = static_cast<long long>(__int2float_rn(static_cast<int32_t>(u - b - c)));
    return fa * fb;
}

// A pass's exact 4 x distortion S = s_hi * 2^32 + s_lo (the sums of
// each term's t >> 32 and t & 0xFFFFFFFF: a pass's terms near 2^62 can
// carry S past int64) as the canonical float32 pair (fl(S),
// fl(S - fl(S))), rounded to nearest even. Below 2^62 in magnitude S is
// one int64; above, |S| is shifted right to 62 bits with a sticky bit so
// that one rounding gives fl(|S|), and the residual comes from the exact
// parts. kernels/cxd_scan.py _dd_pair computes the same.
__device__ __forceinline__ void dist_pair(long long s_hi, long long s_lo,
                                          float* hi, float* lo) {
    const long long two32 = 1ll << 32;
    const long long a = s_hi + (s_lo >> 32);
    const long long b = s_lo & 0xFFFFFFFFll;
    const bool neg = a < 0;
    const long long ma = neg ? -a - (b != 0) : a;
    const long long mb = (neg && b != 0) ? two32 - b : b;
    if (ma < (1ll << 30)) {
        const long long s = a * two32 + b;
        const float h = __ll2float_rn(s);
        *hi = h;
        *lo = __ll2float_rn(s - static_cast<long long>(h));
        return;
    }
    const int k = 64 - __clzll(ma) - 30;
    const long long kept = (ma << (32 - k)) | (mb >> k)
        | static_cast<long long>((mb & ((1ll << k) - 1)) != 0);
    const float hm = __ll2float_rn(kept);
    const long long hr = static_cast<long long>(hm);
    const long long r = (ma - (hr >> (32 - k))) * two32 + mb
        - ((hr & ((1ll << (32 - k)) - 1)) << k);
    *hi = (neg ? -hm : hm) * __int_as_float((127 + k) << 23);
    *lo = __ll2float_rn(neg ? -r : r);
}

// The per-pass results of one block in shared memory (counts or byte
// snapshots, distortion pairs), written to global memory once at the
// block's end, coalesced.
struct Results {
    int32_t* snap;
    float* dh;
    float* dl;
};

__host__ __device__ constexpr int results_bytes(int L) {
    return L * 3 * 12;
}

__device__ __forceinline__ Results results_layout(void* at, int L) {
    Results R;
    R.snap = static_cast<int32_t*>(at);
    R.dh = reinterpret_cast<float*>(R.snap + L * 3);
    R.dl = R.dh + L * 3;
    return R;
}

// --- symbol sinks -----------------------------------------------------

// Symbols a pass's helper lanes formed in parallel (magnitude
// refinement): each lane holds up to four symbols, low byte first, for
// each of its two columns, with their count and offset in coding order.
struct LaneSyms {
    uint32_t syms[2];
    int cnt[2];
    int off[2];
};

// Appends ctx | d << 5 to a ring in shared memory (cxd_scan). At every
// stripe end the warp stores the ring's full 128-byte segments to the
// block's symbol row, one 4-byte word per lane; at the block's end the
// last, partial segment up to the last partial word (its bytes past the
// cursor 0). As before, symbols past the row's capacity are counted but
// not stored: a word is stored only if it lies wholly below the
// capacity (the caller checks the cursor against the capacity).
constexpr int RING = 1024;    // > 127 unflushed + 640, a stripe's most

struct RingSink {
    uint8_t* ring;    // RING bytes of shared memory
    uint8_t* row;     // the block's symbol row in global memory
    int cap;
    int cur;          // symbols so far (lane 0's; every lane's after a flush)
    int flushed;      // symbols stored to the row, the same in every lane
    __device__ __forceinline__ void code(int cx, int bit) {
        ring[cur & (RING - 1)] = static_cast<uint8_t>(cx | (bit << 5));
        cur += 1;
    }
    // A pass ended; its symbol count.
    __device__ __forceinline__ void end_pass(const Results& R, int at,
                                             int lane) {
        if (lane == 0) R.snap[at] = cur;
    }
    // All lanes (their cursors agree): each lane stores its symbols at
    // their places in the ring.
    __device__ __forceinline__ void append_warp(const LaneSyms& ls, int total,
                                                int) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
            for (int q = 0; q < ls.cnt[j]; ++q)
                ring[(cur + ls.off[j] + q) & (RING - 1)] =
                    static_cast<uint8_t>(ls.syms[j] >> (8 * q));
        cur += total;
    }
    // All lanes, converged: store [flushed, end) to the row.
    __device__ __forceinline__ void warp_flush(int lane, bool last) {
        cur = __shfl_sync(FULL, cur, 0);
        const int end = last ? ((cur + 3) & ~3) : (cur & ~127);
        for (int q = flushed + 4 * lane; q < end; q += 4 * WARP) {
            if (q + 4 > cap) break;
            uint32_t word = *reinterpret_cast<const uint32_t*>(
                ring + (q & (RING - 1)));
            if (q + 4 > cur) word &= (1u << (8 * (cur - q))) - 1u;
            *reinterpret_cast<uint32_t*>(row + q) = word;
        }
        flushed = end;
    }
};

// --- the CX/D scan ----------------------------------------------------

// One code-block's scan state in shared memory, 64-bit words, bit y of a
// column word is row y.
struct Scan {
    uint64_t* sig;     // significance, column x at sig[x + 1]
    uint64_t* neg;     // sign (1 = negative) in the extent, same layout
    uint64_t* pi;      // coded in this plane's sigprop pass, column x at pi[x]
    uint64_t* ref;     // refined before
    uint64_t* sets;    // made significant / refined in the current pass
    uint64_t* desc;    // the current stripe's column descriptors
    uint64_t* planes;  // magnitude bits, plane offset off at planes[off * CBLK]
    uint8_t* outb;     // per stripe column: new significance | coded << 4
    const uint8_t* zlut;   // this block's band class's zero-coding table
    const uint8_t* scx;
    int h, w;
};

// 64-bit words of one block's scan state at plane budget L.
__host__ __device__ constexpr int scan_words(int L) {
    return 2 * SIG_COLS + 4 * CBLK + L * CBLK + CBLK / 8;
}

__device__ __forceinline__ Scan scan_layout(uint64_t* smem, int L, int h,
                                            int w, int cls,
                                            const uint8_t* zlut,
                                            const uint8_t* scx) {
    Scan S;
    S.sig = smem;
    S.neg = S.sig + SIG_COLS;
    S.pi = S.neg + SIG_COLS;
    S.ref = S.pi + CBLK;
    S.sets = S.ref + CBLK;
    S.desc = S.sets + CBLK;
    S.planes = S.desc + CBLK;
    S.outb = reinterpret_cast<uint8_t*>(S.planes + L * CBLK);
    S.zlut = zlut + cls * 256;
    S.scx = scx;
    S.h = h;
    S.w = w;
    return S;
}

// Zero the state and build the sign words and the eff magnitude planes
// (plane offset off holds bit nbp - 1 - off) from the block's 64x64 slot.
// Lane t owns columns t and t + 32; a row's loads are one 128-byte line
// per half warp's columns.
__device__ __forceinline__ void load_block(const Scan& S,
                                           const int32_t* __restrict__ coef,
                                           int frac, int floor, int nbp,
                                           int eff, int lane) {
    for (int i = lane; i < SIG_COLS; i += WARP) {
        S.sig[i] = 0;
        S.neg[i] = 0;
    }
    __syncwarp();
    for (int j = 0; j < 2; ++j) {
        const int x = lane + WARP * j;
        S.pi[x] = 0;
        S.ref[x] = 0;
        for (int c0 = 0; c0 < eff; c0 += 8) {
            uint64_t acc[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) acc[k] = 0;
            uint64_t ng = 0;
            if (x < S.w) {
#pragma unroll 4
                for (int y = 0; y < S.h; ++y) {
                    const int32_t c = __ldg(coef + y * CBLK + x);
                    if (c < 0) ng |= 1ull << y;
                    const int32_t v = floored_mag(c, frac, floor);
#pragma unroll
                    for (int k = 0; k < 8; ++k) {
                        const int p = nbp - 1 - c0 - k;
                        if (p >= 0)
                            acc[k] |= static_cast<uint64_t>((v >> p) & 1) << y;
                    }
                }
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
                if (c0 + k < eff) S.planes[(c0 + k) * CBLK + x] = acc[k];
            if (c0 == 0) S.neg[x + 1] = ng;
        }
    }
    __syncwarp();
}

// Rows y0 - 1 .. y0 + 4 of a column word as bits 0-5 (rows outside the
// block read 0).
__device__ __forceinline__ uint32_t win6(uint64_t w, int y0) {
    return static_cast<uint32_t>((y0 == 0 ? (w << 1) : (w >> (y0 - 1))) & 63u);
}

__device__ __forceinline__ uint32_t nib(uint64_t w, int y0) {
    return static_cast<uint32_t>(w >> y0) & 15u;
}

// Descriptor of a stripe column: significance windows of the left
// column, the column and the right column (bits 0-5, 6-11, 12-17), their
// sign windows (18-23, 24-29, 30-35), the column's plane nibble (36-39),
// coded nibble (40-43) and extent nibble (48-51). Window bit j is row
// y0 - 1 + j, nibble bit i row y0 + i.
__device__ __forceinline__ uint32_t field(uint64_t d, int at, int bits) {
    return static_cast<uint32_t>(d >> at) & ((1u << bits) - 1u);
}

// Helper phase before a sigprop (KIND 0) or cleanup (KIND 2) stripe
// (all lanes): descriptors of the lane's columns, the serial lane's
// output bytes cleared, and the mask of the columns that can code
// anything in this pass.
template <int KIND>
__device__ __forceinline__ uint64_t prepare_stripe(const Scan& S, int lane,
                                                   int y0,
                                                   const uint64_t* plane) {
    const int rows = S.h - y0;
    const uint32_t e = rows >= 4 ? 15u : (1u << rows) - 1u;
    bool live[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int x = lane + WARP * j;
        S.outb[x] = 0;
        live[j] = false;
        if (x >= S.w) continue;
        const uint32_t sL = win6(S.sig[x], y0), sC = win6(S.sig[x + 1], y0);
        const uint32_t sR = win6(S.sig[x + 2], y0);
        const uint32_t p = nib(S.pi[x], y0);
        S.desc[x] = static_cast<uint64_t>(sL)
            | (static_cast<uint64_t>(sC) << 6)
            | (static_cast<uint64_t>(sR) << 12)
            | (static_cast<uint64_t>(win6(S.neg[x], y0)) << 18)
            | (static_cast<uint64_t>(win6(S.neg[x + 1], y0)) << 24)
            | (static_cast<uint64_t>(win6(S.neg[x + 2], y0)) << 30)
            | (static_cast<uint64_t>(nib(plane[x], y0)) << 36)
            | (static_cast<uint64_t>(p) << 40)
            | (static_cast<uint64_t>(e) << 48);
        const uint32_t sig4 = (sC >> 1) & 15u;
        if (KIND == 0) {
            uint32_t nbr = 0;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                if (((sL >> i) & 7u) | ((sR >> i) & 7u) | ((sC >> i) & 5u))
                    nbr |= 1u << i;
            live[j] = (e & ~sig4 & nbr) != 0;
        } else {
            live[j] = (e & ~sig4 & ~p) != 0;
        }
    }
    const uint64_t lo = __ballot_sync(FULL, live[0]);
    const uint64_t hi = __ballot_sync(FULL, live[1]);
    return lo | (hi << 32);
}

// Signed contribution of window bit k: +1 / -1 if significant and
// positive / negative, else 0.
__device__ __forceinline__ int sgn_at(uint32_t s, uint32_t n, int k) {
    return ((s >> k) & 1u) ? (((n >> k) & 1u) ? -1 : 1) : 0;
}

// The sign decision of stripe row i (window bit i + 1).
template <class Sink>
__device__ __forceinline__ void code_sign(Sink& s, const uint8_t* scx,
                                          uint32_t sL, uint32_t nL,
                                          uint32_t sC, uint32_t nC,
                                          uint32_t sR, uint32_t nR, int i) {
    const int hs = sgn_at(sL, nL, i + 1) + sgn_at(sR, nR, i + 1);
    const int vs = sgn_at(sC, nC, i) + sgn_at(sC, nC, i + 2);
    const int sx = scx[(hs + 2) * 5 + (vs + 2)];
    s.code(sx & 31, static_cast<int>((nC >> (i + 1)) & 1u) ^ (sx >> 5));
}

// The serial lane's coding of one sigprop (KIND 0) or cleanup (KIND 2)
// stripe: the live columns in order, from their descriptors, registers
// and shared memory only.
template <int KIND, class Sink>
__device__ __forceinline__ void code_stripe(const Scan& S, Sink& s,
                                            uint64_t mask) {
    if (!mask) return;
    int px = -2;          // the column coded last, and its significance
    uint32_t pc = 0;      // window after its coding
    int x = __ffsll(static_cast<long long>(mask)) - 1;
    uint64_t d = S.desc[x];
    while (true) {
        // The next live column's descriptor, loaded ahead.
        mask &= mask - 1;
        int nx = mask ? __ffsll(static_cast<long long>(mask)) - 1 : CBLK;
        uint64_t dn = S.desc[nx & (CBLK - 1)];
        const uint32_t sL = x == px + 1 ? pc : field(d, 0, 6);
        uint32_t sC = field(d, 6, 6);
        const uint32_t sR = field(d, 12, 6);
        const uint32_t nL = field(d, 18, 6), nC = field(d, 24, 6);
        const uint32_t nR = field(d, 30, 6);
        const uint32_t m = field(d, 36, 4), p = field(d, 40, 4);
        const uint32_t e = field(d, 48, 4);
        // Rows still to visit: in the extent, insignificant, and in
        // cleanup not coded by this plane's sigprop pass.
        uint32_t todo = e & ~(sC >> 1) & (KIND == 2 ? ~p : 15u);
        uint32_t ns = 0, coded = 0;
        if (KIND == 2 && e == 15u && (sL | sC | sR) == 0 && p == 0) {
            // Run-length shortcut: four insignificant, uncoded samples
            // with empty neighbourhoods.
            s.code(CTX_RL, m != 0);
            if (m == 0) {
                todo = 0;
            } else {
                const int k = __ffs(static_cast<int>(m)) - 1;
                s.code(CTX_UNI, (k >> 1) & 1);
                s.code(CTX_UNI, k & 1);
                sC |= 2u << k;
                ns = 1u << k;
                code_sign(s, S.scx, sL, nL, sC, nC, sR, nR, k);
                todo &= 14u << k;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t bit = 1u << i;
            if (!(todo & bit)) continue;
            const uint32_t pat = ((sL >> i) & 7u) | (((sR >> i) & 7u) << 3)
                | (((sC >> i) & 1u) << 6) | (((sC >> (i + 2)) & 1u) << 7);
            if (KIND == 0 && pat == 0) continue;
            const int b = static_cast<int>((m >> i) & 1u);
            s.code(S.zlut[pat], b);
            coded |= bit;
            if (b) {
                sC |= bit << 1;
                ns |= bit;
                code_sign(s, S.scx, sL, nL, sC, nC, sR, nR, i);
            }
        }
        S.outb[x] = static_cast<uint8_t>(ns | (coded << 4));
        // A sample made significant can make the next column's samples
        // sigprop candidates.
        if (KIND == 0 && ns && x + 1 < S.w && nx != x + 1) {
            mask |= 1ull << (x + 1);
            nx = x + 1;
            dn = S.desc[nx];
        }
        if (nx == CBLK) return;
        px = x;
        pc = sC;
        x = nx;
        d = dn;
    }
}

// Helper phase after a sigprop (KIND 0) or cleanup (KIND 2) stripe (all
// lanes): merge the serial lane's new significance (and, in sigprop, the
// coded samples) into the column words and the pass's set.
template <int KIND>
__device__ __forceinline__ void merge_stripe(const Scan& S, int lane,
                                             int y0) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int x = lane + WARP * j;
        const uint32_t o = S.outb[x];
        if (o & 15u) {
            const uint64_t ns = static_cast<uint64_t>(o & 15u) << y0;
            S.sig[x + 1] |= ns;
            S.sets[x] |= ns;
        }
        if (KIND == 0 && (o >> 4))
            S.pi[x] |= static_cast<uint64_t>(o >> 4) << y0;
    }
}

// A magnitude refinement stripe, all lanes: refinement changes no
// significance, so every sample's context is known before the stripe.
// Each lane forms the symbols of its two columns, a warp scan places
// them in coding order, and the sink takes them all at once. The
// refined samples go to the refined words and the pass's set.
template <class Sink>
__device__ __forceinline__ void refine_stripe(const Scan& S, Sink& s,
                                              int lane, int y0,
                                              const uint64_t* plane) {
    const int rows = S.h - y0;
    const uint32_t e = rows >= 4 ? 15u : (1u << rows) - 1u;
    LaneSyms ls;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int x = lane + WARP * j;
        ls.syms[j] = 0;
        ls.cnt[j] = 0;
        if (x >= S.w) continue;
        const uint32_t sL = win6(S.sig[x], y0), sC = win6(S.sig[x + 1], y0);
        const uint32_t sR = win6(S.sig[x + 2], y0);
        const uint32_t refine = e & (sC >> 1) & ~nib(S.pi[x], y0);
        if (!refine) continue;
        const uint32_t r = nib(S.ref[x], y0), m = nib(plane[x], y0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            if (!((refine >> i) & 1u)) continue;
            const uint32_t any = ((sL >> i) & 7u) | ((sR >> i) & 7u)
                | ((sC >> i) & 5u);
            const uint32_t cx = (r >> i) & 1u ? 16u : (any ? 15u : 14u);
            ls.syms[j] |= (cx | (((m >> i) & 1u) << 5)) << (8 * ls.cnt[j]);
            ls.cnt[j] += 1;
        }
        S.ref[x] |= static_cast<uint64_t>(refine) << y0;
        S.sets[x] |= static_cast<uint64_t>(refine) << y0;
    }
    // Exclusive scan of the counts in column order: columns 0-31 (the
    // lanes' first), then 32-63.
    int total = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        int incl = ls.cnt[j];
#pragma unroll
        for (int o = 1; o < WARP; o <<= 1) {
            const int v = __shfl_up_sync(FULL, incl, o);
            if (lane >= o) incl += v;
        }
        ls.off[j] = total + incl - ls.cnt[j];
        total += __shfl_sync(FULL, incl, WARP - 1);
    }
    s.append_warp(ls, total, lane);
}

// One pass over the block's stripes (all lanes of the warp): sigprop
// (KIND 0) and cleanup (KIND 2) coded by the serial lane (lane 0)
// between the helpers' prepare and merge phases, magnitude refinement
// (KIND 1) by all lanes. No global memory is read.
template <int KIND, class Sink>
__device__ void run_pass(const Scan& S, Sink& s, int lane,
                         const uint64_t* plane) {
    S.sets[lane] = 0;
    S.sets[lane + WARP] = 0;
    for (int y0 = 0; y0 < S.h; y0 += 4) {
        if (KIND == 1) {
            refine_stripe(S, s, lane, y0, plane);
        } else {
            const uint64_t mask = prepare_stripe<KIND>(S, lane, y0, plane);
            __syncwarp();
            if (lane == 0) code_stripe<KIND>(S, s, mask);
            __syncwarp();
            merge_stripe<KIND>(S, lane, y0);
        }
        __syncwarp();
        s.warp_flush(lane, false);
        __syncwarp();
    }
}

// The pass's exact 4 x distortion (all lanes), d4_sig over the samples
// made significant (kind 0, 2) or d4_ref over the refined ones (kind
// 1), from the block's coefficients, as dist_pair's two parts; lane 0
// stores the pair at *hi, *lo.
__device__ __forceinline__ void pass_distortion(
        const Scan& S, const int32_t* __restrict__ coef, int frac,
        int floor, int lane, int kind, int p, float* hi, float* lo) {
    long long s_hi = 0, s_lo = 0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int x = lane + WARP * j;
        uint64_t set = S.sets[x];
        while (set) {
            int ys[8];
            int32_t cs[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                ys[k] = set ? __ffsll(static_cast<long long>(set)) - 1 : -1;
                set &= set - 1;
            }
#pragma unroll
            for (int k = 0; k < 8; ++k)
                cs[k] = ys[k] >= 0 ? __ldg(coef + ys[k] * CBLK + x) : 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                if (ys[k] < 0) continue;
                const int32_t v = floored_mag(cs[k], frac, floor);
                const long long t = kind == 1 ? d4_ref(v, p) : d4_sig(v, p);
                s_hi += t >> 32;
                s_lo += t & 0xFFFFFFFFll;
            }
        }
    }
#pragma unroll
    for (int o = WARP / 2; o > 0; o >>= 1) {
        s_hi += __shfl_xor_sync(FULL, s_hi, o);
        s_lo += __shfl_xor_sync(FULL, s_lo, o);
    }
    if (lane == 0) dist_pair(s_hi, s_lo, hi, lo);
}

// The block's whole scan (all lanes): every plane offset below eff,
// sigprop and magref from the second on, cleanup always; each pass's
// distortion pair lands in R, and the sink records its position. Returns with the sink
// at the block's end (the caller flushes it).
template <class Sink>
__device__ void scan_block(const Scan& S, Sink& s, const Results& R,
                           const int32_t* __restrict__ coef, int frac,
                           int floor, int nbp, int eff, int lane) {
    load_block(S, coef, frac, floor, nbp, eff, lane);
    for (int off = 0; off < eff; ++off) {
        const int p = nbp - 1 - off;
        const uint64_t* plane = S.planes + off * CBLK;
        for (int kind = off == 0 ? 2 : 0; kind < 3; ++kind) {
            if (kind == 0) run_pass<0>(S, s, lane, plane);
            else if (kind == 1) run_pass<1>(S, s, lane, plane);
            else run_pass<2>(S, s, lane, plane);
            const int at = off * 3 + kind;
            pass_distortion(S, coef, frac, floor, lane, kind, p, R.dh + at,
                            R.dl + at);
            s.end_pass(R, at, lane);
        }
        S.pi[lane] = 0;
        S.pi[lane + WARP] = 0;
        __syncwarp();
    }
}

// Zero a block's results (all lanes).
__device__ __forceinline__ void results_clear(const Results& R, int L,
                                              int lane) {
    for (int i = lane; i < L * 3; i += WARP) {
        R.snap[i] = 0;
        R.dh[i] = 0.0f;
        R.dl[i] = 0.0f;
    }
}

// Store a block's results to its rows of the (N, L, 3) outputs (all
// lanes), the dead passes past eff at the final position.
__device__ __forceinline__ void results_store(const Results& R, int L,
                                              int eff, int final_pos,
                                              int lane, int32_t* snaps,
                                              float* dh, float* dl) {
    for (int i = lane; i < L * 3; i += WARP) {
        snaps[i] = i >= eff * 3 ? final_pos : R.snap[i];
        dh[i] = R.dh[i];
        dl[i] = R.dl[i];
    }
}

}  // namespace t1
