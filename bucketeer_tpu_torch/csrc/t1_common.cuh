// EBCOT Tier-1 device functions shared by the Hopper (sm_90a) kernels
// fused_t1.cu, cxd_scan.cu and mq_scan.cu: the MQ arithmetic coder
// (T.800 Annex C), the bit-packed scan state and the three coding passes
// (Annex D), and the exact distortion terms.
//
// One CUDA thread codes one 64x64 code-block. Scan state (significance,
// sign, coded-this-plane, refined) is bit-packed, one 64-bit word per
// column, in shared memory, laid out [column][thread] so the 32 threads
// of a warp touch 32 consecutive words and do not conflict on banks.
//
// run_pass is a template on its symbol sink: MqSink MQ-codes each
// decision as the scan produces it (fused_t1), SymbolSink appends
// ctx | d << 5 to the block's row of a global symbol buffer (cxd_scan).
//
// Integer arithmetic that the reference does with int32 wraparound runs
// in uint32 here (signed overflow would be undefined), and shifts that
// may reach 32 are guarded.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace t1 {

constexpr int CBLK = 64;
constexpr int NT = 32;           // code-blocks (threads) per thread block
constexpr int NCTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;
constexpr int SIG_COLS = CBLK + 2;   // one zero column each side

// Scan state per thread block, in 64-bit words: sig and neg with the
// zero columns, pi and ref without.
constexpr int WORDS = (2 * SIG_COLS + 2 * CBLK) * NT;

// --- the MQ coder -----------------------------------------------------

struct Coder {
    uint32_t a, c;
    int ct;
    int cur;          // bytes so far including the dummy pre-byte
    uint32_t last;    // the byte at cur - 1
    int nsym;         // decisions coded
    uint8_t* out;
    int cap;
    uint8_t* ctx;     // this thread's context states, stride NT
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
                                           uint8_t* ctx) {
    m.a = 0x8000u;
    m.c = 0;
    m.ct = 12;
    m.cur = 1;
    m.last = 0;
    m.nsym = 0;
    m.out = out;
    m.cap = cap;
    m.ctx = ctx;
    for (int i = 0; i < NCTX; ++i) m.ctx[i * NT] = 0;
    m.ctx[0] = 4;                  // the all-zero-neighbourhood ZC ctx
    m.ctx[CTX_RL * NT] = 3;
    m.ctx[CTX_UNI * NT] = 46;
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

__device__ __forceinline__ void renorm(Coder& m) {
    do {
        m.a = (m.a << 1) & 0xFFFFu;
        m.c <<= 1;
        if (--m.ct == 0) byteout(m);
    } while ((m.a & 0x8000u) == 0);
}

// T.800 C.2.2-C.2.3 ENCODE of one decision. Context state byte: Qe
// index in the low 6 bits, MPS in bit 7.
__device__ __forceinline__ void encode(Coder& m, const int* qe, int cx,
                                       int bit) {
    uint8_t st = m.ctx[cx * NT];
    int idx = st & 63;
    int mps = st >> 7;
    uint32_t q = static_cast<uint32_t>(qe[idx * 4]);
    m.nsym += 1;
    if (bit == mps) {
        m.a -= q;
        if ((m.a & 0x8000u) == 0) {
            if (m.a < q) m.a = q; else m.c += q;
            idx = qe[idx * 4 + 1];
            renorm(m);
        } else {
            m.c += q;
        }
    } else {
        m.a -= q;
        if (m.a < q) m.c += q; else m.a = q;
        if (qe[idx * 4 + 3]) mps ^= 1;
        idx = qe[idx * 4 + 2];
        renorm(m);
    }
    m.ctx[cx * NT] = static_cast<uint8_t>(idx | (mps << 7));
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

// Load the 47 x 4 Qe table into shared memory (all threads of the
// thread block take part; the caller synchronizes).
__device__ __forceinline__ void load_qe(int* qe, const int32_t* qe_g) {
    for (int i = threadIdx.x; i < 47 * 4; i += NT) qe[i] = qe_g[i];
}

// --- symbol sinks -----------------------------------------------------

// MQ-codes each decision inline.
struct MqSink {
    Coder& m;
    const int* qe;
    __device__ __forceinline__ void code(int cx, int bit) {
        encode(m, qe, cx, bit);
    }
};

// Appends ctx | d << 5 to the block's symbol row. Four symbols are
// gathered into one 32-bit store; the row is 4-byte aligned and its
// length a multiple of 4. Symbols past the row's capacity are counted
// but not stored (the caller checks the cursor against the capacity).
struct SymbolSink {
    uint8_t* row;
    int cap;
    int cur;
    uint32_t word;
    __device__ __forceinline__ void code(int cx, int bit) {
        word |= static_cast<uint32_t>(cx | (bit << 5)) << (8 * (cur & 3));
        cur += 1;
        if ((cur & 3) == 0) {
            if (cur <= cap)
                *reinterpret_cast<uint32_t*>(row + cur - 4) = word;
            word = 0;
        }
    }
    // Store the last, partly filled word (its bytes past cur mean
    // nothing).
    __device__ __forceinline__ void finish() {
        if ((cur & 3) && cur < cap)
            *reinterpret_cast<uint32_t*>(row + (cur & ~3)) = word;
    }
};

// --- the CX/D scan ----------------------------------------------------

__device__ __forceinline__ int bit_at(uint64_t w, int y) {
    return (y >= 0 && y < CBLK) ? static_cast<int>((w >> y) & 1ull) : 0;
}

// Signed contribution of sample row y of a column: +1 / -1 if
// significant and positive / negative, else 0.
__device__ __forceinline__ int sgn_at(uint64_t sig, uint64_t neg, int y) {
    return bit_at(sig, y) ? (bit_at(neg, y) ? -1 : 1) : 0;
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

// A pass's exact 4 x distortion S as the canonical float32 pair
// (fl(S), S - fl(S)).
__device__ __forceinline__ void dist_pair(long long s, float* hi,
                                          float* lo) {
    float h = __ll2float_rn(s);
    *hi = h;
    *lo = __ll2float_rn(s - static_cast<long long>(h));
}

struct Block {
    const int32_t* coef;   // 64x64 row-major
    int frac, floor, h, w, cls;
    uint64_t* sig;         // column x at sig[(x + 1) * NT]
    uint64_t* neg;         // same layout
    uint64_t* pi;          // column x at pi[x * NT]
    uint64_t* ref;
};

// This thread's scan state in the thread block's shared words.
__device__ __forceinline__ void block_state(Block& B, uint64_t* smem,
                                            int t) {
    B.sig = smem + t;
    B.neg = smem + SIG_COLS * NT + t;
    B.pi = smem + 2 * SIG_COLS * NT + t;
    B.ref = smem + (2 * SIG_COLS + CBLK) * NT + t;
}

// Zero the scan state and load the sign bits of the block's extent.
__device__ __forceinline__ void block_reset(const Block& B) {
    for (int x = 0; x < SIG_COLS; ++x) {
        B.sig[x * NT] = 0;
        B.neg[x * NT] = 0;
    }
    for (int x = 0; x < CBLK; ++x) {
        B.pi[x * NT] = 0;
        B.ref[x * NT] = 0;
    }
    for (int x = 0; x < B.w; ++x) {
        uint64_t w = 0;
        for (int y = 0; y < B.h; ++y)
            if (__ldg(B.coef + y * CBLK + x) < 0) w |= 1ull << y;
        B.neg[(x + 1) * NT] = w;
    }
}

// Floored quantizer-index magnitude of sample (y, x).
__device__ __forceinline__ int32_t mag(const Block& B, int y, int x) {
    int32_t c = __ldg(B.coef + y * CBLK + x);
    int32_t a = static_cast<int32_t>(c < 0 ? 0u - static_cast<uint32_t>(c)
                                           : static_cast<uint32_t>(c));
    int32_t idx = a >> B.frac;
    return static_cast<int32_t>(static_cast<uint32_t>(idx >> B.floor)
                                << B.floor);
}

__device__ __forceinline__ int zc_ctx(const int* zc, int cls, uint64_t L,
                                      uint64_t C, uint64_t R, int y,
                                      int* total) {
    int h = bit_at(L, y) + bit_at(R, y);
    int v = bit_at(C, y - 1) + bit_at(C, y + 1);
    int d = bit_at(L, y - 1) + bit_at(L, y + 1) + bit_at(R, y - 1)
        + bit_at(R, y + 1);
    *total = h + v + d;
    return zc[cls * 45 + h * 15 + v * 5 + d];
}

template <class Sink>
__device__ __forceinline__ void code_sign(Sink& s, const int* scx,
                                          uint64_t L, uint64_t NL,
                                          uint64_t C, uint64_t NC,
                                          uint64_t R, uint64_t NR, int y) {
    int hs = sgn_at(L, NL, y) + sgn_at(R, NR, y);
    int vs = sgn_at(C, NC, y - 1) + sgn_at(C, NC, y + 1);
    int sx = scx[(hs + 2) * 5 + (vs + 2)];
    s.code(sx & 31, bit_at(NC, y) ^ (sx >> 5));
}

// Load the zero-coding table and the sign-coding table with its
// neighbour sums clipped to [-1, 1] into shared memory (all threads of
// the thread block take part; the caller synchronizes).
__device__ __forceinline__ void load_scan_tables(int* zc, int* scx,
                                                 const int32_t* zc_g,
                                                 const int32_t* sc_ctx,
                                                 const int32_t* sc_xor) {
    for (int i = threadIdx.x; i < 135; i += NT) zc[i] = zc_g[i];
    for (int i = threadIdx.x; i < 25; i += NT) {
        int h = min(max(i / 5 - 2, -1), 1) + 1;
        int v = min(max(i % 5 - 2, -1), 1) + 1;
        scx[i] = sc_ctx[h * 3 + v] | (sc_xor[h * 3 + v] << 5);
    }
}

// One pass over the block's stripe columns. kind: 0 = significance
// propagation, 1 = magnitude refinement, 2 = cleanup. Returns the
// pass's exact 4 x distortion.
template <class Sink>
__device__ long long run_pass(const Block& B, Sink& s, const int* zc,
                              const int* scx, int kind, int p) {
    unsigned long long dist = 0;
    for (int y0 = 0; y0 < B.h; y0 += 4) {
        uint64_t L = B.sig[0], C = B.sig[NT], R = B.sig[2 * NT];
        uint64_t NL = B.neg[0], NC = B.neg[NT], NR = B.neg[2 * NT];
        for (int x = 0; x < B.w; ++x) {
            uint64_t P = B.pi[x * NT];
            int start = 0;
            int ymax = min(y0 + 4, B.h);
            if (kind == 2 && y0 + 3 < B.h) {
                // Run-length shortcut: four insignificant, uncoded
                // samples with empty neighbourhoods.
                int lo = y0 > 0 ? y0 - 1 : 0;
                int hi = min(y0 + 4, CBLK - 1);
                uint64_t win = (~0ull >> (63 - hi)) & (~0ull << lo);
                if (((L | C | R) & win) == 0 && (P & (0xFull << y0)) == 0) {
                    int k = -1;
                    int32_t vk = 0;
                    for (int i = 0; i < 4 && k < 0; ++i) {
                        int32_t v = mag(B, y0 + i, x);
                        if ((v >> p) & 1) { k = i; vk = v; }
                    }
                    s.code(CTX_RL, k >= 0);
                    if (k < 0) {
                        start = 4;
                    } else {
                        s.code(CTX_UNI, (k >> 1) & 1);
                        s.code(CTX_UNI, k & 1);
                        int y = y0 + k;
                        C |= 1ull << y;
                        dist += static_cast<unsigned long long>(d4_sig(vk, p));
                        code_sign(s, scx, L, NL, C, NC, R, NR, y);
                        start = k + 1;
                    }
                }
            }
            for (int y = y0 + start; y < ymax; ++y) {
                uint64_t bit = 1ull << y;
                if (kind == 1) {
                    if (!(C & bit) || (P & bit)) continue;
                    int total;
                    zc_ctx(zc, 0, L, C, R, y, &total);
                    int32_t v = mag(B, y, x);
                    uint64_t rw = B.ref[x * NT];
                    int cx = (rw & bit) ? 16 : (total ? 15 : 14);
                    s.code(cx, (v >> p) & 1);
                    dist += static_cast<unsigned long long>(d4_ref(v, p));
                    B.ref[x * NT] = rw | bit;
                    continue;
                }
                if (C & bit) continue;
                if (kind == 2 && (P & bit)) continue;
                int total;
                int cx = zc_ctx(zc, B.cls, L, C, R, y, &total);
                if (kind == 0 && total == 0) continue;
                int32_t v = mag(B, y, x);
                int b = (v >> p) & 1;
                s.code(cx, b);
                if (kind == 0) P |= bit;
                if (b) {
                    C |= bit;
                    dist += static_cast<unsigned long long>(d4_sig(v, p));
                    code_sign(s, scx, L, NL, C, NC, R, NR, y);
                }
            }
            if (kind == 0) B.pi[x * NT] = P;
            B.sig[(x + 1) * NT] = C;
            L = C;
            NL = NC;
            C = R;
            NC = NR;
            if (x + 3 < SIG_COLS) {
                R = B.sig[(x + 3) * NT];
                NR = B.neg[(x + 3) * NT];
            }
        }
    }
    return static_cast<long long>(dist);
}

}  // namespace t1
