// Fused EBCOT Tier-1 for Hopper (sm_90a): CX/D context modeling and the
// MQ arithmetic coder in one kernel, one CUDA thread per 64x64
// code-block.
//
// Replaces the TPU kernel fused_pallas
// (bucketeer_tpu/codec/pallas/fused_t1.py:72, body _kernel at :47) and
// computes the same outputs as its plain PyTorch version
// (bucketeer_tpu_torch/kernels/fused_t1.py, fused_t1_plain).
//
// What bounds it on this card: neither bytes nor arithmetic rate. A
// code-block's coding is one serial dependency chain: each decision's
// context depends on significance set by the decisions before it in
// coding order, and each MQ step depends on the coder registers of the
// step before. The kernel's time is the longest chain in a launch times
// the latency of one step, divided over the blocks that run at once.
//
// What the design does about it:
// - No symbol buffer: each decision is MQ-coded as the scan produces it
//   (the TPU kernel held ~196 KB of symbols per block in VMEM, more
//   than one H100 block's shared memory beside anything else). Bytes go
//   straight into the block's output row range, dummy pre-byte at 0.
// - Scan state (significance, sign, coded-this-plane, refined) is
//   bit-packed, one 64-bit word per column, in shared memory: 2 KB per
//   code-block. Words are laid out [column][thread] so the 32 threads
//   of a warp touch 32 consecutive words and do not conflict on banks.
// - Each thread loops only over its block's own extent and its
//   realized planes (nbp - floor); a dead block does nothing.
// - Distortion: 4 x distortion of each pass is summed exactly in 64-bit
//   integers from the float32-rounded factors and emitted as the
//   canonical float32 pair (fl(S), S - fl(S)); no float arithmetic is
//   left for the compiler to contract into FMAs.
// - Integer arithmetic that the reference does with int32 wraparound
//   runs in uint32 here (signed overflow would be undefined), and shifts
//   that may reach 32 are guarded.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CBLK = 64;
constexpr int NT = 32;           // code-blocks (threads) per thread block
constexpr int NCTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNI = 18;
constexpr int SIG_COLS = CBLK + 2;   // one zero column each side

// Dynamic shared memory per thread block, in 64-bit words then bytes.
constexpr int WORDS = (2 * SIG_COLS + 2 * CBLK) * NT;
constexpr size_t SMEM_BYTES = WORDS * sizeof(uint64_t) + NCTX * NT;

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

struct Block {
    const int32_t* coef;   // 64x64 row-major
    int frac, floor, h, w, cls;
    uint64_t* sig;         // column x at sig[(x + 1) * NT]
    uint64_t* neg;         // same layout
    uint64_t* pi;          // column x at pi[x * NT]
    uint64_t* ref;
};

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

__device__ __forceinline__ void code_sign(Coder& m, const int* qe,
                                          const int* scx, uint64_t L,
                                          uint64_t NL, uint64_t C,
                                          uint64_t NC, uint64_t R,
                                          uint64_t NR, int y) {
    int hs = sgn_at(L, NL, y) + sgn_at(R, NR, y);
    int vs = sgn_at(C, NC, y - 1) + sgn_at(C, NC, y + 1);
    int sx = scx[(hs + 2) * 5 + (vs + 2)];
    encode(m, qe, sx & 31, bit_at(NC, y) ^ (sx >> 5));
}

// One pass over the block's stripe columns. kind: 0 = significance
// propagation, 1 = magnitude refinement, 2 = cleanup. Returns the
// pass's exact 4 x distortion.
__device__ long long run_pass(const Block& B, Coder& m, const int* zc,
                              const int* scx, const int* qe, int kind,
                              int p) {
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
                    encode(m, qe, CTX_RL, k >= 0);
                    if (k < 0) {
                        start = 4;
                    } else {
                        encode(m, qe, CTX_UNI, (k >> 1) & 1);
                        encode(m, qe, CTX_UNI, k & 1);
                        int y = y0 + k;
                        C |= 1ull << y;
                        dist += static_cast<unsigned long long>(d4_sig(vk, p));
                        code_sign(m, qe, scx, L, NL, C, NC, R, NR, y);
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
                    encode(m, qe, cx, (v >> p) & 1);
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
                encode(m, qe, cx, b);
                if (kind == 0) P |= bit;
                if (b) {
                    C |= bit;
                    dist += static_cast<unsigned long long>(d4_sig(v, p));
                    code_sign(m, qe, scx, L, NL, C, NC, R, NR, y);
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

__global__ void __launch_bounds__(NT)
fused_t1_kernel(const int32_t* __restrict__ blocks,
                const int32_t* __restrict__ nbps,
                const int32_t* __restrict__ floors,
                const int32_t* __restrict__ clss,
                const int32_t* __restrict__ hs,
                const int32_t* __restrict__ ws,
                const int32_t* __restrict__ zc_g,
                const int32_t* __restrict__ sc_ctx,
                const int32_t* __restrict__ sc_xor,
                const int32_t* __restrict__ qe_g,
                int n, int L, int frac, int cap,
                uint8_t* __restrict__ rows, int32_t* __restrict__ snaps,
                int32_t* __restrict__ dlen, float* __restrict__ dh,
                float* __restrict__ dl, int32_t* __restrict__ cur,
                int32_t* __restrict__ curb) {
    __shared__ int zc[135];
    __shared__ int scx[25];
    __shared__ int qe[47 * 4];
    extern __shared__ uint64_t smem[];

    for (int i = threadIdx.x; i < 135; i += NT) zc[i] = zc_g[i];
    for (int i = threadIdx.x; i < 47 * 4; i += NT) qe[i] = qe_g[i];
    for (int i = threadIdx.x; i < 25; i += NT) {
        // Clip the signed neighbour sums to [-1, 1] once, here.
        int h = min(max(i / 5 - 2, -1), 1) + 1;
        int v = min(max(i % 5 - 2, -1), 1) + 1;
        scx[i] = sc_ctx[h * 3 + v] | (sc_xor[h * 3 + v] << 5);
    }
    __syncthreads();

    const int t = threadIdx.x;
    const int b = blockIdx.x * NT + t;
    if (b >= n) return;

    Block B;
    B.coef = blocks + static_cast<size_t>(b) * CBLK * CBLK;
    B.frac = frac;
    B.floor = floors[b];
    B.h = hs[b];
    B.w = ws[b];
    B.cls = clss[b];
    B.sig = smem + t;
    B.neg = smem + SIG_COLS * NT + t;
    B.pi = smem + 2 * SIG_COLS * NT + t;
    B.ref = smem + (2 * SIG_COLS + CBLK) * NT + t;
    const int nbp = nbps[b];
    const int eff = max(nbp - B.floor, 0);
    // Every output is written here, so the wrapper allocates them
    // uninitialised: passes that do not exist read 0.
    for (int i = 0; i < L * 3; ++i) {
        const size_t at = static_cast<size_t>(b) * L * 3 + i;
        snaps[at] = 0;
        dh[at] = 0.0f;
        dl[at] = 0.0f;
    }

    Coder m;
    m.a = 0x8000u;
    m.c = 0;
    m.ct = 12;
    m.cur = 1;
    m.last = 0;
    m.nsym = 0;
    m.out = rows + static_cast<size_t>(b) * cap;
    m.cap = cap;
    m.ctx = reinterpret_cast<uint8_t*>(smem + WORDS) + t;

    if (eff > 0) {
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
        for (int i = 0; i < NCTX; ++i) m.ctx[i * NT] = 0;
        m.ctx[0] = 4;                  // the all-zero-neighbourhood ZC ctx
        m.ctx[CTX_RL * NT] = 3;
        m.ctx[CTX_UNI * NT] = 46;
        put(m, 0, 0);

        for (int off = 0; off < eff; ++off) {
            const int p = nbp - 1 - off;
            for (int kind = off == 0 ? 2 : 0; kind < 3; ++kind) {
                long long s = run_pass(B, m, zc, scx, qe, kind, p);
                size_t at = (static_cast<size_t>(b) * L + off) * 3 + kind;
                snaps[at] = m.cur - 1;
                float hi = __ll2float_rn(s);
                dh[at] = hi;
                dl[at] = __ll2float_rn(s - static_cast<long long>(hi));
            }
            for (int x = 0; x < CBLK; ++x) B.pi[x * NT] = 0;
        }
        // Plane offsets past this block's depth are masked dead passes:
        // their byte snapshot is the count before the flush.
        for (int off = eff; off < L; ++off)
            for (int kind = 0; kind < 3; ++kind)
                snaps[(static_cast<size_t>(b) * L + off) * 3 + kind] =
                    m.cur - 1;
        dlen[b] = flush(m);
    } else {
        dlen[b] = 0;
    }
    cur[b] = m.nsym;
    curb[b] = m.cur;
}

}  // namespace

extern "C" int fused_t1_launch(
        const void* blocks, const void* nbps, const void* floors,
        const void* cls, const void* hs, const void* ws, const void* zc,
        const void* sc_ctx, const void* sc_xor, const void* qe,
        int n, int L, int frac, int cap,
        void* rows, void* snaps, void* dlen, void* dh, void* dl,
        void* cur, void* curb, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    dim3 grid((n + NT - 1) / NT);
    fused_t1_kernel<<<grid, NT, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blocks),
        static_cast<const int32_t*>(nbps),
        static_cast<const int32_t*>(floors),
        static_cast<const int32_t*>(cls),
        static_cast<const int32_t*>(hs),
        static_cast<const int32_t*>(ws),
        static_cast<const int32_t*>(zc),
        static_cast<const int32_t*>(sc_ctx),
        static_cast<const int32_t*>(sc_xor),
        static_cast<const int32_t*>(qe),
        n, L, frac, cap,
        static_cast<uint8_t*>(rows), static_cast<int32_t*>(snaps),
        static_cast<int32_t*>(dlen), static_cast<float*>(dh),
        static_cast<float*>(dl), static_cast<int32_t*>(cur),
        static_cast<int32_t*>(curb));
    return static_cast<int>(cudaGetLastError());
}
