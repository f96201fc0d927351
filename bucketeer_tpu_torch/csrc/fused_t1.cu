// Fused EBCOT Tier-1 for Hopper (sm_90a): CX/D context modeling and the
// MQ arithmetic coder in one kernel, two warps per 64x64 code-block.
//
// Replaces the TPU kernel fused_pallas
// (bucketeer_tpu/codec/pallas/fused_t1.py:72, body _kernel at :47) and
// computes the same outputs as its plain PyTorch version
// (bucketeer_tpu_torch/kernels/fused_t1.py, fused_t1_plain).
//
// What bounds it on this card: neither bytes nor arithmetic rate but the
// serial chains of one code-block: each decision's context depends on
// significance set by the decisions before it in coding order, and each
// MQ step on the coder registers of the step before. At the main path's
// largest launch group (L=8, 1,752 blocks) the bytes bound is 0.0088 ms;
// the longest block's chain alone is ~320 times that and a launch ~660
// times (PERF.md), so a launch can take no less than that chain;
// the design makes the chain short and has every block start at once.
//
// What the design does about it (t1_common.cuh has the scan's details):
// - One thread block of two warps per code-block. Warp 0 runs the scan of
//   t1_common.cuh (scan_block): the block loaded once, coalesced, into
//   bit planes in shared memory; lane 0 coding sigprop and cleanup from
//   registers and shared memory only (no global load on the chain); the
//   other lanes preparing stripes, forming refinement symbols and summing
//   the exact distortion.
// - Warp 1's lane 0 is the MQ coder. The scan does not depend on the
//   coder, so the two chains run side by side: warp 0 writes symbols to
//   a 2 KB ring in shared memory and publishes its count at every stripe
//   end; warp 1 codes them as they arrive and takes each pass's byte
//   count where that pass's symbols end. A launch costs about the longer
//   of the two chains instead of their sum (with the coder inline on the
//   scan's lane 0 the L=8 group took 8.9 ms, against 6.6 ms split).
// - A context state word carries its packed Qe entry, so a decision
//   costs one dependent shared load; renormalization is one leading-zero
//   count. Coded bytes go straight into the block's output row range,
//   dummy pre-byte at 0. No symbol buffer in global memory exists (the
//   TPU kernel held ~196 KB of symbols per block in VMEM).
// - Shared memory per block: scan_words(L) words of scan state and
//   planes, the ring, the context states and the per-pass results, 9.9
//   KB at L=8 and 14.5 KB at L=16 beside 1 KB of tables, so an SM holds
//   18 (L=8) or 14 (L=16) blocks and the L=8 group runs in one wave on
//   132 SMs. fused_t1_occupancy reports the resident thread blocks.
// - Every output entry is written exactly once at the block's end,
//   coalesced, so the wrapper allocates them uninitialised.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include <climits>

#include "t1_common.cuh"

namespace {

using namespace t1;

constexpr int MQR = 2048;           // symbol ring between the two warps
constexpr int STRIPE_MAX = 640;     // a stripe's most symbols

// The two warps' shared counters. The scan warp publishes symbols and
// pass ends; the coder warp publishes how far it has consumed.
struct Handoff {
    volatile int produced;   // symbols in the ring so far
    volatile int consumed;   // symbols coded so far
    volatile int npe;        // pass ends recorded
    volatile int done;       // the scan has ended
    int final_pos, len, nsym, curb;   // the coder's results
};

// The scan warp's sink: symbols into the ring, pass ends into pe_count /
// pe_at (the pass's symbol count and its off * 3 + kind, in order).
struct FeedSink {
    uint8_t* ring;
    Handoff* ho;
    int* pe_count;
    int* pe_at;
    int cur;          // symbols so far (lane 0's; every lane's after a flush)
    int npe;          // pass ends recorded (lane 0's)
    __device__ __forceinline__ void code(int cx, int bit) {
        ring[cur & (MQR - 1)] = static_cast<uint8_t>(cx | (bit << 5));
        cur += 1;
    }
    __device__ __forceinline__ void end_pass(const Results&, int at,
                                             int lane) {
        if (lane == 0) {
            pe_count[npe] = cur;
            pe_at[npe] = at;
            npe += 1;
            __threadfence_block();
            ho->npe = npe;
        }
    }
    __device__ __forceinline__ void append_warp(const LaneSyms& ls, int total,
                                                int) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
            for (int q = 0; q < ls.cnt[j]; ++q)
                ring[(cur + ls.off[j] + q) & (MQR - 1)] =
                    static_cast<uint8_t>(ls.syms[j] >> (8 * q));
        cur += total;
    }
    // All lanes of the scan warp at a stripe end: publish the stripe's
    // symbols, then wait until the ring has room for the next stripe.
    __device__ __forceinline__ void warp_flush(int lane, bool) {
        __threadfence_block();
        cur = __shfl_sync(FULL, cur, 0);
        if (lane == 0) {
            ho->produced = cur;
            while (cur - ho->consumed > MQR - STRIPE_MAX) {
            }
        }
        __syncwarp();
    }
};

// The coder warp's lane 0: MQ-code the ring's symbols as they arrive, and
// at each pass end the byte count so far.
__device__ void consume(Handoff* ho, const uint8_t* ring,
                        const int* pe_count, const int* pe_at,
                        const Results& R, Coder& m, const uint32_t* qe) {
    int consumed = 0, pe = 0, n_pe = 0;
    int next_end = INT_MAX;       // symbol count of the next pass end
    while (true) {
        const int fin = ho->done;
        __threadfence_block();
        const int prod = ho->produced;
        __threadfence_block();
        const int n_new = ho->npe;
        __threadfence_block();
        if (n_new > n_pe) {
            n_pe = n_new;
            if (next_end == INT_MAX) next_end = pe_count[pe];
        }
        while (true) {
            while (next_end == consumed) {
                R.snap[pe_at[pe]] = m.cur - 1;
                pe += 1;
                next_end = pe < n_pe ? pe_count[pe] : INT_MAX;
            }
            const int stop = min(prod, next_end);
            if (consumed >= stop) break;
            int sym = ring[consumed & (MQR - 1)];
            while (consumed < stop) {
                const int nxt = ring[(consumed + 1) & (MQR - 1)];
                encode(m, qe, sym & 31, sym >> 5);
                consumed += 1;
                sym = nxt;
                if ((consumed & 255) == 0) ho->consumed = consumed;
            }
            ho->consumed = consumed;
        }
        if (fin && consumed == prod && next_end == INT_MAX) break;
    }
}

// Dynamic shared memory per thread block at plane budget L: scan state,
// the context states (one word each, padded to 20), the ring, the
// handoff, the pass-end lists and the results.
size_t smem_bytes(int L) {
    return scan_words(L) * sizeof(uint64_t) + 20 * sizeof(uint32_t) + MQR
        + sizeof(Handoff) + 2 * 3 * L * sizeof(int) + results_bytes(L);
}

__global__ void __launch_bounds__(2 * WARP)
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
                int L, int frac, int cap,
                uint8_t* __restrict__ rows, int32_t* __restrict__ snaps,
                int32_t* __restrict__ dlen, float* __restrict__ dh,
                float* __restrict__ dl, int32_t* __restrict__ cur,
                int32_t* __restrict__ curb) {
    __shared__ uint8_t zlut[3 * 256];
    __shared__ uint8_t scx[32];
    __shared__ uint32_t qe[NQE + 1];
    extern __shared__ uint64_t smem[];

    const int warp = threadIdx.x / WARP;
    const int lane = threadIdx.x % WARP;
    const size_t b = blockIdx.x;
    if (warp == 0) {
        load_scan_tables(zlut, scx, zc_g, sc_ctx, sc_xor, lane);
        load_qe(qe, qe_g, lane, WARP);
    }

    const int nbp = nbps[b], floor = floors[b];
    const int eff = max(nbp - floor, 0);
    const Scan S = scan_layout(smem, L, hs[b], ws[b], clss[b], zlut, scx);
    uint32_t* ctx = reinterpret_cast<uint32_t*>(smem + scan_words(L));
    uint8_t* ring = reinterpret_cast<uint8_t*>(ctx + 20);
    Handoff* ho = reinterpret_cast<Handoff*>(ring + MQR);
    int* pe_count = reinterpret_cast<int*>(ho + 1);
    int* pe_at = pe_count + 3 * L;
    const Results R = results_layout(pe_at + 3 * L, L);
    if (warp == 0) results_clear(R, L, lane);
    if (threadIdx.x == 0) {
        ho->produced = 0;
        ho->consumed = 0;
        ho->npe = 0;
        ho->done = 0;
        ho->final_pos = 0;
        ho->len = 0;
        ho->nsym = 0;
        ho->curb = 1;
    }
    __syncthreads();

    if (eff > 0) {
        if (warp == 0) {
            FeedSink sink{ring, ho, pe_count, pe_at, 0, 0};
            scan_block(S, sink, R, blocks + b * CBLK * CBLK, frac, floor, nbp,
                       eff, lane);
            if (lane == 0) {
                __threadfence_block();
                ho->done = 1;
            }
        } else if (lane == 0) {
            Coder m;
            coder_init(m, rows + b * cap, cap, ctx, 1, qe);
            consume(ho, ring, pe_count, pe_at, R, m, qe);
            // Plane offsets past this block's depth are masked dead
            // passes: their byte snapshot is the count before the flush.
            ho->final_pos = m.cur - 1;
            ho->len = flush(m);
            ho->nsym = m.nsym;
            ho->curb = m.cur;
        }
    }
    __syncthreads();
    if (warp == 0) {
        results_store(R, L, eff, ho->final_pos, lane, snaps + b * L * 3,
                      dh + b * L * 3, dl + b * L * 3);
        if (lane == 0) {
            dlen[b] = ho->len;
            cur[b] = ho->nsym;
            curb[b] = ho->curb;
        }
    }
}

}  // namespace

extern "C" int fused_t1_launch(
        const void* blocks, const void* nbps, const void* floors,
        const void* cls, const void* hs, const void* ws, const void* zc,
        const void* sc_ctx, const void* sc_xor, const void* qe,
        int n, int L, int frac, int cap,
        void* rows, void* snaps, void* dlen, void* dh, void* dl,
        void* cur, void* curb, void* stream) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        fused_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    fused_t1_kernel<<<n, 2 * WARP, smem, static_cast<cudaStream_t>(stream)>>>(
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
        L, frac, cap,
        static_cast<uint8_t*>(rows), static_cast<int32_t*>(snaps),
        static_cast<int32_t*>(dlen), static_cast<float*>(dh),
        static_cast<float*>(dl), static_cast<int32_t*>(cur),
        static_cast<int32_t*>(curb));
    return static_cast<int>(cudaGetLastError());
}

// Resident thread blocks (= code-blocks, two warps each) per SM at plane
// budget L.
extern "C" int fused_t1_occupancy(int L, int* blocks_per_sm) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        fused_t1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, fused_t1_kernel, 2 * WARP, smem));
}
