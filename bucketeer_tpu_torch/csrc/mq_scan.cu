// The MQ arithmetic coder (T.800 Annex C) over given ctx | d << 5 symbol
// streams for Hopper (sm_90a), one CUDA thread per code-block: the coded
// bytes, the byte count at every pass boundary, the data length and the
// byte cursor.
//
// Replaces the TPU kernel mq_pallas
// (bucketeer_tpu/codec/pallas/mq_scan.py:74, pallas_call at :85; body
// _mq_block at :46) and computes the same outputs as its plain PyTorch
// version (bucketeer_tpu_torch/kernels/mq_scan.py, mq_scan_plain): the
// semantics of cxd._mq_run with a trip budget at least every block's
// symbol total, which the wrapper checks.
//
// What bounds it on this card: the serial chain of one block's coder
// registers (each symbol's interval update depends on the one before).
// Its bytes bound, the symbols in and the coded bytes out over HBM
// bandwidth, is three orders of magnitude below the chain.
//
// What the design does about it:
// - The coder of t1_common.cuh, fused_t1's, register for register; the
//   19 context-state words per block (each with its packed Qe entry)
//   sit in shared memory.
// - Each thread reads its block's symbols sequentially from global
//   memory (the read-only path, one byte a symbol) and stops at its own
//   total, not at the launch's largest.
// - Pass boundaries: instead of comparing every symbol index with all
//   L x 3 counts, the thread keeps the next boundary due and rescans the
//   counts only when it is reached; an entry whose count is not in
//   [1, total] is never reached and keeps its 0.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include <climits>

#include "t1_common.cuh"

namespace {

using namespace t1;

// The smallest count in (after, total] among a block's L x 3 entries,
// or INT_MAX when there is none.
__device__ __forceinline__ int next_boundary(const int32_t* cnt, int n,
                                             int after, int total) {
    int nx = INT_MAX;
    for (int e = 0; e < n; ++e) {
        const int c = cnt[e];
        if (c > after && c <= total && c < nx) nx = c;
    }
    return nx;
}

__global__ void __launch_bounds__(NT)
mq_scan_kernel(const uint8_t* __restrict__ syms,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ totals,
               const int32_t* __restrict__ flags,
               const int32_t* __restrict__ qe_g,
               int n, int L, int stride, int cap,
               uint8_t* __restrict__ bytebuf, int32_t* __restrict__ snaps,
               int32_t* __restrict__ dlen, int32_t* __restrict__ cur) {
    __shared__ uint32_t qe[NQE + 1];
    __shared__ uint32_t ctx[NCTX * NT];

    load_qe(qe, qe_g, threadIdx.x, NT);
    __syncthreads();

    const int t = threadIdx.x;
    const int b = blockIdx.x * NT + t;
    if (b >= n) return;

    const int ne = L * 3;
    const int32_t* cnt = counts + static_cast<size_t>(b) * ne;
    int32_t* sn = snaps + static_cast<size_t>(b) * ne;
    for (int e = 0; e < ne; ++e) sn[e] = 0;

    Coder m;
    coder_init(m, bytebuf + static_cast<size_t>(b) * cap, cap, ctx + t, NT,
               qe);
    const uint8_t* s = syms + static_cast<size_t>(b) * stride;
    const int total = totals[b];
    int due = next_boundary(cnt, ne, 0, total);
    for (int i = 0; i < total; ++i) {
        const int sym = __ldg(s + i);
        encode(m, qe, sym & 31, sym >> 5);
        if (i + 1 == due) {
            for (int e = 0; e < ne; ++e)
                if (cnt[e] == due) sn[e] = m.cur - 1;
            due = next_boundary(cnt, ne, due, total);
        }
    }
    dlen[b] = flags[b] ? flush(m) : 0;
    cur[b] = m.cur;
}

}  // namespace

extern "C" int mq_scan_launch(
        const void* syms, const void* counts, const void* totals,
        const void* flags, const void* qe,
        int n, int L, int stride, int cap,
        void* bytebuf, void* snaps, void* dlen, void* cur, void* stream) {
    if (n <= 0) return 0;
    dim3 grid((n + NT - 1) / NT);
    mq_scan_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(syms),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(totals),
        static_cast<const int32_t*>(flags),
        static_cast<const int32_t*>(qe),
        n, L, stride, cap,
        static_cast<uint8_t*>(bytebuf), static_cast<int32_t*>(snaps),
        static_cast<int32_t*>(dlen), static_cast<int32_t*>(cur));
    return static_cast<int>(cudaGetLastError());
}

// Resident thread blocks (32 code-blocks, one warp each) per SM; L does
// not change it (the shared memory is static).
extern "C" int mq_scan_occupancy(int L, int* blocks_per_sm) {
    (void)L;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, mq_scan_kernel, NT, 0));
}
