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
//   (run_pass with the MqSink of t1_common.cuh; the TPU kernel held
//   ~196 KB of symbols per block in VMEM, more than one H100 block's
//   shared memory beside anything else). Bytes go straight into the
//   block's output row range, dummy pre-byte at 0.
// - Scan state is bit-packed in shared memory, 2 KB per code-block,
//   and the 19 MQ context states sit beside it (t1_common.cuh).
// - Each thread loops only over its block's own extent and its
//   realized planes (nbp - floor); a dead block does nothing.
// - Distortion: 4 x distortion of each pass is summed exactly in 64-bit
//   integers from the float32-rounded factors and emitted as the
//   canonical float32 pair (fl(S), S - fl(S)); no float arithmetic is
//   left for the compiler to contract into FMAs.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include "t1_common.cuh"

namespace {

using namespace t1;

// Dynamic shared memory per thread block: scan state, then the MQ
// context states.
constexpr size_t SMEM_BYTES = WORDS * sizeof(uint64_t) + NCTX * NT;

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

    load_scan_tables(zc, scx, zc_g, sc_ctx, sc_xor);
    load_qe(qe, qe_g);
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
    block_state(B, smem, t);
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
    m.nsym = 0;
    m.cur = 1;

    if (eff > 0) {
        block_reset(B);
        coder_init(m, rows + static_cast<size_t>(b) * cap, cap,
                   reinterpret_cast<uint8_t*>(smem + WORDS) + t);
        MqSink sink{m, qe};

        for (int off = 0; off < eff; ++off) {
            const int p = nbp - 1 - off;
            for (int kind = off == 0 ? 2 : 0; kind < 3; ++kind) {
                long long s = run_pass(B, sink, zc, scx, kind, p);
                size_t at = (static_cast<size_t>(b) * L + off) * 3 + kind;
                snaps[at] = m.cur - 1;
                dist_pair(s, dh + at, dl + at);
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
