// EBCOT CX/D context-modeling scan for Hopper (sm_90a), one CUDA thread
// per 64x64 code-block: the ordered ctx | d << 5 symbols each block's MQ
// coder would consume, the symbol cursor and the exact distortion pair
// at every pass end.
//
// Replaces the TPU kernel cxd_pallas
// (bucketeer_tpu/codec/pallas/cxd_scan.py:121, pallas_call at :133) and
// computes the same outputs as its plain PyTorch version
// (bucketeer_tpu_torch/kernels/cxd_scan.py, cxd_scan_plain).
//
// What bounds it on this card: the serial chain of one block's scan, as
// for fused_t1.cu (each decision's context depends on the decisions
// before it in coding order), plus the symbol stores. Its bytes bound is
// the coefficients in and one byte per symbol out over HBM bandwidth,
// three orders of magnitude below the chain.
//
// What the design does about it:
// - The scan is fused_t1's (run_pass of t1_common.cuh, bit-packed state
//   in shared memory, only the block's extent and realized planes), with
//   the SymbolSink in place of the MQ coder.
// - The symbol buffer, 53-200 KB per block, is far too large for shared
//   memory, so symbols go to the block's row of global memory,
//   buf[b, cur++]. The sink gathers four symbols into one 32-bit store,
//   a quarter of the store instructions of byte stores; the rows of one
//   warp's threads lie max_syms bytes apart, so stores do not coalesce
//   and the L2 cache merges each thread's sequential words.
// - Every counts, dh and dl entry is written, including passes that do
//   not exist (off 0 sigprop/magref: 0; offsets past the block's depth:
//   the final cursor and a zero pair), so the wrapper allocates with
//   torch.empty. Symbol bytes past a block's cursor carry no meaning.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include "t1_common.cuh"

namespace {

using namespace t1;

constexpr size_t SMEM_BYTES = WORDS * sizeof(uint64_t);

__global__ void __launch_bounds__(NT)
cxd_scan_kernel(const int32_t* __restrict__ blocks,
                const int32_t* __restrict__ nbps,
                const int32_t* __restrict__ floors,
                const int32_t* __restrict__ clss,
                const int32_t* __restrict__ hs,
                const int32_t* __restrict__ ws,
                const int32_t* __restrict__ zc_g,
                const int32_t* __restrict__ sc_ctx,
                const int32_t* __restrict__ sc_xor,
                int n, int L, int frac, int msym,
                uint8_t* __restrict__ buf, int32_t* __restrict__ counts,
                float* __restrict__ dh, float* __restrict__ dl,
                int32_t* __restrict__ cur) {
    __shared__ int zc[135];
    __shared__ int scx[25];
    extern __shared__ uint64_t smem[];

    load_scan_tables(zc, scx, zc_g, sc_ctx, sc_xor);
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
    for (int i = 0; i < L * 3; ++i) {
        const size_t at = static_cast<size_t>(b) * L * 3 + i;
        counts[at] = 0;
        dh[at] = 0.0f;
        dl[at] = 0.0f;
    }

    SymbolSink sink{buf + static_cast<size_t>(b) * msym, msym, 0, 0u};
    if (eff > 0) {
        block_reset(B);
        for (int off = 0; off < eff; ++off) {
            const int p = nbp - 1 - off;
            for (int kind = off == 0 ? 2 : 0; kind < 3; ++kind) {
                long long s = run_pass(B, sink, zc, scx, kind, p);
                size_t at = (static_cast<size_t>(b) * L + off) * 3 + kind;
                counts[at] = sink.cur;
                dist_pair(s, dh + at, dl + at);
            }
            for (int x = 0; x < CBLK; ++x) B.pi[x * NT] = 0;
        }
        sink.finish();
    }
    // Plane offsets past this block's depth are masked dead passes: the
    // cursor stands at its final value.
    for (int off = eff; off < L; ++off)
        for (int kind = 0; kind < 3; ++kind)
            counts[(static_cast<size_t>(b) * L + off) * 3 + kind] = sink.cur;
    cur[b] = sink.cur;
}

}  // namespace

extern "C" int cxd_scan_launch(
        const void* blocks, const void* nbps, const void* floors,
        const void* cls, const void* hs, const void* ws, const void* zc,
        const void* sc_ctx, const void* sc_xor,
        int n, int L, int frac, int msym,
        void* buf, void* counts, void* dh, void* dl, void* cur,
        void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        cxd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(SMEM_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    if (msym % 4) return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((n + NT - 1) / NT);
    cxd_scan_kernel<<<grid, NT, SMEM_BYTES,
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
        n, L, frac, msym,
        static_cast<uint8_t*>(buf), static_cast<int32_t*>(counts),
        static_cast<float*>(dh), static_cast<float*>(dl),
        static_cast<int32_t*>(cur));
    return static_cast<int>(cudaGetLastError());
}
