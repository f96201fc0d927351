// EBCOT CX/D context-modeling scan for Hopper (sm_90a), one warp per
// 64x64 code-block: the ordered ctx | d << 5 symbols each block's MQ
// coder would consume, the symbol cursor and the exact distortion pair
// at every pass end.
//
// Replaces the TPU kernel cxd_pallas
// (bucketeer_tpu/codec/pallas/cxd_scan.py:121, pallas_call at :133) and
// computes the same outputs as its plain PyTorch version
// (bucketeer_tpu_torch/kernels/cxd_scan.py, cxd_scan_plain).
//
// What bounds it on this card: the serial chain of one block's scan, as
// for fused_t1.cu, without the MQ coder's share. Its bytes bound (the
// extents in, one byte per symbol out, over HBM bandwidth) is 0.0175 ms
// at the main path's L=8 group; the longest block's chain alone is
// ~110 times that and a launch ~180 times (PERF.md).
//
// What the design does about it:
// - The scan is fused_t1's (scan_block of t1_common.cuh): one warp per
//   code-block, the block loaded once into bit planes in shared memory,
//   lane 0 coding from registers and shared memory only, the helper
//   lanes preparing stripes, forming refinement symbols and summing
//   distortion. Shared memory per block: scan_words(L) words, a 1 KB
//   symbol ring and the per-pass results, 8.6 KB at L=8 and 13.0 KB at
//   L=16 beside 0.8 KB of tables (22 and 15 resident blocks per SM;
//   cxd_scan_occupancy reports it).
// - Symbols go to the ring in shared memory (one byte store on the
//   chain); at every stripe end the warp stores the ring's full 128-byte
//   segments to the block's row, one word per lane, so each store
//   instruction writes one whole line. The symbol buffer (53-200 KB per
//   block) is far too large for shared memory itself.
// - Every counts, dh and dl entry is written once at the block's end,
//   including passes that do not exist (off 0 sigprop/magref: 0;
//   offsets past the block's depth: the final cursor and a zero pair),
//   so the wrapper allocates with torch.empty. Symbol bytes past a
//   block's cursor carry no meaning.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include "t1_common.cuh"

namespace {

using namespace t1;

// Dynamic shared memory per thread block at plane budget L: scan state,
// the symbol ring, the results.
size_t smem_bytes(int L) {
    return scan_words(L) * sizeof(uint64_t) + RING + results_bytes(L);
}

__global__ void __launch_bounds__(WARP)
cxd_scan_kernel(const int32_t* __restrict__ blocks,
                const int32_t* __restrict__ nbps,
                const int32_t* __restrict__ floors,
                const int32_t* __restrict__ clss,
                const int32_t* __restrict__ hs,
                const int32_t* __restrict__ ws,
                const int32_t* __restrict__ zc_g,
                const int32_t* __restrict__ sc_ctx,
                const int32_t* __restrict__ sc_xor,
                int L, int frac, int msym,
                uint8_t* __restrict__ buf, int32_t* __restrict__ counts,
                float* __restrict__ dh, float* __restrict__ dl,
                int32_t* __restrict__ cur) {
    __shared__ uint8_t zlut[3 * 256];
    __shared__ uint8_t scx[32];
    extern __shared__ uint64_t smem[];

    const int lane = threadIdx.x;
    const size_t b = blockIdx.x;
    load_scan_tables(zlut, scx, zc_g, sc_ctx, sc_xor, lane);

    const int nbp = nbps[b], floor = floors[b];
    const int eff = max(nbp - floor, 0);
    const Scan S = scan_layout(smem, L, hs[b], ws[b], clss[b], zlut, scx);
    uint8_t* ring = reinterpret_cast<uint8_t*>(smem + scan_words(L));
    const Results R = results_layout(ring + RING, L);
    results_clear(R, L, lane);
    __syncwarp();

    RingSink sink{ring, buf + b * msym, msym, 0, 0};
    if (eff > 0) {
        scan_block(S, sink, R, blocks + b * CBLK * CBLK, frac, floor, nbp,
                   eff, lane);
        sink.warp_flush(lane, true);
    }
    // Plane offsets past this block's depth are masked dead passes: the
    // cursor stands at its final value.
    results_store(R, L, eff, sink.cur, lane, counts + b * L * 3,
                  dh + b * L * 3, dl + b * L * 3);
    if (lane == 0) cur[b] = sink.cur;
}

}  // namespace

extern "C" int cxd_scan_launch(
        const void* blocks, const void* nbps, const void* floors,
        const void* cls, const void* hs, const void* ws, const void* zc,
        const void* sc_ctx, const void* sc_xor,
        int n, int L, int frac, int msym,
        void* buf, void* counts, void* dh, void* dl, void* cur,
        void* stream) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        cxd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    if (msym % 4) return static_cast<int>(cudaErrorInvalidValue);
    cxd_scan_kernel<<<n, WARP, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(blocks),
        static_cast<const int32_t*>(nbps),
        static_cast<const int32_t*>(floors),
        static_cast<const int32_t*>(cls),
        static_cast<const int32_t*>(hs),
        static_cast<const int32_t*>(ws),
        static_cast<const int32_t*>(zc),
        static_cast<const int32_t*>(sc_ctx),
        static_cast<const int32_t*>(sc_xor),
        L, frac, msym,
        static_cast<uint8_t*>(buf), static_cast<int32_t*>(counts),
        static_cast<float*>(dh), static_cast<float*>(dl),
        static_cast<int32_t*>(cur));
    return static_cast<int>(cudaGetLastError());
}

// Resident thread blocks (= code-blocks, one warp each) per SM at plane
// budget L.
extern "C" int cxd_scan_occupancy(int L, int* blocks_per_sm) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        cxd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, cxd_scan_kernel, WARP, smem));
}
