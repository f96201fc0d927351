// The MQ arithmetic coder (T.800 Annex C) over given ctx | d << 5 symbol
// streams for Hopper (sm_90a), one warp per code-block: the coded bytes,
// the byte count at every pass boundary, the data length and the byte
// cursor.
//
// Replaces the TPU kernel mq_pallas
// (bucketeer_tpu/codec/pallas/mq_scan.py:74, pallas_call at :85; body
// _mq_block at :46) and computes the same outputs as its plain PyTorch
// version (bucketeer_tpu_torch/kernels/mq_scan.py, mq_scan_plain): the
// semantics of cxd._mq_run with a trip budget at least every block's
// symbol total, which the wrapper checks.
//
// What bounds it on this card: the serial chain of one block's coder
// registers (each decision's interval update depends on the one
// before). Its bytes bound, the symbols in and the coded bytes out over
// HBM bandwidth, is about three orders of magnitude below that chain at
// the main path's L=8 group (PERF.md), so a launch can take no less
// than its longest block's chain, and the design makes one decision as
// short as it can and has every block start at once:
//
// - One thread block of one warp per code-block. Lane 0 is the coder
//   and the only lane that branches on the data, so no decision waits
//   for another block's path. The other lanes set up (the successor
//   table, the pass boundaries in order), stage the symbols, turn each
//   chunk of them into decision words and store the boundaries' byte
//   counts at the end, coalesced. 4-5 KB of shared memory per block, so
//   32 blocks are resident per SM and the L=8 group (1,752 blocks) runs
//   in one wave on all 132 SMs (mq_scan_occupancy reports it).
// - No global load on the chain: the warp stages the block's symbols
//   into two slots of shared memory, CHUNK at a time. While lane 0 codes
//   one chunk, the copy into the other slot is in flight (cp.async, 16
//   bytes a lane, for rows that start on 16 bytes; byte loads before the
//   coding for the others). The copies stop at the block's own total,
//   never at the launch's longest.
// - Little work per decision besides the chain: before lane 0 codes a
//   chunk, the warp turns its symbols into decision words that carry the
//   context's state address, the decision bit placed where the state
//   word has its MPS (one XOR compares them), and whether either of the
//   two decisions before used the same context.
// - The context-state load off the chain: a decision's state word is
//   read two decisions ahead, and the words of both its successor
//   states (one 8-byte load, found by the state's own index) one ahead,
//   while the decisions before it are coded; where one of the two
//   decisions before used the same context, the word it wrote is
//   forwarded instead. The decision loop is unrolled four times, so no
//   read waits at a register move. Renormalization stays the
//   leading-zero count of t1_common.cuh's renorm.
// - Pass boundaries are one compare: the warp sorts the block's L x 3
//   counts once (a rank sort that keeps each count's entry), and lane 0
//   codes straight up to the next boundary before it stores that byte
//   count into every entry with that count. A count not in [1, total]
//   is never reached and keeps 0.
// - Coded bytes go straight to the block's output row, as in fused_t1:
//   a store is not waited on, so it is not on the chain, and BYTEOUT's
//   carry into the byte at cur - 1 is a second store to the same place.
//   Bytes at or past cap are dropped while the cursor still counts them
//   (t1_common.cuh put), and the wrapper's caller checks the cursor.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include <climits>
#include <cstdint>

#include "t1_common.cuh"

namespace {

using namespace t1;

// Symbols staged per slot (kernels/mq_scan.py MQ_CHUNK); a slot's tail
// takes the coder's lookahead past its chunk.
constexpr int CHUNK = 512;
constexpr int SLOT = CHUNK + 16;
constexpr int NCTX_PAD = 32;         // a context number is 5 bits

// Dynamic shared memory per thread block at plane budget L: the two
// symbol slots, the chunk's decision words, the successor pairs, the
// context states, and per pass entry its count, the boundaries in order
// with their entries, and its byte count.
size_t smem_bytes(int L) {
    return 2 * SLOT + (CHUNK + 4) * sizeof(uint32_t)
        + (NQE + 1) * sizeof(uint2) + NCTX_PAD * sizeof(uint32_t)
        + 4 * 3 * L * sizeof(int32_t);
}

// All lanes: start copying the block's symbols [lo, hi) into slot. A row
// on 16 bytes goes by cp.async, 16 bytes a lane, reading nothing past hi
// (the last unit's rest is zero-filled); the caller waits before the
// slot is read. Any other row is copied byte by byte now.
__device__ __forceinline__ void stage(uint8_t* slot, const uint8_t* row,
                                      int lo, int hi, bool vec, int lane) {
    if (vec) {
        for (int u = lo + 16 * lane; u < hi; u += 16 * WARP) {
            const unsigned dst = static_cast<unsigned>(
                __cvta_generic_to_shared(slot + (u - lo)));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                         :: "r"(dst), "l"(row + u), "r"(min(16, hi - u))
                         : "memory");
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
    } else {
        for (int j = lo + lane; j < hi; j += WARP)
            slot[j - lo] = __ldg(row + j);
    }
}

__device__ __forceinline__ void staged(bool vec) {
    if (vec) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A context state word: Qe in bits 0-15, the state's own index in
// 16-21, SWITCH in bit 22, MPS in bit 31. (fused_t1's word carries the
// successor indices instead; here the index finds both successors' words
// with one 8-byte load from the pair table.)
__device__ __forceinline__ uint32_t state_word(const int32_t* qe_g, int j) {
    return static_cast<uint32_t>(qe_g[j * 4])
        | (static_cast<uint32_t>(j) << 16)
        | (static_cast<uint32_t>(qe_g[j * 4 + 3]) << 22);
}

// A decision word, made by the helper lanes from a symbol ctx | d << 5:
// the context's byte offset in the state array (bits 0-6), whether the
// decision before used the same context (bit 7), whether the one before
// that did (bit 8), d > 1 (bit 30, which no MPS equals) and d's low bit
// (bit 31, where the state word has its MPS). Flags 7 and 8 count only
// decisions of the same chunk, since the coder reads the states afresh
// at each chunk's start.
constexpr uint32_t W_OFF = 0x7Cu, W_SAME1 = 0x80u, W_SAME2 = 0x100u;

// All lanes: the decision words of a slot's n symbols, and 4 zero words
// after them for the coder's lookahead.
__device__ __forceinline__ void decode_chunk(uint32_t* dw,
                                             const uint8_t* slot, int n,
                                             int lane) {
    for (int j = lane; j < n + 4; j += WARP) {
        uint32_t w = 0;
        if (j < n) {
            const uint32_t sym = slot[j], cx = sym & 31u, d = sym >> 5;
            w = cx * 4 | (static_cast<uint32_t>(d > 1) << 30) | (d << 31);
            if (j >= 1 && (slot[j - 1] & 31u) == cx) w |= W_SAME1;
            if (j >= 2 && (slot[j - 2] & 31u) == cx) w |= W_SAME2;
        }
        dw[j] = w;
    }
}

__device__ __forceinline__ uint32_t& state_at(uint8_t* ctx, uint32_t w) {
    return *reinterpret_cast<uint32_t*>(ctx + (w & W_OFF));
}

// One decision, T.800 C.2.2-C.2.3 ENCODE as t1_common.cuh encode
// computes it, with the context's state word st and the words of both
// its successor states (t.x after an MPS renormalization, t.y after an
// LPS) given instead of loaded. Returns the context's state after the
// decision (st itself when an MPS leaves A >= 0x8000) and stores it when
// it changed.
__device__ __forceinline__ uint32_t decide(Coder& m, uint8_t* ctx,
                                           uint32_t w, uint32_t st,
                                           uint2 t) {
    const uint32_t q = st & 0xFFFFu, mps = st >> 31;
    const uint32_t a1 = m.a - q;               // A is below 0x10000
    const bool is_mps = ((w ^ st) >> 30) == 0;
    if (is_mps && a1 >= 0x8000u) {
        m.a = a1;
        m.c += q;
        return st;
    }
    const bool exch = a1 < q;
    m.a = is_mps == exch ? q : a1;
    if (is_mps != exch) m.c += q;
    st = is_mps ? (t.x | (mps << 31))
                : (t.y | ((mps ^ ((st >> 22) & 1u)) << 31));
    state_at(ctx, w) = st;
    renorm(m);
    return st;
}

// The pass boundaries in order: the count of boundary k, the entry it
// belongs to, the entries' byte counts, and the next boundary due.
struct Boundaries {
    const int32_t* at;
    const int32_t* entry;
    int32_t* snap;
    int n;
    int k;
    int due;
};

// Lane 0: code decisions [i, hi) of a chunk's words (w[i] is decision
// i), recording every boundary reached on the way, hi's included.
// Nothing the coder's registers wait on is loaded in the decision that
// needs it: the words are read three decisions ahead; a decision's
// context state two ahead, before the store of the decision two before
// it, so where that decision or the one after it used the same context
// the state it wrote is taken instead; the successor pair one ahead.
__device__ __forceinline__ void code_chunk(Coder& m, const uint2* pairs,
                                           uint8_t* ctx, const uint32_t* w,
                                           int i, int hi, Boundaries& bd) {
    uint32_t w0 = w[i], w1 = w[i + 1], w2 = w[i + 2];
    uint32_t st = state_at(ctx, w0);             // this decision's state
    uint32_t raw1 = state_at(ctx, w1);           // the next one's, as read
    uint2 t = pairs[(st >> 16) & 63u];
    uint32_t pns = 0;                            // the decision before's
    for (;;) {
        const int stop = min(hi, bd.due);
        const uint32_t* p = w + i + 3;
        const uint32_t* const end = w + stop + 3;
#pragma unroll 4
        for (; p != end; ++p) {
            const uint32_t raw2 = state_at(ctx, w2);
            const uint32_t w3 = *p;
            const uint32_t ns = decide(m, ctx, w0, st, t);
            st = (w1 & W_SAME1) ? ns : (w1 & W_SAME2) ? pns : raw1;
            t = pairs[(st >> 16) & 63u];
            raw1 = raw2;
            pns = ns;
            w0 = w1;
            w1 = w2;
            w2 = w3;
        }
        i = stop;
        if (i == bd.due) {
            while (bd.k < bd.n && bd.at[bd.k] == i) {
                bd.snap[bd.entry[bd.k]] = m.cur - 1;
                bd.k += 1;
            }
            bd.due = bd.k < bd.n ? bd.at[bd.k] : INT_MAX;
        }
        if (i >= hi) return;
    }
}

__global__ void __launch_bounds__(WARP, 16)
mq_scan_kernel(const uint8_t* __restrict__ syms,
               const int32_t* __restrict__ counts,
               const int32_t* __restrict__ totals,
               const int32_t* __restrict__ flags,
               const int32_t* __restrict__ qe_g,
               int L, int stride, int cap,
               uint8_t* __restrict__ bytebuf, int32_t* __restrict__ snaps,
               int32_t* __restrict__ dlen, int32_t* __restrict__ cur) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint32_t* dw = reinterpret_cast<uint32_t*>(smem + 2 * SLOT);
    uint2* pairs = reinterpret_cast<uint2*>(dw + CHUNK + 4);
    uint32_t* ctx = reinterpret_cast<uint32_t*>(pairs + NQE + 1);
    const int ne = 3 * L;
    int32_t* cnt = reinterpret_cast<int32_t*>(ctx + NCTX_PAD);
    int32_t* at = cnt + ne;
    int32_t* entry = at + ne;
    int32_t* snap = entry + ne;

    const int lane = threadIdx.x;
    const size_t b = blockIdx.x;
    const int total = totals[b];
    const uint8_t* row = syms + b * stride;
    const bool vec = (reinterpret_cast<uintptr_t>(row) & 15u) == 0;
    const int n_chunks = (total + CHUNK - 1) / CHUNK;
    if (n_chunks > 0) stage(smem, row, 0, min(total, CHUNK), vec, lane);

    // Each state's successor pair (NMPS, NLPS), and the contexts' states
    // at the start of a stream (Table D.7; 0 past the 19 contexts).
    for (int k = lane; k < NQE; k += WARP)
        pairs[k] = make_uint2(state_word(qe_g, qe_g[k * 4 + 1]),
                              state_word(qe_g, qe_g[k * 4 + 2]));
    ctx[lane] = lane >= NCTX ? 0u
        : state_word(qe_g, lane == 0 ? 4 : lane == CTX_RL ? 3
                     : lane == CTX_UNI ? 46 : 0);
    for (int e = lane; e < ne; e += WARP) {
        cnt[e] = counts[b * ne + e];
        snap[e] = 0;
    }
    __syncwarp();
    // Each in-range count's rank among the in-range ones, ties in entry
    // order.
    int mine = 0;
    for (int e = lane; e < ne; e += WARP) {
        const int c = cnt[e];
        if (c < 1 || c > total) continue;
        int r = 0;
        for (int j = 0; j < ne; ++j) {
            const int d = cnt[j];
            r += d >= 1 && d <= total && (d < c || (d == c && j < e));
        }
        at[r] = c;
        entry[r] = e;
        mine += 1;
    }
    const int n_due = __reduce_add_sync(FULL, mine);

    // The coder registers as coder_init sets them, with the dummy
    // pre-byte at 0.
    Coder m;
    if (lane == 0) {
        m.a = 0x8000u;
        m.c = 0;
        m.ct = 12;
        m.cur = 1;
        m.last = 0;
        m.out = bytebuf + b * cap;
        m.cap = cap;
        put(m, 0, 0);
    }
    Boundaries bd{at, entry, snap, n_due, 0, INT_MAX};
    staged(vec);
    __syncwarp();
    if (n_due > 0) bd.due = at[0];
    for (int k = 0; k < n_chunks; ++k) {
        const int lo = k * CHUNK, hi = min(total, lo + CHUNK);
        decode_chunk(dw, smem + (k & 1) * SLOT, hi - lo, lane);
        __syncwarp();
        if (k + 1 < n_chunks)
            stage(smem + ((k + 1) & 1) * SLOT, row, hi,
                  min(total, hi + CHUNK), vec, lane);
        if (lane == 0)
            code_chunk(m, pairs, reinterpret_cast<uint8_t*>(ctx), dw - lo,
                       lo, hi, bd);
        staged(vec);
        __syncwarp();
    }
    if (lane == 0) {
        dlen[b] = flags[b] ? flush(m) : 0;
        cur[b] = m.cur;
    }
    __syncwarp();
    for (int e = lane; e < ne; e += WARP) snaps[b * ne + e] = snap[e];
}

}  // namespace

extern "C" int mq_scan_launch(
        const void* syms, const void* counts, const void* totals,
        const void* flags, const void* qe,
        int n, int L, int stride, int cap,
        void* bytebuf, void* snaps, void* dlen, void* cur, void* stream) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        mq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (n <= 0) return 0;
    mq_scan_kernel<<<n, WARP, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(syms),
        static_cast<const int32_t*>(counts),
        static_cast<const int32_t*>(totals),
        static_cast<const int32_t*>(flags),
        static_cast<const int32_t*>(qe),
        L, stride, cap,
        static_cast<uint8_t*>(bytebuf), static_cast<int32_t*>(snaps),
        static_cast<int32_t*>(dlen), static_cast<int32_t*>(cur));
    return static_cast<int>(cudaGetLastError());
}

// Resident thread blocks (= code-blocks, one warp each) per SM at plane
// budget L.
extern "C" int mq_scan_occupancy(int L, int* blocks_per_sm) {
    const size_t smem = smem_bytes(L);
    cudaError_t err = cudaFuncSetAttribute(
        mq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, mq_scan_kernel, WARP, smem));
}
