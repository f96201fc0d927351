// Host assembly of the fused Tier-1's outputs into columns, for
// codec/cxd.py (T1Columns, run_device_mq).
//
// Two entries:
// - t1_group_passes: one launch group's passes, in coding order, into
//   the chunk's per-pass columns. Block k's snapshot tables are indexed
//   by plane offset o from its MSB and pass type t; coding order is
//   row-major over (o, t) with the top plane's first two slots left out
//   and the planes from eff[k] on cut: 3 * eff[k] - 2 passes, written
//   from column index dst[k]. The truncation length is rate.py
//   truncation_lengths' rule (bytes at the pass boundary plus 4, capped
//   at the block's stream length); the distortion is copied as given.
// - t1_gather_bytes: every block's bytes, one copy each, from where the
//   fetch left them to the chunk's concatenation in block order.
//
// Nothing here allocates. One thread per call: the interpreter lock is
// released for the call (ctypes).
//
// Built by g++ -O3 -std=c++17 -fPIC -shared -pthread at first use
// (kernels/build.py) and bound with ctypes (codec/cxd.py).

#include <cstdint>
#include <cstring>

extern "C" {

void t1_group_passes(int g, int L, const int64_t* eff, const int32_t* nbps,
                     const int32_t* snaps, const int32_t* dlen,
                     const double* dists, const int64_t* dst,
                     int32_t* types, int32_t* planes, int64_t* cum_len,
                     double* dist) {
    for (int k = 0; k < g; ++k) {
        int64_t at = dst[k];
        const int64_t cap = dlen[k];
        for (int64_t o = 0; o < eff[k]; ++o) {
            for (int t = o == 0 ? 2 : 0; t < 3; ++t, ++at) {
                const int64_t i = ((int64_t)k * L + o) * 3 + t;
                const int64_t len = (int64_t)snaps[i] + 4;
                types[at] = t;
                planes[at] = (int32_t)(nbps[k] - 1 - o);
                cum_len[at] = len < cap ? len : cap;
                dist[at] = dists[i];
            }
        }
    }
}

void t1_gather_bytes(int n, const int64_t* src, const int64_t* len,
                     const int64_t* off, uint8_t* data) {
    for (int b = 0; b < n; ++b) {
        if (len[b] > 0) {
            std::memcpy(data + off[b],
                        reinterpret_cast<const uint8_t*>(src[b]),
                        (size_t)len[b]);
        }
    }
}

}  // extern "C"
