// The host back half: PCRD-opt layer allocation and Tier-2 packet
// writing (T.800 Annex B; EBCOT's post-compression rate-distortion
// optimization), for codec/t2_native.py.
//
// Two entries, called once per Tier-2 build by codec/encoder.py _finish:
// - t2_allocate: each code-block's convex hull of truncation points, the
//   global slope order of the hull segments and the per-layer byte
//   budgets, giving every block's cumulative (passes, bytes) boundary
//   after each quality layer. Mirrors codec/rate.py allocate.
// - t2_write: the packets of every tile-part in codestream order (tag
//   trees for inclusion and zero bit-planes, pass counts, Lblock lengths,
//   SOP/EPH markers and the packet bodies), from the boundaries and a
//   packet plan made once per encode. Mirrors codec/t2.py encode_packet
//   and encoder._tile_parts.
// t2_result_sizes and t2_result_take hand the written bytes back.
//
// The output is byte-identical to the Python versions, lossy included:
// the float64 arithmetic keeps their order of operations, and no
// multiply-add is contracted (the pragma below; the build sets no
// -march). One thread per call: the interpreter lock is released for
// the call (ctypes), which is what lets other Python threads run.
//
// Built by g++ -O3 -std=c++17 -fPIC -shared -pthread at first use
// (kernels/build.py) and bound with ctypes (codec/t2_native.py).
#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// ---- PCRD-opt (codec/rate.py) ----

struct HullPt {
    int32_t pass;        // -1 for the origin
    int64_t len;
    double dist;
};

struct Segment {
    double slope;
    int32_t block;
    int32_t seg;
    int64_t dlen;
    int32_t pass;
    int64_t cum_len;
};

// rate._hull: the upper convex hull of a block's truncation points,
// with its tie rules.
void block_hull(const int64_t *cum_len, const double *dist, int n,
                double weight, std::vector<HullPt> &hull) {
    hull.clear();
    hull.push_back({-1, 0, 0.0});
    double cum = 0.0;
    for (int i = 0; i < n; ++i) {
        cum += dist[i] * weight;
        const HullPt pt{i, cum_len[i], cum};
        if (pt.len <= hull.back().len) {
            if (pt.dist >= hull.back().dist && hull.size() > 1)
                hull.back() = pt;
            continue;
        }
        while (hull.size() >= 2) {
            const HullPt &a = hull[hull.size() - 2];
            const HullPt &b = hull.back();
            const double lhs = (pt.dist - a.dist) * double(b.len - a.len);
            const double rhs = (b.dist - a.dist) * double(pt.len - a.len);
            if (lhs >= rhs)
                hull.pop_back();
            else
                break;
        }
        if (pt.dist > hull.back().dist) hull.push_back(pt);
    }
}

// ---- Tier-2 (codec/t2.py) ----

// MSB-first bit packer with bit-stuffing after 0xFF (B.10.1).
struct BitWriter {
    std::vector<uint8_t> bytes;
    uint32_t acc = 0;
    int nbits = 0;

    void reset() { bytes.clear(); acc = 0; nbits = 0; }
    int cap() const {
        return (!bytes.empty() && bytes.back() == 0xFF) ? 7 : 8;
    }
    void put_bit(int b) {
        acc = (acc << 1) | uint32_t(b & 1);
        if (++nbits == cap()) {
            bytes.push_back(uint8_t(acc));
            acc = 0;
            nbits = 0;
        }
    }
    void put_bits(uint64_t value, int n) {
        for (int i = n - 1; i >= 0; --i) put_bit(int((value >> i) & 1));
    }
    void flush() {
        if (nbits) {
            acc <<= (cap() - nbits);
            bytes.push_back(uint8_t(acc));
            acc = 0;
            nbits = 0;
        }
        if (!bytes.empty() && bytes.back() == 0xFF) bytes.push_back(0x00);
    }
};

// 2-D tag tree (B.10.2): levels of running minima, each node with the
// value, the lowest value still possible and whether it was sent.
struct TagTree {
    std::vector<int> lw, lh, off;    // per level: width, height, offset
    std::vector<int32_t> value, low;
    std::vector<uint8_t> known;

    void init(int w, int h, const int32_t *leaves) {
        lw.clear(); lh.clear(); off.clear();
        int cw = w, ch = h, total = 0;
        while (true) {
            lw.push_back(cw);
            lh.push_back(ch);
            off.push_back(total);
            total += cw * ch;
            if (cw <= 1 && ch <= 1) break;
            cw = (cw + 1) / 2;
            ch = (ch + 1) / 2;
        }
        value.assign(total, 0);
        low.assign(total, 0);
        known.assign(total, 0);
        std::memcpy(value.data(), leaves, sizeof(int32_t) * w * h);
        for (size_t l = 1; l < lw.size(); ++l) {
            const int pw = lw[l - 1], ph = lh[l - 1];
            const int32_t *up = &value[off[l - 1]];
            int32_t *cur = &value[off[l]];
            for (int y = 0; y < lh[l]; ++y)
                for (int x = 0; x < lw[l]; ++x) {
                    int32_t m = std::numeric_limits<int32_t>::max();
                    for (int dy = 0; dy < 2; ++dy)
                        for (int dx = 0; dx < 2; ++dx) {
                            const int cy = 2 * y + dy, cx = 2 * x + dx;
                            if (cy < ph && cx < pw)
                                m = std::min(m, up[cy * pw + cx]);
                        }
                    cur[y * lw[l] + x] = m;
                }
        }
    }

    void encode(BitWriter &bw, int x, int y, int threshold) {
        int lo = 0;
        for (int lev = int(lw.size()) - 1; lev >= 0; --lev) {
            const int idx = off[lev] + (y >> lev) * lw[lev] + (x >> lev);
            if (lo > low[idx])
                low[idx] = lo;
            else
                lo = low[idx];
            while (lo < threshold) {
                if (lo >= value[idx]) {
                    if (!known[idx]) {
                        bw.put_bit(1);
                        known[idx] = 1;
                    }
                    break;
                }
                bw.put_bit(0);
                ++lo;
            }
            low[idx] = lo;
        }
    }
};

void put_npasses(BitWriter &bw, int n) {
    if (n == 1) {
        bw.put_bit(0);
    } else if (n == 2) {
        bw.put_bits(0b10, 2);
    } else if (n <= 5) {
        bw.put_bits(0b11, 2);
        bw.put_bits(n - 3, 2);
    } else if (n <= 36) {
        bw.put_bits(0b1111, 4);
        bw.put_bits(n - 6, 5);
    } else {
        bw.put_bits(0b111111111, 9);
        bw.put_bits(n - 37, 7);
    }
}

int floor_log2(int64_t n) {
    int r = -1;
    while (n) { n >>= 1; ++r; }
    return r;
}

// One block's contribution to one layer: its new passes and the slice
// of its data they add (encoder._block_layers).
struct Contribution {
    int32_t npasses;
    int64_t begin, len;
};

struct Result {
    std::vector<uint8_t> bytes;
    std::vector<int64_t> part_bytes;
    std::vector<int32_t> packet_lens;
};

}  // namespace

extern "C" {

// Layer allocation (rate.allocate) of n_blocks blocks. Block b has the
// passes [pass_off[b], pass_off[b+1]) of cum_len / dist and the bytes
// [data_off[b], data_off[b+1]) of the data. With has_budget 0 (no
// target, lossless) the last layer carries every pass. Writes the
// cumulative (passes, bytes) after each layer to out_passes / out_bytes
// (n_blocks x n_layers, row-major); returns the number of hull segments.
int t2_allocate(int n_blocks, const int32_t *pass_off,
                const int64_t *cum_len, const double *dist,
                const int64_t *data_off, const double *weights,
                int n_layers, double budget, int has_budget,
                int32_t *out_passes, int64_t *out_bytes) {
    std::vector<Segment> segs;
    std::vector<HullPt> hull;
    int64_t total = 0;
    for (int b = 0; b < n_blocks; ++b) {
        const int p0 = pass_off[b];
        block_hull(cum_len + p0, dist + p0, pass_off[b + 1] - p0,
                   weights[b], hull);
        for (size_t s = 1; s < hull.size(); ++s) {
            const HullPt &a = hull[s - 1], &c = hull[s];
            const int64_t dlen = c.len - a.len;
            segs.push_back({(c.dist - a.dist) / double(dlen), b, int32_t(s),
                            dlen, c.pass, c.len});
            total += dlen;
        }
    }
    // Steepest slope first; ties by block, then segment.
    std::sort(segs.begin(), segs.end(),
              [](const Segment &x, const Segment &y) {
                  if (x.slope != y.slope) return x.slope > y.slope;
                  if (x.block != y.block) return x.block < y.block;
                  return x.seg < y.seg;
              });
    // rate.layer_budgets: halvings ending at the target.
    const double final_budget = has_budget ? budget : double(total);
    std::vector<double> budgets(n_layers);
    for (int l = 0; l < n_layers; ++l)
        budgets[l] = final_budget / double(int64_t(1) << (n_layers - 1 - l));
    if (!has_budget)
        budgets[n_layers - 1] = std::numeric_limits<double>::infinity();

    std::vector<int32_t> st_pass(n_blocks, 0);
    std::vector<int64_t> st_bytes(n_blocks, 0);
    int64_t cum = 0;
    size_t si = 0;
    for (int l = 0; l < n_layers; ++l) {
        while (si < segs.size()) {
            const Segment &s = segs[si];
            if (double(cum + s.dlen) > budgets[l]) break;
            cum += s.dlen;
            st_pass[s.block] = s.pass + 1;
            st_bytes[s.block] = s.cum_len;
            ++si;
        }
        for (int b = 0; b < n_blocks; ++b) {
            out_passes[int64_t(b) * n_layers + l] = st_pass[b];
            out_bytes[int64_t(b) * n_layers + l] = st_bytes[b];
        }
    }
    if (!has_budget) {
        for (int b = 0; b < n_blocks; ++b) {
            if (pass_off[b + 1] > pass_off[b]) {
                out_passes[int64_t(b) * n_layers + n_layers - 1] =
                    pass_off[b + 1] - pass_off[b];
                out_bytes[int64_t(b) * n_layers + n_layers - 1] =
                    data_off[b + 1] - data_off[b];
            }
        }
    }
    return int(segs.size());
}

// The packets of every tile-part, from the layer boundaries (as
// t2_allocate writes them) and the packet plan:
// - band-precinct k is a bp_dims[2k] x bp_dims[2k+1] grid of the blocks
//   bp_blocks[bp_off[k] .. bp_off[k+1]) (row-major), whose missing
//   bit-planes are bp_zbp[...];
// - precinct record r < n_records holds the band-precincts
//   [rec_off[r], rec_off[r+1]);
// - packet i, in codestream order, is record pkts[3i] at layer
//   pkts[3i+1], with SOP sequence number pkts[3i+2] (-1: no SOP);
// - tile-part j holds the packets [part_off[j], part_off[j+1]).
// Returns a handle for t2_result_sizes / t2_result_take.
void *t2_write(const uint8_t *data, const int64_t *data_off,
               const int32_t *passes, const int64_t *bytes, int n_layers,
               const int32_t *bp_dims, const int32_t *bp_off,
               const int32_t *bp_blocks, const int32_t *bp_zbp,
               const int32_t *rec_off, int n_records, const int32_t *pkts,
               int n_parts,
               const int32_t *part_off, int use_eph) {
    // Every band-precinct entry's per-layer contributions, and the
    // trees' leaves: the first layer a block contributes to (n_layers if
    // none) and its missing bit-planes (0 if never included).
    const int32_t n_bps = rec_off[n_records];
    const int32_t n_entries = bp_off[n_bps];
    const int32_t n_packets = part_off[n_parts];
    std::vector<Contribution> contrib(int64_t(n_entries) * n_layers);
    std::vector<int32_t> incl_leaf(n_entries), zbp_leaf(n_entries);
    int64_t body_total = 0;
    for (int32_t e = 0; e < n_entries; ++e) {
        const int32_t b = bp_blocks[e];
        const int64_t dbeg = data_off[b], dlen = data_off[b + 1] - dbeg;
        const int32_t *bp_pass = passes + int64_t(b) * n_layers;
        const int64_t *bp_byte = bytes + int64_t(b) * n_layers;
        int32_t prev_p = 0;
        int64_t prev_b = 0;
        int first = n_layers;
        for (int l = 0; l < n_layers; ++l) {
            Contribution &c = contrib[int64_t(e) * n_layers + l];
            c.npasses = 0;
            c.begin = dbeg;
            c.len = 0;
            if (bp_pass[l] > prev_p) {
                // data[prev_b:cb], clamped as a Python slice is.
                const int64_t lo = std::min(prev_b, dlen);
                const int64_t hi = std::min(bp_byte[l], dlen);
                c.npasses = bp_pass[l] - prev_p;
                c.begin = dbeg + lo;
                c.len = std::max<int64_t>(0, hi - lo);
                prev_p = bp_pass[l];
                prev_b = bp_byte[l];
                body_total += c.len;
                if (first == n_layers) first = l;
            }
        }
        incl_leaf[e] = first;
        zbp_leaf[e] = first < n_layers ? bp_zbp[e] : 0;
    }
    std::vector<TagTree> incl(n_bps), zbp(n_bps);
    for (int32_t k = 0; k < n_bps; ++k) {
        const int w = bp_dims[2 * k], h = bp_dims[2 * k + 1];
        if (w * h == 0) continue;
        incl[k].init(w, h, &incl_leaf[bp_off[k]]);
        zbp[k].init(w, h, &zbp_leaf[bp_off[k]]);
    }
    std::vector<int32_t> included_in(n_entries, -1), lblock(n_entries, 3);

    Result *res = new Result();
    // The bodies, plus room for the headers and markers.
    res->bytes.reserve(body_total + 4 * int64_t(n_entries) * n_layers
                       + 16 * int64_t(n_packets));
    res->packet_lens.reserve(n_packets);
    res->part_bytes.reserve(n_parts);
    BitWriter bw;
    for (int j = 0; j < n_parts; ++j) {
        const size_t part_start = res->bytes.size();
        for (int32_t i = part_off[j]; i < part_off[j + 1]; ++i) {
            const int32_t r = pkts[3 * i], layer = pkts[3 * i + 1];
            const int32_t sop = pkts[3 * i + 2];
            const size_t pkt_start = res->bytes.size();
            bool any_data = false;
            for (int32_t k = rec_off[r]; k < rec_off[r + 1] && !any_data;
                 ++k)
                for (int32_t e = bp_off[k]; e < bp_off[k + 1]; ++e)
                    if (contrib[int64_t(e) * n_layers + layer].npasses) {
                        any_data = true;
                        break;
                    }
            bw.reset();
            bw.put_bit(any_data ? 1 : 0);
            int64_t body = 0;
            if (any_data) {
                for (int32_t k = rec_off[r]; k < rec_off[r + 1]; ++k) {
                    const int w = bp_dims[2 * k];
                    for (int32_t e = bp_off[k]; e < bp_off[k + 1]; ++e) {
                        const int i_blk = e - bp_off[k];
                        const int x = i_blk % w, y = i_blk / w;
                        const Contribution &c =
                            contrib[int64_t(e) * n_layers + layer];
                        if (included_in[e] < 0) {
                            incl[k].encode(bw, x, y, layer + 1);
                            if (c.npasses) {
                                included_in[e] = layer;
                                zbp[k].encode(bw, x, y, 1 << 30);
                            }
                        } else {
                            bw.put_bit(c.npasses ? 1 : 0);
                        }
                        if (!c.npasses) continue;
                        put_npasses(bw, c.npasses);
                        // Length signaling (B.10.7), one codeword segment.
                        int nbits = lblock[e] + floor_log2(c.npasses);
                        while (c.len >= (int64_t(1) << nbits)) {
                            bw.put_bit(1);
                            ++lblock[e];
                            ++nbits;
                        }
                        bw.put_bit(0);
                        bw.put_bits(uint64_t(c.len), nbits);
                        body += c.len;
                    }
                }
            }
            bw.flush();
            std::vector<uint8_t> &out = res->bytes;
            if (sop >= 0) {
                const uint8_t m[6] = {0xFF, 0x91, 0x00, 0x04,
                                      uint8_t((sop >> 8) & 0xFF),
                                      uint8_t(sop & 0xFF)};
                out.insert(out.end(), m, m + 6);
            }
            out.insert(out.end(), bw.bytes.begin(), bw.bytes.end());
            if (use_eph) {
                out.push_back(0xFF);
                out.push_back(0x92);
            }
            if (body) {
                const size_t at = out.size();
                out.resize(at + body);
                uint8_t *dst = out.data() + at;
                for (int32_t k = rec_off[r]; k < rec_off[r + 1]; ++k)
                    for (int32_t e = bp_off[k]; e < bp_off[k + 1]; ++e) {
                        const Contribution &c =
                            contrib[int64_t(e) * n_layers + layer];
                        if (!c.npasses || !c.len) continue;
                        std::memcpy(dst, data + c.begin, c.len);
                        dst += c.len;
                    }
            }
            res->packet_lens.push_back(int32_t(out.size() - pkt_start));
        }
        res->part_bytes.push_back(int64_t(res->bytes.size() - part_start));
    }
    return res;
}

// Each tile-part's byte count (n_parts) and each packet's length, in
// the order written; returns the total bytes.
int64_t t2_result_sizes(void *handle, int64_t *part_bytes,
                        int32_t *packet_lens) {
    const Result *res = static_cast<const Result *>(handle);
    std::copy(res->part_bytes.begin(), res->part_bytes.end(), part_bytes);
    std::copy(res->packet_lens.begin(), res->packet_lens.end(),
              packet_lens);
    return int64_t(res->bytes.size());
}

// Copy the written bytes to out (t2_result_sizes' total) and free the
// handle.
void t2_result_take(void *handle, uint8_t *out) {
    Result *res = static_cast<Result *>(handle);
    if (!res->bytes.empty())
        std::memcpy(out, res->bytes.data(), res->bytes.size());
    delete res;
}

}  // extern "C"
