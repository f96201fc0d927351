// Host MQ replay of device CX/D symbol streams: the host half of the
// CX/D-split Tier-1 (codec/cxd.py run_cxd on the card, this on the CPU).
// Each block's ordered ctx | d << 5 symbols go through the MQ arithmetic
// coder (T.800 Annex C.2, register for register with codec/mq.py's
// MQEncoder); the truncation length is taken at every pass end, and the
// device's exact distortions pass straight through.
//
// Blocks are independent: t1_encode_cxd fans them out over a
// std::thread pool.
//
// Built by g++ -O3 -std=c++17 -fPIC -shared -pthread at first use
// (kernels/build.py) and bound with ctypes (codec/t1_batch.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---- MQ encoder (T.800 Annex C.2) ----

struct QeRow { uint16_t qe; uint8_t nmps, nlps, sw; };

// T.800 Table C.2: (Qe, NMPS, NLPS, SWITCH).
static const QeRow QE[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},
    {0x0AC1, 4, 12, 0},  {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0},
    {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},  {0x4801, 9, 14, 0},
    {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1},
    {0x5401, 16, 14, 0}, {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0},
    {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0}, {0x3001, 21, 19, 0},
    {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0},
    {0x1401, 28, 25, 0}, {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0},
    {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0}, {0x08A1, 33, 30, 0},
    {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0},
    {0x0085, 40, 37, 0}, {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0},
    {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0}, {0x0005, 45, 42, 0},
    {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0},
};

constexpr int N_CTX = 19;
constexpr int CTX_RL = 17;
constexpr int CTX_UNIFORM = 18;

struct MQEnc {
    uint32_t a = 0x8000, c = 0;
    int ct = 12;
    std::vector<uint8_t> buf;
    uint8_t idx[N_CTX];
    uint8_t mps[N_CTX];

    MQEnc() {
        buf.reserve(4096);
        buf.push_back(0);  // dummy pre-byte
        std::memset(idx, 0, sizeof(idx));
        std::memset(mps, 0, sizeof(mps));
        idx[0] = 4;
        idx[CTX_RL] = 3;
        idx[CTX_UNIFORM] = 46;
    }

    void byteout() {
        if (buf.back() == 0xFF) {
            buf.push_back((c >> 20) & 0xFF);
            c &= 0xFFFFF;
            ct = 7;
        } else if (c < 0x8000000u) {
            buf.push_back((c >> 19) & 0xFF);
            c &= 0x7FFFF;
            ct = 8;
        } else {
            buf.back() += 1;
            if (buf.back() == 0xFF) {
                c &= 0x7FFFFFF;
                buf.push_back((c >> 20) & 0xFF);
                c &= 0xFFFFF;
                ct = 7;
            } else {
                buf.push_back((c >> 19) & 0xFF);
                c &= 0x7FFFF;
                ct = 8;
            }
        }
    }

    void renorm() {
        do {
            a = (a << 1) & 0xFFFF;
            c = c << 1;
            if (--ct == 0) byteout();
        } while (!(a & 0x8000));
    }

    void encode(int bit, int ctx) {
        const QeRow& row = QE[idx[ctx]];
        uint32_t qe = row.qe;
        if (bit == mps[ctx]) {
            a -= qe;
            if (!(a & 0x8000)) {
                if (a < qe) a = qe; else c += qe;
                idx[ctx] = row.nmps;
                renorm();
            } else {
                c += qe;
            }
        } else {
            a -= qe;
            if (a < qe) c += qe; else a = qe;
            if (row.sw) mps[ctx] ^= 1;
            idx[ctx] = row.nlps;
            renorm();
        }
    }

    // MQEncoder.truncation_length: bytes so far plus 4.
    int64_t trunc_length() const {
        return (int64_t)buf.size() - 1 + 4;
    }

    void flush() {
        uint32_t tempc = c + a;
        c |= 0xFFFF;
        if (c >= tempc) c -= 0x8000;
        c = c << ct;
        byteout();
        c = c << ct;
        byteout();
        if (buf.size() > 1 && buf.back() == 0xFF) buf.pop_back();
        // buf[0] stays the dummy byte; callers read buf[1..).
    }
};

struct PassRec {
    int32_t type;      // 0=sigprop 1=magref 2=cleanup
    int32_t plane;
    int64_t cum_len;
    double dist;
};

struct BlockOut {
    std::vector<uint8_t> data;
    int32_t nbps = 0;
    std::vector<PassRec> passes;
};

struct T1Result {
    std::vector<BlockOut> blocks;
};

template <typename F>
void run_pool(int n_blocks, int n_threads, F&& body) {
    std::atomic<int> next(0);
    auto worker = [&]() {
        for (;;) {
            int i = next.fetch_add(1);
            if (i >= n_blocks) break;
            body(i);
        }
    };
    if (n_threads <= 1 || n_blocks <= 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        int nt = n_threads < n_blocks ? n_threads : n_blocks;
        for (int t = 0; t < nt; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
}

}  // namespace

extern "C" {

// payload: 384-byte rows of 6-bit symbols, four per little-endian 24-bit
// group, symbol = ctx (low 5 bits) | decision << 5; block i's rows start
// at row_offsets[i]*384. Pass metadata is flat across blocks: block i
// owns passes [pass_offsets[i], pass_offsets[i+1]) with per-pass symbol
// counts, types/planes for the pass table, and the device-computed exact
// distortion reductions passed straight through. nbps[i] is the block's
// coded bit-plane count. Blocks with zero passes code as empty (nbps 0).
T1Result* t1_encode_cxd(int n_blocks, const uint8_t* payload,
                        const int64_t* row_offsets,
                        const int32_t* nbps,
                        const int64_t* pass_offsets,
                        const int32_t* pass_types,
                        const int32_t* pass_planes,
                        const int32_t* pass_nsyms,
                        const double* pass_dists, int n_threads) {
    auto* res = new T1Result();
    res->blocks.resize(n_blocks);
    run_pool(n_blocks, n_threads, [&](int i) {
        BlockOut& out = res->blocks[i];
        const int64_t p0 = pass_offsets[i], p1 = pass_offsets[i + 1];
        if (p1 <= p0) return;               // dead block: zero passes
        const uint8_t* rows = payload + row_offsets[i] * 384;
        MQEnc mq;
        int64_t sym = 0;
        uint32_t word = 0;
        for (int64_t j = p0; j < p1; j++) {
            for (int32_t s = 0; s < pass_nsyms[j]; s++, sym++) {
                const int r = (int)(sym & 3);
                if (r == 0) {       // one load per 4-symbol group
                    const uint8_t* g = rows + (sym >> 2) * 3;
                    word = (uint32_t)g[0] | ((uint32_t)g[1] << 8) |
                           ((uint32_t)g[2] << 16);
                }
                const uint32_t cxd = (word >> (6 * r)) & 63u;
                mq.encode((int)(cxd >> 5), (int)(cxd & 31u));
            }
            out.passes.push_back({pass_types[j], pass_planes[j],
                                  mq.trunc_length(), pass_dists[j]});
        }
        mq.flush();
        out.nbps = nbps[i];
        out.data.assign(mq.buf.begin() + 1, mq.buf.end());
        const int64_t total = (int64_t)out.data.size();
        for (auto& pr : out.passes)
            if (pr.cum_len > total) pr.cum_len = total;
    });
    return res;
}

void t1_block_sizes(T1Result* r, int32_t* nbps, int32_t* npasses,
                    int64_t* nbytes) {
    for (size_t i = 0; i < r->blocks.size(); i++) {
        nbps[i] = r->blocks[i].nbps;
        npasses[i] = (int32_t)r->blocks[i].passes.size();
        nbytes[i] = (int64_t)r->blocks[i].data.size();
    }
}

void t1_block_get(T1Result* r, int i, uint8_t* data, int32_t* ptype,
                  int32_t* pplane, int64_t* plen, double* pdist) {
    const BlockOut& b = r->blocks[i];
    if (!b.data.empty()) std::memcpy(data, b.data.data(), b.data.size());
    for (size_t k = 0; k < b.passes.size(); k++) {
        ptype[k] = b.passes[k].type;
        pplane[k] = b.passes[k].plane;
        plen[k] = b.passes[k].cum_len;
        pdist[k] = b.passes[k].dist;
    }
}

void t1_result_free(T1Result* r) { delete r; }

}  // extern "C"
