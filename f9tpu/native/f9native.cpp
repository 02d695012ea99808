// f9native: host-native kernels for the f9tpu framework.
//
// Two roles, mirroring the reference's native dependencies (SURVEY.md §2.3):
//
//  1. A double-precision polyphase resampler ("oracle"): the role JUCE's
//     WindowedSincInterpolator / LagrangeInterpolator play for BASELINE.json —
//     the CPU accuracy reference the device output is tested against.  The phase
//     bank is designed in Python (float64) and passed in, so this checks the
//     *execution* path (indexing, accumulation) independently of the design.
//
//  2. Hot host-codec loops: 24-bit PCM pack/unpack and int16/int32/float
//     conversions — the equivalents of JUCE's AudioFormatManager sample
//     conversion inner loops (reference: Source/MainComponent.cpp:718-742,
//     784-801), vectorizable by the compiler and parallelized with threads.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <algorithm>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Oracle: polyphase rational resampler, double precision.
//   H: (L, K) phase bank, row-major.  For output n:
//     u = n*M + delay;  base = u/L;  p = u%L;
//     y[n] = sum_j H[p, j] * x[base - j]   (x out of range -> 0)
// ---------------------------------------------------------------------------
void f9_resample_oracle(
    const double* x, int64_t in_len,
    const double* H, int64_t L, int64_t M, int64_t K, int64_t delay,
    double* y, int64_t out_len)
{
    for (int64_t n = 0; n < out_len; ++n) {
        const int64_t u = n * M + delay;
        const int64_t base = u / L;
        const int64_t p = u % L;
        const double* h = H + p * K;
        const int64_t j_lo = std::max<int64_t>(0, base - (in_len - 1));
        const int64_t j_hi = std::min<int64_t>(K - 1, base);
        double acc = 0.0;
        for (int64_t j = j_lo; j <= j_hi; ++j)
            acc += h[j] * x[base - j];
        y[n] = acc;
    }
}

// Multi-threaded variant over output chunks (embarrassingly parallel).
void f9_resample_oracle_mt(
    const double* x, int64_t in_len,
    const double* H, int64_t L, int64_t M, int64_t K, int64_t delay,
    double* y, int64_t out_len, int32_t n_threads)
{
    if (n_threads <= 1 || out_len < (int64_t)1 << 14) {
        f9_resample_oracle(x, in_len, H, L, M, K, delay, y, out_len);
        return;
    }
    std::vector<std::thread> ts;
    const int64_t chunk = (out_len + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; ++t) {
        const int64_t lo = t * chunk;
        const int64_t hi = std::min(out_len, lo + chunk);
        if (lo >= hi) break;
        ts.emplace_back([=]() {
            for (int64_t n = lo; n < hi; ++n) {
                const int64_t u = n * M + delay;
                const int64_t base = u / L;
                const int64_t p = u % L;
                const double* h = H + p * K;
                const int64_t j_lo = std::max<int64_t>(0, base - (in_len - 1));
                const int64_t j_hi = std::min<int64_t>(K - 1, base);
                double acc = 0.0;
                for (int64_t j = j_lo; j <= j_hi; ++j)
                    acc += h[j] * x[base - j];
                y[n] = acc;
            }
        });
    }
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Codec hot loops.
// ---------------------------------------------------------------------------

// little-endian 24-bit -> float32 in [-1, 1)
void f9_unpack24_to_f32(const uint8_t* src, int64_t n, float* dst)
{
    constexpr float inv = 1.0f / 8388608.0f;
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* b = src + 3 * i;
        int32_t v = (int32_t)((uint32_t)b[0] | ((uint32_t)b[1] << 8) |
                              ((uint32_t)b[2] << 16));
        v = (v << 8) >> 8;  // sign extend from bit 23
        dst[i] = (float)v * inv;
    }
}

// int32 PCM codes -> little-endian 24-bit bytes
void f9_pack24_from_i32(const int32_t* src, int64_t n, uint8_t* dst)
{
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t v = (uint32_t)src[i];
        uint8_t* b = dst + 3 * i;
        b[0] = (uint8_t)(v & 0xFF);
        b[1] = (uint8_t)((v >> 8) & 0xFF);
        b[2] = (uint8_t)((v >> 16) & 0xFF);
    }
}

// interleave planar (channels, frames) f32 -> (frames*channels) f32
void f9_interleave_f32(const float* src, int64_t channels, int64_t frames,
                       float* dst)
{
    for (int64_t c = 0; c < channels; ++c) {
        const float* s = src + c * frames;
        float* d = dst + c;
        for (int64_t f = 0; f < frames; ++f) d[f * channels] = s[f];
    }
}

// deinterleave (frames*channels) f32 -> planar (channels, frames) f32
void f9_deinterleave_f32(const float* src, int64_t channels, int64_t frames,
                         float* dst)
{
    for (int64_t c = 0; c < channels; ++c) {
        float* d = dst + c * frames;
        const float* s = src + c;
        for (int64_t f = 0; f < frames; ++f) d[f] = s[f * channels];
    }
}

int32_t f9_native_abi_version(void) { return 4; }

}  // extern "C"

// ---------------------------------------------------------------------------
// Async data loader: a native thread pool that decodes integer-PCM WAV files
// straight into caller-owned float32 planar buffers.  This is the native
// "data loader" runtime component (the role JUCE's AudioFormatManager +
// message-thread loading plays in the reference, Source/MainComponent.cpp:705-749):
// file I/O, header walk, sample conversion and deinterleave all happen off
// the Python thread; Python polls ticket completion.
// ---------------------------------------------------------------------------

#include <atomic>
#include <condition_variable>
#include <cstdio>
#include <mutex>
#include <queue>
#include <string>

namespace {

struct LoadJob {
    std::string path;
    float* dst;            // planar (channels, frames) float32, caller-owned
    int64_t max_frames;    // capacity of dst per channel
    int32_t expect_channels;
    // results
    std::atomic<int32_t> status{0};  // 0 pending, 1 ok, <0 error code
    int64_t frames_read{0};
    int32_t rate{0};
};

struct Loader {
    std::vector<std::thread> workers;
    std::queue<LoadJob*> pending;
    std::mutex mu;
    std::condition_variable cv;
    bool stopping = false;
    std::vector<LoadJob*> jobs;  // owned

    explicit Loader(int n_threads) {
        for (int i = 0; i < n_threads; ++i)
            workers.emplace_back([this]() { run(); });
    }
    ~Loader() {
        {
            std::lock_guard<std::mutex> g(mu);
            stopping = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
        for (auto* j : jobs) delete j;
    }
    void run() {
        for (;;) {
            LoadJob* job;
            {
                std::unique_lock<std::mutex> g(mu);
                cv.wait(g, [this]() { return stopping || !pending.empty(); });
                if (stopping && pending.empty()) return;
                job = pending.front();
                pending.pop();
            }
            decode(job);
        }
    }
    static void decode(LoadJob* job) {
        FILE* f = std::fopen(job->path.c_str(), "rb");
        if (!f) { job->status.store(-1); return; }
        uint8_t head[12];
        if (std::fread(head, 1, 12, f) != 12 || std::memcmp(head, "RIFF", 4) ||
            std::memcmp(head + 8, "WAVE", 4)) {
            std::fclose(f); job->status.store(-2); return;
        }
        uint16_t tag = 0, channels = 0, bits = 0;
        uint32_t rate = 0;
        int64_t data_off = -1; uint32_t data_size = 0;
        uint8_t hdr[8];
        while (std::fread(hdr, 1, 8, f) == 8) {
            uint32_t size;
            std::memcpy(&size, hdr + 4, 4);
            long pos = std::ftell(f);
            if (!std::memcmp(hdr, "fmt ", 4)) {
                uint8_t fmt[40] = {0};
                std::fread(fmt, 1, size < 40 ? size : 40, f);
                std::memcpy(&tag, fmt, 2);
                std::memcpy(&channels, fmt + 2, 2);
                std::memcpy(&rate, fmt + 4, 4);
                std::memcpy(&bits, fmt + 14, 2);
                if (tag == 0xFFFE && size >= 40) std::memcpy(&tag, fmt + 24, 2);
            } else if (!std::memcmp(hdr, "data", 4)) {
                data_off = pos; data_size = size;
                if (tag) break;
            }
            std::fseek(f, pos + size + (size & 1), SEEK_SET);
        }
        if (tag != 1 || data_off < 0 || channels == 0 ||
            (bits != 16 && bits != 24)) {
            std::fclose(f); job->status.store(-3); return;
        }
        if (channels != job->expect_channels && job->expect_channels > 0) {
            std::fclose(f); job->status.store(-4); return;
        }
        const int64_t bpf = (int64_t)channels * (bits / 8);
        std::fseek(f, 0, SEEK_END);
        const int64_t actual = std::ftell(f) - data_off;
        std::fseek(f, data_off, SEEK_SET);
        int64_t frames = std::min<int64_t>(data_size, actual) / bpf;
        frames = std::min<int64_t>(frames, job->max_frames);
        std::vector<uint8_t> buf(frames * bpf);
        if ((int64_t)std::fread(buf.data(), 1, buf.size(), f) != (int64_t)buf.size()) {
            std::fclose(f); job->status.store(-5); return;
        }
        std::fclose(f);
        // convert + deinterleave
        for (int32_t c = 0; c < channels; ++c) {
            float* d = job->dst + (int64_t)c * job->max_frames;
            if (bits == 16) {
                constexpr float inv = 1.0f / 32768.0f;
                const uint8_t* s = buf.data() + c * 2;
                for (int64_t i = 0; i < frames; ++i, s += bpf) {
                    int16_t v;
                    std::memcpy(&v, s, 2);
                    d[i] = (float)v * inv;
                }
            } else {
                constexpr float inv = 1.0f / 8388608.0f;
                const uint8_t* s = buf.data() + c * 3;
                for (int64_t i = 0; i < frames; ++i, s += bpf) {
                    int32_t v = (int32_t)((uint32_t)s[0] | ((uint32_t)s[1] << 8) |
                                          ((uint32_t)s[2] << 16));
                    v = (v << 8) >> 8;
                    d[i] = (float)v * inv;
                }
            }
        }
        job->frames_read = frames;
        job->rate = (int32_t)rate;
        job->status.store(1);
    }
};

}  // namespace

extern "C" {

void* f9_loader_create(int32_t n_threads) { return new Loader(n_threads); }
void f9_loader_destroy(void* loader) { delete (Loader*)loader; }

// Submit: returns a ticket (job pointer) to poll.
void* f9_loader_submit(void* loader, const char* path, float* dst,
                       int64_t max_frames, int32_t expect_channels) {
    auto* L = (Loader*)loader;
    auto* job = new LoadJob();
    job->path = path;
    job->dst = dst;
    job->max_frames = max_frames;
    job->expect_channels = expect_channels;
    {
        std::lock_guard<std::mutex> g(L->mu);
        L->jobs.push_back(job);
        L->pending.push(job);
    }
    L->cv.notify_one();
    return job;
}

// Poll: 0 = pending, 1 = done, <0 = error; on done fills frames/rate.
int32_t f9_loader_poll(void* ticket, int64_t* frames, int32_t* rate) {
    auto* job = (LoadJob*)ticket;
    const int32_t st = job->status.load();
    if (st == 1) {
        *frames = job->frames_read;
        *rate = job->rate;
    }
    return st;
}

}  // extern "C"

// ===========================================================================
// 3. FLAC frame decoder (RFC 9639) — the native hot path behind
//    f9tpu/io/flac.py (whose pure-Python decoder is the readable,
//    spec-shaped form and the parity oracle for this one).  Decodes a run
//    of frames starting at a frame boundary: every subframe type
//    (CONSTANT / VERBATIM / FIXED 0-4 / LPC 1-32), RICE + RICE2 residuals
//    with escaped raw partitions, wasted bits, all four channel
//    assignments, CRC-8 + CRC-16 verification.  The role JUCE's
//    FlacAudioFormat (vendored libFLAC) plays in the reference's format
//    manager (Source/MainComponent.cpp:13).
// ===========================================================================

namespace flacdec {

static uint8_t CRC8_T[256];
static uint16_t CRC16_T[256];
static const bool tables_ready = []() {
    for (int i = 0; i < 256; ++i) {
        int c8 = i;
        for (int k = 0; k < 8; ++k)
            c8 = (c8 & 0x80) ? ((c8 << 1) ^ 0x07) : (c8 << 1);
        CRC8_T[i] = (uint8_t)c8;
        int c16 = i << 8;
        for (int k = 0; k < 8; ++k)
            c16 = (c16 & 0x8000) ? ((c16 << 1) ^ 0x8005) : (c16 << 1);
        CRC16_T[i] = (uint16_t)c16;
    }
    return true;
}();

static inline uint8_t crc8(const uint8_t* p, int64_t n) {
    uint8_t c = 0;
    for (int64_t i = 0; i < n; ++i) c = CRC8_T[c ^ p[i]];
    return c;
}
static inline uint16_t crc16(const uint8_t* p, int64_t n) {
    uint16_t c = 0;
    for (int64_t i = 0; i < n; ++i)
        c = (uint16_t)((c << 8) ^ CRC16_T[((c >> 8) ^ p[i]) & 0xFF]);
    return c;
}

// MSB-first bit reader with a 64-bit cache.  The low `nb` bits of `acc`
// are the unread bits; bits above them are consumed garbage (reads mask).
struct BR {
    const uint8_t* d;
    int64_t n;          // total bytes
    int64_t bytep = 0;  // next byte to load into the cache
    uint64_t acc = 0;
    int nb = 0;
    bool err = false;

    BR(const uint8_t* data, int64_t nbytes) : d(data), n(nbytes) {}

    int64_t bitpos() const { return bytep * 8 - nb; }

    inline void refill() {
        while (nb <= 56 && bytep < n) { acc = (acc << 8) | d[bytep++]; nb += 8; }
    }
    inline uint64_t read(int k) {  // k in [0, 33]
        if (k == 0) return 0;
        if (nb < k) {
            refill();
            if (nb < k) { err = true; nb = 0; return 0; }
        }
        nb -= k;
        return (acc >> nb) & ((1ull << k) - 1);
    }
    inline int64_t read_signed(int k) {
        uint64_t v = read(k);
        if (k && (v >> (k - 1))) return (int64_t)v - ((int64_t)1 << k);
        return (int64_t)v;
    }
    inline int64_t unary() {
        int64_t z = 0;
        for (;;) {
            if (nb == 0) {
                refill();
                if (nb == 0) { err = true; return 0; }
            }
            uint64_t seg = nb == 64 ? acc : (acc & ((1ull << nb) - 1));
            if (seg == 0) { z += nb; nb = 0; continue; }
            int hb = 63 - __builtin_clzll(seg);
            z += nb - 1 - hb;
            nb = hb;  // consume the zeros and the terminating 1
            return z;
        }
    }
    inline void align() { nb -= nb & 7; }
};

enum {
    FLAC_OK = 0,
    FLAC_ERR_SYNC = -1,
    FLAC_ERR_CRC8 = -2,
    FLAC_ERR_CRC16 = -3,
    FLAC_ERR_RESERVED = -4,
    FLAC_ERR_TRUNCATED = -5,
    FLAC_ERR_CHANNELS = -6,
    FLAC_ERR_VALUE = -7,
};

static int read_utf8_num(BR& br, uint64_t* out) {
    uint32_t b0 = (uint32_t)br.read(8);
    if (br.err) return FLAC_ERR_TRUNCATED;
    if (b0 < 0x80) { *out = b0; return FLAC_OK; }
    int extra = 0;
    uint32_t mask = 0x40;
    while (b0 & mask) { ++extra; mask >>= 1; }
    if (extra < 1 || extra > 6) return FLAC_ERR_VALUE;
    uint64_t v = b0 & (mask - 1);
    for (int i = 0; i < extra; ++i) {
        uint32_t b = (uint32_t)br.read(8);
        if (br.err) return FLAC_ERR_TRUNCATED;
        if ((b & 0xC0) != 0x80) return FLAC_ERR_VALUE;
        v = (v << 6) | (b & 0x3F);
    }
    *out = v;
    return FLAC_OK;
}

static int decode_residual(BR& br, int64_t blocksize, int order, int64_t* res) {
    uint32_t method = (uint32_t)br.read(2);
    if (method > 1) return FLAC_ERR_RESERVED;
    const int pbits = 4 + (int)method;
    const uint32_t escape = (1u << pbits) - 1;
    const uint32_t po = (uint32_t)br.read(4);
    const int64_t nparts = (int64_t)1 << po;
    if (blocksize % nparts) return FLAC_ERR_VALUE;
    const int64_t psize = blocksize >> po;
    if (po > 0 && psize <= order) return FLAC_ERR_VALUE;
    int64_t pos = 0;
    for (int64_t p = 0; p < nparts; ++p) {
        int64_t cnt = psize - (p == 0 ? order : 0);
        if (cnt < 0) return FLAC_ERR_VALUE;
        uint32_t param = (uint32_t)br.read(pbits);
        if (br.err) return FLAC_ERR_TRUNCATED;
        if (param == escape) {
            int nbits = (int)br.read(5);
            if (nbits == 0) {
                for (int64_t i = 0; i < cnt; ++i) res[pos + i] = 0;
            } else {
                for (int64_t i = 0; i < cnt; ++i)
                    res[pos + i] = br.read_signed(nbits);
            }
        } else {
            const int k = (int)param;
            for (int64_t i = 0; i < cnt; ++i) {
                uint64_t q = (uint64_t)br.unary();
                uint64_t v = (q << k) | br.read(k);
                res[pos + i] = (int64_t)(v >> 1) ^ -(int64_t)(v & 1);
            }
        }
        if (br.err) return FLAC_ERR_TRUNCATED;
        pos += cnt;
    }
    return FLAC_OK;
}

// decode one subframe into x[0..blocksize)
static int decode_subframe(BR& br, int64_t blocksize, int bps, int64_t* x) {
    if (br.read(1)) return FLAC_ERR_VALUE;  // padding bit
    uint32_t t = (uint32_t)br.read(6);
    int wasted = 0;
    if (br.read(1)) {
        const int64_t w = br.unary();
        if (w > 40) return FLAC_ERR_VALUE;  // legal max is bps-1 <= 31;
        wasted = (int)w + 1;                // bound before narrowing
    }
    if (br.err) return FLAC_ERR_TRUNCATED;
    const int eb = bps - wasted;
    if (eb <= 0) return FLAC_ERR_VALUE;
    if (t == 0) {                               // CONSTANT
        int64_t v = br.read_signed(eb);
        for (int64_t i = 0; i < blocksize; ++i) x[i] = v;
    } else if (t == 1) {                        // VERBATIM
        for (int64_t i = 0; i < blocksize; ++i) x[i] = br.read_signed(eb);
    } else if (t >= 8 && t <= 12) {             // FIXED
        const int order = (int)t - 8;
        if (order > blocksize) return FLAC_ERR_VALUE;
        for (int i = 0; i < order; ++i) x[i] = br.read_signed(eb);
        int rc = decode_residual(br, blocksize, order, x + order);
        if (rc) return rc;
        switch (order) {
        case 0: break;
        case 1:
            for (int64_t i = 1; i < blocksize; ++i) x[i] += x[i - 1];
            break;
        case 2:
            for (int64_t i = 2; i < blocksize; ++i)
                x[i] += 2 * x[i - 1] - x[i - 2];
            break;
        case 3:
            for (int64_t i = 3; i < blocksize; ++i)
                x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
            break;
        case 4:
            for (int64_t i = 4; i < blocksize; ++i)
                x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
            break;
        }
    } else if (t >= 32) {                       // LPC
        const int order = (int)(t & 31) + 1;
        if (order > blocksize) return FLAC_ERR_VALUE;
        for (int i = 0; i < order; ++i) x[i] = br.read_signed(eb);
        const int prec = (int)br.read(4) + 1;
        if (prec == 16) return FLAC_ERR_VALUE;
        const int shift = (int)br.read_signed(5);
        if (shift < 0) return FLAC_ERR_VALUE;
        int64_t coefs[32];
        for (int i = 0; i < order; ++i) coefs[i] = br.read_signed(prec);
        int rc = decode_residual(br, blocksize, order, x + order);
        if (rc) return rc;
        // Range check mirrors flac.py _restore_lpc: valid samples fit 33
        // bits, so a reconstruction past 2^40 means corrupt LPC params.  A
        // crafted stream can carry a valid CRC over its own bytes, so CRC-16
        // alone does not reject it — without this both decoders must agree
        // to fail, not silently wrap (round-4 advisor finding).
        const int64_t LPC_LIM = (int64_t)1 << 40;
        for (int64_t i = order; i < blocksize; ++i) {
            int64_t acc = 0;
            for (int j = 0; j < order; ++j) acc += coefs[j] * x[i - 1 - j];
            x[i] += acc >> shift;
            if (x[i] > LPC_LIM || x[i] < -LPC_LIM) return FLAC_ERR_VALUE;
        }
    } else {
        return FLAC_ERR_RESERVED;
    }
    if (br.err) return FLAC_ERR_TRUNCATED;
    if (wasted)
        for (int64_t i = 0; i < blocksize; ++i) x[i] <<= wasted;
    return FLAC_OK;
}

}  // namespace flacdec

extern "C" {

// Decode frames from `data` (which must start at a frame boundary) until
// `want_samples` samples are decoded, the buffer is exhausted, or the next
// frame would not fit in the remaining capacity.  Output is planar int32:
// out[c * out_stride + i].  Returns 0 (or a negative FLAC_ERR_*); fills
// samples_done / bytes_used either way with progress so far.
int32_t f9_flac_decode(const uint8_t* data, int64_t nbytes,
                       int32_t channels, int32_t stream_bits,
                       int32_t* out, int64_t out_stride,
                       int64_t want_samples,
                       int64_t* samples_done, int64_t* bytes_used) {
    using namespace flacdec;
    *samples_done = 0;
    *bytes_used = 0;
    if (channels < 1 || channels > 8 || stream_bits < 4 || stream_bits > 32)
        return FLAC_ERR_VALUE;
    const int64_t MAXBLOCK = 65535;
    std::vector<int64_t> buf((size_t)(2 > channels ? 2 : channels) * MAXBLOCK);
    int64_t off = 0;
    int64_t done = 0;
    while (done < want_samples && off < nbytes) {
        BR br(data + off, nbytes - off);
        if (br.read(14) != 0x3FFE) return FLAC_ERR_SYNC;
        if (br.read(1)) return FLAC_ERR_RESERVED;
        (void)br.read(1);  // blocking strategy: both accepted
        const uint32_t bs_code = (uint32_t)br.read(4);
        const uint32_t sr_code = (uint32_t)br.read(4);
        const uint32_t ch_code = (uint32_t)br.read(4);
        const uint32_t ss_code = (uint32_t)br.read(3);
        if (br.read(1)) return FLAC_ERR_RESERVED;
        if (br.err) return FLAC_ERR_TRUNCATED;
        uint64_t number;
        int rc = read_utf8_num(br, &number);
        if (rc) return rc;
        int64_t blocksize;
        if (bs_code == 0) return FLAC_ERR_RESERVED;
        else if (bs_code == 1) blocksize = 192;
        else if (bs_code <= 5) blocksize = 576ll << (bs_code - 2);
        else if (bs_code == 6) blocksize = (int64_t)br.read(8) + 1;
        else if (bs_code == 7) blocksize = (int64_t)br.read(16) + 1;
        else blocksize = 256ll << (bs_code - 8);
        // spec max blocksize is 65535; a crafted code-7 header can claim
        // 65536, which would overflow the per-channel scratch slots
        if (blocksize > MAXBLOCK) return FLAC_ERR_VALUE;
        if (sr_code == 12) (void)br.read(8);
        else if (sr_code == 13 || sr_code == 14) (void)br.read(16);
        else if (sr_code == 15) return FLAC_ERR_VALUE;
        int bits;
        if (ss_code == 0) bits = stream_bits;
        else if (ss_code == 1) bits = 8;
        else if (ss_code == 2) bits = 12;
        else if (ss_code == 4) bits = 16;
        else if (ss_code == 5) bits = 20;
        else if (ss_code == 6) bits = 24;
        else if (ss_code == 7) bits = 32;
        else return FLAC_ERR_RESERVED;
        if (br.err) return FLAC_ERR_TRUNCATED;
        if ((br.bitpos() & 7) != 0) return FLAC_ERR_VALUE;  // defensive
        const int64_t hdr_len = br.bitpos() >> 3;
        if (crc8(data + off, hdr_len) != (uint8_t)br.read(8))
            return FLAC_ERR_CRC8;
        // whole frames only: stop BEFORE consuming when this frame would
        // overflow the physical capacity, so bytes_used stays at a frame
        // boundary and a streaming caller resumes losslessly.  Callers size
        // capacity >= want_samples + the 65535 max blocksize, so the
        // done == 0 case can only mean a miscalled buffer.
        if (done + blocksize > out_stride) {
            if (done > 0) break;
            return FLAC_ERR_VALUE;
        }

        int64_t* ch0 = buf.data();
        if (ch_code <= 7) {
            if ((int)ch_code + 1 != channels) return FLAC_ERR_CHANNELS;
            for (int c = 0; c < channels; ++c) {
                rc = decode_subframe(br, blocksize, bits, ch0 + c * MAXBLOCK);
                if (rc) return rc;
            }
        } else if (ch_code <= 10) {
            if (channels != 2) return FLAC_ERR_CHANNELS;
            const int bits_a = bits + (ch_code == 9 ? 1 : 0);
            const int bits_b = bits + (ch_code == 9 ? 0 : 1);
            rc = decode_subframe(br, blocksize, bits_a, ch0);
            if (rc) return rc;
            rc = decode_subframe(br, blocksize, bits_b, ch0 + MAXBLOCK);
            if (rc) return rc;
            int64_t* a = ch0;
            int64_t* b = ch0 + MAXBLOCK;
            if (ch_code == 8) {            // left/side
                for (int64_t i = 0; i < blocksize; ++i) b[i] = a[i] - b[i];
            } else if (ch_code == 9) {     // side/right (stream order)
                for (int64_t i = 0; i < blocksize; ++i) {
                    int64_t side = a[i], right = b[i];
                    a[i] = side + right;
                }
            } else {                        // mid/side
                for (int64_t i = 0; i < blocksize; ++i) {
                    int64_t m2 = (a[i] << 1) | (b[i] & 1);
                    int64_t s = b[i];
                    a[i] = (m2 + s) >> 1;
                    b[i] = (m2 - s) >> 1;
                }
            }
        } else {
            return FLAC_ERR_RESERVED;
        }
        br.align();
        if ((br.bitpos() & 7) != 0) return FLAC_ERR_VALUE;
        const int64_t body_len = br.bitpos() >> 3;
        if (body_len + 2 > nbytes - off) return FLAC_ERR_TRUNCATED;
        if (crc16(data + off, body_len) != (uint16_t)br.read(16))
            return FLAC_ERR_CRC16;
        for (int c = 0; c < channels; ++c) {
            const int64_t* src = ch0 + c * MAXBLOCK;
            int32_t* dst = out + c * out_stride + done;
            for (int64_t i = 0; i < blocksize; ++i) dst[i] = (int32_t)src[i];
        }
        done += blocksize;
        off += br.bitpos() >> 3;
        *samples_done = done;
        *bytes_used = off;
    }
    return FLAC_OK;
}

}  // extern "C"

// ===========================================================================
// 4. FLAC frame ENCODER — the native twin of the Python encoder in
//    f9tpu/io/flac.py (fixed predictors 0-4, exact per-partition rice
//    parameter search, escape fallback, stereo decorrelation, wasted
//    bits, constant detection).  Every search below uses the same
//    deterministic integer arithmetic as the Python form, so the two
//    produce BIT-IDENTICAL frames (a tested contract: the Python encoder
//    is the readable oracle, this is the production path).
// ===========================================================================

namespace flacenc {

struct BW {
    std::vector<uint8_t> buf;
    uint64_t acc = 0;
    int nb = 0;

    inline void write(uint64_t v, int nbits) {  // nbits <= 57
        acc = (acc << nbits) | (v & ((nbits == 64) ? ~0ull : ((1ull << nbits) - 1)));
        nb += nbits;
        while (nb >= 8) {
            nb -= 8;
            buf.push_back((uint8_t)((acc >> nb) & 0xFF));
        }
        acc &= (1ull << nb) - 1;
    }
    inline void write_signed(int64_t v, int nbits) {
        write((uint64_t)v, nbits);
    }
    inline void write_unary(int64_t q) {  // q zeros then a 1
        while (q >= 32) { write(0, 32); q -= 32; }
        write(1, (int)q + 1);
    }
    inline void align() { if (nb) write(0, 8 - nb); }
};

static inline uint64_t zigzag(int64_t v) {
    return (uint64_t)((v << 1) ^ (v >> 63));
}

static inline int signed_bits_range(int64_t mn, int64_t mx) {
    int need = 1;
    if (mx > 0) { int b = 64 - __builtin_clzll((uint64_t)mx); need = b + 1; }
    if (mn < 0) {
        uint64_t m = (uint64_t)(~mn);
        int b = m ? 64 - __builtin_clzll(m) : 0;
        if (b + 1 > need) need = b + 1;
    }
    return need;
}

// exact rice cost for zigzagged values at parameter k
static inline int64_t rice_cost(const uint64_t* u, int64_t n, int k) {
    int64_t c = 0;
    for (int64_t i = 0; i < n; ++i) c += (int64_t)(u[i] >> k);
    return c + n * (k + 1);
}

// (k, bits): floor-mean seeds a +-3 window searched with exact costs
// (mirrors flac.py _best_rice_k bit-for-bit)
static inline void best_rice_k(const uint64_t* u, int64_t n,
                               int* best_k, int64_t* best_c) {
    if (n == 0) { *best_k = 0; *best_c = 0; return; }
    uint64_t sum = 0;
    for (int64_t i = 0; i < n; ++i) sum += u[i];
    uint64_t mean = sum / (uint64_t)n;
    int k0 = 0;
    if (mean) { int b = 64 - __builtin_clzll(mean); k0 = b - 1; }
    if (k0 < 0) k0 = 0;
    int lo = k0 - 2 > 0 ? k0 - 2 : 0;
    int hi = k0 + 3 < 30 ? k0 + 3 : 30;
    int bk = 0;
    int64_t bc = -1;
    for (int k = lo; k <= hi; ++k) {
        int64_t c = rice_cost(u, n, k);
        if (bc < 0 || c < bc) { bk = k; bc = c; }
    }
    *best_k = bk;
    *best_c = bc;
}

struct PartPlan { int k; int nb; };  // k = -1 means escaped raw, width nb

// mirrors flac.py _encode_residual: po search with exact totals
static void encode_residual(BW& bw, const int64_t* res, int64_t blocksize,
                            int order, std::vector<uint64_t>& uscratch,
                            std::vector<PartPlan>& plan_scratch) {
    const int64_t nres = blocksize - order;
    uscratch.resize((size_t)nres);
    for (int64_t i = 0; i < nres; ++i) uscratch[i] = zigzag(res[i]);
    const uint64_t* u = uscratch.data();

    int best_po = 0, best_method = 0;
    int64_t best_total = -1;
    std::vector<PartPlan> best_plan;
    for (int po = 0; po <= 6; ++po) {
        const int64_t nparts = (int64_t)1 << po;
        const int64_t psize = blocksize >> po;
        if (po && ((blocksize % nparts) || psize <= order)) continue;
        plan_scratch.clear();
        int64_t pos = 0, content = 0;
        int max_k = 0;
        for (int64_t p = 0; p < nparts; ++p) {
            const int64_t cnt = psize - (p == 0 ? order : 0);
            int k;
            int64_t c;
            best_rice_k(u + pos, cnt, &k, &c);
            int nbw = 1;
            if (cnt) {
                int64_t mn = res[pos], mx = res[pos];
                for (int64_t i = 1; i < cnt; ++i) {
                    if (res[pos + i] < mn) mn = res[pos + i];
                    if (res[pos + i] > mx) mx = res[pos + i];
                }
                nbw = signed_bits_range(mn, mx);
            }
            const int64_t raw_c = 5 + cnt * nbw;
            if (nbw <= 31 && c > raw_c) {
                plan_scratch.push_back({-1, nbw});
                content += raw_c;
            } else {
                plan_scratch.push_back({k, 0});
                content += c;
                if (k > max_k) max_k = k;
            }
            pos += cnt;
        }
        const int method = max_k > 14 ? 1 : 0;
        const int64_t total = 2 + 4 + (int64_t)(4 + method) * nparts + content;
        if (best_total < 0 || total < best_total) {
            best_total = total;
            best_po = po;
            best_method = method;
            best_plan = plan_scratch;
        }
    }
    const int pbits = 4 + best_method;
    const uint32_t escape = (1u << pbits) - 1;
    bw.write((uint64_t)best_method, 2);
    bw.write((uint64_t)best_po, 4);
    const int64_t nparts = (int64_t)1 << best_po;
    const int64_t psize = blocksize >> best_po;
    int64_t pos = 0;
    for (int64_t p = 0; p < nparts; ++p) {
        const int64_t cnt = psize - (p == 0 ? order : 0);
        const PartPlan pp = best_plan[(size_t)p];
        if (pp.k < 0) {
            bw.write(escape, pbits);
            bw.write((uint64_t)pp.nb, 5);
            for (int64_t i = 0; i < cnt; ++i)
                bw.write_signed(res[pos + i], pp.nb);
        } else {
            bw.write((uint64_t)pp.k, pbits);
            const int k = pp.k;
            for (int64_t i = 0; i < cnt; ++i) {
                const uint64_t v = u[pos + i];
                bw.write_unary((int64_t)(v >> k));
                if (k) bw.write(v & ((1ull << k) - 1), k);
            }
        }
        pos += cnt;
    }
}

// mirrors flac.py _pick_fixed_order: first order (0..min(4, n-1)) with the
// minimal sum|residual|; fills res (length n - order) and returns the order
static int pick_fixed_order(const int64_t* x, int64_t n,
                            std::vector<int64_t>& d_scratch,
                            std::vector<int64_t>& res_out) {
    const int max_order = n - 1 < 4 ? (int)(n - 1) : 4;
    // cost of order 0
    int best_order = 0;
    int64_t best_cost = 0;
    for (int64_t i = 0; i < n; ++i)
        best_cost += x[i] < 0 ? -x[i] : x[i];
    d_scratch.assign(x, x + n);
    std::vector<int64_t> cur(d_scratch);
    for (int o = 1; o <= max_order; ++o) {
        // cur := diff(cur), length n - o
        const int64_t m = n - o;
        int64_t cost = 0;
        for (int64_t i = 0; i < m; ++i) {
            cur[i] = cur[i + 1] - cur[i];
            cost += cur[i] < 0 ? -cur[i] : cur[i];
        }
        cur.resize((size_t)m);
        if (cost < best_cost) { best_cost = cost; best_order = o; }
    }
    // recompute the best order's residual (cheap: <= 4 diff passes)
    res_out.assign(x, x + n);
    for (int o = 0; o < best_order; ++o) {
        const int64_t m = n - o - 1;
        for (int64_t i = 0; i < m; ++i)
            res_out[i] = res_out[i + 1] - res_out[i];
        res_out.resize((size_t)m);
    }
    return best_order;
}

// sum|residual| at the winning fixed order — the stereo-decision metric
// (mirrors flac.py _abs_cost)
static int64_t abs_cost(const int64_t* x, int64_t n,
                        std::vector<int64_t>& d_scratch,
                        std::vector<int64_t>& res_scratch) {
    int order = pick_fixed_order(x, n, d_scratch, res_scratch);
    (void)order;
    int64_t c = 0;
    for (int64_t v : res_scratch) c += v < 0 ? -v : v;
    return c;
}

// ---- LPC analysis: bit-for-bit mirror of flac.py (_windowed_autocorr /
// _levinson / _quantize_lpc / _lpc_residual / _pick_lpc).  Every float64
// operation happens in the same order with no FMA contraction (the build
// passes -ffp-contract=off), so both sides produce identical doubles;
// everything downstream of quantization is exact integer math.

static const int LPC_PRECISION = 15;
static const int LPC_ORDERS[4] = {4, 8, 12, 16};
static const int LPC_MAX_ORDER = 16;
static const int LPC_N_WINDOWS = 2;   // 0 = Welch, 1 = biweight

static void windowed_autocorr(const int64_t* xs, int64_t n, int max_lag,
                              int window, double* r,
                              std::vector<double>& wd) {
    // deterministic polynomial windows only — no libm cos whose last-ulp
    // platform differences would break the parity contract.  0: Welch
    // (1 - d^2); 1: biweight ((1 - d^2)^2), the round-5 second
    // apodization candidate (stronger taper wins on tonal material)
    wd.resize((size_t)n);
    const double half = (double)(n - 1) / 2.0;
    if (window == 0) {
        for (int64_t i = 0; i < n; ++i) {
            const double d = ((double)i - half) / half;
            wd[(size_t)i] = (double)xs[i] * (1.0 - d * d);
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            const double d = ((double)i - half) / half;
            const double t = 1.0 - d * d;
            wd[(size_t)i] = (double)xs[i] * (t * t);
        }
    }
    for (int k = 0; k <= max_lag; ++k) {
        double acc = 0.0;
        const double* w = wd.data();
        for (int64_t i = 0; i < n - k; ++i) acc += w[i] * w[i + k];
        r[k] = acc;
    }
}

// per-order coefficients; returns how many orders were produced
static int levinson(const double* r, int max_order,
                    double coefs[LPC_MAX_ORDER][LPC_MAX_ORDER]) {
    double lpc[LPC_MAX_ORDER], nxt[LPC_MAX_ORDER];
    double err = r[0];
    int produced = 0;
    for (int i = 0; i < max_order; ++i) {
        if (err <= 0.0) break;     // NaN compares false -> continue, as in
        double acc = r[i + 1];     // the Python oracle
        for (int j = 0; j < i; ++j) acc -= lpc[j] * r[i - j];
        const double k = acc / err;
        for (int j = 0; j < i; ++j) nxt[j] = lpc[j] - k * lpc[i - 1 - j];
        nxt[i] = k;
        err = err * (1.0 - k * k);
        for (int j = 0; j <= i; ++j) { lpc[j] = nxt[j]; coefs[i][j] = nxt[j]; }
        produced = i + 1;
    }
    return produced;
}

static void quantize_lpc(const double* c, int order, int precision,
                         int64_t* q, int* shift_out) {
    double cmax = 0.0;
    for (int j = 0; j < order; ++j) {
        const double a = c[j] < 0.0 ? -c[j] : c[j];
        if (a > cmax) cmax = a;
    }
    if (cmax <= 0.0) {
        for (int j = 0; j < order; ++j) q[j] = 0;
        *shift_out = 0;
        return;
    }
    int e;
    std::frexp(cmax, &e);          // 2^(e-1) <= cmax < 2^e
    int shift = precision - 1 - e;
    if (shift > 15) shift = 15;
    if (shift < 0) shift = 0;
    const int64_t qmax = ((int64_t)1 << (precision - 1)) - 1;
    const int64_t qmin = -((int64_t)1 << (precision - 1));
    const double scale = (double)((int64_t)1 << shift);
    double ferr = 0.0;
    for (int j = 0; j < order; ++j) {
        const double v = c[j] * scale + ferr;
        double qd = std::floor(v + 0.5);
        int64_t qi = (int64_t)qd;
        if (qi > qmax) qi = qmax;
        else if (qi < qmin) qi = qmin;
        ferr = v - (double)qi;
        q[j] = qi;
    }
    *shift_out = shift;
}

struct LpcPlan {
    int order = 0;
    int shift = 0;
    int64_t q[LPC_MAX_ORDER];
    int64_t cost = -1;             // -1: no viable candidate
};

static void pick_lpc(const int64_t* xs, int64_t n, LpcPlan* plan,
                     std::vector<double>& wd, std::vector<int64_t>& res) {
    // the candidate iteration order (windows outer, orders inner,
    // strict-< keeps the earlier winner) is part of the parity contract
    // with flac.py::_pick_lpc — do not reorder
    plan->cost = -1;
    if (n <= (int64_t)LPC_MAX_ORDER * 2) return;
    for (int win = 0; win < LPC_N_WINDOWS; ++win) {
        double r[LPC_MAX_ORDER + 1];
        windowed_autocorr(xs, n, LPC_MAX_ORDER, win, r, wd);
        if (r[0] == 0.0) continue;
        double coefs[LPC_MAX_ORDER][LPC_MAX_ORDER];
        const int produced = levinson(r, LPC_MAX_ORDER, coefs);
        for (int oi = 0; oi < 4; ++oi) {
            const int o = LPC_ORDERS[oi];
            if (o > produced) continue;
            int64_t q[LPC_MAX_ORDER];
            int shift;
            quantize_lpc(coefs[o - 1], o, LPC_PRECISION, q, &shift);
            bool any = false;
            for (int j = 0; j < o; ++j) any = any || (q[j] != 0);
            if (!any) continue;
            res.resize((size_t)(n - o));
            int64_t cost = 0;
            for (int64_t i = o; i < n; ++i) {
                int64_t acc = 0;
                for (int j = 0; j < o; ++j) acc += q[j] * xs[i - 1 - j];
                const int64_t v = xs[i] - (acc >> shift);
                res[(size_t)(i - o)] = v;
                cost += v < 0 ? -v : v;
            }
            if (plan->cost < 0 || cost < plan->cost) {
                plan->order = o;
                plan->shift = shift;
                for (int j = 0; j < o; ++j) plan->q[j] = q[j];
                plan->cost = cost;
            }
        }
    }
}

static void encode_subframe(BW& bw, const int64_t* x_in, int64_t n, int bps,
                            std::vector<int64_t>& xs,
                            std::vector<int64_t>& d_scratch,
                            std::vector<int64_t>& res_scratch,
                            std::vector<uint64_t>& u_scratch,
                            std::vector<PartPlan>& plan_scratch,
                            std::vector<double>& wd_scratch) {
    bool all_equal = true;
    for (int64_t i = 1; i < n; ++i)
        if (x_in[i] != x_in[0]) { all_equal = false; break; }
    if (n && all_equal) {
        bw.write(0, 1);
        bw.write(0, 6);          // CONSTANT
        bw.write(0, 1);
        bw.write_signed(x_in[0], bps);
        return;
    }
    uint64_t acc = 0;
    for (int64_t i = 0; i < n; ++i) acc |= (uint64_t)x_in[i];
    int wasted = 0;
    if (acc) wasted = __builtin_ctzll(acc);
    if (wasted > bps - 1) wasted = bps - 1;
    const int eb = bps - wasted;
    xs.resize((size_t)n);
    for (int64_t i = 0; i < n; ++i) xs[i] = x_in[i] >> wasted;
    const int order = pick_fixed_order(xs.data(), n, d_scratch, res_scratch);
    int64_t fcost = 0;
    for (int64_t v : res_scratch) fcost += v < 0 ? -v : v;
    LpcPlan lp;
    pick_lpc(xs.data(), n, &lp, wd_scratch, d_scratch);
    if (lp.cost >= 0 && lp.cost < fcost) {
        const int o = lp.order;
        bw.write(0, 1);
        bw.write((uint64_t)(32 + (o - 1)), 6);  // LPC
        if (wasted) {
            bw.write(1, 1);
            bw.write(1, wasted);
        } else {
            bw.write(0, 1);
        }
        for (int i = 0; i < o; ++i) bw.write_signed(xs[(size_t)i], eb);
        bw.write(LPC_PRECISION - 1, 4);
        bw.write_signed(lp.shift, 5);
        for (int j = 0; j < o; ++j) bw.write_signed(lp.q[j], LPC_PRECISION);
        res_scratch.resize((size_t)(n - o));   // winner's residual, exact
        for (int64_t i = o; i < n; ++i) {
            int64_t a2 = 0;
            for (int j = 0; j < o; ++j) a2 += lp.q[j] * xs[i - 1 - j];
            res_scratch[(size_t)(i - o)] = xs[i] - (a2 >> lp.shift);
        }
        encode_residual(bw, res_scratch.data(), n, o, u_scratch,
                        plan_scratch);
        return;
    }
    bw.write(0, 1);
    bw.write((uint64_t)(8 + order), 6);  // FIXED
    if (wasted) {
        bw.write(1, 1);
        bw.write(1, wasted);     // (wasted-1) zeros then a 1
    } else {
        bw.write(0, 1);
    }
    for (int i = 0; i < order; ++i) bw.write_signed(xs[(size_t)i], eb);
    encode_residual(bw, res_scratch.data(), n, order, u_scratch, plan_scratch);
}

}  // namespace flacenc

extern "C" {

// Encode ONE frame (fixed blocking strategy) from planar int32 codes.
// Returns the frame's byte length (written into `out`, capacity out_cap)
// or a negative error.  Bit-identical to flac.py _encode_frame.
int64_t f9_flac_encode_frame(const int32_t* codes, int64_t n, int64_t stride,
                             int32_t channels, int32_t bits,
                             int64_t frame_no, int32_t nominal_block,
                             int32_t sample_rate,
                             uint8_t* out, int64_t out_cap) {
    using namespace flacenc;
    using flacdec::crc8;
    using flacdec::crc16;
    if (channels < 1 || channels > 8 || n < 1) return -7;
    // the frame header's blocksize-minus-1 field is 16-bit: larger frames
    // would silently truncate (mirrors FlacWriter's [16, 65535] validation;
    // a final partial frame below 16 is legal, so only the cap binds here)
    if (n > 65535) return -7;
    BW bw;
    bw.buf.reserve((size_t)(n * channels * 5 + 64));
    bw.write(0x3FFE, 14);
    bw.write(0, 1);
    bw.write(0, 1);              // fixed blocking
    int bs_code;
    int bs_extra = -1;           // -1 none, else value (width from code)
    // blocksize table (flac.py _BLOCKSIZE_CODE)
    int table_code = 0;
    switch (n) {
    case 192: table_code = 1; break;
    case 576: table_code = 2; break;
    case 1152: table_code = 3; break;
    case 2304: table_code = 4; break;
    case 4608: table_code = 5; break;
    case 256: table_code = 8; break;
    case 512: table_code = 9; break;
    case 1024: table_code = 10; break;
    case 2048: table_code = 11; break;
    case 4096: table_code = 12; break;
    case 8192: table_code = 13; break;
    case 16384: table_code = 14; break;
    case 32768: table_code = 15; break;
    }
    if (n == nominal_block && table_code) {
        bs_code = table_code;
    } else if (n - 1 < 256) {
        bs_code = 6; bs_extra = (int)(n - 1);
    } else {
        bs_code = 7; bs_extra = (int)(n - 1);
    }
    bw.write((uint64_t)bs_code, 4);
    int sr_code = 0;
    switch (sample_rate) {
    case 88200: sr_code = 1; break;
    case 176400: sr_code = 2; break;
    case 192000: sr_code = 3; break;
    case 8000: sr_code = 4; break;
    case 16000: sr_code = 5; break;
    case 22050: sr_code = 6; break;
    case 24000: sr_code = 7; break;
    case 32000: sr_code = 8; break;
    case 44100: sr_code = 9; break;
    case 48000: sr_code = 10; break;
    case 96000: sr_code = 11; break;
    }
    bw.write((uint64_t)sr_code, 4);

    // channel assignment decision (2ch only; mirrors flac.py options order)
    std::vector<int64_t> L, R, S, M, xs, d1, d2, res;
    std::vector<uint64_t> uz;
    std::vector<PartPlan> plan;
    std::vector<double> wd;
    int ch_code;
    if (channels == 2) {
        L.resize((size_t)n); R.resize((size_t)n);
        S.resize((size_t)n); M.resize((size_t)n);
        for (int64_t i = 0; i < n; ++i) {
            const int64_t l = codes[i], r = codes[stride + i];
            L[(size_t)i] = l; R[(size_t)i] = r;
            S[(size_t)i] = l - r;
            M[(size_t)i] = (l + r) >> 1;
        }
        const int64_t c_l = abs_cost(L.data(), n, d1, res);
        const int64_t c_r = abs_cost(R.data(), n, d1, res);
        const int64_t c_s = abs_cost(S.data(), n, d1, res);
        const int64_t c_m = abs_cost(M.data(), n, d1, res);
        const int codes4[4] = {0x1, 0x8, 0x9, 0xA};
        const int64_t costs4[4] = {c_l + c_r, c_l + c_s, c_r + c_s, c_m + c_s};
        int bi = 0;
        for (int i = 1; i < 4; ++i) if (costs4[i] < costs4[bi]) bi = i;
        ch_code = codes4[bi];
    } else {
        ch_code = channels - 1;
    }
    bw.write((uint64_t)ch_code, 4);
    int ss_code = 0;
    switch (bits) {
    case 8: ss_code = 1; break;
    case 12: ss_code = 2; break;
    case 16: ss_code = 4; break;
    case 20: ss_code = 5; break;
    case 24: ss_code = 6; break;
    case 32: ss_code = 7; break;
    default: return -7;
    }
    bw.write((uint64_t)ss_code, 3);
    bw.write(0, 1);
    // UTF-8-style coded frame number (flac.py _utf8_coded)
    {
        uint64_t fn = (uint64_t)frame_no;
        if (fn < 0x80) {
            bw.write(fn, 8);
        } else {
            int total = 2;
            for (; total <= 7; ++total) {
                const int payload = 6 * (total - 1) + (total < 7 ? 7 - total : 0);
                if (payload < 64 && fn < (1ull << payload)) break;
            }
            if (total > 7) return -7;
            if (total < 7) {
                const uint32_t lead = (0xFFu << (8 - total)) & 0xFF;
                bw.write(lead | (uint32_t)(fn >> (6 * (total - 1))), 8);
            } else {
                bw.write(0xFE, 8);
            }
            for (int i = total - 2; i >= 0; --i)
                bw.write(0x80 | ((fn >> (6 * i)) & 0x3F), 8);
        }
    }
    if (bs_extra >= 0) bw.write((uint64_t)bs_extra, bs_code == 6 ? 8 : 16);
    // header CRC-8 (bw is byte-aligned here)
    bw.write(crc8(bw.buf.data(), (int64_t)bw.buf.size()), 8);

    if (channels == 2 && ch_code >= 8) {
        if (ch_code == 8) {
            encode_subframe(bw, L.data(), n, bits, xs, d1, res, uz, plan, wd);
            encode_subframe(bw, S.data(), n, bits + 1, xs, d1, res, uz, plan, wd);
        } else if (ch_code == 9) {
            encode_subframe(bw, S.data(), n, bits + 1, xs, d1, res, uz, plan, wd);
            encode_subframe(bw, R.data(), n, bits, xs, d1, res, uz, plan, wd);
        } else {
            encode_subframe(bw, M.data(), n, bits, xs, d1, res, uz, plan, wd);
            encode_subframe(bw, S.data(), n, bits + 1, xs, d1, res, uz, plan, wd);
        }
    } else {
        std::vector<int64_t> chan((size_t)n);
        for (int c = 0; c < channels; ++c) {
            for (int64_t i = 0; i < n; ++i) chan[(size_t)i] = codes[c * stride + i];
            encode_subframe(bw, chan.data(), n, bits, xs, d1, res, uz, plan, wd);
        }
    }
    bw.align();
    const uint16_t c16 = crc16(bw.buf.data(), (int64_t)bw.buf.size());
    bw.write(c16, 16);
    const int64_t len = (int64_t)bw.buf.size();
    if (len > out_cap) return -8;
    std::memcpy(out, bw.buf.data(), (size_t)len);
    return len;
}

}  // extern "C"

extern "C" {

// Encode a RUN of frames in parallel (frames are independent: fixed
// predictors only see in-block samples, so per-frame bytes are identical
// to the sequential form — the thread count can never change the output).
// codes: planar (channels, n_total); frames are `block`-sized with a
// final partial.  out: concatenated frames; frame_lens[i] = each length.
// Returns total bytes or a negative error.
int64_t f9_flac_encode_frames_mt(const int32_t* codes, int64_t n_total,
                                 int64_t stride, int32_t channels,
                                 int32_t bits, int64_t first_frame_no,
                                 int32_t block, int32_t sample_rate,
                                 int32_t n_threads,
                                 uint8_t* out, int64_t out_cap,
                                 int64_t* frame_lens) {
    if (block < 1 || n_total < 1) return -7;
    const int64_t n_frames = (n_total + block - 1) / block;
    const int64_t slot = (int64_t)block * channels * 8 + 256;
    std::vector<uint8_t> scratch((size_t)(n_frames * slot));
    std::atomic<int64_t> next{0};
    std::atomic<int64_t> err{0};
    auto work = [&]() {
        for (;;) {
            const int64_t i = next.fetch_add(1);
            if (i >= n_frames || err.load()) return;
            const int64_t lo = i * block;
            const int64_t n = (lo + block <= n_total) ? block : n_total - lo;
            const int64_t rc = f9_flac_encode_frame(
                codes + lo, n, stride, channels, bits, first_frame_no + i,
                block, sample_rate, scratch.data() + i * slot, slot);
            if (rc < 0) { err.store(rc); return; }
            frame_lens[i] = rc;
        }
    };
    int nt = n_threads < 1 ? 1 : n_threads;
    if (nt > n_frames) nt = (int)n_frames;
    if (nt <= 1) {
        work();
    } else {
        std::vector<std::thread> ts;
        for (int t = 0; t < nt; ++t) ts.emplace_back(work);
        for (auto& th : ts) th.join();
    }
    if (err.load()) return err.load();
    int64_t total = 0;
    for (int64_t i = 0; i < n_frames; ++i) {
        if (total + frame_lens[i] > out_cap) return -8;
        std::memcpy(out + total, scratch.data() + i * slot,
                    (size_t)frame_lens[i]);
        total += frame_lens[i];
    }
    return total;
}

}  // extern "C"

// ===========================================================================
// Vorbis packet front half — bit-for-bit mirror of f9tpu/io/vorbis.py's
// packet decode UP TO the spectrum (mode/window bits, floor1 decode +
// curve render, residue types 0/1/2, square-polar inverse coupling).
// The float32 residue adds and coupling run per element in the same order
// as the numpy oracle, so the (residue, curve) pair returned to Python is
// BITWISE identical to the pure-Python decode; Python keeps the float64
// curve multiply, the FFT-based IMDCT, the window lap and all granule
// logic.  Floor type 0 streams (extinct; hand-built test vectors only)
// stay on the Python path — the setup serializer refuses them.
// ===========================================================================

namespace vorbis {

struct Eop {};                       // spec "end-of-packet condition"
struct Bad {};                       // malformed stream (fatal, not EOP)

struct VBits {
    const uint8_t* d;
    int64_t pos, n;
    VBits(const uint8_t* data, int64_t len) : d(data), pos(0), n(8 * len) {}
    uint64_t read(int k) {
        int64_t p = pos, e = p + k;
        if (e > n) { pos = n; throw Eop{}; }
        int64_t b0 = p >> 3, b1 = (e + 7) >> 3;
        uint64_t chunk = 0;
        for (int64_t i = b1 - 1; i >= b0; --i) chunk = (chunk << 8) | d[i];
        pos = e;
        return (chunk >> (p & 7)) & ((k == 64) ? ~0ull : ((1ull << k) - 1));
    }
    int read_bit() {
        if (pos >= n) throw Eop{};
        int b = (d[pos >> 3] >> (pos & 7)) & 1;
        ++pos;
        return b;
    }
    int peek8() const {
        int64_t b0 = pos >> 3;
        uint64_t chunk = d[b0];
        if (b0 + 1 < (n + 7) / 8) chunk |= (uint64_t)d[b0 + 1] << 8;
        return (int)((chunk >> (pos & 7)) & 0xFF);
    }
};

struct VCodebook {
    int dim = 0, entries = 0;
    std::vector<int64_t> tree;           // n_nodes * 2
    int32_t fe[256], fl[256], fn[256];
    int single_entry = -1, single_bits = 0;
    std::vector<float> vq;               // entries * dim (empty: scalar)

    int walk(VBits& br, int64_t ni) const {
        for (;;) {
            ni = tree[(size_t)(ni * 2 + br.read_bit())];
            if (ni < 0) return (int)~ni;
        }
    }
    int decode_scalar(VBits& br) const {
        if (single_entry >= 0) { br.read(single_bits); return single_entry; }
        if (tree.empty()) throw Bad{};   // empty book: malformed stream
        const int p = br.peek8();
        const int e = fe[p];
        if (e >= 0) {
            const int l = fl[p];
            if (br.pos + l > br.n) return walk(br, 0);
            br.pos += l;
            return e;
        }
        if (br.pos + 8 > br.n) return walk(br, 0);
        br.pos += 8;
        return walk(br, fn[p]);
    }
    const float* decode_vq(VBits& br) const {
        return &vq[(size_t)decode_scalar(br) * dim];
    }
};

struct VFloor1 {
    std::vector<int32_t> pcl, dims, subs, masters, subbooks;  // subbooks: 8/class
    int multiplier = 1;
    std::vector<int32_t> x_list, order, low_nb, high_nb;
};

struct VResidue {
    int type = 0, begin = 0, end = 0, psize = 0, nclass = 0, classbook = 0;
    std::vector<int32_t> books;          // nclass * 8
};

struct VMapping {
    std::vector<int32_t> coupling;       // pairs flattened
    std::vector<int32_t> mux, sm_floor, sm_residue;
};

struct VSetup {
    int channels = 0, bs0 = 0, bs1 = 0, mode_bits = 0;
    std::vector<VCodebook> books;
    std::vector<VFloor1> floors;
    std::vector<VResidue> residues;
    std::vector<VMapping> mappings;
    std::vector<int32_t> mode_blockflag, mode_mapping;
    float inv_db[256];
};

struct BlobReader {
    const uint8_t* d;
    int64_t pos, n;
    bool bad = false;
    BlobReader(const uint8_t* data, int64_t len) : d(data), pos(0), n(len) {}
    int32_t i32() {
        if (pos + 4 > n) { bad = true; return 0; }
        int32_t v;
        std::memcpy(&v, d + pos, 4);
        pos += 4;
        return v;
    }
    void i32v(std::vector<int32_t>& out, int64_t count) {
        out.resize((size_t)count);
        if (pos + 4 * count > n) { bad = true; return; }
        std::memcpy(out.data(), d + pos, (size_t)(4 * count));
        pos += 4 * count;
    }
    void f32v(float* out, int64_t count) {
        if (pos + 4 * count > n) { bad = true; return; }
        std::memcpy(out, d + pos, (size_t)(4 * count));
        pos += 4 * count;
    }
};

static int64_t render_point(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                            int64_t x) {
    const int64_t dy = y1 - y0, adx = x1 - x0;
    const int64_t off = (dy < 0 ? -dy : dy) * (x - x0) / adx;
    return dy < 0 ? y0 - off : y0 + off;
}

static void render_line(int64_t x0, int64_t y0, int64_t x1, int64_t y1,
                        int64_t* v, int64_t lim) {
    const int64_t dy = y1 - y0, adx = x1 - x0;
    int64_t ady = dy < 0 ? -dy : dy;
    const int64_t base = ady / adx * (dy >= 0 ? 1 : -1);
    const int64_t sy = dy >= 0 ? base + 1 : base - 1;
    ady -= (base < 0 ? -base : base) * adx;
    int64_t y = y0, err = 0;
    if (x0 < lim) v[x0] = y;
    const int64_t xe = x1 < lim ? x1 : lim;
    for (int64_t x = x0 + 1; x < xe; ++x) {
        err += ady;
        if (err >= adx) { err -= adx; y += sy; }
        else y += base;
        v[x] = y;
    }
}

}  // namespace vorbis

extern "C" {

void* f9_vorbis_setup(const uint8_t* blob, int64_t len) {
    using namespace vorbis;
    auto s = new VSetup();
    BlobReader r(blob, len);
    s->channels = r.i32();
    s->bs0 = r.i32();
    s->bs1 = r.i32();
    s->mode_bits = r.i32();
    const int nb = r.i32();
    s->books.resize((size_t)nb);
    for (auto& b : s->books) {
        b.dim = r.i32();
        b.entries = r.i32();
        b.single_entry = r.i32();
        b.single_bits = r.i32();
        const int n_nodes = r.i32();
        std::vector<int32_t> t;
        r.i32v(t, (int64_t)n_nodes * 2);
        b.tree.assign(t.begin(), t.end());
        std::vector<int32_t> f;
        r.i32v(f, 256); std::memcpy(b.fe, f.data(), 1024);
        r.i32v(f, 256); std::memcpy(b.fl, f.data(), 1024);
        r.i32v(f, 256); std::memcpy(b.fn, f.data(), 1024);
        const int has_vq = r.i32();
        if (has_vq) {
            b.vq.resize((size_t)b.entries * b.dim);
            r.f32v(b.vq.data(), (int64_t)b.entries * b.dim);
        }
    }
    const int nf = r.i32();
    s->floors.resize((size_t)nf);
    for (auto& fl : s->floors) {
        const int np = r.i32();
        r.i32v(fl.pcl, np);
        const int nc = r.i32();
        r.i32v(fl.dims, nc);
        r.i32v(fl.subs, nc);
        r.i32v(fl.masters, nc);
        r.i32v(fl.subbooks, (int64_t)nc * 8);
        fl.multiplier = r.i32();
        const int nx = r.i32();
        r.i32v(fl.x_list, nx);
        r.i32v(fl.order, nx);
        r.i32v(fl.low_nb, nx);
        r.i32v(fl.high_nb, nx);
    }
    const int nr = r.i32();
    s->residues.resize((size_t)nr);
    for (auto& re : s->residues) {
        re.type = r.i32();
        re.begin = r.i32();
        re.end = r.i32();
        re.psize = r.i32();
        re.nclass = r.i32();
        re.classbook = r.i32();
        r.i32v(re.books, (int64_t)re.nclass * 8);
    }
    const int nm = r.i32();
    s->mappings.resize((size_t)nm);
    for (auto& m : s->mappings) {
        const int ncpl = r.i32();
        r.i32v(m.coupling, (int64_t)ncpl * 2);
        r.i32v(m.mux, s->channels);
        const int nsm = r.i32();
        r.i32v(m.sm_floor, nsm);
        r.i32v(m.sm_residue, nsm);
    }
    const int nmodes = r.i32();
    r.i32v(s->mode_blockflag, nmodes);
    r.i32v(s->mode_mapping, nmodes);
    r.f32v(s->inv_db, 256);
    if (r.bad || r.pos != r.n) { delete s; return nullptr; }
    return s;
}

void f9_vorbis_free(void* p) { delete (vorbis::VSetup*)p; }

// Decode one packet's front half.  res_out/curve_out: channels * (bs1/2)
// float32, fully overwritten.  flags_out[0/1] = prev/next window flags.
// Returns the block size n, 0 for non-audio/undecodable packets, -1 on a
// malformed-stream error.
int64_t f9_vorbis_packet(void* setup, const uint8_t* pkt, int64_t len,
                         float* res_out, float* curve_out,
                         int32_t* flags_out) {
    using namespace vorbis;
    const VSetup& s = *(const VSetup*)setup;
    VBits br(pkt, len);
    int n, prev_flag = 1, next_flag = 1, mapping_i;
    try {
        if (br.read_bit() != 0) return 0;
        const int mode_i = s.mode_bits ? (int)br.read(s.mode_bits) : 0;
        if (mode_i >= (int)s.mode_blockflag.size()) return 0;
        const int blockflag = s.mode_blockflag[(size_t)mode_i];
        mapping_i = s.mode_mapping[(size_t)mode_i];
        n = blockflag ? s.bs1 : s.bs0;
        if (blockflag) {
            prev_flag = br.read_bit();
            next_flag = br.read_bit();
        }
    } catch (Eop&) {
        return 0;
    }
    const int64_t n2 = n / 2;
    const int ch = s.channels;
    try {
    const int64_t cap = (int64_t)s.bs1 / 2;
    const VMapping& mp = s.mappings[(size_t)mapping_i];
    std::fill(res_out, res_out + (int64_t)ch * cap, 0.0f);
    std::fill(curve_out, curve_out + (int64_t)ch * cap, 0.0f);

    // --- floor1 decode, per channel ---
    // y vectors (None -> used=false); EOP leaves the rest unused
    std::vector<std::vector<int64_t>> ys((size_t)ch);
    std::vector<char> used((size_t)ch, 0);
    try {
        for (int c = 0; c < ch; ++c) {
            const VFloor1& fl =
                s.floors[(size_t)mp.sm_floor[(size_t)mp.mux[(size_t)c]]];
            if (!br.read_bit()) continue;
            static const int ranges[4] = {256, 128, 86, 64};
            const int rng = ranges[fl.multiplier - 1];
            int bits = 0;
            while ((1 << bits) <= rng - 1) ++bits;   // ilog(rng - 1)
            auto& y = ys[(size_t)c];
            y.push_back((int64_t)br.read(bits));
            y.push_back((int64_t)br.read(bits));
            for (size_t pi = 0; pi < fl.pcl.size(); ++pi) {
                const int cls = fl.pcl[pi];
                const int cdim = fl.dims[(size_t)cls];
                const int cbits = fl.subs[(size_t)cls];
                const int csub = (1 << cbits) - 1;
                int64_t cval = 0;
                if (cbits)
                    cval = s.books[(size_t)fl.masters[(size_t)cls]]
                               .decode_scalar(br);
                for (int j = 0; j < cdim; ++j) {
                    const int book = fl.subbooks[(size_t)cls * 8
                                                 + (cval & csub)];
                    cval >>= cbits;
                    y.push_back(book >= 0
                                    ? s.books[(size_t)book].decode_scalar(br)
                                    : 0);
                }
            }
            used[(size_t)c] = 1;
        }
    } catch (Eop&) {
        // remaining floors unused (their y stays empty, used stays 0)
        for (int c = 0; c < ch; ++c)
            if (used[(size_t)c] && ys[(size_t)c].empty()) used[(size_t)c] = 0;
    }

    // --- nonzero vector propagate ---
    std::vector<char> no_res((size_t)ch);
    for (int c = 0; c < ch; ++c) no_res[(size_t)c] = !used[(size_t)c];
    for (size_t k = 0; k + 1 < mp.coupling.size(); k += 2) {
        const int m = mp.coupling[k], a = mp.coupling[k + 1];
        if (!(no_res[(size_t)m] && no_res[(size_t)a]))
            no_res[(size_t)m] = no_res[(size_t)a] = 0;
    }

    // --- residues per submap ---
    const size_t nsm = mp.sm_floor.size();
    for (size_t sm = 0; sm < nsm; ++sm) {
        std::vector<int> ch_idx;
        for (int c = 0; c < ch; ++c)
            if ((size_t)mp.mux[(size_t)c] == sm) ch_idx.push_back(c);
        const VResidue& re = s.residues[(size_t)mp.sm_residue[sm]];
        const int nch = (int)ch_idx.size();
        if (!nch) continue;
        std::vector<float*> vecs;
        std::vector<char> dnd;
        std::vector<float> joint;
        bool is2 = re.type == 2;
        if (is2) {
            bool all_dnd = true;
            for (int c : ch_idx) all_dnd = all_dnd && no_res[(size_t)c];
            if (all_dnd) continue;
            joint.assign((size_t)nch * n2, 0.0f);
            vecs.push_back(joint.data());
            dnd.push_back(0);
        } else {
            for (int c : ch_idx) {
                vecs.push_back(res_out + (int64_t)c * cap);
                dnd.push_back(no_res[(size_t)c]);
            }
        }
        const int64_t actual = is2 ? (int64_t)nch * n2 : n2;
        const int64_t begin = re.begin < actual ? re.begin : actual;
        const int64_t end = re.end < actual ? re.end : actual;
        const int64_t to_read = end - begin;
        if (to_read > 0) {
            const int64_t parts = to_read / re.psize;
            const VCodebook& cb = s.books[(size_t)re.classbook];
            const int cpc = cb.dim;
            const int nv = (int)vecs.size();
            std::vector<int64_t> classif((size_t)nv * (parts + cpc), 0);
            try {
                for (int pass = 0; pass < 8; ++pass) {
                    int64_t pcount = 0;
                    while (pcount < parts) {
                        if (pass == 0) {
                            for (int j = 0; j < nv; ++j) {
                                if (dnd[(size_t)j]) continue;
                                int64_t temp = cb.decode_scalar(br);
                                for (int i = cpc - 1; i >= 0; --i) {
                                    classif[(size_t)j * (parts + cpc)
                                            + pcount + i] =
                                        temp % re.nclass;
                                    temp /= re.nclass;
                                }
                            }
                        }
                        for (int i = 0; i < cpc && pcount < parts; ++i) {
                            for (int j = 0; j < nv; ++j) {
                                if (dnd[(size_t)j]) continue;
                                const int64_t cl =
                                    classif[(size_t)j * (parts + cpc)
                                            + pcount];
                                const int vq =
                                    re.books[(size_t)cl * 8 + pass];
                                if (vq < 0) continue;
                                float* v = vecs[(size_t)j];
                                const int64_t off =
                                    begin + pcount * re.psize;
                                const VCodebook& bk = s.books[(size_t)vq];
                                const int dim = bk.dim;
                                if (re.type == 0) {
                                    const int64_t step = re.psize / dim;
                                    for (int64_t t = 0; t < step; ++t) {
                                        const float* tv = bk.decode_vq(br);
                                        for (int dd = 0; dd < dim; ++dd)
                                            v[off + t + dd * step] += tv[dd];
                                    }
                                } else {
                                    int64_t t = 0;
                                    while (t < re.psize) {
                                        const float* tv = bk.decode_vq(br);
                                        for (int dd = 0; dd < dim; ++dd)
                                            v[off + t + dd] += tv[dd];
                                        t += dim;
                                    }
                                }
                            }
                            ++pcount;
                        }
                    }
                }
            } catch (Eop&) { /* rest of the vector stays zero */ }
        }
        if (is2) {
            for (int k = 0; k < nch; ++k) {
                float* dst = res_out + (int64_t)ch_idx[(size_t)k] * cap;
                for (int64_t i = 0; i < n2; ++i)
                    dst[i] = joint[(size_t)(i * nch + k)];
            }
        }
    }

    // --- inverse coupling, reverse declaration order ---
    for (int64_t k = (int64_t)mp.coupling.size() - 2; k >= 0; k -= 2) {
        float* M = res_out + (int64_t)mp.coupling[(size_t)k] * cap;
        float* A = res_out + (int64_t)mp.coupling[(size_t)k + 1] * cap;
        for (int64_t i = 0; i < n2; ++i) {
            const float m = M[i], a = A[i];
            float nm, na;
            if (m > 0.0f) {
                if (a > 0.0f) { nm = m; na = m - a; }
                else          { nm = m + a; na = m; }
            } else {
                if (a > 0.0f) { nm = m; na = m + a; }
                else          { nm = m - a; na = m; }
            }
            M[i] = nm;
            A[i] = na;
        }
    }

    // --- floor curves (spec 7.2.4 integer math + inverse-dB table) ---
    std::vector<int64_t> out_i((size_t)n2);
    for (int c = 0; c < ch; ++c) {
        float* cv = curve_out + (int64_t)c * cap;
        if (!used[(size_t)c]) continue;          // curve stays zero
        const VFloor1& fl =
            s.floors[(size_t)mp.sm_floor[(size_t)mp.mux[(size_t)c]]];
        const auto& y = ys[(size_t)c];
        static const int ranges[4] = {256, 128, 86, 64};
        const int64_t rng = ranges[fl.multiplier - 1];
        const size_t nx = fl.x_list.size();
        std::vector<int64_t> final_y(nx, 0);
        std::vector<char> step2(nx, 0);
        final_y[0] = y[0];
        final_y[1] = y[1];
        step2[0] = step2[1] = 1;
        for (size_t i = 2; i < nx; ++i) {
            const int lo = fl.low_nb[i], hi = fl.high_nb[i];
            const int64_t predicted = render_point(
                fl.x_list[(size_t)lo], final_y[(size_t)lo],
                fl.x_list[(size_t)hi], final_y[(size_t)hi], fl.x_list[i]);
            const int64_t val = i < y.size() ? y[i] : 0;
            const int64_t highroom = rng - predicted;
            const int64_t lowroom = predicted;
            const int64_t room =
                2 * (highroom < lowroom ? highroom : lowroom);
            if (val) {
                step2[(size_t)lo] = step2[(size_t)hi] = step2[i] = 1;
                if (val >= room) {
                    final_y[i] = highroom > lowroom
                                     ? val - lowroom + predicted
                                     : predicted - (val - highroom) - 1;
                } else if (val & 1) {
                    final_y[i] = predicted - ((val + 1) >> 1);
                } else {
                    final_y[i] = predicted + (val >> 1);
                }
            } else {
                step2[i] = 0;
                final_y[i] = predicted;
            }
        }
        std::fill(out_i.begin(), out_i.end(), 0);
        const int64_t mul = fl.multiplier;
        auto clampy = [rng](int64_t v) {
            return v < 0 ? (int64_t)0 : (v > rng - 1 ? rng - 1 : v);
        };
        int64_t lx = 0;
        int64_t ly = clampy(final_y[(size_t)fl.order[0]]) * mul;
        int64_t hx = lx, hy = ly;
        for (size_t oi = 1; oi < nx; ++oi) {
            const int idx = fl.order[oi];
            if (!step2[(size_t)idx]) continue;
            hx = fl.x_list[(size_t)idx];
            hy = clampy(final_y[(size_t)idx]) * mul;
            if (lx < n2) render_line(lx, ly, hx, hy, out_i.data(), n2);
            lx = hx;
            ly = hy;
        }
        if (hx < n2)
            for (int64_t i = hx; i < n2; ++i) out_i[(size_t)i] = hy;
        for (int64_t i = 0; i < n2; ++i) {
            int64_t v = out_i[(size_t)i];
            cv[i] = s.inv_db[v > 255 ? 255 : v];
        }
    }
    } catch (Bad&) {
        return -1;                   // mirrors the oracle's VorbisError
    }
    flags_out[0] = prev_flag;
    flags_out[1] = next_flag;
    return n;
}

// RFC 3533 Ogg CRC-32 (0x04c11db7, unreflected, init/xorout 0) — the page
// scan's hot loop (io/ogg.py computes the identical table in Python).
uint32_t f9_ogg_crc(const uint8_t* data, int64_t len, uint32_t crc) {
    static uint32_t tab[256];
    static bool init = false;
    if (!init) {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t r = i << 24;
            for (int k = 0; k < 8; ++k)
                r = (r << 1) ^ ((r & 0x80000000u) ? 0x04C11DB7u : 0u);
            tab[i] = r;
        }
        init = true;
    }
    for (int64_t i = 0; i < len; ++i)
        crc = (crc << 8) ^ tab[((crc >> 24) ^ data[i]) & 0xFF];
    return crc;
}

}  // extern "C"

// ===========================================================================
// ALAC packet decoder — bit-for-bit mirror of f9tpu/io/alac.py (the pure
// integer spec oracle): adaptive Golomb-Rice with the decaying history,
// zero-run blocks and escapes; the sign-adaptive FIR predictor (orders
// 1-30, order-31 first difference, mode-15 double stage); bytes_shifted
// low-byte reattachment; stereo decorrelation; AAC-style element
// sequences with the Apple channel-layout remap.  Exact integer math
// throughout, so the two decoders can never drift (the FLAC twin rule).
// ===========================================================================

namespace alac {

struct Err {};                        // malformed/truncated/hostile packet

struct ABits {
    const uint8_t* d;
    int64_t pos, n;
    ABits(const uint8_t* data, int64_t len) : d(data), pos(0), n(8 * len) {}
    uint64_t read(int k) {
        int64_t p = pos, e = p + k;
        if (e > n) throw Err{};
        pos = e;
        uint64_t v = 0;
        int64_t first = p >> 3, last = (e + 7) >> 3;
        for (int64_t i = first; i < last; ++i) v = (v << 8) | d[i];
        v >>= (last << 3) - e;
        return k == 64 ? v : (v & ((1ull << k) - 1));
    }
    int64_t read_signed(int k) {
        uint64_t v = read(k);
        if (k && (v >> (k - 1))) return (int64_t)v - ((int64_t)1 << k);
        return (int64_t)v;
    }
    int unary_ones_max9() {
        int count = 0;
        while (count < 9) {
            if (pos >= n) throw Err{};
            const int bit = (d[pos >> 3] >> (7 - (pos & 7))) & 1;
            ++pos;
            if (!bit) return count;
            ++count;
        }
        return count;
    }
};

static inline int64_t sign_ext(int64_t v, int bits) {
    v &= ((int64_t)1 << bits) - 1;
    if (v >> (bits - 1)) v -= (int64_t)1 << bits;
    return v;
}

static inline int bitlen(int64_t x) {
    int b = 0;
    while (x > 0) { ++b; x >>= 1; }
    return b;
}

static int64_t decode_scalar(ABits& br, int k, int bps) {
    const int x = br.unary_ones_max9();
    if (x > 8) return (int64_t)br.read(bps);
    if (k == 1) return x;
    const int64_t extra = (int64_t)br.read(k);
    int64_t v = ((int64_t)x << k) - x;
    if (extra > 1) return v + extra - 1;
    br.pos -= 1;                      // remainder 0 uses k-1 bits
    return v;
}

struct Cfg {
    int frame_length, bit_depth, pb, mb, kb, channels;
};

static void rice_decompress(ABits& br, int64_t* out, int64_t nb, int bps,
                            const Cfg& cfg, int history_mult) {
    int64_t history = cfg.mb;
    int64_t sign_modifier = 0;
    int64_t i = 0;
    while (i < nb) {
        int k = bitlen((history >> 9) + 3) - 1;
        if (k > cfg.kb) k = cfg.kb;
        const int64_t x = decode_scalar(br, k, bps) + sign_modifier;
        sign_modifier = 0;
        out[i] = (x >> 1) ^ -(x & 1);
        if (x > 0xFFFF) history = 0xFFFF;
        else history += x * history_mult - ((history * history_mult) >> 9);
        if (history < 128 && i + 1 < nb) {
            int kk = 7 - (history ? bitlen(history) - 1 : 0)
                     + (int)((history + 16) >> 6);
            if (kk > cfg.kb) kk = cfg.kb;
            int64_t block_size = decode_scalar(br, kk, 16);
            if (block_size > 0) {
                if (block_size >= nb - i) block_size = nb - i - 1;
                for (int64_t j = 0; j < block_size; ++j) out[i + 1 + j] = 0;
                i += block_size;
            }
            if (block_size <= 0xFFFF) sign_modifier = 1;
            history = 0;
        }
        ++i;
    }
}

static void lpc_predict(const int64_t* errs, int64_t* out, int64_t nb,
                        int bps, int64_t* coefs, int order, int quant) {
    if (nb == 0) return;
    out[0] = errs[0];
    if (order == 0) {
        for (int64_t i = 1; i < nb; ++i) out[i] = errs[i];
        return;
    }
    if (order == 31) {
        int64_t acc = errs[0];
        out[0] = acc;
        for (int64_t i = 1; i < nb; ++i) {
            acc = sign_ext(acc + errs[i], bps);
            out[i] = acc;
        }
        return;
    }
    if (quant <= 0) throw Err{};
    int64_t i = 1;
    for (; i <= order && i < nb; ++i)
        out[i] = sign_ext(out[i - 1] + errs[i], bps);
    const int64_t lim = (int64_t)1 << 40;
    for (; i < nb; ++i) {
        int64_t error_val = errs[i];
        const int64_t base = i - order;
        const int64_t d0 = out[base - 1];
        int64_t val = 0;
        for (int j = 0; j < order; ++j) val += (out[base + j] - d0) * coefs[j];
        val = (val + ((int64_t)1 << (quant - 1))) >> quant;
        val += d0 + error_val;
        if (val > lim || val < -lim) throw Err{};   // hostile-stream guard
        out[i] = sign_ext(val, bps);
        if (error_val > 0) {
            for (int j = 0; j < order && error_val > 0; ++j) {
                const int64_t v = d0 - out[base + j];
                const int64_t sign = (v > 0) - (v < 0);
                coefs[j] -= sign;
                error_val -= ((v * sign) >> quant) * (j + 1);
            }
        } else if (error_val < 0) {
            for (int j = 0; j < order && error_val < 0; ++j) {
                const int64_t v = d0 - out[base + j];
                const int64_t sign = -((v > 0) - (v < 0));
                coefs[j] -= sign;
                error_val -= ((v * sign) >> quant) * (j + 1);
            }
        }
    }
}

static const int CH_SLOTS[8][8] = {
    {0}, {0, 1}, {2, 0, 1}, {2, 0, 1, 3}, {2, 0, 1, 3, 4},
    {2, 0, 1, 4, 5, 3}, {2, 0, 1, 4, 5, 6, 3}, {2, 6, 7, 0, 1, 4, 5, 3}};

}  // namespace alac

extern "C" {

// Decode one ALAC packet.  out: channels * frame_length int32 (planar,
// channel-layout remapped).  Returns the sample count, or -1 on a
// malformed/truncated/hostile packet.
int64_t f9_alac_decode_packet(
    int32_t frame_length, int32_t bit_depth, int32_t pb, int32_t mb,
    int32_t kb, int32_t channels, const uint8_t* pkt, int64_t len,
    int32_t* out) {
    using namespace alac;
    const Cfg cfg{frame_length, bit_depth, pb, mb, kb, channels};
    ABits br(pkt, len);
    std::vector<int64_t> bufs((size_t)2 * frame_length);
    std::vector<int64_t> errs((size_t)frame_length);
    std::vector<int64_t> shift_vals((size_t)2 * frame_length);
    std::vector<int64_t> chan((size_t)channels * frame_length);
    try {
        int ch_index = 0;
        int64_t nb_packet = -1;
        for (;;) {
            const int element = (int)br.read(3);
            if (element == 7) break;                    // END
            int nch;
            if (element == 0 || element == 3) nch = 1;  // SCE / LFE
            else if (element == 1) nch = 2;             // CPE
            else return -1;
            if (ch_index + nch > channels) return -1;
            br.read(4);                                 // instance tag
            if (br.read(12) != 0) return -1;
            const int has_size = (int)br.read(1);
            const int bytes_shifted = (int)br.read(2);
            if (bytes_shifted == 3) return -1;
            const int uncompressed = (int)br.read(1);
            int64_t nb = has_size ? (int64_t)br.read(32) : frame_length;
            if (nb > frame_length) return -1;
            const int extra_bits = bytes_shifted * 8;
            const int bps = bit_depth - extra_bits + nch - 1;
            if (bps <= 0 || bps > 32) return -1;
            std::fill(bufs.begin(), bufs.end(), 0);
            if (!uncompressed) {
                const int decorr_shift = (int)br.read(8);
                const int64_t decorr_weight = br.read_signed(8);
                int modes[2], quants[2], pbfs[2], orders[2];
                int64_t coefs[2][32];
                for (int c = 0; c < nch; ++c) {
                    modes[c] = (int)br.read(4);
                    quants[c] = (int)br.read(4);
                    pbfs[c] = (int)br.read(3);
                    orders[c] = (int)br.read(5);
                    for (int j = orders[c] - 1; j >= 0; --j)
                        coefs[c][j] = br.read_signed(16);
                    if (modes[c] != 0 && modes[c] != 15) return -1;
                }
                if (bytes_shifted) {
                    for (int64_t i = 0; i < nb; ++i)
                        for (int c = 0; c < nch; ++c)
                            shift_vals[(size_t)(c * frame_length + i)] =
                                (int64_t)br.read(extra_bits);
                }
                for (int c = 0; c < nch; ++c) {
                    const int hist_mult = (cfg.pb * pbfs[c]) >> 2;
                    rice_decompress(br, errs.data(), nb, bps, cfg,
                                    hist_mult);
                    if (modes[c] == 15) {
                        for (int64_t i = 1; i < nb; ++i)
                            errs[(size_t)i] = sign_ext(
                                errs[(size_t)i] + errs[(size_t)(i - 1)],
                                bps);
                    }
                    lpc_predict(errs.data(),
                                bufs.data() + (size_t)c * frame_length, nb,
                                bps, coefs[c], orders[c], quants[c]);
                }
                if (nch == 2 && decorr_weight) {
                    int64_t* a = bufs.data();
                    int64_t* b = bufs.data() + frame_length;
                    for (int64_t i = 0; i < nb; ++i) {
                        const int64_t aa =
                            a[i] - ((b[i] * decorr_weight) >> decorr_shift);
                        const int64_t bb = b[i] + aa;
                        a[i] = bb;
                        b[i] = aa;
                    }
                }
                if (bytes_shifted) {
                    for (int c = 0; c < nch; ++c) {
                        int64_t* v = bufs.data() + (size_t)c * frame_length;
                        const int64_t* sv =
                            shift_vals.data() + (size_t)c * frame_length;
                        for (int64_t i = 0; i < nb; ++i)
                            v[i] = (v[i] << extra_bits) | sv[i];
                    }
                }
            } else {
                for (int64_t i = 0; i < nb; ++i)
                    for (int c = 0; c < nch; ++c)
                        bufs[(size_t)c * frame_length + i] =
                            br.read_signed(bit_depth);
            }
            for (int c = 0; c < nch; ++c) {
                const int row = channels <= 8
                                    ? CH_SLOTS[channels - 1][ch_index + c]
                                    : ch_index + c;
                std::memcpy(chan.data() + (size_t)row * frame_length,
                            bufs.data() + (size_t)c * frame_length,
                            (size_t)nb * 8);
            }
            ch_index += nch;
            if (nb_packet < 0) nb_packet = nb;
            else if (nb != nb_packet) return -1;
        }
        if (ch_index != channels) return -1;
        const int64_t n = nb_packet < 0 ? 0 : nb_packet;
        for (int c = 0; c < channels; ++c)
            for (int64_t i = 0; i < n; ++i)
                out[(size_t)c * frame_length + i] =
                    (int32_t)chan[(size_t)c * frame_length + i];
        return n;
    } catch (Err&) {
        return -1;
    }
}

}  // extern "C"

// ===========================================================================
// MPEG audio Layer III Huffman front half (io/mp3.py `_huffman_decode`).
//
// The big-values + count1 bitstream walk is the serial integer core of MP3
// decode (~2/3 of pure-Python decode time); everything float (requantize,
// stereo, IMDCT, synthesis) stays in NumPy.  This twin is BIT-IDENTICAL to
// the Python oracle by construction: the code trees are built from the SAME
// (length, symbol) lists io/mp3tables.py ships (passed in at init — single
// source of truth), and the walk mirrors the Python loop bit for bit,
// including the error conditions (reserved table, >19-bit lookup, count1
// overrun rollback) and the end+19 slack the spec's padding tolerance
// allows.  tests/test_mp3.py runs every decode through BOTH paths.

namespace mp3huff {

struct Node { int32_t kid[2]; int16_t sym; };  // sym >= 0 iff leaf

struct Tree {
    std::vector<Node> nodes;  // nodes[0] = root (present iff !empty)
    void clear() { nodes.clear(); }
    bool empty() const { return nodes.empty(); }
    int32_t add() {
        nodes.push_back(Node{{-1, -1}, -1});
        return (int32_t)nodes.size() - 1;
    }
    bool insert(int32_t length, int32_t code, int32_t sym) {
        if (nodes.empty()) add();
        int32_t cur = 0;
        for (int32_t i = length - 1; i >= 0; --i) {
            if (nodes[(size_t)cur].sym >= 0) return false;  // prefix clash
            const int bit = (code >> i) & 1;
            int32_t nxt = nodes[(size_t)cur].kid[bit];
            if (nxt < 0) {
                nxt = add();
                nodes[(size_t)cur].kid[bit] = nxt;
            }
            cur = nxt;
        }
        if (nodes[(size_t)cur].sym >= 0 || nodes[(size_t)cur].kid[0] >= 0 ||
            nodes[(size_t)cur].kid[1] >= 0)
            return false;
        nodes[(size_t)cur].sym = (int16_t)sym;
        return true;
    }
};

static Tree g_tables[34];   // 0..31 big-values ids, 32 = quad A, 33 = quad B
static std::mutex g_mu;
static bool g_ready = false;

static inline int bit_at(const uint8_t* d, int64_t pos) {
    return (d[pos >> 3] >> (7 - (pos & 7))) & 1;
}

}  // namespace mp3huff

extern "C" {

// entries: flattened (table_id, length, code, symbol) int32 quads.
// table_id 1..31 = big-value tables ((x<<4)|y symbols), 32 = count1 A,
// 33 = count1 B.  Returns 0, or -1 on malformed input.
int32_t f9_mp3_huff_init(const int32_t* entries, int64_t n) {
    using namespace mp3huff;
    std::lock_guard<std::mutex> lk(g_mu);
    for (auto& t : g_tables) t.clear();
    g_ready = false;
    for (int64_t i = 0; i < n; ++i) {
        const int32_t tid = entries[4 * i];
        const int32_t len = entries[4 * i + 1];
        const int32_t code = entries[4 * i + 2];
        const int32_t sym = entries[4 * i + 3];
        if (tid < 1 || tid > 33 || len < 1 || len > 24 || sym < 0 ||
            sym > 255)
            return -1;
        if (!g_tables[tid].insert(len, code, sym)) return -1;
    }
    g_ready = true;
    return 0;
}

// One granule-channel: big-values regions + count1.  `pos`/`end` are bit
// positions into `data` (reservoir tail + main data + >=8 zero pad bytes —
// the caller guarantees end + 64 bits fit, mirroring the Python guard).
// tid* = resolved code table id (0 = all zeros, -1 = reserved), linb* =
// linbits per region; r1/r2/big_end are the clamped region line bounds.
// Outputs is_out[576] and meta_out[2] = {rzero, pos_after}; returns 0,
// or -1 exactly where the Python oracle raises Mp3Error.
int32_t f9_mp3_huffman(const uint8_t* data, int64_t nbytes, int64_t pos,
                       int64_t end, int32_t big_end, int32_t r1, int32_t r2,
                       int32_t tid0, int32_t tid1, int32_t tid2,
                       int32_t linb0, int32_t linb1, int32_t linb2,
                       int32_t count1table, int32_t* is_out,
                       int64_t* meta_out) {
    using namespace mp3huff;
    if (!g_ready) return -2;
    const int64_t hard = nbytes * 8;   // absolute safety bound (pad bytes)
    // pos may legally exceed end (a corrupt granule whose scalefactor
    // sums overrun part2_3_length) — the walk then errors via the
    // end+19 slack check, exactly like the Python oracle.  All reads
    // stay below end + 576 bits, which the caller's pad guarantees.
    if (end + 576 > hard || pos < 0 || pos > end + 576) return -3;
    std::memset(is_out, 0, 576 * sizeof(int32_t));
    const int32_t starts[3] = {0, r1, r2};
    const int32_t stops[3] = {r1, r2, big_end};
    const int32_t tids[3] = {tid0, tid1, tid2};
    const int32_t linbs[3] = {linb0, linb1, linb2};
    for (int reg = 0; reg < 3; ++reg) {
        const int32_t start = starts[reg], stop = stops[reg];
        if (stop <= start) continue;
        const int32_t tid = tids[reg];
        if (tid < 0) return -1;           // reserved table named in frame
        if (tid == 0) continue;           // table 0: all zeros
        const Tree& tree = g_tables[tid];
        if (tree.empty()) return -2;
        const int32_t linbits = linbs[reg];
        for (int32_t line = start; line < stop; line += 2) {
            int32_t cur = 0;
            int32_t length = 0;
            for (;;) {
                const int bit = bit_at(data, pos);
                ++pos;
                ++length;
                cur = tree.nodes[(size_t)cur].kid[bit];
                if (cur >= 0 && tree.nodes[(size_t)cur].sym >= 0) break;
                if (cur < 0 || length > 19 || pos >= end + 19) return -1;
            }
            const int32_t sym = tree.nodes[(size_t)cur].sym;
            int32_t x = sym >> 4, y = sym & 15;
            if (x == 15 && linbits) {
                int32_t ext = 0;
                for (int32_t k = 0; k < linbits; ++k) {
                    ext = (ext << 1) | bit_at(data, pos);
                    ++pos;
                }
                x += ext;
            }
            if (x) {
                if (bit_at(data, pos)) x = -x;
                ++pos;
            }
            is_out[line] = x;
            if (y == 15 && linbits) {
                int32_t ext = 0;
                for (int32_t k = 0; k < linbits; ++k) {
                    ext = (ext << 1) | bit_at(data, pos);
                    ++pos;
                }
                y += ext;
            }
            if (y) {
                if (bit_at(data, pos)) y = -y;
                ++pos;
            }
            is_out[line + 1] = y;
        }
    }
    const Tree& qt = g_tables[count1table ? 33 : 32];
    if (qt.empty()) return -2;
    int32_t line = big_end;
    while (pos < end && line < 576) {
        const int64_t sp = pos;
        int32_t cur = 0;
        int32_t length = 0;
        int32_t v = -1;
        while (length < 7) {
            const int bit = bit_at(data, pos);
            ++pos;
            ++length;
            cur = qt.nodes[(size_t)cur].kid[bit];
            if (cur < 0) return -1;
            if (qt.nodes[(size_t)cur].sym >= 0) {
                v = qt.nodes[(size_t)cur].sym;
                break;
            }
        }
        if (v < 0) return -1;
        const int32_t quad[4] = {(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1,
                                 v & 1};
        for (int k = 0; k < 4; ++k) {
            int32_t q = quad[k];
            if (q) {
                if (bit_at(data, pos)) q = -q;
                ++pos;
            }
            if (line + k < 576) is_out[line + k] = q;
        }
        if (pos > end) {
            // final quad overran part2_3_length: the encoder's padding
            // bits happened to look like a codeword — discard it
            for (int k = 0; k < 4 && line + k < 576; ++k)
                is_out[line + k] = 0;
            pos = sp;
            break;
        }
        line += 4;
    }
    int32_t rzero = line < 576 ? line : 576;
    while (rzero > 0 && is_out[rzero - 1] == 0) --rzero;
    meta_out[0] = rzero;
    meta_out[1] = pos;
    return 0;
}

}  // extern "C"
