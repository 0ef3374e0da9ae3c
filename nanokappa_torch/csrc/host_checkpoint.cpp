// The driver's particle_data.txt checkpoint on the host, in one pass over
// chunks of pool lanes on several threads.
//
// For each lane the pass selects the alive ones in lane order, clips the
// flattened mode into the table and splits it into (q-point, branch),
// forms the occupation as float64(dev) + be_table[mode], and formats the
// row "%d, %d, %.3f, %.3f, %.3f, %.6e\n" with std::to_chars, which gives
// np.savetxt's bytes for that format (nanokappa_torch/native.py
// format_particle_rows is the same formatter on one thread). Chunk c of
// `chunk_lanes` lanes writes its rows at out + c * chunk_cap; the caller
// writes the chunks in order, so the file's rows keep the lanes' order
// whatever thread formatted them.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread host_checkpoint.cpp
// Loaded through ctypes (nanokappa_torch/native.py).

#include <atomic>
#include <charconv>
#include <cstdint>
#include <system_error>
#include <thread>
#include <vector>

namespace {

// The most bytes one row takes: two int32 ids, three %.3f of float32
// values (at most 39 integer digits), one %.6e of a double, separators.
constexpr int64_t kRowMax = 192;

struct Rows {
    const float* pos;       // lane i, axis a at pos[i * pos_lane + a * pos_axis]
    int64_t pos_lane, pos_axis;
    const int32_t* mode;    // lane i at mode[i * mode_stride]
    int64_t mode_stride;
    const float* dev;       // lane i at dev[i * dev_stride]
    int64_t dev_stride;
    const uint8_t* alive;   // (n,) 0/1
    const double* be;       // (n_modes,) Bose-Einstein occupation at T_ref
    int32_t n_modes, n_branches;
};

inline char* put_sep(char* p) {
    p[0] = ',';
    p[1] = ' ';
    return p + 2;
}

// Rows of the alive lanes in [lo, hi) into [out, out + cap); the bytes
// written, or -1 if they do not fit.
int64_t format_lanes(const Rows& r, int64_t lo, int64_t hi, char* out, int64_t cap) {
    char* p = out;
    char* end = out + cap;
    for (int64_t i = lo; i < hi; ++i) {
        if (!r.alive[i]) continue;
        if (end - p < kRowMax) return -1;
        int32_t m = r.mode[i * r.mode_stride];
        m = m < 0 ? 0 : (m >= r.n_modes ? r.n_modes - 1 : m);
        const float* xyz = r.pos + i * r.pos_lane;
        const double occ = double(r.dev[i * r.dev_stride]) + r.be[m];
        p = std::to_chars(p, end, m / r.n_branches).ptr;
        p = put_sep(p);
        p = std::to_chars(p, end, m % r.n_branches).ptr;
        for (int a = 0; a < 3; ++a) {
            p = put_sep(p);
            p = std::to_chars(p, end, double(xyz[a * r.pos_axis]), std::chars_format::fixed, 3).ptr;
        }
        p = put_sep(p);
        p = std::to_chars(p, end, occ, std::chars_format::scientific, 6).ptr;
        *p++ = '\n';
    }
    return p - out;
}

}  // namespace

extern "C" {

// Formats the alive lanes of a pool's host rows as particle_data.txt rows,
// chunk c (lanes [c * chunk_lanes, (c + 1) * chunk_lanes)) into
// out + c * chunk_cap, its length into chunk_bytes[c]. `threads` threads
// (the caller's among them) take chunks in turn; at 1 nothing is spawned,
// and a thread the system refuses leaves its share to the others.
// Returns 0, or -1 if a chunk overflowed its cap.
int64_t format_checkpoint_rows(
    const float* pos, int64_t pos_lane, int64_t pos_axis,
    const int32_t* mode, int64_t mode_stride,
    const float* dev, int64_t dev_stride,
    const uint8_t* alive,
    int64_t n_lanes,
    const double* be_table, int32_t n_modes, int32_t n_branches,
    int64_t chunk_lanes, int32_t threads,
    char* out, int64_t chunk_cap, int64_t* chunk_bytes
) {
    const Rows r{pos, pos_lane, pos_axis, mode, mode_stride, dev, dev_stride,
                 alive, be_table, n_modes, n_branches};
    const int64_t n_chunks = (n_lanes + chunk_lanes - 1) / chunk_lanes;
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        for (int64_t c = next.fetch_add(1); c < n_chunks; c = next.fetch_add(1)) {
            const int64_t lo = c * chunk_lanes;
            const int64_t hi = lo + chunk_lanes < n_lanes ? lo + chunk_lanes : n_lanes;
            chunk_bytes[c] = format_lanes(r, lo, hi, out + c * chunk_cap, chunk_cap);
        }
    };
    std::vector<std::thread> pool;
    for (int32_t t = 1; t < threads; ++t) {
        try {
            pool.emplace_back(work);
        } catch (const std::system_error&) {
            break;
        }
    }
    work();
    for (auto& t : pool) t.join();
    for (int64_t c = 0; c < n_chunks; ++c)
        if (chunk_bytes[c] < 0) return -1;
    return 0;
}

}  // extern "C"
