// Native host-side traceback decoder: banded-NW move-code array -> per-
// problem edit paths + CIGAR strings (reference: the backtrace phase of
// cudaaligner/src/ukkonen_gpu.cu and the host CIGAR RLE of
// cudaaligner/src/alignment_impl.cpp [U]).
//
// Two layouts of AlignmentState codes (0 match, 1 mismatch, 2 insertion,
// 3 deletion) come from the device:
//   row  — ops/nw_band.banded_nw: (Lq, B, W) one code per byte, band lane
//          r + j - i;
//   diag — ops/nw_diag_pallas: (B, ceil((Lq+Lt+1)/4), r+1), four
//          anti-diagonals per byte; cell (i, j) is at diagonal d = i + j,
//          half-band cell (j - i + r - par) / 2 with par = (d + r) & 1,
//          bits 2 * (d % 4).
// The walk is inherently serial per problem, so it belongs on the host; this
// C++ pass replaces the vectorized-NumPy lockstep walk with a single linear
// scan per problem and fuses the CIGAR run-length encoding into the same
// pass.  Semantics are bit-identical to ops/nw_band.traceback_paths,
// ops/nw_diag_pallas.traceback_paths_diag and cpu/nw_oracle.path_to_cigar
// (asserted by tests/test_native_traceback.py).
//
// Build: native/build.sh -> claragenomicsanalysis_tpu/io/_native/libtraceback.so

#include <cstdint>
#include <string>
#include <vector>

namespace {

constexpr uint8_t kMatch = 0;
constexpr uint8_t kMismatch = 1;
constexpr uint8_t kInsertion = 2;
constexpr uint8_t kDeletion = 3;

struct Result {
    std::vector<std::vector<uint8_t>> paths;
    std::vector<std::string> cigars;
};

void append_run(std::string* cigar, long count, char op) {
    if (count <= 0) return;
    *cigar += std::to_string(count);
    *cigar += op;
}

}  // namespace

extern "C" {

// tb: C-order uint8 — (rows, B, W) in the row layout (diag == 0), or
// (B, rows, W) in the diag layout (diag == 1).  qlen/tlen: (B,) int32;
// r: band radius.  extended: 0 -> M/I/D CIGAR ops (match+mismatch fold to
// M), 1 -> =/X/I/D.
void* cga_tb_decode(const uint8_t* tb, long rows, long B, long W,
                    const int32_t* qlen, const int32_t* tlen, long r,
                    int extended, int diag) {
    auto* res = new (std::nothrow) Result();
    if (!res) return nullptr;
    res->paths.resize(B);
    res->cigars.resize(B);
    const char op_of[2][4] = {{'M', 'M', 'I', 'D'}, {'=', 'X', 'I', 'D'}};
    const char* ops = op_of[extended ? 1 : 0];

    for (long b = 0; b < B; ++b) {
        long i = qlen[b];
        long j = tlen[b];
        std::vector<uint8_t>& path = res->paths[b];
        path.reserve(i + j);
        // Bound the walk at qlen+tlen steps (like the NumPy walker): a
        // band-overflow problem carries garbage codes, and an unbounded walk
        // on garbage (e.g. DELETION while j <= 0) would never terminate.
        // Callers drop truncated paths by status.
        const long max_steps = qlen[b] + tlen[b];
        while ((i > 0 || j > 0) && i >= 0 && j >= 0 &&
               static_cast<long>(path.size()) < max_steps) {
            uint8_t code;
            if (i == 0) {
                code = kDeletion;  // row 0: pure deletion tail
            } else if (diag) {
                const long d = i + j;
                long cell = (j - i + r - ((d + r) & 1)) >> 1;
                if (cell < 0) cell = 0;
                if (cell > W - 1) cell = W - 1;
                long row = d >> 2;
                if (row > rows - 1) row = rows - 1;
                const uint8_t byte = tb[(b * rows + row) * W + cell];
                code = (byte >> (2 * (d & 3))) & 3;
            } else {
                long lane = r + j - i;
                if (lane < 0) lane = 0;
                if (lane > W - 1) lane = W - 1;
                long row = i - 1;
                if (row > rows - 1) row = rows - 1;
                code = tb[(row * B + b) * W + lane];
            }
            path.push_back(code);
            if (code == kMatch || code == kMismatch || code == kInsertion) --i;
            if (code == kMatch || code == kMismatch || code == kDeletion) --j;
        }
        // walk emitted end-to-start: reverse, then RLE into the CIGAR
        std::string& cigar = res->cigars[b];
        long run = 0;
        char run_op = 0;
        for (size_t s = path.size(); s-- > 0;) {
            // in-place reverse: swap s with mirror once (do before RLE)
            size_t m = path.size() - 1 - s;
            if (s > m) std::swap(path[s], path[m]);
        }
        for (uint8_t code : path) {
            char op = ops[code & 3];
            if (op == run_op) {
                ++run;
            } else {
                append_run(&cigar, run, run_op);
                run_op = op;
                run = 1;
            }
        }
        append_run(&cigar, run, run_op);
    }
    return res;
}

long cga_tb_path_len(void* h, long b) {
    return static_cast<Result*>(h)->paths[b].size();
}

const uint8_t* cga_tb_path(void* h, long b) {
    return static_cast<Result*>(h)->paths[b].data();
}

const char* cga_tb_cigar(void* h, long b) {
    return static_cast<Result*>(h)->cigars[b].c_str();
}

void cga_tb_free(void* h) { delete static_cast<Result*>(h); }

}  // extern "C"
