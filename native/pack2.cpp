// Native host-side 2-bit read packing for the mapper's sketch transfer
// (the hot half of ops/sketch.pack_reads; reference counterpart: the
// host index transfer path of cudamapper/src/index_host_copy.cu [U]).
//
// The NumPy version makes ~5 passes over the (B, L) int8 matrix (clip,
// astype, reshape, three shift-or combines) plus a 2-pass argwhere scan
// for ambiguous-base positions, pure host time on the mapper's critical
// path at a 100 Mbp run's chunk shape.  This fuses everything into ONE linear pass per row:
// pack four clipped bases per output byte and record in-span negative
// (N) positions as they fly by, in the same row-major order
// np.argwhere produces.  Semantics are bit-identical to pack_reads'
// NumPy path (asserted by tests/test_mapper_extras.py).
//
// Build: native/build.sh -> claragenomicsanalysis_tpu/io/_native/libpack2.so

#include <cstdint>
#include <vector>

namespace {

struct NPos {
    std::vector<int32_t> rows;
    std::vector<int32_t> cols;
};

}  // namespace

extern "C" {

// reads: (B, L) int8 row-major, L % 4 == 0; lens: (B,) int32.
// packed_out: (B, L/4) uint8, caller-allocated.
// Returns a handle holding the in-span N positions (row-major order).
void* cga_pack2(const int8_t* reads, long B, long L, const int32_t* lens,
                uint8_t* packed_out) {
    auto* np = new NPos();
    const long L4 = L / 4;
    for (long i = 0; i < B; ++i) {
        const int8_t* row = reads + i * L;
        uint8_t* out = packed_out + i * L4;
        const long n = lens[i];
        for (long j4 = 0; j4 < L4; ++j4) {
            const long j = j4 * 4;
            // clip(-1 -> 0) matches np.clip(reads, 0, 3): codes are in
            // [-1, 3], so only the negative sentinel needs the clamp
            const int8_t c0 = row[j], c1 = row[j + 1];
            const int8_t c2 = row[j + 2], c3 = row[j + 3];
            out[j4] = static_cast<uint8_t>(
                (c0 < 0 ? 0 : c0) | ((c1 < 0 ? 0 : c1) << 2) |
                ((c2 < 0 ? 0 : c2) << 4) | ((c3 < 0 ? 0 : c3) << 6));
            if (j < n) {
                // in-span ambiguous bases (rare): recorded in the same
                // row-major order np.argwhere yields
                const long hi = (j + 4 < n) ? j + 4 : n;
                for (long jj = j; jj < hi; ++jj) {
                    if (row[jj] < 0) {
                        np->rows.push_back(static_cast<int32_t>(i));
                        np->cols.push_back(static_cast<int32_t>(jj));
                    }
                }
            }
        }
    }
    return np;
}

long cga_pack2_n(void* h) {
    return static_cast<long>(static_cast<NPos*>(h)->rows.size());
}

const int32_t* cga_pack2_rows(void* h) {
    return static_cast<NPos*>(h)->rows.data();
}

const int32_t* cga_pack2_cols(void* h) {
    return static_cast<NPos*>(h)->cols.data();
}

void cga_pack2_free(void* h) { delete static_cast<NPos*>(h); }

}  // extern "C"
