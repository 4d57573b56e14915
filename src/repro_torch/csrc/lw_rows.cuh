// The row primitives of kernel B2 that its single-problem entries
// (lw_step.cu) and its batch form (lw_merge_batch.cu) share, with the batch
// forms of B1 and B3 (argmin_batch.cu, lazy_merge_batch.cu): the merge, a
// row's liveness test, a live row's first minimum and the merged row.
#pragma once

#include "first_min.cuh"
#include "lance_williams.cuh"

namespace {

struct Merge {
    int i, j;
    float dij, ni, nj;
};

__device__ __forceinline__ bool is_live(const unsigned* bits, int c) {
    return (bits[c >> 5] >> (c & 31)) & 1u;
}

// Row r's first minimum over its valid cells but column i, U float4 loads
// in flight a thread: cell (r, c) counts when c is alive and not i, j or r.
// Column i's new value is folded in after the row's reduction, so the scan
// does not wait for it.
template <int T, int U>
__device__ __forceinline__ void scan_row(const float* row, int n, int r, const Merge& m,
                                         const unsigned* bits, int lane, float& bv, int& bc) {
    auto visit = [&](float v, int c) {
        if (v < bv && c != m.i && c != m.j && c != r && is_live(bits, c)) { bv = v; bc = c; }
    };
    const int head = head_columns(row, n);
    const int body = head + ((n - head) & ~3);
    if (lane < head) visit(row[lane], lane);
    for (int c0 = head + 4 * lane; c0 < body; c0 += 4 * T * U) {
        float4 x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) x[u] = *reinterpret_cast<const float4*>(row + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                visit(x[u].x, c);
                visit(x[u].y, c + 1);
                visit(x[u].z, c + 2);
                visit(x[u].w, c + 3);
            }
        }
    }
    if (body + lane < n) visit(row[body + lane], body + lane);
}

// The merged row, written whole, and its first minimum (when row i is live
// after the merge): cell (i, c) is the recurrence at spectator c, 0 where c
// is dead, i or j.  One row a merge, but the kernel's last row to finish
// when its loads wait one by one: every load of a pass is issued before
// any cell is computed, U float4 of row i with the matching cells of row j
// and sizes (fewer where a block owns a row, to spare registers).
template <int M, int T, int U>
__device__ __forceinline__ void merged_row(float* row_i, const float* row_j, const float* sizes,
                                           int n, const Merge& m, bool live_i,
                                           const unsigned* bits, int lane, float& bv, int& bc) {
    // row j's cell (j, i) belongs to row j's threads, which write it: never read
    auto dkj = [&](int c) { return c != m.i ? row_j[c] : 0.0f; };
    auto cell = [&](float dki, float dkj, float nk, int c) {
        const bool keep = c != m.i && c != m.j && is_live(bits, c);
        const float v = keep ? lance_williams<M>(dki, dkj, m.dij, m.ni, m.nj, nk) : 0.0f;
        if (live_i && keep && v < bv) { bv = v; bc = c; }
        return v;
    };
    const int head = head_columns(row_i, n);
    const int body = head + ((n - head) & ~3);
    if (lane < head) row_i[lane] = cell(row_i[lane], dkj(lane), sizes[lane], lane);
    for (int c0 = head + 4 * lane; c0 < body; c0 += 4 * T * U) {
        float4 x[U], y[U], nk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                x[u] = *reinterpret_cast<const float4*>(row_i + c);
                y[u] = make_float4(dkj(c), dkj(c + 1), dkj(c + 2), dkj(c + 3));
                nk[u] = make_float4(sizes[c], sizes[c + 1], sizes[c + 2], sizes[c + 3]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                float4 v;  // one statement a cell: the columns are visited in order
                v.x = cell(x[u].x, y[u].x, nk[u].x, c);
                v.y = cell(x[u].y, y[u].y, nk[u].y, c + 1);
                v.z = cell(x[u].z, y[u].z, nk[u].z, c + 2);
                v.w = cell(x[u].w, y[u].w, nk[u].w, c + 3);
                *reinterpret_cast<float4*>(row_i + c) = v;
            }
        }
    }
    const int c = body + lane;
    if (c < n) row_i[c] = cell(row_i[c], dkj(c), sizes[c], c);
}

}  // namespace
