// (value, index) reductions that keep the FIRST minimum.
//
// Blocks and warps combine partial results in no fixed order, so every
// combine compares the index as well as the value: on equal values the
// smaller index wins.  That reproduces the row-major first-minimum
// tie-breaking of the JAX engine (jnp.argmin) at every level.  A masked
// cell takes part with value +inf, so a fully masked range yields
// (+inf, smallest index), as jnp.argmin does.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

// Columns of a row of n floats at `row` before its first 16-byte boundary
// (at most n): a row scan reads them one by one, then float4.
__device__ __forceinline__ int head_columns(const float* row, int n) {
    const unsigned misalign = (unsigned)reinterpret_cast<uintptr_t>(row) & 15u;
    return min((int)(((16u - misalign) & 15u) >> 2), n);
}

__device__ __forceinline__ bool first_min_better(float v, long long c, float bv, long long bc) {
    return v < bv || (v == bv && c < bc);
}

__device__ __forceinline__ bool first_min_better(float v, int c, float bv, int bc) {
    return v < bv || (v == bv && c < bc);
}

// Reduce one (v, c) per lane to the warp's first minimum, 32-bit indices;
// the result is valid in lane 0.
__device__ __forceinline__ void warp_first_min(float& v, int& c) {
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oc = __shfl_down_sync(0xffffffffu, c, off);
        if (first_min_better(ov, oc, v, c)) { v = ov; c = oc; }
    }
}

// Reduce (v, c) over a row's group of T contiguous lanes of a warp (T a
// power of two up to 32); valid in the group's first lane.  Every lane of
// the warp takes part.
template <int T>
__device__ __forceinline__ void group_first_min(float& v, int& c) {
    for (int off = T / 2; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off, T);
        const int oc = __shfl_down_sync(0xffffffffu, c, off, T);
        if (first_min_better(ov, oc, v, c)) { v = ov; c = oc; }
    }
}

// Reduce one (v, c) per thread to the block's first minimum; the result
// is valid in thread 0.  blockDim.x must be a multiple of 32, at most 1024.
__device__ __forceinline__ void block_first_min(float& v, long long& c) {
    __shared__ float sv[32];
    __shared__ long long sc[32];
    const unsigned lane = threadIdx.x & 31u, warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const long long oc = __shfl_down_sync(0xffffffffu, c, off);
        if (first_min_better(ov, oc, v, c)) { v = ov; c = oc; }
    }
    if (lane == 0) { sv[warp] = v; sc[warp] = c; }
    __syncthreads();
    if (warp == 0) {
        const unsigned nwarps = blockDim.x >> 5;
        v = lane < nwarps ? sv[lane] : CUDART_INF_F;
        c = lane < nwarps ? sc[lane] : LLONG_MAX;
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_down_sync(0xffffffffu, v, off);
            const long long oc = __shfl_down_sync(0xffffffffu, c, off);
            if (first_min_better(ov, oc, v, c)) { v = ov; c = oc; }
        }
    }
}
