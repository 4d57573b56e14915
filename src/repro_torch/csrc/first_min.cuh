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

__device__ __forceinline__ bool first_min_better(float v, long long c, float bv, long long bc) {
    return v < bv || (v == bv && c < bc);
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
