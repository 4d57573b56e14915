// The Lance-Williams recurrence for one spectator k, shared by the kernels
// that apply it (lw_step.cu, lw_update.cu).
//
//   D(k, i u j) = a_i D(k,i) + a_j D(k,j) + b D(i,j) + g |D(k,i) - D(k,j)|
//
// with the coefficients of repro_torch.core.linkage.coefficients.  The _rn
// intrinsics forbid multiply-add contraction: each operation is rounded on
// its own, in the order of linkage.update_row, so a kernel built on this
// function agrees bit for bit with the plain torch version.
#pragma once

#include <cuda_runtime.h>

// Order of repro_torch.core.linkage.METHODS.
enum Method { kSingle = 0, kComplete, kAverage, kWeighted, kCentroid, kMedian, kWard };

template <int M>
__device__ __forceinline__ float lance_williams(float dki, float dkj, float dij,
                                                float ni, float nj, float nk) {
    float ai = 0.5f, aj = 0.5f, b = 0.0f, g = 0.0f;
    if (M == kSingle) g = -0.5f;
    if (M == kComplete) g = 0.5f;
    if (M == kAverage || M == kCentroid) {
        const float tot = __fadd_rn(ni, nj);
        ai = __fdiv_rn(ni, tot);
        aj = __fdiv_rn(nj, tot);
        if (M == kCentroid) b = __fdiv_rn(-__fmul_rn(ni, nj), __fmul_rn(tot, tot));
    }
    if (M == kMedian) b = -0.25f;
    if (M == kWard) {
        const float tot = __fadd_rn(__fadd_rn(ni, nj), nk);
        ai = __fdiv_rn(__fadd_rn(ni, nk), tot);
        aj = __fdiv_rn(__fadd_rn(nj, nk), tot);
        b = __fdiv_rn(-nk, tot);
    }
    const float s = __fadd_rn(__fadd_rn(__fmul_rn(ai, dki), __fmul_rn(aj, dkj)), __fmul_rn(b, dij));
    return __fadd_rn(s, __fmul_rn(g, fabsf(__fsub_rn(dki, dkj))));
}

// Instantiate `launch<M>` for the method index `method` and call it with
// `args`; an index outside METHODS returns cudaErrorInvalidValue.
#define LW_DISPATCH_METHOD(method, launch, ...)                          \
    switch (method) {                                                    \
        case kSingle: launch<kSingle>(__VA_ARGS__); break;               \
        case kComplete: launch<kComplete>(__VA_ARGS__); break;           \
        case kAverage: launch<kAverage>(__VA_ARGS__); break;             \
        case kWeighted: launch<kWeighted>(__VA_ARGS__); break;           \
        case kCentroid: launch<kCentroid>(__VA_ARGS__); break;           \
        case kMedian: launch<kMedian>(__VA_ARGS__); break;               \
        case kWard: launch<kWard>(__VA_ARGS__); break;                   \
        default: return (int)cudaErrorInvalidValue;                      \
    }
