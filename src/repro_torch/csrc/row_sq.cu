// One row of squared Euclidean distances, (d,) x (m, d) -> (m,), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise.py::row_sq_euclidean_pallas
// (every trip of the matrix-free NN chain: the chain tip against every
// geometric summary).  out[k] = sum_c (Y[k, c] - x[c])^2 in float32.
//
// Bound: bytes.  The row reads Y once and writes m floats, 4 (m d + m + d)
// bytes, against 3 m d flops: at m = 32768, d = 128 that is 16.9 MB, which
// fits in the 50 MB L2, so a chain that builds one row after another reads
// the summaries from L2, not from HBM (chip_smoke.py measures the card's L2
// read rate for this bound).  Design: the TPU kernel put the row on the MXU
// in Gram form (xx + yy - 2 x.y).  A single row is a matrix-vector product
// that no tensor core helps, so this kernel takes the difference form: the
// same bytes, no cancellation, and the arithmetic of the JAX package's own
// jnp row.  One warp owns one point row at a time (a grid-stride loop over
// rows); every warp reads the tip x through the read-only cache, where its
// few hundred bytes stay; rows are read with 16-byte loads when d % 4 == 0
// and both operands are 16-byte aligned; a warp shuffle sums the 32 lanes.
// There is no padding: the kernel masks its own ragged edge in m and d.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float sq_diff4(float4 a, float4 b) {
    const float t0 = a.x - b.x, t1 = a.y - b.y, t2 = a.z - b.z, t3 = a.w - b.w;
    return t0 * t0 + t1 * t1 + t2 * t2 + t3 * t3;
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
row_sq_kernel(const float* __restrict__ x, const float* __restrict__ Y, long long m,
              long long d, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * kWarps;
    for (long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); k < m; k += stride) {
        const float* y = Y + k * d;
        float acc = 0.0f;
        if (kVec4) {
            const float4* y4 = reinterpret_cast<const float4*>(y);
            const float4* x4 = reinterpret_cast<const float4*>(x);
            for (long long q = lane; q < d / 4; q += 32)
                acc += sq_diff4(__ldg(y4 + q), __ldg(x4 + q));
        } else {
            for (long long c = lane; c < d; c += 32) {
                const float t = __ldg(y + c) - __ldg(x + c);
                acc += t * t;
            }
        }
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) out[k] = acc;
    }
}

template <bool kVec4>
void launch(const float* x, const float* Y, long long m, long long d, float* out,
            cudaStream_t stream) {
    const long long blocks = (m + kWarps - 1) / kWarps;
    row_sq_kernel<kVec4><<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0,
                           stream>>>(x, Y, m, d, out);
}

}  // namespace

// x: (d,) float32, Y: (m, d) float32 row-major, out: (m,) float32.  Launches
// on `stream` of CUDA device `device` (nothing when m == 0); returns
// cudaGetLastError().
extern "C" int row_sq_euclidean(int device, const float* x, const float* Y, long long m,
                                long long d, float* out, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (m <= 0) return 0;
    const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    if (vec4) launch<true>(x, Y, m, d, out, stream);
    else launch<false>(x, Y, m, d, out, stream);
    return (int)cudaGetLastError();
}
