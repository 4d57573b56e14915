// Pairwise squared Euclidean distances, (n, d) x (m, d) -> (n, m), for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/pairwise.py::pairwise_sq_euclidean_pallas
// (the streaming labeler's one distance call: queries against the k cluster
// representatives, and the landmark tier's (n - k, k) assignment).
// out[a, b] = max(|x_a|^2 + |y_b|^2 - 2 x_a . y_b, 0) in float32: the TPU
// kernel's Gram form, which keeps the labels of the JAX package's kernel route.
//
// Bound: operations.  2 n m d flops against 4 (n d + m d + n m) bytes; at
// (124917, 6155, 128) that is 1.97e11 flops, 2.94 ms at the card's 67 TFLOP/s
// outside the tensor cores, against 3.14 GB, 0.94 ms at 3.35 TB/s.  Design: a
// block computes a 64 x 64 output tile with 256 threads, each holding a 4 x 4
// tile of sums in registers.  d is staged through shared memory in chunks of
// 16 (the point rows stored transposed, so that a thread reads its 4 rows and
// its 4 columns as two float4), and the products are FFMA only: TF32 tensor
// cores would miss the 1e-4 tolerance.  Both norms are summed from the same
// staged chunks, by the first 128 threads.  The epilogue is the add, the clamp
// and the store.  n, m and d are ragged and masked, nothing is padded; output
// offsets are 64-bit, and row tiles go on gridDim.x, whose limit is 2^31 - 1.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // output tile: kTile x kTile
constexpr int kChunk = 16;                // d staged kChunk columns at a time
constexpr int kThreads = 256;             // 16 x 16 threads, 4 x 4 outputs each
constexpr int kMicro = 4;
constexpr int kPad = 4;                   // keeps rows 16-byte aligned, halves bank conflicts
constexpr long long kMaxGridY = 65535;

__global__ void __launch_bounds__(kThreads)
pairwise_sq_kernel(const float* __restrict__ X, const float* __restrict__ Y, long long n,
                   long long m, long long d, float* __restrict__ out) {
    __shared__ __align__(16) float xs[kChunk][kTile + kPad];
    __shared__ __align__(16) float ys[kChunk][kTile + kPad];
    __shared__ float xn[kTile], yn[kTile];

    const int t = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * kTile;
    const long long col0 = (long long)blockIdx.y * kTile;
    // loader: tile row lr, chunk columns lc .. lc + 3 of both operands
    const int lr = t >> 2, lc = (t & 3) * kMicro;
    const long long xr = row0 + lr, yr = col0 + lr;
    const float* xrow = X + xr * d;
    const float* yrow = Y + yr * d;
    // this thread's outputs: rows ty*4 .. +3, columns tx*4 .. +3 of the tile
    const int ty = t >> 4, tx = t & 15;

    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
        for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
    float norm = 0.0f;    // threads 0..63: |x|^2 of tile row t; 64..127: |y|^2 of row t - 64

    for (long long k0 = 0; k0 < d; k0 += kChunk) {
#pragma unroll
        for (int q = 0; q < kMicro; ++q) {
            const long long c = k0 + lc + q;
            xs[lc + q][lr] = (xr < n && c < d) ? __ldg(xrow + c) : 0.0f;
            ys[lc + q][lr] = (yr < m && c < d) ? __ldg(yrow + c) : 0.0f;
        }
        __syncthreads();
        if (t < 2 * kTile) {
            const int r = t & (kTile - 1);
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
                const float v = t < kTile ? xs[k][r] : ys[k][r];
                norm = fmaf(v, v, norm);
            }
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * kMicro]);
            const float4 b = *reinterpret_cast<const float4*>(&ys[k][tx * kMicro]);
            const float av[kMicro] = {a.x, a.y, a.z, a.w};
            const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < kMicro; ++i)
#pragma unroll
                for (int j = 0; j < kMicro; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    if (t < kTile) xn[t] = norm;
    else if (t < 2 * kTile) yn[t - kTile] = norm;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
        const long long r = row0 + ty * kMicro + i;
        if (r >= n) break;
        float* orow = out + r * m;
#pragma unroll
        for (int j = 0; j < kMicro; ++j) {
            const long long c = col0 + tx * kMicro + j;
            if (c < m)
                orow[c] = fmaxf(xn[ty * kMicro + i] + yn[tx * kMicro + j] - 2.0f * acc[i][j], 0.0f);
        }
    }
}

}  // namespace

// X: (n, d) float32, Y: (m, d) float32, both row-major; out: (n, m) float32.
// Launches on `stream` of CUDA device `device` (nothing when n or m is 0);
// returns cudaGetLastError(), or cudaErrorInvalidValue when m needs more than
// 65535 column tiles.
extern "C" int pairwise_sq_euclidean(int device, const float* X, const float* Y, long long n,
                                     long long m, long long d, float* out, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || m <= 0) return 0;
    const long long row_tiles = (n + kTile - 1) / kTile, col_tiles = (m + kTile - 1) / kTile;
    if (col_tiles > kMaxGridY || row_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)row_tiles, (unsigned)col_tiles);
    pairwise_sq_kernel<<<grid, kThreads, 0, stream>>>(X, Y, n, m, d, out);
    return (int)cudaGetLastError();
}
