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
// outside the tensor cores, against 3.14 GB, 0.94 ms at 3.35 TB/s.  The
// products are FFMA in full float32: TF32 tensor cores miss the 1e-4
// tolerance.  The design is a register-tiled SIMT GEMM:
//   - A 128 x 128 output tile a block, 256 threads, 8 x 8 sums a thread in
//     registers, as four 4 x 4 quadrants 64 rows and 64 columns apart.  For
//     each k a thread reads its 8 rows and 8 columns as four 16-byte shared
//     loads and does 64 FFMAs.  A warp covers a 4 x 8 patch of the 16 x 16
//     thread grid, so its loads are 4 and 8 distinct float4 of one shared
//     row: broadcasts, one wavefront each.
//   - d is staged in chunks of 8 columns, transposed (x and y rows become
//     shared columns), through two stages of shared memory.  The transpose
//     takes the register path: each thread loads one float4 of X and one of
//     Y a chunk, and the next chunk's loads are issued before the current
//     chunk is computed, then stored into the other stage; one barrier a
//     chunk.  The shared row pitch of 132 floats keeps the float4 reads
//     aligned and the transposed stores of a warp on 32 distinct banks.
//   - The norms ride on the staging: each thread sums the squares of the
//     float4 it loaded, and the two threads of a row add theirs at the end.
//   - The epilogue stages each half of the tile (64 x 128) in shared memory
//     and writes it row by row, a warp on 32 consecutive floats: coalesced
//     whatever m is (m = 6155 leaves rows unaligned for float4 stores), and
//     streaming (st.global.cs), since the matrix is written once.
//   - Tiles are numbered column tile first, so the blocks in flight share
//     their X tile through L2; Y (3 MB at k = 6155) stays in L2.
//   - __launch_bounds__(256, 2): at most 128 registers a thread, two blocks
//     an SM; 33.8 KB of dynamic shared memory a block (under the 48 KB that
//     needs no opt-in).
// n, m and d are ragged and masked, nothing is padded; output offsets are
// 64-bit.  d % 4 != 0 or operands not 16-byte aligned take scalar loads.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kTile = 128;                // output tile: kTile x kTile a block
constexpr int kHalf = kTile / 2;          // the quadrants' offset
constexpr int kChunk = 8;                 // d staged kChunk columns at a time
constexpr int kThreads = 256;             // 16 x 16 threads, 8 x 8 outputs each
constexpr int kLd = kTile + 4;            // shared row pitch, in floats
constexpr int kStage = 2 * kChunk * kLd;  // one stage: the X chunk, then the Y chunk
constexpr int kSmemFloats = 2 * kStage > kHalf * kLd ? 2 * kStage : kHalf * kLd;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);
static_assert(kSmemBytes <= 48 * 1024, "above 48 KB needs cudaFuncSetAttribute");

// Columns k .. k + 3 of a row, 0 past d or for a row past the end.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* row, bool ok, long long k, long long d) {
    if constexpr (kVec) {   // d % 4 == 0: the float4 is all in or all out
        return ok && k < d ? __ldg(reinterpret_cast<const float4*>(row + k))
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    } else {
        return make_float4(ok && k < d ? __ldg(row + k) : 0.0f,
                           ok && k + 1 < d ? __ldg(row + k + 1) : 0.0f,
                           ok && k + 2 < d ? __ldg(row + k + 2) : 0.0f,
                           ok && k + 3 < d ? __ldg(row + k + 3) : 0.0f);
    }
}

__device__ __forceinline__ float sum_sq(float4 v, float acc) {
    acc = fmaf(v.x, v.x, acc);
    acc = fmaf(v.y, v.y, acc);
    acc = fmaf(v.z, v.z, acc);
    return fmaf(v.w, v.w, acc);
}

// The loaded float4 of X and Y into a stage, transposed: chunk column k of
// tile row r goes to shared row k, column r.
__device__ __forceinline__ void stage_chunk(float* s, int r, int k, float4 x, float4 y) {
    s[(k + 0) * kLd + r] = x.x;
    s[(k + 1) * kLd + r] = x.y;
    s[(k + 2) * kLd + r] = x.z;
    s[(k + 3) * kLd + r] = x.w;
    s += kChunk * kLd;
    s[(k + 0) * kLd + r] = y.x;
    s[(k + 1) * kLd + r] = y.y;
    s[(k + 2) * kLd + r] = y.z;
    s[(k + 3) * kLd + r] = y.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
pairwise_sq_kernel(const float* __restrict__ X, const float* __restrict__ Y, long long n,
                   long long m, long long d, long long col_tiles, float* __restrict__ out) {
    extern __shared__ __align__(16) float smem[];
    __shared__ float xn[kTile], yn[kTile];

    const int t = threadIdx.x;
    const long long row0 = (long long)blockIdx.x / col_tiles * kTile;
    const long long col0 = (long long)blockIdx.x % col_tiles * kTile;
    // loader: tile row lr, chunk columns lk .. lk + 3 of both operands
    const int lr = t >> 1, lk = (t & 1) * 4;
    const bool xok = row0 + lr < n, yok = col0 + lr < m;
    const float* xrow = X + (xok ? row0 + lr : 0) * d;
    const float* yrow = Y + (yok ? col0 + lr : 0) * d;
    // this thread's sums: rows ty*4 + i (+ 64), columns tx*4 + j (+ 64)
    const int warp = t >> 5, lane = t & 31;
    const int ty = (warp >> 1) * 4 + (lane >> 3), tx = (warp & 1) * 8 + (lane & 7);

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float4 xv = load4<kVec>(xrow, xok, lk, d), yv = load4<kVec>(yrow, yok, lk, d);
    float xsq = sum_sq(xv, 0.0f), ysq = sum_sq(yv, 0.0f);
    stage_chunk(smem, lr, lk, xv, yv);
    __syncthreads();

    const long long chunks = (d + kChunk - 1) / kChunk;
    for (long long c = 0; c < chunks; ++c) {
        const bool more = c + 1 < chunks;
        if (more) {   // the next chunk's loads fly while this one is computed
            xv = load4<kVec>(xrow, xok, (c + 1) * kChunk + lk, d);
            yv = load4<kVec>(yrow, yok, (c + 1) * kChunk + lk, d);
        }
        const float* xs = smem + (c & 1) * kStage;
        const float* ys = xs + kChunk * kLd;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            const float4 a0 = *reinterpret_cast<const float4*>(xs + k * kLd + ty * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(xs + k * kLd + kHalf + ty * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(ys + k * kLd + tx * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(ys + k * kLd + kHalf + tx * 4);
            const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        if (more) {
            xsq = sum_sq(xv, xsq);
            ysq = sum_sq(yv, ysq);
            stage_chunk(smem + ((c + 1) & 1) * kStage, lr, lk, xv, yv);
        }
        __syncthreads();
    }
    // the two threads of a tile row hold its two halves of every chunk
    xsq += __shfl_xor_sync(0xffffffffu, xsq, 1);
    ysq += __shfl_xor_sync(0xffffffffu, ysq, 1);
    if ((t & 1) == 0) {
        xn[lr] = xsq;
        yn[lr] = ysq;
    }
    __syncthreads();

    // epilogue, a half of the tile at a time through shared memory
    float* cs = smem;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int rl = ty * 4 + i;
            const float x2 = xn[h * kHalf + rl];
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                const int cl = q * kHalf + tx * 4, a = h * 4 + i, b = q * 4;
                float4 v;
                v.x = fmaxf(x2 + yn[cl + 0] - 2.0f * acc[a][b + 0], 0.0f);
                v.y = fmaxf(x2 + yn[cl + 1] - 2.0f * acc[a][b + 1], 0.0f);
                v.z = fmaxf(x2 + yn[cl + 2] - 2.0f * acc[a][b + 2], 0.0f);
                v.w = fmaxf(x2 + yn[cl + 3] - 2.0f * acc[a][b + 3], 0.0f);
                *reinterpret_cast<float4*>(cs + rl * kLd + cl) = v;
            }
        }
        __syncthreads();
        for (int rl = warp; rl < kHalf; rl += kThreads / 32) {
            const long long r = row0 + h * kHalf + rl;
            if (r >= n) break;
            float* orow = out + r * m + col0;
#pragma unroll
            for (int q = 0; q < kTile / 32; ++q) {
                const int cl = lane + 32 * q;
                if (col0 + cl < m) __stcs(orow + cl, cs[rl * kLd + cl]);
            }
        }
        if (h == 0) __syncthreads();
    }
}

}  // namespace

// X: (n, d) float32, Y: (m, d) float32, both row-major; out: (n, m) float32.
// Launches on `stream` of CUDA device `device` (nothing when n or m is 0);
// returns cudaGetLastError(), or cudaErrorInvalidValue when the tiles
// outnumber a grid's 2^31 - 1 blocks.
extern "C" int pairwise_sq_euclidean(int device, const float* X, const float* Y, long long n,
                                     long long m, long long d, float* out, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || m <= 0) return 0;
    const long long row_tiles = (n + kTile - 1) / kTile, col_tiles = (m + kTile - 1) / kTile;
    if (row_tiles > 0x7fffffffLL / col_tiles) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)(row_tiles * col_tiles);
    const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    if (vec)
        pairwise_sq_kernel<true><<<blocks, kThreads, kSmemBytes, stream>>>(X, Y, n, m, d,
                                                                            col_tiles, out);
    else
        pairwise_sq_kernel<false><<<blocks, kThreads, kSmemBytes, stream>>>(X, Y, n, m, d,
                                                                             col_tiles, out);
    return (int)cudaGetLastError();
}
