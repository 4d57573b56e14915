// Masked (min, flat argmin) of a square distance matrix, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/minscan.py::masked_argmin_pallas
// (the merge loop's seed, once per run).  Cell (r, c) takes part when
// alive[r], alive[c] and r != c; ties go to the first minimum in row-major
// order; a fully masked matrix gives (+inf, 0).
//
// Bound: one read of the L x L live cells of D (4 bytes a cell) at
// 3.35 TB/s; the operations are a compare a cell.  This kernel reads whole
// live rows, 4 L n bytes.  Design: the TPU kernel kept one
// candidate per row slab and reduced the slabs in a jnp epilogue.  Blocks
// on the card run in no order, so pass 1 gives every row its own block
// (coalesced reads of one contiguous row, dead rows not read at all) and
// writes that row's first minimum; pass 2, one block, reduces the n row
// results keeping the first row that attains the minimum.  Both passes
// compare indices on equal values (first_min.cuh), so the result does not
// depend on the order in which blocks finish.
#include "first_min.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kReduceThreads = 1024;

__global__ void __launch_bounds__(kRowThreads)
masked_row_min(const float* __restrict__ D, const unsigned char* __restrict__ alive,
               long long n, float* __restrict__ rmin, long long* __restrict__ rarg) {
    const long long r = blockIdx.x;
    float bv = CUDART_INF_F;
    long long bc = LLONG_MAX;
    if (alive[r]) {
        const float* row = D + r * n;
#pragma unroll 4
        for (long long c = threadIdx.x; c < n; c += kRowThreads) {
            const float v = (alive[c] && c != r) ? row[c] : CUDART_INF_F;
            if (first_min_better(v, c, bv, bc)) { bv = v; bc = c; }
        }
    } else if (threadIdx.x == 0) {
        bc = 0;  // a dead row is all +inf: its first minimum is column 0
    }
    block_first_min(bv, bc);
    if (threadIdx.x == 0) { rmin[r] = bv; rarg[r] = bc; }
}

__global__ void __launch_bounds__(kReduceThreads)
first_min_over_rows(const float* __restrict__ rmin, const long long* __restrict__ rarg,
                    long long n, float* __restrict__ out_v, long long* __restrict__ out_flat) {
    float bv = CUDART_INF_F;
    long long br = LLONG_MAX;
    for (long long r = threadIdx.x; r < n; r += kReduceThreads) {
        if (first_min_better(rmin[r], r, bv, br)) { bv = rmin[r]; br = r; }
    }
    block_first_min(bv, br);
    if (threadIdx.x == 0) { *out_v = bv; *out_flat = br * n + rarg[br]; }
}

}  // namespace

// D: (n, n) float32, alive: (n,) bool, rmin/rarg: (n,) scratch; outputs one
// float32 and one int64.  Launches on `stream` of CUDA device `device`;
// returns cudaGetLastError().
extern "C" int masked_argmin(int device, const float* D, const unsigned char* alive, long long n,
                             float* rmin, long long* rarg, float* out_v, long long* out_flat,
                             cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    masked_row_min<<<(unsigned)n, kRowThreads, 0, stream>>>(D, alive, n, rmin, rarg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    first_min_over_rows<<<1, kReduceThreads, 0, stream>>>(rmin, rarg, n, out_v, out_flat);
    return (int)cudaGetLastError();
}
