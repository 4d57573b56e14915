// Fused Lance-Williams merge step, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/lw_step.py::lw_step_pallas
// (every merge of the loop, n-1 launches a run).  For the merge of slots
// i < j it
//   1. evaluates the LW recurrence for the merged row,
//   2. commits it into row i and column i of D (row/column j stay as
//      garbage; column i of a dead row gets 0, as in the TPU kernel), and
//   3. writes each row's (min, first column) of the post-merge masked
//      matrix, where j is dead: cell (r, c) counts when r and c are alive,
//      neither is j, and r != c.  A fully masked row gives (+inf, 0).
//
// Bound: bytes.  The step needs the L x L live cells of D read once and row
// i and column i written, about 4 L^2 bytes for L slots live after the
// merge, against a few flops a cell.  This kernel reads whole live rows,
// 4 L n bytes.  Design: D is updated in place.  One block owns one row, reads it
// once with coalesced loads, and writes only its own cells (its cell of
// column i, or all of row i), so blocks share no data and need no order.
// The two fetched rows are copies taken before the launch, which makes the
// in-place update safe.  Rows that are dead after the merge are not read.
// Unlike the TPU kernel, which rewrites every slab, this one stores 2n
// cells instead of n^2.  The merge scalars (d_ij, n_i, n_j, i, j) are read
// from device memory, so the host never waits for them.
//
// The recurrence is the shared lance_williams.cuh, rounded operation by
// operation as linkage.update_row, so the kernel agrees bit for bit with
// the plain torch step.
#include "first_min.cuh"
#include "lance_williams.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void __launch_bounds__(kThreads)
lw_step_kernel(float* __restrict__ D, const float* __restrict__ dki,
               const float* __restrict__ dkj, const float* __restrict__ sizes,
               const unsigned char* __restrict__ alive, const float* __restrict__ p_dij,
               const float* __restrict__ p_ni, const float* __restrict__ p_nj,
               const long long* __restrict__ p_i, const long long* __restrict__ p_j,
               long long n, float* __restrict__ rmin, long long* __restrict__ rarg) {
    const long long r = blockIdx.x;
    const long long i = *p_i, j = *p_j;
    const float dij = *p_dij, ni = *p_ni, nj = *p_nj;
    float* row = D + r * n;

    // cell (r, i) after the merge: the recurrence at spectator r, 0 elsewhere
    const bool keep_r = alive[r] && r != i && r != j;
    const float new_r = keep_r ? lance_williams<M>(dki[r], dkj[r], dij, ni, nj, sizes[r]) : 0.0f;
    const bool live_r = alive[r] && r != j;  // row r's liveness after the merge

    float bv = CUDART_INF_F;
    long long bc = LLONG_MAX;
    if (r == i) {
        // the merged row, written whole
#pragma unroll 4
        for (long long c = threadIdx.x; c < n; c += kThreads) {
            const bool keep_c = alive[c] && c != i && c != j;
            const float v = keep_c ? lance_williams<M>(dki[c], dkj[c], dij, ni, nj, sizes[c]) : 0.0f;
            row[c] = v;
            const float m = (live_r && keep_c) ? v : CUDART_INF_F;
            if (first_min_better(m, c, bv, bc)) { bv = m; bc = c; }
        }
    } else if (live_r) {
#pragma unroll 4
        for (long long c = threadIdx.x; c < n; c += kThreads) {
            const float v = c == i ? new_r : row[c];
            const float m = (alive[c] && c != j && c != r) ? v : CUDART_INF_F;
            if (first_min_better(m, c, bv, bc)) { bv = m; bc = c; }
        }
        if (threadIdx.x == 0) row[i] = new_r;  // no thread of this block reads row[i]
    } else if (threadIdx.x == 0) {
        row[i] = new_r;
        bc = 0;  // a dead row is all +inf: its first minimum is column 0
    }
    block_first_min(bv, bc);
    if (threadIdx.x == 0) { rmin[r] = bv; rarg[r] = bc; }
}

template <int M>
void launch(float* D, const float* dki, const float* dkj, const float* sizes,
            const unsigned char* alive, const float* dij, const float* ni, const float* nj,
            const long long* i, const long long* j, long long n, float* rmin, long long* rarg,
            cudaStream_t stream) {
    lw_step_kernel<M><<<(unsigned)n, kThreads, 0, stream>>>(D, dki, dkj, sizes, alive, dij,
                                                              ni, nj, i, j, n, rmin, rarg);
}

}  // namespace

// D: (n, n) float32, updated in place; dki, dkj, sizes: (n,) float32; alive:
// (n,) bool; dij, ni, nj: one float32 each; i, j: one int64 each (i < j);
// rmin: (n,) float32 and rarg: (n,) int64 outputs.  `method` indexes
// linkage.METHODS.  Launches on `stream` of CUDA device `device`; returns
// cudaGetLastError().
extern "C" int lw_step(int device, int method, float* D, const float* dki, const float* dkj,
                       const float* sizes, const unsigned char* alive, const float* dij,
                       const float* ni, const float* nj, const long long* i, const long long* j,
                       long long n, float* rmin, long long* rarg, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    LW_DISPATCH_METHOD(method, launch, D, dki, dkj, sizes, alive, dij, ni, nj, i, j, n, rmin, rarg,
                       stream)
    return (int)cudaGetLastError();
}
