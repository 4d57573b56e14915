// Lance-Williams row update of one merge, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/lw_update.py::lw_update_pallas
// (the `lazy` variant of the kernel backend: every merge, n-1 launches a
// run).  For the merge of slots i and j,
//
//   out[k] = a_i d_ki[k] + a_j d_kj[k] + b d_ij + g |d_ki[k] - d_kj[k]|
//
// with the coefficients of the method (ward's depend on sizes[k]), and 0
// where keep[k] is false (dead slots, i and j).
//
// Bound: bytes.  The bool mask is read and one float32 row written on
// every lane; rows i and j (and, for ward, sizes) are read on the kept
// lanes only, and each method reads only the merge scalars its
// coefficients use: with every lane kept, 17 n + 12 bytes for ward and
// 13 n + 4 for complete, against about a dozen flops a lane.  At n = 16384
// that is at most 279 KB, which its caller finds in L2.  The kernel is one
// thread a lane, with neighbouring threads on neighbouring addresses; the
// ragged edge is masked, so nothing is padded to the TPU's 128 lanes.  The
// merge scalars (d_ij, n_i, n_j) are read from device memory, so the host
// never waits for them.  A row of n = 16384 is 64 blocks: the launch, not
// the bytes, sets its time.
//
// The recurrence is the shared lance_williams.cuh, rounded operation by
// operation as linkage.update_row, so the kernel agrees bit for bit with
// the plain torch version.
#include "lance_williams.cuh"

namespace {

constexpr int kThreads = 256;

template <int M>
__global__ void __launch_bounds__(kThreads)
lw_update_kernel(const float* __restrict__ dki, const float* __restrict__ dkj,
                 const float* __restrict__ sizes, const unsigned char* __restrict__ keep,
                 const float* __restrict__ p_dij, const float* __restrict__ p_ni,
                 const float* __restrict__ p_nj, long long n, float* __restrict__ out) {
    const long long k = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (k >= n) return;
    out[k] = keep[k] ? lance_williams<M>(dki[k], dkj[k], *p_dij, *p_ni, *p_nj, sizes[k]) : 0.0f;
}

template <int M>
void launch(const float* dki, const float* dkj, const float* sizes, const unsigned char* keep,
            const float* dij, const float* ni, const float* nj, long long n, float* out,
            cudaStream_t stream) {
    const unsigned blocks = (unsigned)((n + kThreads - 1) / kThreads);
    lw_update_kernel<M><<<blocks, kThreads, 0, stream>>>(dki, dkj, sizes, keep, dij, ni, nj,
                                                          n, out);
}

}  // namespace

// dki, dkj, sizes: (n,) float32; keep: (n,) bool; dij, ni, nj: one float32
// each; out: (n,) float32 output (n >= 1).  `method` indexes
// linkage.METHODS.  Launches on `stream` of CUDA device `device`; returns
// cudaGetLastError().
extern "C" int lw_update(int device, int method, const float* dki, const float* dkj,
                         const float* sizes, const unsigned char* keep, const float* dij,
                         const float* ni, const float* nj, long long n, float* out,
                         cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    LW_DISPATCH_METHOD(method, launch, dki, dkj, sizes, keep, dij, ni, nj, n, out, stream)
    return (int)cudaGetLastError();
}
