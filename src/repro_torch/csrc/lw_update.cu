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
//
// Two more entries make one merge of the `lazy` loop device-resident, in
// two launches that read nothing back, so that a chunk of merges replays as
// a CUDA graph (engine._lazy_resident_ops):
//   lazy_merge (a thread a lane, ceil(n/256) blocks): this row update over
//     rows i and j of D, written into row and column i in place (j stays as
//     garbage); then, lane by lane, the cached row minima's invalidation of
//     engine._cache_invalidate: column i lowers a row's (min, first column)
//     where it beats it (an equal value wins on a smaller column), and the
//     rows whose cached column was i or j, not lowered and alive, are stale.
//     Row i is always stale, and the launch holds its whole masked row (the
//     kept lanes of the update), so it reduces row i's first minimum itself;
//     the other stale rows go on a list, by one atomicAdd a warp.  Every
//     row that is final folds (rmin, row) into the next candidate's key.
//     The last block by ticket writes the merge record, alive, the sizes
//     and row i's minimum.
//   lazy_rescan (a fixed grid of 132 blocks, one an H100 SM, so that the
//     graph stays valid): each stale row gets the (min, first column) of
//     its masked row, as engine._masked_row_mins does (dead columns and the
//     diagonal left out; a fully masked row gives (+inf, 0)), folded into
//     the candidate's key; the last block by ticket sets the next candidate
//     (the first live row attaining the minimum of rmin, then its cached
//     column) and empties the list.
// Bound: bytes.  The merge reads rows i and j, alive, sizes, rmin and rarg
// once and writes row and column i, 33 n bytes, the rescan reads 4 n bytes
// a stale row, and each cache entry rewritten (a lowered column's, a stale
// row's) takes 12: (33 + 4 s) n + 12 c for s stale rows and c entries.
// The rows stream from HBM once D outgrows L2 (n = 8192: 256 MiB).  Both
// launches are short; their time is latency: the launch, the ticket, and
// the last block's few dependent round trips (last_block.cuh).
//
// The batch form of this merge, one launch a lockstep merge of B stacked
// problems, is a body of its own: lazy_merge_batch.cu.
#include <climits>

#include "first_min.cuh"
#include "lance_williams.cuh"
#include "last_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRescanUnroll = 4;          // float4 loads of a stale row in flight a thread
constexpr int kRescanBlocks = 132;        // the rescan's fixed grid: one block an H100 SM

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

// The resident lazy loop's state, updated in place by each merge.
struct Lazy {
    float* D;                  // (n, n), garbage representation
    unsigned char* alive;      // (n,) bool
    float* sizes;              // (n,)
    float* merges;             // (cap, 4) rows (i, j, dist, new size)
    long long cap;
    long long* count;          // merges recorded: the next row of `merges`
    long long* cand;           // (r, c): the merge to make
    float* dmin;               // D(r, c)
    float* rmin;               // (n,) each row's cached (min, first column)
    long long* rarg;
    int* stale;                // (n,) rows to rescan, in no order
    int* n_stale;              // their count
    long long* rescanned;      // stale rows rescanned over the run
    unsigned long long* sync;  // row i's key, the merge's ticket, the next candidate's key,
                               // the rescan's ticket
    int n;
};

__device__ __forceinline__ unsigned long long warp_min_key(unsigned long long key) {
    for (int off = 16; off > 0; off >>= 1) key = min(key, __shfl_down_sync(0xffffffffu, key, off));
    return key;
}

// The merge: the update of row and column i, the caches' invalidation lane
// by lane, and in the last block the bookkeeping and row i's minimum.  `kb`
// is the block's index among the problem's `blocks`.
template <int M>
__device__ __forceinline__ void lazy_merge_body(const Lazy& a, int kb, unsigned blocks) {
    __shared__ unsigned long long s_key[2][kWarps];
    __shared__ bool last;
    const long long r = a.cand[0], c = a.cand[1];
    const int i = (int)min(r, c), j = (int)max(r, c);
    const float dij = *a.dmin, ni = a.sizes[i], nj = a.sizes[j];
    const int k = kb * kThreads + threadIdx.x, lane = threadIdx.x & 31;
    unsigned long long key_i = kKeyInit, key_c = kKeyInit;
    bool push = false;
    if (k < a.n) {
        const bool alive_k = a.alive[k], keep = alive_k && k != i && k != j;
        float* cell_ik = a.D + (long long)i * a.n + k;
        const float v = keep ? lance_williams<M>(*cell_ik, a.D[(long long)j * a.n + k], dij, ni,
                                                 nj, a.sizes[k])
                             : 0.0f;
        *cell_ik = v;                            // row i
        a.D[(long long)k * a.n + i] = v;         // column i
        if (keep) key_i = min_key(v, k);         // row i's masked row: the kept lanes
        if (k != i) {                            // row i's cache is the last block's
            // engine._cache_invalidate: column i (+inf off the kept lanes)
            const float col = keep ? v : CUDART_INF_F;
            float rm = a.rmin[k];
            long long ra = a.rarg[k];
            const bool lower = (col < rm || (col == rm && (long long)i < ra)) && k != j;
            if (lower) {
                rm = col;
                ra = i;
                a.rmin[k] = rm;
                a.rarg[k] = ra;
            }
            const bool live = alive_k && k != j;
            push = live && !lower && (ra == i || ra == j);
            if (live && !push) key_c = min_key(rm, k);
        }
    }
    // the stale rows onto the list, one atomicAdd a warp
    const unsigned pushed = __ballot_sync(0xffffffffu, push);
    if (pushed) {
        const int leader = __ffs(pushed) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(a.n_stale, __popc(pushed));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (push) a.stale[base + __popc(pushed & ((1u << lane) - 1u))] = k;
    }
    key_i = warp_min_key(key_i);
    key_c = warp_min_key(key_c);
    if (lane == 0) {
        s_key[0][threadIdx.x >> 5] = key_i;
        s_key[1][threadIdx.x >> 5] = key_c;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kWarps; ++w) {
            key_i = min(key_i, s_key[0][w]);
            key_c = min(key_c, s_key[1][w]);
        }
        if (key_i < kKeyInit) atomicMin(a.sync, key_i);
        if (key_c < kKeyInit) atomicMin(a.sync + 2, key_c);
        last = draw_ticket(a.sync + 1, blocks);
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    const unsigned long long ki = atomicExch(a.sync, kKeyInit);
    a.sync[1] = 0;
    const long long t = *a.count;
    const float size = __fadd_rn(ni, nj);
    if (t < a.cap) {
        float* rec = a.merges + 4 * t;
        rec[0] = (float)i;
        rec[1] = (float)j;
        rec[2] = dij;
        rec[3] = size;
    }
    *a.count = t + 1;
    const bool live_i = a.alive[i] && i != j;
    a.alive[j] = 0;
    a.sizes[j] = 0.0f;
    a.sizes[i] = size;
    if (live_i) {   // row i: its first minimum over the kept lanes, (+inf, 0) if none
        const float v = key_value(ki);
        a.rmin[i] = v;
        a.rarg[i] = (long long)(ki & 0xffffffffull);
        atomicMin(a.sync + 2, min_key(v, i));
    }
}

template <int M>
__global__ void __launch_bounds__(kThreads) lazy_merge_kernel(const Lazy a) {
    lazy_merge_body<M>(a, blockIdx.x, gridDim.x);
}

// Row k's first minimum over its live columns but k; a thread visits its
// columns in increasing order, kRescanUnroll float4 loads in flight.
__device__ __forceinline__ void rescan_row(const float* row, const unsigned char* alive, int n,
                                           int k, float& bv, int& bc) {
    auto visit = [&](float v, int c) {
        if (v < bv && c != k && alive[c]) { bv = v; bc = c; }
    };
    const int t = threadIdx.x;
    const int head = head_columns(row, n);
    const int body = head + ((n - head) & ~3);
    if (t < head) visit(row[t], t);
    for (int c0 = head + 4 * t; c0 < body; c0 += 4 * kThreads * kRescanUnroll) {
        float4 x[kRescanUnroll];
#pragma unroll
        for (int u = 0; u < kRescanUnroll; ++u) {
            const int cu = c0 + 4 * kThreads * u;
            if (cu < body) x[u] = *reinterpret_cast<const float4*>(row + cu);
        }
#pragma unroll
        for (int u = 0; u < kRescanUnroll; ++u) {
            const int cu = c0 + 4 * kThreads * u;
            if (cu < body) {
                visit(x[u].x, cu);
                visit(x[u].y, cu + 1);
                visit(x[u].z, cu + 2);
                visit(x[u].w, cu + 3);
            }
        }
    }
    if (body + t < n) visit(row[body + t], body + t);
}

// The rescan of the stale rows, a block a row, and in the last block the
// next candidate.  `p` is the block's index among the problem's `blocks`.
__device__ __forceinline__ void lazy_rescan_body(const Lazy& a, int p, unsigned blocks) {
    __shared__ float sv[kWarps];
    __shared__ int sc[kWarps];
    __shared__ bool last;
    const int ns = *a.n_stale, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    unsigned long long key_c = kKeyInit;
    for (int s = p; s < ns; s += (int)blocks) {
        const int k = a.stale[s];
        float bv = CUDART_INF_F;
        int bc = INT_MAX;
        rescan_row(a.D + (long long)k * a.n, a.alive, a.n, k, bv, bc);
        warp_first_min(bv, bc);
        if (lane == 0) {
            sv[warp] = bv;
            sc[warp] = bc;
        }
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int w = 1; w < kWarps; ++w)
                if (first_min_better(sv[w], sc[w], bv, bc)) { bv = sv[w]; bc = sc[w]; }
            if (bv == CUDART_INF_F) bc = 0;   // no cell below +inf: the first column
            a.rmin[k] = bv;
            a.rarg[k] = bc;
            key_c = min(key_c, min_key(bv, k));
        }
        __syncthreads();
    }
    if (threadIdx.x == 0) {
        if (key_c < kKeyInit) atomicMin(a.sync + 2, key_c);
        last = draw_ticket(a.sync + 3, blocks);   // releases this thread's rmin/rarg writes
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    const unsigned long long key = atomicExch(a.sync + 2, kKeyInit);
    const int r = (int)(key & 0xffffffffull);
    a.cand[0] = r;
    a.cand[1] = __ldcg(a.rarg + r);
    *a.dmin = key_value(key);
    *a.rescanned += ns;
    *a.n_stale = 0;
    a.sync[3] = 0;
}

__global__ void __launch_bounds__(kThreads) lazy_rescan_kernel(const Lazy a) {
    lazy_rescan_body(a, blockIdx.x, gridDim.x);
}

int merge_blocks(int n) { return (n + kThreads - 1) / kThreads; }

template <int M>
void launch_merge(const Lazy& a, cudaStream_t stream) {
    lazy_merge_kernel<M><<<(unsigned)merge_blocks(a.n), kThreads, 0, stream>>>(a);
}

template <int M>
void load_merge(cudaError_t* err) {
    cudaFuncAttributes attr;
    *err = cudaFuncGetAttributes(&attr, (const void*)lazy_merge_kernel<M>);
    if (*err == cudaSuccess) *err = cudaFuncGetAttributes(&attr, (const void*)lazy_rescan_kernel);
}

Lazy lazy_state(float* D, unsigned char* alive, float* sizes, float* merges, long long cap,
                long long* count, long long* cand, float* dmin, float* rmin, long long* rarg,
                int* stale, int* n_stale, long long* rescanned, unsigned long long* sync,
                long long n) {
    return Lazy{D, alive, sizes, merges, cap, count, cand, dmin, rmin, rarg, stale, n_stale,
                rescanned, sync, (int)n};
}

}  // namespace

// The resident lazy merge's two launches, in place on its state: D (n, n)
// float32; alive (n,) bool; sizes (n,) float32; merges (cap, 4) float32;
// count one int64; cand (r, c) int64 and dmin one float32, the merge to make,
// replaced by the next candidate; rmin (n,) float32 and rarg (n,) int64, the
// cached row minima; stale (n,) int32 and n_stale one int32 (0 between
// merges); rescanned one int64, advanced by the stale rows; sync four int64,
// (0xFF80...0, 0, 0xFF80...0, 0) between launches.  n < 2^31.  `method`
// indexes linkage.METHODS.  lazy_merge, then lazy_rescan, on `stream` of
// CUDA device `device`; each returns cudaGetLastError().
extern "C" int lazy_merge(int device, int method, float* D, unsigned char* alive, float* sizes,
                          float* merges, long long cap, long long* count, long long* cand,
                          float* dmin, float* rmin, long long* rarg, int* stale, int* n_stale,
                          long long* rescanned, unsigned long long* sync, long long n,
                          cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Lazy a = lazy_state(D, alive, sizes, merges, cap, count, cand, dmin, rmin, rarg, stale,
                              n_stale, rescanned, sync, n);
    LW_DISPATCH_METHOD(method, launch_merge, a, stream)
    return (int)cudaGetLastError();
}

extern "C" int lazy_rescan(int device, float* D, unsigned char* alive, float* sizes,
                           float* merges, long long cap, long long* count, long long* cand,
                           float* dmin, float* rmin, long long* rarg, int* stale, int* n_stale,
                           long long* rescanned, unsigned long long* sync, long long n,
                           cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Lazy a = lazy_state(D, alive, sizes, merges, cap, count, cand, dmin, rmin, rarg, stale,
                              n_stale, rescanned, sync, n);
    lazy_rescan_kernel<<<kRescanBlocks, kThreads, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

// Load both kernels of a lazy merge before a stream capture: CUDA loads
// kernels lazily, at their first launch, and a first load must not fall
// inside a capture.  Returns the CUDA error.
extern "C" int lazy_merge_load(int device, int method) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    LW_DISPATCH_METHOD(method, load_merge, &err)
    return (int)err;
}

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
