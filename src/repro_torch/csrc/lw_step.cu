// Fused Lance-Williams merge step, for sm_90a.
//
// Replaces the Pallas TPU kernel repro/kernels/lw_step.py::lw_step_pallas
// (every merge of the loop, n-1 launches a run).  For the merge of slots
// i < j it
//   1. evaluates the LW recurrence for the merged row,
//   2. commits it into row i and column i of D (row/column j stay as
//      garbage; column i of a dead row gets 0, as in the TPU kernel), and
//   3. finds each row's (min, first column) of the post-merge masked
//      matrix, where j is dead: cell (r, c) counts when r and c are alive,
//      neither is j, and r != c.  A fully masked row gives (+inf, 0).
//
// Two entries share the body.  lw_step takes the merge's scalars from the
// caller and writes the per-row results (the TPU kernel's contract).
// lw_merge is one whole merge of the device-resident loop: it reads the
// candidate (r, c, m) that the previous merge left on the device, and the
// last block to finish picks the next candidate (the first row attaining
// the minimum, then that row's first column) and does the bookkeeping: the
// merge record at a device-side counter, alive, the liveness bitmask and
// the sizes.  The host reads nothing back, so a chunk of merges is
// captured once as a CUDA graph and replayed.
//
// Bound: bytes.  The step needs the L x L live cells of D read once and row
// and column i written, about 4 L^2 bytes for L slots live after the merge,
// against a few operations a cell: tensor cores do not apply.  This kernel
// reads whole live rows, 4 L n bytes; the dead columns are compaction's
// work.  What the design does about the bytes it does read:
//   - 16-byte loads.  A row is read as float4, neighbouring threads on
//     neighbouring addresses, several loads in flight a thread.  A row is
//     16-byte aligned only when n % 4 == 0, so the columns before its first
//     16-byte boundary and its ragged tail are read one by one.
//   - Liveness once a block.  A bitmask of ceil(n/32) words (2 KiB at
//     n = 16384) is staged in shared memory instead of a byte load a cell.
//     The resident loop keeps it on the device (the epilogue clears bit j);
//     lw_step packs it from the bool mask in a first, small launch.
//   - 32-bit column indices in the inner loop.  A thread visits its columns
//     in increasing order, so a strict v < best keeps its first minimum; the
//     index breaks ties only where threads combine (first_min.cuh).
//   - A grid that serves small n.  Up to n = 1024 a warp owns a row (8 rows
//     a block), up to n = 4096 two warps do (n = 1968 is 492 blocks, not
//     1968 blocks of 256 threads each scanning 8 cells), above it a block
//     owns a row.  A dead row only writes its 0 into column i.
//   - No row copies.  D stays exactly symmetric, so row r's threads read
//     D(r, i) and D(r, j) from their own row and row i's threads read rows i
//     and j.  No cell is read by one block and written by another in the
//     same launch: column i is written only by its own row's threads, row i
//     only by row i's, and the one cell of row j that is written, D(j, i),
//     is one row i's threads never read (column i of the merged row is 0,
//     not a recurrence).  Row r's scan skips column i and reads its cells
//     before the row's reduction (a barrier of its warp or block); the
//     row's first thread then reads D(r, i) and D(r, j), folds the new
//     value into the row's minimum and writes it, the row's one write.
//   - Short dependency chains for small n, where a merge is a few
//     microseconds of latency: a warp-owned row is read in one pass of 8
//     float4 a thread, the merge's sizes and D(r, i), D(r, j) are read
//     beside the scan, not before it, and the merged row issues all its
//     loads of a pass before computing a cell.
//   - Every block of the main pass reads sizes, alive and the candidate as
//     they were before the merge; only the epilogue, in the last block to
//     draw the ticket (last_block.cuh), writes them.  The running minimum is
//     one 64-bit atomicMin a block on a key packed as (order-preserving bits
//     of the value, row), which keeps the first row attaining the minimum,
//     as torch.min does.  The next D(r, c) is the value half of the winning
//     key, the exact float that won; the one cell the last block reads from
//     another block, rarg[r], its writer fences before the ticket.
//
// The recurrence is the shared lance_williams.cuh, rounded operation by
// operation as linkage.update_row, so the kernel agrees bit for bit with
// the plain torch step.
//
// The merge entry's batch form, lw_merge_batch, is lw_merge_batch.cu; the
// row primitives the two files share are lw_rows.cuh.
#include "first_min.cuh"
#include "lance_williams.cuh"
#include "last_block.cuh"
#include "lw_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kBlocksPerSM = 4;
// Up to kWarpRowMaxN a warp owns a row, up to kPairRowMaxN two warps do,
// above it the block does.
constexpr long long kWarpRowMaxN = 1024;
constexpr long long kPairRowMaxN = 4096;

struct Operands {
    float* D;                  // (n, n), updated in place
    float* sizes;              // (n,) cluster sizes before the merge
    unsigned* bits;            // ceil(n/32) words: liveness before the merge
    int n;
    float* rmin;               // (n,) each row's (min, first column) after the merge
    long long* rarg;
    // lw_step: the merge's scalars, one element each
    const float* dij;
    const float* ni;
    const float* nj;
    const long long* pi;
    const long long* pj;
    // lw_merge: the candidate and the bookkeeping
    long long* cand;           // (r, c)
    float* dmin;               // D(r, c)
    unsigned char* alive;      // (n,) bool
    float* merges;             // (cap, 4) rows (i, j, dist, new size)
    long long cap;
    long long* count;          // merges recorded: the next row of `merges`
    unsigned long long* sync;  // the running minimum's key, the block ticket
};

// The merge's slots and distance; its sizes come later (merge_sizes), off
// the path to the first row loads.
template <bool kResident>
__device__ __forceinline__ Merge read_merge(const Operands& a) {
    if constexpr (kResident) {
        const long long r = a.cand[0], c = a.cand[1];
        return {(int)min(r, c), (int)max(r, c), *a.dmin, 0.0f, 0.0f};
    } else {
        return {(int)*a.pi, (int)*a.pj, *a.dij, 0.0f, 0.0f};
    }
}

template <bool kResident>
__device__ __forceinline__ void merge_sizes(const Operands& a, Merge& m) {
    if constexpr (kResident) {
        m.ni = a.sizes[m.i];
        m.nj = a.sizes[m.j];
    } else {
        m.ni = *a.ni;
        m.nj = *a.nj;
    }
}

// Reduce the row's (v, c) over its G warps; the result is valid in the
// row's first thread.
template <int G>
__device__ __forceinline__ void row_first_min(float& v, int& c) {
    warp_first_min(v, c);
    if constexpr (G > 1) {
        __shared__ float sv[kWarps];
        __shared__ int sc[kWarps];
        const int warp = threadIdx.x >> 5;
        if ((threadIdx.x & 31) == 0) { sv[warp] = v; sc[warp] = c; }
        __syncthreads();
        if (threadIdx.x % (32 * G) == 0) {
            for (int w = warp + 1; w < warp + G; ++w)
                if (first_min_better(sv[w], sc[w], v, c)) { v = sv[w]; c = sc[w]; }
        }
    }
}

// The last block of a merge to finish: the next candidate and the
// bookkeeping, once every block has read the state from before the merge.
// Each row's writer fenced its rmin/rarg before the block barrier, and the
// ticket is drawn with release and acquire (last_block.cuh).
__device__ __forceinline__ void finish_merge(const Operands& a, const Merge& m,
                                             const unsigned long long* block_keys, int rows,
                                             unsigned blocks) {
    __shared__ bool last;
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned long long key = kKeyInit;
        for (int g = 0; g < rows; ++g) key = min(key, block_keys[g]);
        if (key < kKeyInit) atomicMin(a.sync, key);
        last = draw_ticket(a.sync + 1, blocks);
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    const unsigned long long key = atomicExch(a.sync, kKeyInit);
    const int r = (int)(key & 0xffffffffull);
    const long long t = *a.count;
    const float size = __fadd_rn(m.ni, m.nj);
    if (t < a.cap) {
        float* rec = a.merges + 4 * t;
        rec[0] = (float)m.i;
        rec[1] = (float)m.j;
        rec[2] = m.dij;
        rec[3] = size;
    }
    *a.count = t + 1;
    a.alive[m.j] = 0;
    a.bits[m.j >> 5] &= ~(1u << (m.j & 31));
    a.sizes[m.j] = 0.0f;
    a.sizes[m.i] = size;
    a.cand[0] = r;
    a.cand[1] = __ldcg(a.rarg + r);
    *a.dmin = key_value(key);
    a.sync[1] = 0;
}

// One merge; G warps own a row, kThreads / (32 G) rows a block, `rb` the
// block's row block and `blocks` the launch's blocks.
template <int M, int G, bool kResident>
__device__ __forceinline__ void step(const Operands& a, int rb, unsigned blocks) {
    constexpr int T = 32 * G;
    constexpr int R = kThreads / T;
    extern __shared__ unsigned s_bits[];
    __shared__ unsigned long long s_key[R];
    for (int w = threadIdx.x; w < (a.n + 31) >> 5; w += kThreads) s_bits[w] = a.bits[w];
    Merge m = read_merge<kResident>(a);
    __syncthreads();
    merge_sizes<kResident>(a, m);

    const int lane = threadIdx.x % T, group = threadIdx.x / T;
    const int r = rb * R + group;
    float bv = CUDART_INF_F, new_r = 0.0f;
    int bc = INT_MAX;
    if (r < a.n) {
        float* row = a.D + (long long)r * a.n;
        const bool live_r = r != m.j && is_live(s_bits, r);
        if (r == m.i) {
            merged_row<M, T, G == kWarps ? 2 : 4>(row, a.D + (long long)m.j * a.n, a.sizes,
                                                  a.n, m, live_r, s_bits, lane, bv, bc);
        } else if (live_r) {
            scan_row<T, G == kWarps ? kUnroll : 2 * kUnroll>(row, a.n, r, m, s_bits, lane, bv,
                                                             bc);
            new_r = lance_williams<M>(row[m.i], row[m.j], m.dij, m.ni, m.nj, a.sizes[r]);
        }
    }
    row_first_min<G>(bv, bc);
    if (lane == 0) {
        // cell (r, i): alive, not j, and not r (row i's own scan covers it)
        if (r < a.n && r != m.i && r != m.j && is_live(s_bits, r) && is_live(s_bits, m.i) &&
            m.i != m.j && first_min_better(new_r, m.i, bv, bc)) {
            bv = new_r;
            bc = m.i;
        }
        if (bv == CUDART_INF_F) bc = 0;  // no cell below +inf: the first column
        if (r < a.n) {
            if (r != m.i) a.D[(long long)r * a.n + m.i] = new_r;
            a.rmin[r] = bv;
            a.rarg[r] = bc;
        }
        if constexpr (kResident) {
            __threadfence();     // rarg[r] before the ticket: the last block reads it
            s_key[group] = r < a.n && bv < CUDART_INF_F ? min_key(bv, r) : kKeyInit;
        }
    }
    if constexpr (kResident) finish_merge(a, m, s_key, R, blocks);
}

// Four blocks an SM (at most 64 registers a thread): n = 1968 runs in one
// wave, and a row a block keeps enough loads in flight for HBM.
template <int M, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) lw_step_kernel(const Operands a) {
    step<M, G, false>(a, blockIdx.x, gridDim.x);
}

template <int M, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM) lw_merge_kernel(const Operands a) {
    step<M, G, true>(a, blockIdx.x, gridDim.x);
}

// alive as a bitmask: bit c % 32 of word c / 32.
__global__ void __launch_bounds__(kThreads)
pack_alive_kernel(const unsigned char* __restrict__ alive, int n, unsigned* __restrict__ bits) {
    const int c = blockIdx.x * kThreads + threadIdx.x;
    const unsigned word = __ballot_sync(0xffffffffu, c < n && alive[c]);
    if ((threadIdx.x & 31) == 0 && c < n) bits[c >> 5] = word;
}

size_t shared_bytes(int n) { return (size_t)((n + 31) / 32) * sizeof(unsigned); }

// Which entry a launch is.
enum Entry { kStep, kMerge };

// One launch of a single-problem entry: G warps own a row, by the row's length.
template <int M, Entry E>
struct Launch {
    template <int G>
    static void go(const Operands& a, cudaStream_t stream) {
        constexpr int R = kWarps / G;
        const unsigned blocks = (unsigned)((a.n + R - 1) / R);
        if constexpr (E == kMerge) {
            lw_merge_kernel<M, G><<<blocks, kThreads, shared_bytes(a.n), stream>>>(a);
        } else {
            lw_step_kernel<M, G><<<blocks, kThreads, shared_bytes(a.n), stream>>>(a);
        }
    }

    static void run(const Operands& a, cudaStream_t stream) {
        if (a.n <= kWarpRowMaxN) go<1>(a, stream);
        else if (a.n <= kPairRowMaxN) go<2>(a, stream);
        else go<kWarps>(a, stream);
    }

    template <int G>
    static const void* kernel() {
        if constexpr (E == kMerge) return (const void*)lw_merge_kernel<M, G>;
        else return (const void*)lw_step_kernel<M, G>;
    }

    static cudaError_t load(long long n, cudaFuncAttributes* attr) {
        const void* fn = n <= kWarpRowMaxN   ? kernel<1>()
                         : n <= kPairRowMaxN ? kernel<2>()
                                             : kernel<kWarps>();
        return cudaFuncGetAttributes(attr, fn);
    }
};

template <int M>
void launch_step(const Operands& a, cudaStream_t stream) { Launch<M, kStep>::run(a, stream); }

template <int M>
void launch_merge(const Operands& a, cudaStream_t stream) { Launch<M, kMerge>::run(a, stream); }

template <int M>
void load_entry(long long n, int entry, cudaFuncAttributes* attr, cudaError_t* err) {
    *err = entry == kMerge ? Launch<M, kMerge>::load(n, attr) : Launch<M, kStep>::load(n, attr);
}

}  // namespace

// D: (n, n) float32, updated in place (symmetric: rows i and j are read from
// it); sizes: (n,) float32 and alive: (n,) bool, both from before the
// merge; dij, ni, nj: one float32 each; i, j: one int64 each (i < j);
// bits: (ceil(n/32),) int32 scratch; rmin: (n,) float32 and rarg: (n,)
// int64 outputs.  n <= 393216 (the bitmask fits in 48 KiB of shared
// memory).  `method` indexes linkage.METHODS.  Launches on `stream` of CUDA
// device `device`; returns cudaGetLastError().
extern "C" int lw_step(int device, int method, float* D, const float* sizes,
                       const unsigned char* alive, const float* dij, const float* ni,
                       const float* nj, const long long* i, const long long* j, long long n,
                       unsigned* bits, float* rmin, long long* rarg, cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    pack_alive_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        alive, (int)n, bits);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    Operands a{};
    a.D = D;
    a.sizes = const_cast<float*>(sizes);
    a.bits = bits;
    a.n = (int)n;
    a.rmin = rmin;
    a.rarg = rarg;
    a.dij = dij;
    a.ni = ni;
    a.nj = nj;
    a.pi = i;
    a.pj = j;
    LW_DISPATCH_METHOD(method, launch_step, a, stream)
    return (int)cudaGetLastError();
}

// One merge of the device-resident loop, in place.  D: (n, n) float32;
// alive: (n,) bool; bits: (ceil(n/32),) int32, alive as a bitmask; sizes:
// (n,) float32; merges: (cap, 4) float32; cand: (r, c) int64 and dmin: one
// float32, the merge to make, replaced by the next candidate; count: one
// int64, the row of `merges` to write, advanced; rmin: (n,) float32 and
// rarg: (n,) int64, the rows' results; sync: two int64, (0xFF80...0, 0)
// between launches.  Launches on `stream` of CUDA device `device`; returns
// cudaGetLastError().
Operands merge_operands(float* D, unsigned char* alive, unsigned* bits, float* sizes,
                        float* merges, long long cap, long long* cand, float* dmin,
                        long long* count, float* rmin, long long* rarg,
                        unsigned long long* sync, long long n) {
    Operands a{};
    a.D = D;
    a.sizes = sizes;
    a.bits = bits;
    a.n = (int)n;
    a.rmin = rmin;
    a.rarg = rarg;
    a.cand = cand;
    a.dmin = dmin;
    a.alive = alive;
    a.merges = merges;
    a.cap = cap;
    a.count = count;
    a.sync = sync;
    return a;
}

extern "C" int lw_merge(int device, int method, float* D, unsigned char* alive, unsigned* bits,
                        float* sizes, float* merges, long long cap, long long* cand, float* dmin,
                        long long* count, float* rmin, long long* rarg, unsigned long long* sync,
                        long long n, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const Operands a = merge_operands(D, alive, bits, sizes, merges, cap, cand, dmin, count, rmin,
                                      rarg, sync, n);
    LW_DISPATCH_METHOD(method, launch_merge, a, stream)
    return (int)cudaGetLastError();
}

// Load the kernel a launch of `entry` (0 lw_step, 1 lw_merge) at this n
// takes, before a stream capture: CUDA loads kernels lazily, at their first
// launch, and a first load must not fall inside a capture.  Writes the
// kernel's registers a thread and local (spilled) bytes a thread; returns
// the CUDA error.
extern "C" int lw_merge_load(int device, int method, long long n, int entry, int* regs,
                             int* local_bytes) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr{};
    LW_DISPATCH_METHOD(method, load_entry, n, entry, &attr, &err)
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)err;
}
