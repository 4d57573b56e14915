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
// A third entry, lw_merge_batch, is the merge entry with a lane index more:
// B stacked problems of n slots merge in lockstep, one launch a merge of
// every lane (the batched kernel engine of a shape bucket).  Lane b's
// operands sit at b n^2 (D), b n (alive, sizes, rmin, rarg), b ceil(n/32)
// (bits), b cap 4 (merges) and b times the width of each per-lane word
// (cand, dmin, count, limit, sync).  The grid's x axis is lane-major over
// each lane's row blocks (gridDim.y would stop at 65535 lanes); the ticket
// is a lane's, drawn by its blocks, and the lane's last block does its
// epilogue.  A lane whose count has reached its limit (it made its
// min(max(n_real - stop_at_k, 0), n_steps) merges, or it is padding with
// n_real = 0) is a no-op: its first block adds one to its count, which
// then counts the lockstep merges, and no cell, record or word of it is
// written.  The single-problem entry is this body compiled without the
// lane index.
#include "first_min.cuh"
#include "lance_williams.cuh"
#include "last_block.cuh"

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
    // lw_merge_batch: each lane's merge limit, and its blocks
    const long long* limit;
    int lane_blocks;

    // Lane `b`'s operands of a batch of stacked problems.
    __device__ __forceinline__ Operands lane(long long b) const {
        const long long nn = (long long)n * n, words = (n + 31) >> 5;
        Operands l = *this;
        l.D += b * nn;
        l.sizes += b * n;
        l.bits += b * words;
        l.rmin += b * n;
        l.rarg += b * n;
        l.cand += 2 * b;
        l.dmin += b;
        l.alive += b * n;
        l.merges += b * cap * 4;
        l.count += b;
        l.sync += 2 * b;
        l.limit += b;
        return l;
    }
};

struct Merge {
    int i, j;
    float dij, ni, nj;
};

__device__ __forceinline__ bool is_live(const unsigned* bits, int c) {
    return (bits[c >> 5] >> (c & 31)) & 1u;
}

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

// Row r's first minimum over its valid cells but column i, U float4 loads
// in flight a thread: cell (r, c) counts when c is alive and not i, j or r.
// Column i's new value is folded in after the row's reduction, so the scan
// does not wait for it.
template <int T, int U>
__device__ __forceinline__ void scan_row(const float* row, int n, int r, const Merge& m,
                                         const unsigned* bits, int lane, float& bv, int& bc) {
    auto visit = [&](float v, int c) {
        if (v < bv && c != m.i && c != m.j && c != r && is_live(bits, c)) { bv = v; bc = c; }
    };
    const int head = head_columns(row, n);
    const int body = head + ((n - head) & ~3);
    if (lane < head) visit(row[lane], lane);
    for (int c0 = head + 4 * lane; c0 < body; c0 += 4 * T * U) {
        float4 x[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) x[u] = *reinterpret_cast<const float4*>(row + c);
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                visit(x[u].x, c);
                visit(x[u].y, c + 1);
                visit(x[u].z, c + 2);
                visit(x[u].w, c + 3);
            }
        }
    }
    if (body + lane < n) visit(row[body + lane], body + lane);
}

// The merged row, written whole, and its first minimum (when row i is live
// after the merge): cell (i, c) is the recurrence at spectator c, 0 where c
// is dead, i or j.  One row a merge, but the kernel's last row to finish
// when its loads wait one by one: every load of a pass is issued before
// any cell is computed, U float4 of row i with the matching cells of row j
// and sizes (fewer where a block owns a row, to spare registers).
template <int M, int T, int U>
__device__ __forceinline__ void merged_row(float* row_i, const float* row_j, const float* sizes,
                                           int n, const Merge& m, bool live_i,
                                           const unsigned* bits, int lane, float& bv, int& bc) {
    // row j's cell (j, i) belongs to row j's threads, which write it: never read
    auto dkj = [&](int c) { return c != m.i ? row_j[c] : 0.0f; };
    auto cell = [&](float dki, float dkj, float nk, int c) {
        const bool keep = c != m.i && c != m.j && is_live(bits, c);
        const float v = keep ? lance_williams<M>(dki, dkj, m.dij, m.ni, m.nj, nk) : 0.0f;
        if (live_i && keep && v < bv) { bv = v; bc = c; }
        return v;
    };
    const int head = head_columns(row_i, n);
    const int body = head + ((n - head) & ~3);
    if (lane < head) row_i[lane] = cell(row_i[lane], dkj(lane), sizes[lane], lane);
    for (int c0 = head + 4 * lane; c0 < body; c0 += 4 * T * U) {
        float4 x[U], y[U], nk[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                x[u] = *reinterpret_cast<const float4*>(row_i + c);
                y[u] = make_float4(dkj(c), dkj(c + 1), dkj(c + 2), dkj(c + 3));
                nk[u] = make_float4(sizes[c], sizes[c + 1], sizes[c + 2], sizes[c + 3]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int c = c0 + 4 * T * u;
            if (c < body) {
                float4 v;  // one statement a cell: the columns are visited in order
                v.x = cell(x[u].x, y[u].x, nk[u].x, c);
                v.y = cell(x[u].y, y[u].y, nk[u].y, c + 1);
                v.z = cell(x[u].z, y[u].z, nk[u].z, c + 2);
                v.w = cell(x[u].w, y[u].w, nk[u].w, c + 3);
                *reinterpret_cast<float4*>(row_i + c) = v;
            }
        }
    }
    const int c = body + lane;
    if (c < n) row_i[c] = cell(row_i[c], dkj(c), sizes[c], c);
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
// block's row block within its lane and `blocks` the lane's blocks.
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

// The batch: block x is row block x % lane_blocks of lane x / lane_blocks.
template <int M, int G>
__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
lw_merge_batch_kernel(const Operands a0) {
    const int b = blockIdx.x / a0.lane_blocks, rb = blockIdx.x - b * a0.lane_blocks;
    const Operands a = a0.lane(b);
    if (*a.count >= *a.limit) {   // the lane made its merges: a no-op, counted
        if (rb == 0 && threadIdx.x == 0) *a.count += 1;
        return;
    }
    step<M, G, true>(a, rb, a0.lane_blocks);
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
enum Entry { kStep, kMerge, kMergeBatch };

// One launch of `lanes` problems: G warps own a row, by the row's length.
template <int M, Entry E>
struct Launch {
    template <int G>
    static void go(Operands a, long long lanes, cudaStream_t stream) {
        constexpr int R = kWarps / G;
        const unsigned blocks = (unsigned)((a.n + R - 1) / R);
        if constexpr (E == kMergeBatch) {
            a.lane_blocks = (int)blocks;
            lw_merge_batch_kernel<M, G>
                <<<(unsigned)(lanes * blocks), kThreads, shared_bytes(a.n), stream>>>(a);
        } else if constexpr (E == kMerge) {
            lw_merge_kernel<M, G><<<blocks, kThreads, shared_bytes(a.n), stream>>>(a);
        } else {
            lw_step_kernel<M, G><<<blocks, kThreads, shared_bytes(a.n), stream>>>(a);
        }
    }

    static void run(const Operands& a, long long lanes, cudaStream_t stream) {
        if (a.n <= kWarpRowMaxN) go<1>(a, lanes, stream);
        else if (a.n <= kPairRowMaxN) go<2>(a, lanes, stream);
        else go<kWarps>(a, lanes, stream);
    }

    template <int G>
    static const void* kernel() {
        if constexpr (E == kMergeBatch) return (const void*)lw_merge_batch_kernel<M, G>;
        else return (const void*)lw_merge_kernel<M, G>;
    }

    static cudaError_t load(long long n) {
        cudaFuncAttributes attr;
        const void* fn = n <= kWarpRowMaxN   ? kernel<1>()
                         : n <= kPairRowMaxN ? kernel<2>()
                                             : kernel<kWarps>();
        return cudaFuncGetAttributes(&attr, fn);
    }
};

template <int M>
void launch_step(const Operands& a, cudaStream_t stream) { Launch<M, kStep>::run(a, 1, stream); }

template <int M>
void launch_merge(const Operands& a, cudaStream_t stream) { Launch<M, kMerge>::run(a, 1, stream); }

template <int M>
void launch_merge_batch(const Operands& a, long long lanes, cudaStream_t stream) {
    Launch<M, kMergeBatch>::run(a, lanes, stream);
}

template <int M>
void load_merge(long long n, bool batch, cudaError_t* err) {
    *err = batch ? Launch<M, kMergeBatch>::load(n) : Launch<M, kMerge>::load(n);
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

// One lockstep merge of B stacked problems, in place, each lane as lw_merge
// on its own slices: D (B, n, n), alive and sizes (B, n), bits (B,
// ceil(n/32)), merges (B, cap, 4), cand (B, 2), dmin (B,), count (B,), rmin
// and rarg (B, n), sync (B, 2); limit (B,) int64, the merges a lane makes (a
// lane whose count reached it only adds one to its count).  Same stream and
// return as lw_merge.
extern "C" int lw_merge_batch(int device, int method, float* D, unsigned char* alive,
                              unsigned* bits, float* sizes, float* merges, long long cap,
                              long long* cand, float* dmin, long long* count, float* rmin,
                              long long* rarg, unsigned long long* sync, long long n,
                              const long long* limit, long long B, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    Operands a = merge_operands(D, alive, bits, sizes, merges, cap, cand, dmin, count, rmin, rarg,
                                sync, n);
    a.limit = limit;
    LW_DISPATCH_METHOD(method, launch_merge_batch, a, B, stream)
    return (int)cudaGetLastError();
}

// Load the lw_merge (batch: lw_merge_batch) kernel a launch at this n
// takes, before a stream capture: CUDA loads kernels lazily, at their first
// launch, and a first load must not fall inside a capture.  Returns the
// CUDA error.
extern "C" int lw_merge_load(int device, int method, long long n, int batch) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    LW_DISPATCH_METHOD(method, load_merge, n, batch != 0, &err)
    return (int)err;
}
