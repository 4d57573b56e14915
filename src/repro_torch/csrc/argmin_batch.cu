// Kernel B1's batch form, for sm_90a: each lane's masked (min, flat argmin)
// of B stacked (n, n) problems, one launch a call.
//
// Replaces the batched use of the Pallas TPU kernel
// repro/kernels/minscan.py::masked_argmin_pallas (the JAX package batches
// that kernel through pallas_call's vmap rule; the batched kernel engine
// seeds each compaction stage of a bucket with one call).  Each lane's
// result is masked_argmin's on its slices (minscan.cu), bit for bit: cell
// (r, c) takes part when alive[r], alive[c] and r != c; ties go to the first
// minimum in row-major order; a lane with no live cell gives (+inf, 0).
//
// Bound: bytes, each lane's L x L live cells read once (4 L^2), its liveness
// (n bytes) and its result (12 bytes).  A stage's seed finds each lane's
// live slots packed into a prefix (compact_batch), so a kernel that reads
// only the live rows over the live columns reads the bound's bytes there.
// The design:
//   - One launch, no second pass, no global scratch and no ticket.  A lane
//     is owned by a warp (rows of up to 32 slots, several lanes a block), by
//     a block, or by a thread-block cluster of up to 8 blocks, as the host
//     plans (kernels/minscan.py argmin_batch_plan, B2's batch rule past 32
//     slots).  A block's row groups keep a running (key, column) of their
//     rows' minima, which the block reduces in shared memory; a cluster's
//     blocks store theirs into block 0's shared memory (distributed shared
//     memory) before cluster.sync(), and block 0's thread 0 writes the
//     lane's result (batch_rows.cuh block_min_key, cluster_keys).  The key
//     orders (value, row), and each row's column is its first minimum, so
//     the least key is the row-major first minimum whatever order the rows
//     were scanned in.
//   - Live rows over the live span.  The lane's liveness becomes a bitmask
//     in shared memory, a word a warp's ballot over byte loads (kBitLoads
//     words in flight a warp).  The span [lo, hi) runs from its first live
//     slot to one past its last.  Dead rows are never read: a block lists
//     the live rows of its range, a chunk of 1024 at a time, and its warps
//     deal them out to their row groups; each row is read over the span
//     only, dead columns and the diagonal masked.
//   - Bytes in flight without registers.  Where rows are 16-byte aligned
//     and the span, rounded out to 16 bytes, is at least 128 columns, each
//     warp's bulk-copy pipe (the Tensor Memory Accelerator, batch_rows.cuh,
//     shared with B2's batch form) brings the rows, or 1024-column chunks of
//     them, into shared memory while the warp scans the buffer that landed.
//     Shorter or unaligned spans go into registers from the first live
//     slot's bitmask word on (at most 31 columns before the span), every
//     float4 of a pass issued before any compare (lw_rows.cuh scan_row, as
//     B2's and B3's batch forms read their rows); so do rows of 65 to
//     256 slots where the plan says (a lane's chain of round trips, not its
//     bytes, sets the time there), one pass of 512 threads.  A bulk row's
//     float4 takes its four cells' liveness from one bitmask word.
//   - A warp a lane up to 32 slots: the rows lo .. hi - 1 are one run of at
//     most 1024 contiguous floats (a row is at most 4 sectors), read whole,
//     float4 where aligned, kWarpLoads loads in flight a thread, and reduced
//     on the flat index, which is row-major order itself.
//   - 32-bit indices inside a lane: n <= 4096 (the bitmask's 128 words), so
//     r n + c < 2^24; the flat index is widened to 64 bits when written.
#include <cooperative_groups.h>

#include "batch_lanes.cuh"
#include "batch_rows.cuh"
#include "first_min.cuh"
#include "last_block.cuh"
#include "lw_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxN = 4096;        // the bitmask's 128 words
constexpr int kWarpMaxN = 32;      // rows a warp-owned lane may have
constexpr int kWarpLoads = 8;      // loads in flight a thread of a warp-owned lane
constexpr int kBitLoads = 4;       // liveness words in flight a warp
constexpr int kBulkMinCols = 128;  // the shortest span the bulk copies take

// The operands: lane b's matrix at b n^2 and liveness at b n; its result at b.
struct ArgminOperands {
    const float* D;
    const unsigned char* alive;
    float* out_v;
    long long* out_flat;
    long long lanes;
    int n;
};

// The rows a block scans: its listed rows of one lane, read over the span
// columns [lo, lo + cols).
struct ArgminLane {
    const float* D;
    const unsigned* bits;   // shared: the lane's liveness
    const int* list;        // shared: the chunk's listed rows
    int* next;              // shared: the next list place to deal out
    int n, listed, lo, cols;
    __device__ const float* row(int r) const { return D + (size_t)r * n + lo; }
    __device__ int span_cols() const { return cols; }
};

// A row group's first minimum of row r, folded into the thread's running
// (key, column) by the group's first thread.
template <int T>
__device__ __forceinline__ void fold_row(int r, int l, float bv, int bc, unsigned long long& key,
                                         int& col) {
    group_first_min<T>(bv, bc);
    if (l == 0 && r >= 0 && bv < CUDART_INF_F) {
        const unsigned long long k = min_key(bv, r);
        if (k < key) { key = k; col = bc; }
    }
}

// Row r (r < 0: none) over the span in registers, by a group of T threads,
// U float4 a thread a pass; the span's unaligned head is read one by one.
// The span starts on a bitmask word (lo a multiple of 32), so that scan_row
// sees the columns from lo on as a row of their own: its bitmask from lo's
// word, its diagonal at r - lo.
template <int T, int U>
__device__ __forceinline__ void register_row(const ArgminLane& x, int r, int l,
                                             unsigned long long& key, int& col) {
    float bv = CUDART_INF_F;
    int bc = INT_MAX;
    if (r >= 0) {
        const int d = r - x.lo;
        scan_row<T, U>(x.row(r), x.cols, d, Merge{d, d, 0.0f, 0.0f, 0.0f}, x.bits + (x.lo >> 5), l,
                       bv, bc);
        if (bv < CUDART_INF_F) bc += x.lo;
    }
    fold_row<T>(r, l, bv, bc, key, col);
}

// The warp's share of the listed rows in registers, dealt out a row to
// each of its groups at a time.
template <int T, int U>
__device__ __forceinline__ void register_rows(const ArgminLane& x, int wl,
                                              unsigned long long& key, int& col) {
    const int l = wl % T, group = wl / T;
    for (;;) {
        const int first = deal_rows<T>(x, wl);
        if (first >= x.listed) break;
        const int s = first + group;
        register_row<T, U>(x, s < x.listed ? x.list[s] : -1, l, key, col);
    }
}

// The warp's share of the listed rows through its bulk-copy pipe, started
// by start_pipe.  A group scans its row's cells from shared memory, a
// float4 a thread at a time in column order; a row longer than 32 T floats
// goes by in chunks, its minimum carried from chunk to chunk.
template <int T>
__device__ __forceinline__ void bulk_rows(const ArgminLane& x, Pipe& p, int wl,
                                          unsigned long long& key, int& col) {
    constexpr int kCols = 32 * T;
    const int l = wl % T, group = wl / T;
    float bv = CUDART_INF_F;
    int bc = INT_MAX;
    for (;;) {
        const int s = p.stage, first = p.place[s], c0 = p.chunk[s] * kCols;
        if (first >= x.listed) break;
        const int slot = first + group;
        const int r = slot < x.listed ? x.list[slot] : -1;
        if (c0 == 0) {   // a row's first chunk
            bv = CUDART_INF_F;
            bc = INT_MAX;
        }
        mbar_wait(&p.full[s], (p.phases >> s) & 1u);
        p.phases ^= 1u << s;
        const int cols = min(kCols, x.cols - c0);
        if (r >= 0) {
            const float* row = p.buf + s * kStageFloats + group * kCols;
            for (int c = 4 * l; c < cols; c += 4 * T) {
                const float4 v = *reinterpret_cast<const float4*>(row + c);
                // the span starts on a multiple of 4: a float4's cells share a bitmask word
                const int cc = x.lo + c0 + c;
                unsigned live = (x.bits[cc >> 5] >> (cc & 31)) & 0xfu;
                if ((unsigned)(r - cc) < 4u) live &= ~(1u << (r - cc));   // the diagonal
                const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (((live >> q) & 1u) && e[q] < bv) {
                        bv = e[q];
                        bc = cc + q;
                    }
                }
            }
        }
        __syncwarp();   // the buffer is read: it may be refilled
        if (c0 + cols == x.cols) fold_row<T>(r, l, bv, bc, key, col);
        if (wl == 0) issue<T>(x, p, s);
        p.stage = (s + 1) % kStages;
        __syncwarp();
    }
}

// A lane of up to 32 slots by one warp (`wl` its lane): the rows lo .. hi -
// 1 whole, V floats a load (4: rows 16-byte aligned), each thread's flat
// indices ascending, then the warp's first minimum on the flat index.
template <int V>
__device__ __forceinline__ void warp_lane(const ArgminOperands& a, long long lane, int wl) {
    const int n = a.n;
    const unsigned bits = __ballot_sync(0xffffffffu, wl < n && a.alive[lane * n + wl]);
    float bv = CUDART_INF_F;
    int bf = INT_MAX;
    if (bits) {
        const float* D = a.D + (size_t)lane * n * n;
        const int f_end = (32 - __clz(bits)) * n;
        for (int f0 = (__ffs(bits) - 1) * n + V * wl; f0 < f_end; f0 += V * 32 * kWarpLoads) {
            float x[kWarpLoads][V];
#pragma unroll
            for (int u = 0; u < kWarpLoads; ++u) {
                const int f = f0 + V * 32 * u;
                if (f < f_end) {
                    if constexpr (V == 4) {
                        const float4 v = *reinterpret_cast<const float4*>(D + f);
                        x[u][0] = v.x;
                        x[u][1] = v.y;
                        x[u][2] = v.z;
                        x[u][3] = v.w;
                    } else {
                        x[u][0] = D[f];
                    }
                }
            }
#pragma unroll
            for (int u = 0; u < kWarpLoads; ++u) {
                const int f = f0 + V * 32 * u;
                if (f < f_end) {
                    const int r = f / n, c = f - r * n;   // V cells of one row
                    if ((bits >> r) & 1u) {
#pragma unroll
                        for (int q = 0; q < V; ++q) {
                            if (x[u][q] < bv && c + q != r && ((bits >> (c + q)) & 1u)) {
                                bv = x[u][q];
                                bf = f + q;
                            }
                        }
                    }
                }
            }
        }
    }
    warp_first_min(bv, bf);
    if (wl == 0) {
        a.out_v[lane] = bv;
        a.out_flat[lane] = bv < CUDART_INF_F ? bf : 0;
    }
}

// Every lane's masked first minimum.  T == 0: a warp a lane, THREADS / 32
// lanes a block, U floats a load.  Otherwise a block owns a lane (a launch
// without a cluster: block x is lane x) or a cluster of k blocks does (block
// x is rank x % k of lane x / k); a row group of T threads scans a live row
// over the span: through the warp's bulk-copy pipe where kBulk and the span
// is long enough, else in registers, U float4 a thread a pass.
template <int T, int U, int THREADS, bool kBulk>
__global__ void __launch_bounds__(THREADS, THREADS <= 128 ? 1024 / THREADS : 512 / THREADS)
argmin_batch_kernel(const __grid_constant__ ArgminOperands a) {
    if constexpr (T == 0) {
        const long long lane = (long long)blockIdx.x * (THREADS / 32) + (threadIdx.x >> 5);
        if (lane < a.lanes) warp_lane<U>(a, lane, threadIdx.x & 31);
    } else {
        constexpr int kBlockWarps = THREADS / 32;
        extern __shared__ __align__(128) unsigned s_bits[];
        __shared__ unsigned s_mask[32];   // a chunk's listed rows, a word each
        __shared__ int s_first[32];       // the list place of each word's first listed row
        __shared__ int s_listed, s_next;  // the chunk's listed rows; the next one dealt out
        __shared__ int s_span[4];         // the lane's span; this block's first and last row
        __shared__ unsigned long long s_key[kBlockWarps];
        __shared__ int s_col[kBlockWarps];
        __shared__ unsigned long long c_key[kMaxCluster];   // block 0's: each block's (key, col)
        __shared__ int c_col[kMaxCluster];
        __shared__ unsigned long long s_full[kBulk ? kBlockWarps * kStages : 1];
        __shared__ int s_place[kBulk ? kBlockWarps * kStages : 1];   // each buffer's unit
        __shared__ int s_chunk[kBulk ? kBlockWarps * kStages : 1];

        // a launch without a cluster is one of clusters of one block
        const unsigned blocks = cg::this_cluster().num_blocks();
        const unsigned rank = cg::this_cluster().block_rank();
        const unsigned lane = blockIdx.x / blocks;
        const int n = a.n, words = (n + 31) >> 5;
        const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
        if (blocks > 1) cluster_arrive_relaxed();   // paired with the wait before the keys

        // the liveness bitmask, a word a warp's ballot
        const unsigned char* alive = a.alive + (size_t)lane * n;
        for (int w0 = warp; w0 < words; w0 += kBitLoads * kBlockWarps) {
            bool al[kBitLoads];
#pragma unroll
            for (int q = 0; q < kBitLoads; ++q) {
                const int c = 32 * (w0 + q * kBlockWarps) + wl;
                al[q] = c < n && alive[c];
            }
#pragma unroll
            for (int q = 0; q < kBitLoads; ++q) {
                const unsigned word = __ballot_sync(0xffffffffu, al[q]);
                if (wl == 0 && w0 + q * kBlockWarps < words) s_bits[w0 + q * kBlockWarps] = word;
            }
        }
        Pipe pipe{};
        if constexpr (kBulk) pipe = make_pipe(s_bits, n, s_full, s_place, s_chunk, warp, wl);
        __syncthreads();   // the bitmask staged

        // the span, and this block's rows: of a cluster's, a range holding an
        // equal share of the live rows (the ranges partition the lane's rows)
        if (warp == 0) {
            int lo = n, hi = 0;
            for (int w = wl; w < words; w += 32) {
                const unsigned word = s_bits[w];
                if (word) {
                    lo = min(lo, 32 * w + __ffs(word) - 1);
                    hi = max(hi, 32 * w + 32 - __clz(word));
                }
            }
            lo = __reduce_min_sync(0xffffffffu, lo);
            hi = __reduce_max_sync(0xffffffffu, hi);
            int first = 0, last = n;
            if (blocks > 1) {
                const int live = live_before(s_bits, words, n, wl);
                if (rank > 0)
                    first = row_of_live(s_bits, words, n, wl, (int)(rank * live / blocks));
                if (rank + 1 < blocks)
                    last = row_of_live(s_bits, words, n, wl, (int)((rank + 1) * live / blocks));
            }
            if (wl == 0) {
                s_span[0] = lo;
                s_span[1] = hi;
                s_span[2] = max(first, lo);
                s_span[3] = min(last, hi);
            }
        }
        __syncthreads();
        const int lo = s_span[0], hi = s_span[1], rlo = s_span[2], rhi = s_span[3];
        // the span read: rounded out to 16 bytes on the bulk path, and in
        // registers from its first bitmask word
        const int lo4 = lo & ~3, cols4 = ((hi + 3) & ~3) - lo4, lo32 = lo & ~31;
        const bool bulk = kBulk && hi > lo && cols4 >= kBulkMinCols;
        int* s_list = reinterpret_cast<int*>(s_bits + words);
        ArgminLane x{a.D + (size_t)lane * n * n, s_bits, s_list, &s_next, n, 0,
                     bulk ? lo4 : lo32, bulk ? cols4 : hi - lo32};

        unsigned long long key = kKeyInit;
        int col = 0;
        for (int base = rlo & ~31; base < rhi; base += kChunk) {
            const int end = min(base + kChunk, rhi);
            __syncthreads();   // the previous chunk's rows dealt out
            if (warp == 0) {   // the chunk's listed rows: the live ones
                const int r0 = base + 32 * wl;
                unsigned mask = 0;
                if (r0 < end) {
                    mask = s_bits[r0 >> 5];
                    if (r0 < rlo) mask &= rlo - r0 < 32 ? ~0u << (rlo - r0) : 0u;
                    if (end - r0 < 32) mask &= (1u << (end - r0)) - 1u;
                }
                int upto = __popc(mask);
                for (int off = 1; off < 32; off <<= 1) {
                    const int o = __shfl_up_sync(0xffffffffu, upto, off);
                    if (wl >= off) upto += o;
                }
                s_mask[wl] = mask;
                s_first[wl] = upto - __popc(mask);
                if (wl == 31) s_listed = upto;
                if (wl == 0) s_next = 0;
            }
            __syncthreads();
            for (int r = max(base, rlo) + threadIdx.x; r < end; r += THREADS) {
                const int w = (r - base) >> 5;
                const unsigned mask = s_mask[w], bit = 1u << (r & 31);
                if (mask & bit) s_list[s_first[w] + __popc(mask & (bit - 1u))] = r;
            }
            __syncthreads();
            x.listed = s_listed;
            if constexpr (kBulk) {
                if (bulk) {
                    if (wl == 0) start_pipe<T>(x, pipe);
                    __syncwarp();
                    bulk_rows<T>(x, pipe, wl, key, col);
                } else {   // a short span: one pass of 128 columns a row group
                    register_rows<T, 32 / T>(x, wl, key, col);
                }
            } else {
                register_rows<T, U>(x, wl, key, col);
            }
        }

        // the block's (key, column), then the cluster's in block 0
        block_min_key<kBlockWarps>(key, col, s_key, s_col);
        if (blocks > 1) {
            cluster_keys(key, col, rank, c_key, c_col);
            if (rank != 0) return;
            cluster_min_key(key, col, blocks, c_key, c_col);
        }
        if (threadIdx.x != 0) return;
        const int r = (int)(key & 0xffffffffull);
        float v = key_value(key);
        if (v == 0.0f) v = x.D[(size_t)r * n + col];   // a zero keys as +0: the cell's own sign
        a.out_v[lane] = v;
        a.out_flat[lane] = (long long)r * n + col;
    }
}

// The kernel of a plan (group T threads a row, 0 for a warp a lane; unroll
// U float4 a thread a pass in registers, 0 for bulk copies, or on the warp
// path the floats a load; THREADS a block), or nullptr for a plan with none.
// Whether a cluster owns a lane is the launch's.
template <int T, int U, int THREADS, bool kBulk>
const void* argmin_fn() {
    return (const void*)argmin_batch_kernel<T, U, THREADS, kBulk>;
}

const void* argmin_kernel(int group, int unroll, int threads, bool cluster) {
    if (group == 0) {   // a warp a lane, 4 lanes a block
        if (cluster || threads != 128) return nullptr;
        if (unroll == 4) return argmin_fn<0, 4, 128, false>();
        if (unroll == 1) return argmin_fn<0, 1, 128, false>();
        return nullptr;
    }
    if (unroll == 0 && threads == 256) {   // bulk copies: a block or a cluster a lane
        switch (group) {
            case 4: return argmin_fn<4, 0, 256, true>();   // rows of 128
            case 8: return argmin_fn<8, 0, 256, true>();
            case 16: return argmin_fn<16, 0, 256, true>();
            case 32: return argmin_fn<32, 0, 256, true>();
            default: return nullptr;
        }
    }
    if (unroll == 0 && threads == 512 && group == 32)   // rows in chunks, few lanes
        return argmin_fn<32, 0, 512, true>();
    if (group == 32 && unroll == 8 && threads == 256)   // long unaligned rows
        return argmin_fn<32, 8, 256, false>();
    if (unroll == 8 && threads == 512) {   // short rows, one pass of 512 threads
        if (group == 4) return argmin_fn<4, 8, 512, false>();
        if (group == 8) return argmin_fn<8, 8, 512, false>();
    }
    if (cluster || group != 4 || threads != 256 || unroll != 4) return nullptr;
    return argmin_fn<4, 4, 256, false>();   // short rows: a block a lane
}

// The kernel's grid and dynamic shared memory for a plan, or false for a
// plan the launch cannot take at this n and alignment.
bool argmin_launch(long long lanes, int n, bool aligned, int group, int unroll, int threads,
                   int blocks, const void** fn, unsigned* grid, size_t* smem) {
    *fn = argmin_kernel(group, unroll, threads, blocks > 1);
    if (*fn == nullptr || n < 1 || n > kMaxN || lanes < 1 || blocks < 1 ||
        blocks > kMaxCluster)
        return false;
    if (group == 0) {   // a warp a lane: rows of up to 32 slots, float4 loads on aligned rows
        if (n > kWarpMaxN || (unroll == 4 && !aligned)) return false;
        const long long per_block = threads / 32;
        *grid = (unsigned)((lanes + per_block - 1) / per_block);
        *smem = 0;
        return true;
    }
    if ((unroll == 0 && !aligned) || lanes * blocks > INT_MAX)   // bulk copies: aligned rows
        return false;
    *grid = (unsigned)(lanes * blocks);
    *smem = batch_shared_bytes(n, unroll == 0, threads);
    return true;
}

}  // namespace

// Each lane's masked (min, flat argmin) of D (B, n, n) float32 with alive
// (B, n) bool: out_v (B,) float32 and out_flat (B,) int64, lane b's minimum
// and its flat index r n + c within the lane.  The plan: `group` threads a
// row (0: a warp a lane), `unroll` float4 a thread a pass (0: bulk copies;
// on the warp path the floats a load), `threads` a block, `blocks` blocks a
// lane (a cluster when more than one).  A plan the kernel cannot take (no
// instantiation, n above 4096, bulk copies or float4 loads on unaligned
// rows) returns cudaErrorInvalidValue.  Launches on `stream` of CUDA device
// `device`; returns the CUDA error.
extern "C" int masked_argmin_batch(int device, const float* D, const unsigned char* alive,
                                   long long B, long long n, float* out_v, long long* out_flat,
                                   int group, int unroll, int threads, int blocks,
                                   cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const bool aligned = n % 4 == 0 && (reinterpret_cast<uintptr_t>(D) & 15u) == 0;
    const void* fn;
    unsigned grid;
    size_t smem;
    if (n > kMaxN || !argmin_launch(B, (int)n, aligned, group, unroll, threads, blocks, &fn,
                                    &grid, &smem))
        return (int)cudaErrorInvalidValue;
    const ArgminOperands a{D, alive, out_v, out_flat, B, (int)n};
    return (int)launch_lanes(fn, a, grid, threads, blocks, smem, stream);
}

// Load the kernel of the plan at this n (on aligned rows) and allow it its
// shared memory; writes its registers a thread, local (spilled) bytes a
// thread and the blocks an SM holds; returns the CUDA error.
extern "C" int masked_argmin_batch_load(int device, long long n, int group, int unroll,
                                        int threads, int blocks, int* regs, int* local_bytes,
                                        int* blocks_per_sm) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const void* fn;
    unsigned grid;
    size_t smem;
    if (n > kMaxN || !argmin_launch(1, (int)n, true, group, unroll, threads, blocks, &fn, &grid,
                                    &smem))
        return (int)cudaErrorInvalidValue;
    cudaFuncAttributes attr{};
    err = allow_shared(fn, smem);
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, fn);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, fn, threads, smem);
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)err;
}
