// Kernel B2's batch form, for sm_90a: one lockstep merge of B stacked
// problems of n slots, one launch a merge of every lane.
//
// Replaces the batched use of the Pallas TPU kernel
// repro/kernels/lw_step.py::lw_step_pallas (the JAX package batches that
// kernel through pallas_call's vmap rule; the batched kernel engine makes
// one lockstep merge a launch).  Each lane's merge is lw_merge's (lw_step.cu),
// bit for bit: the LW row committed into row and column i, every row's
// (min, first column) after the merge, the next candidate and the
// bookkeeping.  A lane whose count has reached its limit (it made its
// min(max(n_real - stop_at_k, 0), n_steps) merges, or it is padding with
// n_real = 0) is a no-op: its count goes up by one, which then counts the
// lockstep merges, and no cell, record or word of it is written.
//
// Bound: bytes, the live rows of every active lane read once (Σ 4·L'² for
// L' slots live after the merge) and row and column i written.  The design:
// a lane is owned whole by one block or by a thread-block cluster of up to
// 8 blocks; the host plans which, and how rows are read
// (kernels/lw_step.py merge_batch_plan), from B and n.  What that buys over
// row blocks with a ticket a lane:
//   - No ticket and no global atomic.  A block's row groups keep a running
//     (key, column) of their rows' minima; the block reduces them in shared
//     memory, and a cluster's blocks store theirs into block 0's shared
//     memory (distributed shared memory) before cluster.sync(), which takes
//     the ticket's place.  The owner's thread 0 then does the epilogue.  The
//     lane's sync words are not touched.
//   - Live rows only.  A block lists the live rows of its range but i and j
//     in shared memory, a chunk of 1024 rows at a time, from the liveness
//     bitmask, and its warps deal the list out among themselves (a shared
//     counter), a row to each of a warp's row groups.  The rows not listed,
//     dead or j, get their column-i 0 and (+inf, 0) minimum from the same
//     strided loop that builds the list, so that every buffer stays the
//     plain twin's.  One warp writes the merged row i beside them.
//   - Bytes in flight without registers.  Where rows are 16-byte aligned
//     (n % 4 == 0, every bucket) and at least 128 slots long, each warp runs
//     its own pipeline of kStages buffers of 4 KiB in shared memory: its
//     first lane deals itself the next rows and has the Tensor Memory
//     Accelerator copy them in (cp.async.bulk, one copy a row or a row's
//     1024-column chunk, completion counted by an mbarrier a buffer), while
//     the warp scans the buffer that has landed (batch_rows.cuh, shared with
//     B1's batch form, which also shares the row listing and the keys'
//     reduction).  Short or unaligned rows
//     are loaded into registers instead, every float4 of a pass issued
//     before any compare (scan_row).
//   - A finished or padding lane's blocks read count and limit, the first
//     block adds one to count, and all exit.
//   - Short chains: count, limit, the candidate and the first bitmask words
//     are loaded together, before the lane's state is known.
//   - No spills: the operands are one __grid_constant__ struct of base
//     pointers, and a lane's pointers are formed from its 32-bit index
//     where they are used.
#include <cooperative_groups.h>

#include "batch_lanes.cuh"
#include "batch_rows.cuh"
#include "first_min.cuh"
#include "lance_williams.cuh"
#include "last_block.cuh"
#include "lw_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kBatchThreads = 256;

// The batch buffers' base pointers: lane b's slices sit at b n^2 (D), b n
// (alive, sizes, rmin, rarg), b ceil(n/32) (bits), b cap 4 (merges), 2b
// (cand) and b (dmin, count, limit).
struct BatchOperands {
    float* D;
    float* sizes;
    unsigned* bits;
    float* rmin;
    long long* rarg;
    long long* cand;
    float* dmin;
    unsigned char* alive;
    float* merges;
    long long* count;
    const long long* limit;
    long long cap;
    int n;
};

// A row group's last step on row r: fold column i's new value into the
// row's reduced minimum (first thread), write D(r, i), rmin[r] and rarg[r],
// and keep the running (key, column).
template <int T>
__device__ __forceinline__ void finish_row(float* D, float* rmin, long long* rarg, int n, int r,
                                           const Merge& m, bool live_i, float new_r, float bv,
                                           int bc, int l, unsigned long long& key, int& col) {
    group_first_min<T>(bv, bc);
    if (l != 0 || r < 0) return;
    if (live_i && first_min_better(new_r, m.i, bv, bc)) {
        bv = new_r;
        bc = m.i;
    }
    if (bv == CUDART_INF_F) bc = 0;   // no cell below +inf: the first column
    D[(size_t)r * n + m.i] = new_r;
    rmin[r] = bv;
    rarg[r] = bc;
    if (bv < CUDART_INF_F) {
        const unsigned long long k = min_key(bv, r);
        if (k < key) { key = k; col = bc; }
    }
}

// What a block's warps share while they scan one lane's rows.
struct Lane {
    float* D;
    const float* sizes;
    float* rmin;
    long long* rarg;
    const unsigned* bits;   // shared: the liveness before the merge
    const int* list;        // shared: the chunk's listed rows
    int* next;              // shared: the next list place to deal out
    int n, listed;
    Merge m;
    bool live_i;
    __device__ const float* row(int r) const { return D + (size_t)r * n; }   // read whole
    __device__ int span_cols() const { return n; }
};

// Row r (a listed row: live, not i and not j) in registers, by a group of T
// threads, U float4 a thread a pass; r < 0 is no row.  The scalars of
// column i's new value are loaded beside the row's first pass.
template <int M, int T, int U>
__device__ __forceinline__ void register_row(const Lane& x, int r, int l, unsigned long long& key,
                                             int& col) {
    float bv = CUDART_INF_F, new_r = 0.0f;
    int bc = INT_MAX;
    if (r >= 0) {
        const float* row = x.D + (size_t)r * x.n;
        const float dki = row[x.m.i], dkj = row[x.m.j], nk = x.sizes[r];
        scan_row<T, U>(row, x.n, r, x.m, x.bits, l, bv, bc);
        new_r = lance_williams<M>(dki, dkj, x.m.dij, x.m.ni, x.m.nj, nk);
    }
    finish_row<T>(x.D, x.rmin, x.rarg, x.n, r, x.m, x.live_i, new_r, bv, bc, l, key, col);
}

// The warp's share of the chunk's rows in registers, dealt out a row to
// each of its groups at a time.
template <int M, int T, int U>
__device__ __forceinline__ void register_rows(const Lane& x, int wl, unsigned long long& key,
                                              int& col) {
    const int l = wl % T, group = wl / T;
    for (;;) {
        const int first = deal_rows<T>(x, wl);
        if (first >= x.listed) break;
        const int s = first + group;
        register_row<M, T, U>(x, s < x.listed ? x.list[s] : -1, l, key, col);
    }
}

// The warp's share of the chunk's rows through its bulk-copy pipeline,
// started by start_pipe.  A group scans its row's cells from shared
// memory, a float4 a thread at a time in column order; a row longer than
// 32 T floats goes by in chunks, its minimum and D(r, i), D(r, j) carried
// from chunk to chunk.
template <int M, int T>
__device__ __forceinline__ void bulk_rows(const Lane& x, Pipe& p, int wl,
                                          unsigned long long& key, int& col) {
    constexpr int kCols = 32 * T;
    const int l = wl % T, group = wl / T;
    // the size of a unit's row (its first chunk's), loaded a unit ahead
    auto row_size = [&](int s) {
        const int slot = p.place[s] + group;
        return p.chunk[s] == 0 && slot < x.listed ? x.sizes[x.list[slot]] : 0.0f;
    };
    float bv = CUDART_INF_F, dki = 0.0f, dkj = 0.0f, nk = row_size(p.stage);
    int bc = INT_MAX;
    for (;;) {
        const int s = p.stage, first = p.place[s], c0 = p.chunk[s] * kCols;
        if (first >= x.listed) break;
        const int slot = first + group;
        const int r = slot < x.listed ? x.list[slot] : -1;
        const int s1 = (s + 1) % kStages;
        const float nk_next = row_size(s1);
        if (c0 == 0) {   // a row's first chunk
            bv = CUDART_INF_F;
            bc = INT_MAX;
        }
        mbar_wait(&p.full[s], (p.phases >> s) & 1u);
        p.phases ^= 1u << s;
        const int cols = min(kCols, x.n - c0);
        if (r >= 0) {
            const float* row = p.buf + s * kStageFloats + group * kCols;
            for (int c = 4 * l; c < cols; c += 4 * T) {
                const float4 v = *reinterpret_cast<const float4*>(row + c);
                const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int cc = c0 + c + q;
                    if (e[q] < bv && cc != x.m.i && cc != x.m.j && cc != r &&
                        is_live(x.bits, cc)) {
                        bv = e[q];
                        bc = cc;
                    }
                }
            }
            if (x.m.i >= c0 && x.m.i < c0 + cols) dki = row[x.m.i - c0];
            if (x.m.j >= c0 && x.m.j < c0 + cols) dkj = row[x.m.j - c0];
        }
        __syncwarp();   // the buffer is read: it may be refilled
        if (c0 + cols == x.n) {
            const float new_r =
                r >= 0 ? lance_williams<M>(dki, dkj, x.m.dij, x.m.ni, x.m.nj, nk) : 0.0f;
            finish_row<T>(x.D, x.rmin, x.rarg, x.n, r, x.m, x.live_i, new_r, bv, bc, l, key, col);
        }
        if (wl == 0) issue<T>(x, p, s);
        if (p.chunk[s1] == 0) nk = nk_next;
        p.stage = s1;
        __syncwarp();
    }
}

// One lockstep merge.  A block owns a lane (a launch without a cluster:
// block x is lane x) or a cluster of k blocks does (block x is rank x % k of
// lane x / k).  A row group
// of T threads scans a live row: from shared memory, through the warp's
// bulk-copy pipeline (kBulk), or in registers, U float4 a thread a pass.
// A whole warp (UM float4 a thread a pass) writes the merged row i.
template <int M, int T, int U, int UM, int THREADS, bool kBulk>
__global__ void __launch_bounds__(THREADS, THREADS <= 128 ? 1024 / THREADS : 512 / THREADS)
lw_merge_batch_kernel(const __grid_constant__ BatchOperands a) {
    constexpr int kBlockWarps = THREADS / 32;
    extern __shared__ __align__(128) unsigned s_bits[];
    __shared__ unsigned s_mask[32];      // a chunk's listed rows, a word each
    __shared__ int s_first[32];          // the list place of each word's first listed row
    __shared__ int s_listed, s_next;     // the chunk's listed rows; the next one dealt out
    __shared__ unsigned long long s_key[kBlockWarps];
    __shared__ int s_col[kBlockWarps];
    __shared__ unsigned long long c_key[kMaxCluster];   // block 0's: each block's (key, col)
    __shared__ int c_col[kMaxCluster];
    __shared__ unsigned long long s_full[kBulk ? kBlockWarps * kStages : 1];
    __shared__ int s_place[kBulk ? kBlockWarps * kStages : 1];   // each buffer's unit
    __shared__ int s_chunk[kBulk ? kBlockWarps * kStages : 1];

    // a launch without a cluster is one of clusters of one block
    const unsigned blocks = cg::this_cluster().num_blocks(), rank = cg::this_cluster().block_rank();
    const unsigned lane = blockIdx.x / blocks;
    const int n = a.n, words = (n + 31) >> 5;
    const long long count = a.count[lane], limit = a.limit[lane];
    const long long cr = a.cand[2 * (size_t)lane], cc = a.cand[2 * (size_t)lane + 1];
    const float dij = a.dmin[lane];
    const unsigned w0 = (int)threadIdx.x < words ? a.bits[(size_t)lane * words + threadIdx.x] : 0u;
    if (count >= limit) {   // the lane made its merges, or is padding: a no-op, counted
        if (rank == 0 && threadIdx.x == 0) a.count[lane] = count + 1;
        return;
    }
    if (blocks > 1) cluster_arrive_relaxed();   // paired with the wait before the keys
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    Pipe pipe{};
    if constexpr (kBulk) pipe = make_pipe(s_bits, n, s_full, s_place, s_chunk, warp, wl);
    Merge m{(int)min(cr, cc), (int)max(cr, cc), dij, 0.0f, 0.0f};
    float* sizes = a.sizes + (size_t)lane * n;
    m.ni = sizes[m.i];
    m.nj = sizes[m.j];
    if ((int)threadIdx.x < words) s_bits[threadIdx.x] = w0;
    for (int w = threadIdx.x + THREADS; w < words; w += THREADS)
        s_bits[w] = a.bits[(size_t)lane * words + w];
    int* s_list = reinterpret_cast<int*>(s_bits + words);
    Lane x{a.D + (size_t)lane * n * n, sizes, a.rmin + (size_t)lane * n,
           a.rarg + (size_t)lane * n, s_bits, s_list, &s_next, n, 0, m, false};

    // this block's rows: of a cluster's, a range holding an equal share of
    // the live rows (the ranges partition the lane's rows); equal ranges of
    // rows would leave a ragged lane's dead padding, at its end, to its
    // last blocks
    int lo = 0, hi = n;
    if (blocks > 1) {
        __syncthreads();   // the bitmask staged
        if (warp == 0) {
            const int live = live_before(s_bits, words, n, wl);
            const int first = rank == 0 ? 0 : row_of_live(s_bits, words, n, wl,
                                                          (int)(rank * live / blocks));
            const int last = rank + 1 == blocks
                                 ? n
                                 : row_of_live(s_bits, words, n, wl,
                                               (int)((rank + 1) * live / blocks));
            if (wl == 0) {
                s_first[0] = first;
                s_first[1] = last;
            }
        }
        __syncthreads();
        lo = s_first[0];
        hi = s_first[1];
    }
    unsigned long long key = kKeyInit;
    int col = 0;
    for (int base = lo & ~31; base < hi; base += kChunk) {
        const int end = min(base + kChunk, hi);
        __syncthreads();   // the bitmask staged; the previous chunk's rows dealt out
        if (warp == 0) {   // the chunk's listed rows: live, not i and not j
            const int r0 = base + 32 * wl;
            unsigned mask = 0;
            if (r0 < end) {
                mask = s_bits[r0 >> 5];
                if (r0 < lo) mask &= lo - r0 < 32 ? ~0u << (lo - r0) : 0u;
                if (end - r0 < 32) mask &= (1u << (end - r0)) - 1u;
                if ((m.j >> 5) == (r0 >> 5)) mask &= ~(1u << (m.j & 31));
                if ((m.i >> 5) == (r0 >> 5)) mask &= ~(1u << (m.i & 31));
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
        for (int r = max(base, lo) + threadIdx.x; r < end; r += THREADS) {
            const int w = (r - base) >> 5;
            const unsigned mask = s_mask[w], bit = 1u << (r & 31);
            if (mask & bit) {
                s_list[s_first[w] + __popc(mask & (bit - 1u))] = r;
            } else if (r != m.i) {   // dead, or j: column i's 0, no minimum
                x.D[(size_t)r * n + m.i] = 0.0f;
                x.rmin[r] = CUDART_INF_F;
                x.rarg[r] = 0;
            }
        }
        __syncthreads();
        x.listed = s_listed;
        x.live_i = m.i != m.j && is_live(s_bits, m.i);
        if constexpr (kBulk) {   // the first rows' copies fly while warp 0 writes row i
            if (wl == 0) start_pipe<T>(x, pipe);
        }
        if (warp == 0 && m.i >= max(base, lo) && m.i < end) {   // the merged row, whole
            float bv = CUDART_INF_F;
            int bc = INT_MAX;
            merged_row<M, 32, UM>(x.D + (size_t)m.i * n, x.D + (size_t)m.j * n, sizes, n, m,
                                  x.live_i, s_bits, wl, bv, bc);
            warp_first_min(bv, bc);
            if (wl == 0) {
                if (bv == CUDART_INF_F) bc = 0;
                x.rmin[m.i] = bv;
                x.rarg[m.i] = bc;
                if (bv < CUDART_INF_F && min_key(bv, m.i) < key) {
                    key = min_key(bv, m.i);
                    col = bc;
                }
            }
        }
        if constexpr (kBulk) {
            __syncwarp();
            bulk_rows<M, T>(x, pipe, wl, key, col);
        } else {
            register_rows<M, T, U>(x, wl, key, col);
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

    // the epilogue: the record, the bookkeeping and the next candidate
    const float size = __fadd_rn(m.ni, m.nj);
    if (count < a.cap) {
        float* rec = a.merges + ((size_t)lane * a.cap + count) * 4;
        rec[0] = (float)m.i;
        rec[1] = (float)m.j;
        rec[2] = m.dij;
        rec[3] = size;
    }
    a.count[lane] = count + 1;
    a.alive[(size_t)lane * n + m.j] = 0;
    a.bits[(size_t)lane * words + (m.j >> 5)] = s_bits[m.j >> 5] & ~(1u << (m.j & 31));
    sizes[m.j] = 0.0f;
    sizes[m.i] = size;
    a.cand[2 * (size_t)lane] = (int)(key & 0xffffffffull);
    a.cand[2 * (size_t)lane + 1] = col;
    a.dmin[lane] = key_value(key);
}

// The kernel of a plan (T threads a row; U float4 a thread a pass, 0 for
// bulk copies; THREADS a block), or nullptr for a plan with none.  Whether a
// cluster owns a lane is the launch's.  The merged row's warp reads 4
// float4 a thread a pass where rows are long.
template <int M, int T, int U, bool kBulk, int THREADS = kBatchThreads>
const void* batch_fn() {
    constexpr int UM = T >= 8 ? 4 : 1;
    return (const void*)lw_merge_batch_kernel<M, T, U, UM, THREADS, kBulk>;
}

template <int M>
const void* batch_kernel(int group, int unroll, int threads, bool cluster) {
    if (unroll == 0 && threads == kBatchThreads) {   // bulk copies: a block or a cluster a lane
        switch (group) {
            case 4: return cluster ? nullptr : batch_fn<M, 4, 1, true>();   // rows of 128
            case 8: return batch_fn<M, 8, 1, true>();
            case 16: return batch_fn<M, 16, 1, true>();
            case 32: return batch_fn<M, 32, 1, true>();
            default: return nullptr;
        }
    }
    if (unroll == 0 && threads == 512 && group == 32)   // rows in chunks, few lanes
        return batch_fn<M, 32, 1, true, 512>();
    if (group == 32 && unroll == 8 && threads == kBatchThreads)   // long unaligned rows
        return batch_fn<M, 32, 8, false>();
    if (cluster || group != 4) return nullptr;   // short rows: a block a lane
    if (unroll == 1 && threads == 32) return batch_fn<M, 4, 1, false, 32>();
    if (unroll == 2 && threads == 128) return batch_fn<M, 4, 2, false, 128>();
    if (unroll == 4 && threads == 256) return batch_fn<M, 4, 4, false>();
    if (unroll == 8 && threads == 256) return batch_fn<M, 4, 8, false>();
    return nullptr;
}

template <int M>
void launch_merge_batch(const BatchOperands& a, long long lanes, int group, int unroll,
                        int threads, int blocks, cudaStream_t stream, cudaError_t* err) {
    const void* fn = batch_kernel<M>(group, unroll, threads, blocks > 1);
    const bool unaligned = a.n % 4 != 0 || (reinterpret_cast<uintptr_t>(a.D) & 15u) != 0;
    if (fn == nullptr || blocks < 1 || blocks > kMaxCluster || lanes * blocks > INT_MAX ||
        (unroll == 0 && unaligned)) {   // bulk copies take 16-byte aligned rows only
        *err = cudaErrorInvalidValue;
        return;
    }
    *err = launch_lanes(fn, a, (unsigned)(lanes * blocks), threads, blocks,
                        batch_shared_bytes(a.n, unroll == 0, threads), stream);
}

template <int M>
void load_batch(long long n, int group, int unroll, int threads, int blocks,
                cudaFuncAttributes* attr, int* per_sm, cudaError_t* err) {
    const void* fn = batch_kernel<M>(group, unroll, threads, blocks > 1);
    const size_t smem = batch_shared_bytes((int)n, unroll == 0, threads);
    *err = fn == nullptr ? cudaErrorInvalidValue : allow_shared(fn, smem);
    if (*err == cudaSuccess) *err = cudaFuncGetAttributes(attr, fn);
    if (*err == cudaSuccess)
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
}

}  // namespace

// One lockstep merge of B stacked problems, in place, each lane as lw_merge
// on its own slices: D (B, n, n), alive and sizes (B, n), bits (B,
// ceil(n/32)), merges (B, cap, 4), cand (B, 2), dmin (B,), count (B,), rmin
// and rarg (B, n); limit (B,) int64, the merges a lane makes (a lane whose
// count reached it only adds one to its count).  The plan: `group` threads
// a row, `unroll` float4 a thread a pass, `threads` a block, `blocks` blocks
// a lane (a cluster when more than one).  Same stream and return as
// lw_merge.
extern "C" int lw_merge_batch(int device, int method, float* D, unsigned char* alive,
                              unsigned* bits, float* sizes, float* merges, long long cap,
                              long long* cand, float* dmin, long long* count, float* rmin,
                              long long* rarg, long long n, const long long* limit, long long B,
                              int group, int unroll, int threads, int blocks,
                              cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const BatchOperands a{D, sizes, bits, rmin, rarg, cand, dmin, alive, merges, count, limit,
                          cap, (int)n};
    LW_DISPATCH_METHOD(method, launch_merge_batch, a, B, group, unroll, threads, blocks, stream,
                       &err)
    return (int)err;
}

// Load the kernel of the plan (`group`, `unroll`, `threads`, `blocks`) at
// this n before a stream capture (CUDA loads kernels lazily, at their first
// launch, and a first load must not fall inside a capture), and allow it
// its shared memory.  Writes its registers a thread, local (spilled) bytes
// a thread and the blocks an SM holds; returns the CUDA error.
extern "C" int lw_merge_batch_load(int device, int method, long long n, int group, int unroll,
                                   int threads, int blocks, int* regs, int* local_bytes,
                                   int* blocks_per_sm) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr{};
    LW_DISPATCH_METHOD(method, load_batch, n, group, unroll, threads, blocks, &attr,
                       blocks_per_sm, &err)
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)err;
}
