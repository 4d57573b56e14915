// The row machinery that the batch forms of kernels B1 and B2
// (argmin_batch.cu, lw_merge_batch.cu) share, where a block or a
// thread-block cluster owns a lane and scans its live rows:
//   - the live-row listing over the lane's liveness bitmask (live_before,
//     row_of_live: a cluster's blocks split the live rows evenly);
//   - each warp's bulk-copy pipe: kStages buffers of 4 KiB in shared memory,
//     filled by the Tensor Memory Accelerator (cp.async.bulk, completion
//     counted by an mbarrier a buffer) with the listed rows, or 1024-column
//     chunks of them, over the lane's column span (make_pipe, issue,
//     start_pipe), while the warp's row groups scan the buffer that has
//     landed (each kernel's own bulk_rows);
//   - the listed rows dealt out to a warp, a row to each of its row groups
//     at a time (deal_rows);
//   - the lane's least (key, column) over the block's warps (block_min_key)
//     and, in a cluster, its blocks, through block 0's shared memory
//     (cluster_keys, cluster_min_key).
// A lane's row list (the `x` of these functions) has the members list and
// next (shared: the listed rows and the next list place to deal out) and
// listed, and the columns its rows are read over: row(r), the first of row
// r's, and span_cols(), how many.
#pragma once

#include <cooperative_groups.h>

#include "batch_lanes.cuh"
#include "last_block.cuh"

namespace {

constexpr int kChunk = 1024;       // rows listed at a time: one warp, a word a lane
constexpr int kStages = 3;         // a warp's row buffers in flight (bulk copies)
constexpr int kStageFloats = 1024; // a buffer: 32/T rows of up to 32 T floats, or a row's chunk

// The warp's least (key, column); valid in lane 0.  Keys are distinct (a
// row each) or kKeyInit.
__device__ __forceinline__ void warp_min_key(unsigned long long& key, int& col) {
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long ok = __shfl_down_sync(0xffffffffu, key, off);
        const int oc = __shfl_down_sync(0xffffffffu, col, off);
        if (ok < key) { key = ok; col = oc; }
    }
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");
}

__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" : : "r"(smem_addr(bar)) : "memory");
}

// Arrive on the buffer's barrier and expect `bytes` of copies to land.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 : : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the barrier's phase `parity` to complete.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    asm volatile(
        "{\n\t.reg .pred P1;\n\t"
        "LAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
        "@P1 bra DONE;\n\t"
        "bra LAB_WAIT;\n\t"
        "DONE:\n\t}\n"
        : : "r"(smem_addr(bar)), "r"(parity) : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) from global `src`
// to this block's shared `dst` by the Tensor Memory Accelerator,
// completion counted on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        : : "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// The live rows of the bitmask (n rows, `words` words), by one warp (`wl`
// its lane); valid in every lane.
__device__ __forceinline__ int live_before(const unsigned* bits, int words, int n, int wl) {
    int live = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
        int c = w0 + wl < words ? __popc(bits[w0 + wl]) : 0;
        for (int off = 16; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
        live += c;
    }
    return live;
}

// The row of the live row of rank `t` (from 0; n past the last), by one warp;
// valid in every lane.
__device__ __forceinline__ int row_of_live(const unsigned* bits, int words, int n, int wl, int t) {
    int before = 0;
    for (int w0 = 0; w0 < words; w0 += 32) {
        const unsigned word = w0 + wl < words ? bits[w0 + wl] : 0u;
        int upto = __popc(word);
        for (int off = 1; off < 32; off <<= 1) {
            const int o = __shfl_up_sync(0xffffffffu, upto, off);
            if (wl >= off) upto += o;
        }
        const unsigned holds = __ballot_sync(0xffffffffu, before + upto > t);
        if (holds) {
            const int w = __ffs(holds) - 1;
            const int k = t - before - (__shfl_sync(0xffffffffu, upto, w) -
                                        __popc(__shfl_sync(0xffffffffu, word, w)));
            return min(n, 32 * (w0 + w) + (int)__fns(__shfl_sync(0xffffffffu, word, w), 0, k + 1));
        }
        before += __shfl_sync(0xffffffffu, upto, 31);
    }
    return n;
}

// The first list place of the next rows dealt out to the warp, a row to
// each of its groups of T threads (>= listed: none left); valid in every
// lane.
template <int T, class X>
__device__ __forceinline__ int deal_rows(const X& x, int wl) {
    int first = 0;
    if (wl == 0) first = atomicAdd(x.next, 32 / T);
    return __shfl_sync(0xffffffffu, first, 0);
}

// A warp's bulk-copy pipeline: kStages buffers, each holding one unit (32/T
// rows of up to 32 T floats, or one 32 T-column chunk of a row when T is 32
// and rows are longer), each with an mbarrier and the unit's first list
// place and chunk.  Its first lane is the producer.
struct Pipe {
    float* buf;                  // kStages * kStageFloats floats
    unsigned long long* full;    // kStages barriers
    int* place;                  // kStages: the unit's first list place (>= listed: none)
    int* chunk;                  // kStages: the unit's column chunk
    int stage;                   // the next buffer to scan
    unsigned phases;             // bit s: the parity of buffer s's next completion
    int deal, deal_chunk;        // the producer's current unit
};

// The dynamic shared memory of a launch: the bitmask, the list, and with
// bulk copies each warp's buffers (128-byte aligned).
__host__ __device__ __forceinline__ size_t batch_list_bytes(int n) {
    const int words = (n + 31) / 32;
    const int list = 32 * words < kChunk ? 32 * words : kChunk;
    return ((size_t)(words + list) * sizeof(unsigned) + 127) / 128 * 128;
}

size_t batch_shared_bytes(int n, bool bulk, int threads) {
    return batch_list_bytes(n) +
           (bulk ? (size_t)(threads / 32) * kStages * kStageFloats * sizeof(float) : 0);
}

// Warp `warp`'s pipe: its buffers past the bitmask `s_bits` and the list of a
// lane of n slots (dynamic shared memory), its barriers and unit records in
// the block's static arrays of kStages a warp; its first lane initialises
// the barriers.
__device__ __forceinline__ Pipe make_pipe(unsigned* s_bits, int n, unsigned long long* s_full,
                                          int* s_place, int* s_chunk, int warp, int wl) {
    Pipe pipe{};
    pipe.buf = reinterpret_cast<float*>(reinterpret_cast<char*>(s_bits) + batch_list_bytes(n)) +
               warp * kStages * kStageFloats;
    pipe.full = s_full + warp * kStages;
    pipe.place = s_place + warp * kStages;
    pipe.chunk = s_chunk + warp * kStages;
    if (wl == 0) {
        for (int k = 0; k < kStages; ++k) mbar_init(&pipe.full[k]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
    }
    return pipe;
}

// The producer's next unit into buffer s (first lane only): the next chunk
// of its current row, or the next rows dealt out; none past the list.
template <int T, class X>
__device__ __forceinline__ void issue(const X& x, Pipe& p, int s) {
    constexpr int kRows = 32 / T, kCols = 32 * T;
    const int chunks = (x.span_cols() + kCols - 1) / kCols;
    if (p.deal < x.listed && p.deal_chunk + 1 < chunks) {
        ++p.deal_chunk;
    } else {
        p.deal = atomicAdd(x.next, kRows);
        p.deal_chunk = 0;
    }
    p.place[s] = p.deal;
    p.chunk[s] = p.deal_chunk;
    if (p.deal >= x.listed) return;
    const int c0 = p.deal_chunk * kCols, cols = min(kCols, x.span_cols() - c0);
    const int rows = min(kRows, x.listed - p.deal);
    mbar_expect(&p.full[s], (unsigned)(rows * cols) * 4u);
    float* dst = p.buf + s * kStageFloats;
    for (int g = 0; g < rows; ++g)
        bulk_copy(dst + g * kCols, x.row(x.list[p.deal + g]) + c0, (unsigned)cols * 4u,
                  &p.full[s]);
}

// The producer's first kStages units (first lane only).
template <int T, class X>
__device__ __forceinline__ void start_pipe(const X& x, Pipe& p) {
    p.deal = x.listed;   // deal out rows from the first unit on
    for (int k = 0; k < kStages; ++k) issue<T>(x, p, (p.stage + k) % kStages);
}

// The block's least (key, column) over its warps' (the running pairs of
// every thread), valid in thread 0; `s_key` and `s_col` are the block's
// shared arrays of a pair a warp.  The block barrier inside also orders every
// read of the lane's state before what follows.
template <int kBlockWarps>
__device__ __forceinline__ void block_min_key(unsigned long long& key, int& col,
                                              unsigned long long* s_key, int* s_col) {
    const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
    warp_min_key(key, col);
    if (wl == 0) {
        s_key[warp] = key;
        s_col[warp] = col;
    }
    __syncthreads();   // also: every read of the lane's state is done
    if (threadIdx.x == 0) {
        for (int w = 1; w < kBlockWarps; ++w)
            if (s_key[w] < key) { key = s_key[w]; col = s_col[w]; }
    }
}

// Where a cluster owns the lane: each block's thread 0 stores its block's
// (key, column) into block 0's `c_key` and `c_col` (distributed shared
// memory, kMaxCluster pairs) before cluster.sync(), which takes a ticket's
// place.  Every thread of every block calls it; the blocks called
// cluster_arrive_relaxed() when they started.
__device__ __forceinline__ void cluster_keys(unsigned long long key, int col, unsigned rank,
                                             unsigned long long* c_key, int* c_col) {
    cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
    cluster_wait();   // every block of the cluster has started: block 0's memory is there
    if (threadIdx.x == 0) {
        *cluster.map_shared_rank(&c_key[rank], 0) = key;
        *cluster.map_shared_rank(&c_col[rank], 0) = col;
    }
    cluster.sync();   // releases the keys to block 0; every block has read the state
}

// Block 0's thread 0 folds the cluster's `blocks` pairs (cluster_keys) into
// its own: the lane's least (key, column).
__device__ __forceinline__ void cluster_min_key(unsigned long long& key, int& col,
                                                unsigned blocks, const unsigned long long* c_key,
                                                const int* c_col) {
    if (threadIdx.x == 0) {
        for (unsigned q = 1; q < blocks; ++q)
            if (c_key[q] < key) { key = c_key[q]; col = c_col[q]; }
    }
}

}  // namespace
