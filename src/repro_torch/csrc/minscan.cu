// Masked (min, flat argmin) of a square distance matrix, for sm_90a: the
// single-problem entry of kernel B1.
//
// Replaces the Pallas TPU kernel repro/kernels/minscan.py::masked_argmin_pallas
// (the merge loop's seed, once a compaction stage).  Cell (r, c) takes part
// when alive[r], alive[c] and r != c; ties go to the first minimum in
// row-major order; a fully masked matrix gives (+inf, 0).
//
// Bound: one read of the L x L live cells of D (4 bytes a cell) at
// 3.35 TB/s; the operations are a compare a cell.  This kernel reads whole
// live rows, 4 L n bytes.  Design: the TPU kernel kept one candidate per
// row slab and reduced the slabs in a jnp epilogue.  Blocks on the card run
// in no order, and a seed is one launch:
//   - A warp a row, 8 rows a block: coalesced 16-byte loads of the row
//     (its head before the first 16-byte boundary and its tail one float a
//     lane), 8 in flight a lane; dead rows are not read at all.  The warp
//     keeps the row's first minimum (first_min.cuh: indices compared on
//     equal values) and stores it as (value bits, column), fenced.
//   - The block folds its rows' (value, row) into one 64-bit atomicMin,
//     whose order is the first row that attains the minimum; the block that
//     draws the last ticket (last_block.cuh) reads that row's column, writes
//     the result, and resets the key and the ticket for the next launch.
//     The key holds the row, not the flat index, which does not fit 32 bits
//     past n = 65536.
//   - A warp reads its row at one warp's rate, so with dead rows among a
//     block's the block waits on its live warps: on an H100 at n = 16384
//     with 40% of the rows dead it took 3.6% longer than a block a row,
//     and as long on the all-live state that every seed of a run finds.
// Two earlier forms, a block a row with a second one-block pass over the n
// row results (two launches) and a block a row with this ticket (one
// launch), both took ~11.6 us at n = 1968 on an H100, a block's fixed
// latency over two waves of blocks; the ticket made the second 3% slower
// at n = 16384, one same-address atomic pair a row
// (chip_smoke.py --single-kernel-times).
//
// The batch form (masked_argmin_batch, B stacked problems) has a body of
// its own in argmin_batch.cu: one launch, a lane owned by a warp, a block
// or a cluster, only each lane's live rows over its live column span read.
// Compiled from that lane body with the lane index fixed at 0, this entry
// ran 3-11% slower on an H100 (chip_smoke.py --single-kernel-times on both
// versions).
#include <climits>

#include "first_min.cuh"
#include "last_block.cuh"

namespace {

constexpr int kRowThreads = 256;
constexpr int kRowWarps = kRowThreads / 32;     // rows a block
constexpr unsigned long long kNoKey = ~0ull;    // above every key

// Fold column c, holding x, of row r into the lane's first minimum.
__device__ __forceinline__ void visit(const unsigned char* __restrict__ alive, long long r,
                                      int c, float x, float& bv, int& bc) {
    const float v = (__ldg(alive + c) && c != r) ? x : CUDART_INF_F;
    if (first_min_better(v, c, bv, bc)) { bv = v; bc = c; }
}

__global__ void __launch_bounds__(kRowThreads)
masked_row_min(const float* __restrict__ D, const unsigned char* __restrict__ alive, int n,
               unsigned long long* __restrict__ rows, unsigned long long* __restrict__ sync,
               float* __restrict__ out_v, long long* __restrict__ out_flat) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long r = (long long)blockIdx.x * kRowWarps + warp;
    unsigned long long key = kNoKey;
    if (r < n) {
        float bv = CUDART_INF_F;
        int bc = INT_MAX;
        if (__ldg(alive + r)) {
            const float* row = D + r * n;
            const int head = head_columns(row, n), n4 = (n - head) >> 2;
            if (lane < head) visit(alive, r, lane, __ldg(row + lane), bv, bc);
            const float4* row4 = reinterpret_cast<const float4*>(row + head);
#pragma unroll 8
            for (int q = lane; q < n4; q += 32) {
                const float4 x = __ldg(row4 + q);
                const int c = head + 4 * q;
                visit(alive, r, c, x.x, bv, bc);
                visit(alive, r, c + 1, x.y, bv, bc);
                visit(alive, r, c + 2, x.z, bv, bc);
                visit(alive, r, c + 3, x.w, bv, bc);
            }
            const int tail = head + 4 * n4 + lane;
            if (tail < n) visit(alive, r, tail, __ldg(row + tail), bv, bc);
        } else {
            bc = 0;  // a dead row is all +inf: its first minimum is column 0
        }
        warp_first_min(bv, bc);
        if (lane == 0) {
            rows[r] = ((unsigned long long)__float_as_uint(bv) << 32) | (unsigned)bc;
            __threadfence();    // read by the last block, after the ticket
            key = min_key(bv, (int)r);
        }
    }
    __shared__ unsigned long long s_key[kRowWarps];
    __shared__ bool last;
    if (lane == 0) s_key[warp] = key;
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kRowWarps; ++w) key = s_key[w] < key ? s_key[w] : key;
        if (key != kNoKey) atomicMin(sync, key);
        last = draw_ticket(sync + 1);
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    const unsigned long long won = atomicExch(sync, kNoKey);
    sync[1] = 0;
    const long long best = (long long)(won & 0xffffffffull);
    const unsigned long long rec = __ldcg(rows + best);
    *out_v = __uint_as_float((unsigned)(rec >> 32));        // the row's own float
    *out_flat = best * n + (long long)(rec & 0xffffffffull);
}

}  // namespace

// D: (n, n) float32, alive: (n,) bool, rows: (n,) int64 scratch, sync: two
// int64, (~0, 0) between launches (the kernel leaves them so); outputs one
// float32 and one int64.  Launches on `stream` of CUDA device `device`;
// returns cudaGetLastError().
extern "C" int masked_argmin(int device, const float* D, const unsigned char* alive, long long n,
                             unsigned long long* rows, unsigned long long* sync, float* out_v,
                             long long* out_flat, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0 || n > INT_MAX) return (int)cudaErrorInvalidValue;
    const unsigned blocks = (unsigned)((n + kRowWarps - 1) / kRowWarps);
    masked_row_min<<<blocks, kRowThreads, 0, stream>>>(D, alive, (int)n, rows, sync, out_v,
                                                       out_flat);
    return (int)cudaGetLastError();
}
