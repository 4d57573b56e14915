// One row of squared Euclidean distances, (d,) x (m, d) -> (m,), one whole
// trip of the matrix-free NN chain, and one rank's vote of a trip of the
// sharded chain, for sm_90a.
//
// All three replace the Pallas TPU kernel
// repro/kernels/pairwise.py::row_sq_euclidean_pallas, which builds one row
// of the matrix-free chain a trip: the chain tip against every geometric
// summary.  out[k] = sum_c (Y[k, c] - x[c])^2 in float32.
//
// row_sq_euclidean: the row alone (the TPU kernel's contract).
// Bound: bytes.  The row reads Y once and writes m floats, 4 (m d + m + d)
// bytes, against 3 m d flops: at m = 32768, d = 128 that is 16.9 MB, which
// fits in the 50 MB L2, so a chain that builds one row after another reads
// the summaries from L2, not from HBM (chip_smoke.py measures the card's L2
// read rate for this bound).  Design: the TPU kernel put the row on the MXU
// in Gram form (xx + yy - 2 x.y).  A single row is a matrix-vector product
// that no tensor core helps, so this kernel takes the difference form: the
// same bytes, no cancellation, and the arithmetic of the JAX package's own
// jnp row.  One warp owns one point row at a time (a grid-stride loop over
// rows); every warp reads the tip x through the read-only cache, where its
// few hundred bytes stay; rows are read with 16-byte loads when d % 4 == 0
// and both operands are 16-byte aligned; a warp shuffle sums the 32 lanes.
// There is no padding: the kernel masks its own ragged edge in m and d.
//
// chain_trip: one whole trip of the chain loop (core/nnchain.py) in one
// launch that reads nothing back, so that chunks of trips replay as a CUDA
// graph.  The state lives on the device: the summaries W (n, d) and u (n,),
// sizes, alive and its bitmask, the chain stack, the merge records and the
// counts (chain length, merges, trips, stopped).  Every block builds its
// share of the tip's row, ||w_top - w_k||^2 and the method's summary
// distance, masks dead slots and the tip, and folds it into a first minimum
// kept as one 64-bit atomicMin on (order-preserving value bits, slot); the
// block that holds the previous chain element stores its value, so the tie
// test compares the kernel's own floats.  The last block to draw the
// ticket decides, as the plain loop does: a NaN minimum stops the chain;
// the previous element wins ties (a merge); otherwise the first slot of the
// minimum is pushed.  A merge writes the merged summary into slot i, the
// record, sizes, alive and the bitmask, and pops the chain by two; a chain
// left empty gets the first live slot at once, so the next trip finds its
// tip.  A trip past the last merge, the trip cap or a stop does nothing.
// Bound: bytes, the summaries read once: 4 m d + 4 m (u for average and
// weighted, the sizes for ward) + m / 8 (the bitmask) plus O(d), at the L2
// read rate (the summaries stay in L2 from trip to trip): about 2 us at
// (32768, 128).  Design:
//   - 8 lanes a row, 16-byte loads, neighbouring lanes on neighbouring
//     addresses; each thread keeps its share of the tip in registers (at
//     most 4 float4: d <= 128) and issues the loads of 4 rows before it
//     sums any, so 16 loads are in flight a thread at d = 128.  Another d,
//     or operands not 16-byte aligned, take a scalar path.
//   - A grid of at most two blocks an SM (__launch_bounds__(256, 2)): at
//     (32768, 128) 256 blocks of 128 rows each, one wave on 132 SMs.
//   - The row is never written: each row's value goes straight into the
//     block's minimum.
//   - Every block reads the state as it was before the trip; only the last
//     block writes it, behind the ticket that it draws after every block's
//     rows are done (last_block.cuh: release and acquire; the one value it
//     reads from another block, row[prev], is fenced by its writer), so no
//     block still reads W when slot i's summary is rewritten.  It resets
//     the key and the ticket for the next launch.
//   - The epilogue rounds each operation on its own (__fmul_rn, ...), in
//     the plain version's order: the merged summaries equal the plain
//     twin's but for the order of the gap's sum.  The row's sum runs in
//     another order than torch's, so the two agree to a tolerance.
//
// chain_vote: one rank's vote of one trip of the sharded chain
// (core/distributed.py), in one launch: the front half of a trip over the
// rank's block of rows at an offset, stopped at the vote that the ranks'
// all_gather elects from.  It writes (local min, first local slot, prev's
// masked value) into a (3,) send buffer, bit for bit what the row entry
// followed by the torch epilogue gives (the row, summary_distance, the
// masks, min and the prev index: ~10 launches).  Bound: bytes, 4 (rows d +
// rows + d) + rows + 12 (the block, u or the sizes, alive, the tip, the
// triple), at the L2 read rate where the block stays there from trip to
// trip.  Design:
//   - The row entry's per-row sum (warp_rows_sq: a warp a row, the same
//     lane partition, sq_diff4 partial and xor tree), with 4 rows' loads in
//     flight a warp, where the row entry has one; dead slots and the tip
//     load nothing.  On an H100, 8 rows a warp took ~0.5 us less at
//     (32768, 128) and ~0.6 us more at (1968, 64), whose 31 blocks then
//     leave most SMs idle; loads issued before the rows' liveness was
//     known were no faster.
//   - The epilogue rounds each operation in summary_distance's order, as
//     chain_trip's does; the row is never written: each masked value goes
//     into the block's first minimum, then one 64-bit atomicMin on (value
//     bits, local slot), a NaN keyed first.  The warp that holds prev
//     stores its value, fenced; the last block by ticket writes the triple
//     and resets the key and the ticket.
//   - A grid of one wave, at most two blocks an SM, as chain_trip's.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <cstdint>

#include "lance_williams.cuh"
#include "last_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kMaxBlocks = 1 << 20;

__device__ __forceinline__ float sq_diff4(float4 a, float4 b) {
    const float t0 = a.x - b.x, t1 = a.y - b.y, t2 = a.z - b.z, t3 = a.w - b.w;
    return t0 * t0 + t1 * t1 + t2 * t2 + t3 * t3;
}

// The per-row sum of both the row entry and the vote: ||y[r] - x||^2 for R
// rows of d floats, one warp each.  Lane `lane` adds its chunks in order
// from 0 (kVec4: float4 q = lane, lane + 32, ...; else floats c = lane,
// lane + 32, ...), the R rows' loads of a chunk issued together; then each
// row's xor-shuffle tree, which leaves every lane the same sum.  A row that
// is not live loads nothing, and its sum means nothing.
template <bool kVec4, int R>
__device__ __forceinline__ void warp_rows_sq(const float* __restrict__ x,
                                             const float* const (&y)[R], const bool (&live)[R],
                                             long long d, int lane, float (&sum)[R]) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    if (kVec4) {
        const float4* x4 = reinterpret_cast<const float4*>(x);
        for (long long q = lane; q < d / 4; q += 32) {
            float4 t[R];
#pragma unroll
            for (int r = 0; r < R; ++r)
                t[r] = live[r] ? __ldg(reinterpret_cast<const float4*>(y[r]) + q)
                               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            const float4 xq = __ldg(x4 + q);
#pragma unroll
            for (int r = 0; r < R; ++r) acc[r] += sq_diff4(t[r], xq);
        }
    } else {
        for (long long c = lane; c < d; c += 32) {
            float t[R];
#pragma unroll
            for (int r = 0; r < R; ++r) t[r] = live[r] ? __ldg(y[r] + c) : 0.0f;
            const float xc = __ldg(x + c);
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float s = t[r] - xc;
                acc[r] += s * s;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
        for (int off = 16; off > 0; off >>= 1) acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        sum[r] = acc[r];
    }
}

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
row_sq_kernel(const float* __restrict__ x, const float* __restrict__ Y, long long m,
              long long d, float* __restrict__ out) {
    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * kWarps;
    for (long long k = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); k < m; k += stride) {
        const float* y[1] = {Y + k * d};
        const bool live[1] = {true};
        float sum[1];
        warp_rows_sq<kVec4, 1>(x, y, live, d, lane, sum);
        if (lane == 0) out[k] = sum[0];
    }
}

template <bool kVec4>
void launch(const float* x, const float* Y, long long m, long long d, float* out,
            cudaStream_t stream) {
    const long long blocks = (m + kWarps - 1) / kWarps;
    row_sq_kernel<kVec4><<<(unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks), kThreads, 0,
                           stream>>>(x, Y, m, d, out);
}

}  // namespace

// x: (d,) float32, Y: (m, d) float32 row-major, out: (m,) float32.  Launches
// on `stream` of CUDA device `device` (nothing when m == 0); returns
// cudaGetLastError().
extern "C" int row_sq_euclidean(int device, const float* x, const float* Y, long long m,
                                long long d, float* out, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (m <= 0) return 0;
    const bool vec4 = d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(Y) % 16 == 0;
    if (vec4) launch<true>(x, Y, m, d, out, stream);
    else launch<false>(x, Y, m, d, out, stream);
    return (int)cudaGetLastError();
}

namespace {

constexpr int kTripThreads = 256;
constexpr int kTripWarps = kTripThreads / 32;
constexpr int kLanes = 8;                          // lanes a row
constexpr int kGroups = kTripThreads / kLanes;     // rows a block at a time
constexpr int kRows = 4;                           // rows a thread has in flight
constexpr int kTripBlocksPerSM = 2;
constexpr int kMaxSums = 4;                        // float4 of the tip a lane keeps: d <= 128
constexpr unsigned long long kTripKeyInit = ~0ull; // above every key

struct Trip {
    float* W;                  // (n, d) summaries
    float* u;                  // (n,)
    unsigned char* alive;      // (n,) bool
    unsigned* bits;            // ceil(n/32) words: alive as a bitmask
    float* sizes;              // (n,)
    int* chain;                // (n + 1,) the chain stack
    float* merges;             // (n_steps, 4) rows (i, j, dist, new size)
    int* count;                // chain length, merges, trips, stopped
    unsigned long long* sync;  // the running minimum's key, the block ticket, row[prev]
    int n, d, n_steps, cap;
};

// (value, slot) as a key whose unsigned order is (value, slot)'s order; -0
// keys as +0, since torch.min counts them equal; a NaN keys below every
// value (high word 0), so the last block sees that the row has one.
__device__ __forceinline__ unsigned long long trip_key(float v, int k) {
    if (v != v) return (unsigned long long)(unsigned)k;
    unsigned b = __float_as_uint(v == 0.0f ? 0.0f : v);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return ((unsigned long long)b << 32) | (unsigned)k;
}

// The LW distance from the summaries (nnchain.summary_distance, its order).
template <int M>
__device__ __forceinline__ float summary_distance(float sq, float u_k, float u_top, float n_k,
                                                  float n_top) {
    if (M == kWard)
        return __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(2.0f, n_top), n_k), __fadd_rn(n_top, n_k)),
                         sq);
    return __fadd_rn(__fadd_rn(sq, u_k), u_top);
}

__device__ __forceinline__ bool bit_live(const unsigned* bits, int k) {
    return (__ldg(bits + (k >> 5)) >> (k & 31)) & 1u;
}

// Sum the 8 lanes of a row's group; every lane gets the sum.
__device__ __forceinline__ float group_sum(float acc) {
    acc += __shfl_xor_sync(0xffffffffu, acc, 4);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    return acc;
}

// Fold row k's value into the thread's minimum key; the group that holds
// the previous chain element stores its value for the tie test.
template <int M>
__device__ __forceinline__ void visit(const Trip& a, int k, bool live, float sq, float side,
                                      float u_top, float n_top, int prev, int lane,
                                      unsigned long long& best) {
    if (k >= a.n) return;
    float v = CUDART_INF_F;
    if (live) v = M == kWard ? summary_distance<M>(sq, 0.0f, u_top, side, n_top)
                             : summary_distance<M>(sq, side, u_top, 0.0f, n_top);
    const unsigned long long key = trip_key(v, k);
    best = key < best ? key : best;
    if (k == prev && lane == 0) {
        a.sync[2] = __float_as_uint(v);
        __threadfence();
    }
}

// The main pass: this block's rows, V float4 of the tip a lane in
// registers (V = 0: the scalar path).  Returns the thread's minimum key.
template <int M, int V>
__device__ __forceinline__ unsigned long long trip_rows(const Trip& a, int top, int prev,
                                                        float u_top, float n_top) {
    const int lane = threadIdx.x % kLanes, group = threadIdx.x / kLanes;
    const float* side_of = M == kWard ? a.sizes : a.u;   // the one per-slot scalar the method reads
    unsigned long long best = kTripKeyInit;
    if constexpr (V > 0) {
        const int d4 = a.d >> 2;
        const float4* W4 = reinterpret_cast<const float4*>(a.W);
        float4 tip[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
            const int q = lane + kLanes * v;
            tip[v] = q < d4 ? __ldg(W4 + (long long)top * d4 + q) : make_float4(0, 0, 0, 0);
        }
        for (int base = blockIdx.x * kGroups * kRows; base < a.n;
             base += gridDim.x * kGroups * kRows) {
            float4 y[kRows][V];
            float side[kRows];
            bool live[kRows];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const int k = base + r * kGroups + group;
                live[r] = k < a.n && k != top && bit_live(a.bits, k);
                side[r] = live[r] ? __ldg(side_of + k) : 0.0f;
#pragma unroll
                for (int v = 0; v < V; ++v) {
                    const int q = lane + kLanes * v;
                    y[r][v] = live[r] && q < d4 ? __ldg(W4 + (long long)k * d4 + q)
                                                : make_float4(0, 0, 0, 0);
                }
            }
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                float acc = 0.0f;
#pragma unroll
                for (int v = 0; v < V; ++v) acc += sq_diff4(y[r][v], tip[v]);
                acc = group_sum(acc);
                visit<M>(a, base + r * kGroups + group, live[r], acc, side[r], u_top, n_top, prev,
                         lane, best);
            }
        }
    } else {
        const float* w_top = a.W + (long long)top * a.d;
        for (int base = blockIdx.x * kGroups; base < a.n; base += gridDim.x * kGroups) {
            const int k = base + group;
            const bool live = k < a.n && k != top && bit_live(a.bits, k);
            float acc = 0.0f;
            if (live) {
                const float* y = a.W + (long long)k * a.d;
                for (int c = lane; c < a.d; c += kLanes) {
                    const float t = __ldg(y + c) - __ldg(w_top + c);
                    acc += t * t;
                }
            }
            acc = group_sum(acc);
            visit<M>(a, k, live, acc, live ? __ldg(side_of + k) : 0.0f, u_top, n_top, prev, lane,
                     best);
        }
    }
    return best;
}

// The block's minimum key; valid in thread 0.
__device__ __forceinline__ unsigned long long block_min_key(unsigned long long key) {
    __shared__ unsigned long long s_key[kTripWarps];
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
        key = o < key ? o : key;
    }
    if ((threadIdx.x & 31) == 0) s_key[threadIdx.x >> 5] = key;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < kTripWarps; ++w) key = s_key[w] < key ? s_key[w] : key;
    return key;
}

// The block's sum of one float a thread; valid in thread 0.
__device__ __forceinline__ float block_sum(float x) {
    __shared__ float s_sum[kTripWarps];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if ((threadIdx.x & 31) == 0) s_sum[threadIdx.x >> 5] = x;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int w = 1; w < kTripWarps; ++w) x += s_sum[w];
    return x;
}

enum TripOp { kPush = 0, kMerge, kStop };

// The last block of a trip: the decision, the merge or the push, and the
// counts.  Every other block has read the state from before the trip.
template <int M>
__device__ __forceinline__ void finish_trip(const Trip& a, int len, int top, int prev, int nm,
                                            int it) {
    __shared__ int s_op, s_i, s_j, s_first;
    __shared__ float s_m, s_ni, s_nj;
    if (threadIdx.x == 0) {
        const unsigned long long key = atomicExch(a.sync, kTripKeyInit);
        const long long* pv_bits = reinterpret_cast<const long long*>(a.sync + 2);
        const float pv = __uint_as_float((unsigned)__ldcg(pv_bits));
        a.sync[1] = 0;
        int op = kPush, c = (int)(key & 0xffffffffull);
        const float m = key_value(key);
        if ((key >> 32) == 0) op = kStop;                 // a NaN in the row: no candidate
        else if (prev >= 0 && pv == m) { op = kMerge; c = prev; }
        s_op = op;
        s_m = m;
        s_i = min(top, c);
        s_j = max(top, c);
        if (op == kMerge) {
            s_ni = __ldcg(a.sizes + s_i);
            s_nj = __ldcg(a.sizes + s_j);
        }
        if (op == kPush) {
            a.chain[len] = c;
            a.count[0] = len + 1;
        }
        if (op == kStop) a.count[3] = 1;
        a.count[2] = it + 1;
        s_first = a.n;
    }
    __syncthreads();
    if (s_op != kMerge) return;
    const int i = s_i, j = s_j;
    const float ni = s_ni, nj = s_nj, tot = __fadd_rn(ni, nj);
    float gap = 0.0f;
    float* wi_row = a.W + (long long)i * a.d;
    const float* wj_row = a.W + (long long)j * a.d;
    for (int c = threadIdx.x; c < a.d; c += kTripThreads) {
        const float wi = __ldcg(wi_row + c), wj = __ldcg(wj_row + c);
        if (M != kWard) {
            const float t = __fsub_rn(wi, wj);
            gap = __fadd_rn(gap, __fmul_rn(t, t));
        }
        wi_row[c] = M == kWeighted
                        ? __fmul_rn(0.5f, __fadd_rn(wi, wj))
                        : __fdiv_rn(__fadd_rn(__fmul_rn(ni, wi), __fmul_rn(nj, wj)), tot);
    }
    if (M != kWard) gap = block_sum(gap);
    if (threadIdx.x == 0) {
        float u_new = 0.0f;                               // ward's u stays 0
        if (M != kWard) {
            const float ui = __ldcg(a.u + i), uj = __ldcg(a.u + j);
            if (M == kWeighted)
                u_new = __fadd_rn(__fmul_rn(0.5f, __fadd_rn(ui, uj)), __fmul_rn(0.25f, gap));
            else
                u_new = __fadd_rn(
                    __fdiv_rn(__fadd_rn(__fmul_rn(ni, ui), __fmul_rn(nj, uj)), tot),
                    __fmul_rn(__fdiv_rn(__fmul_rn(ni, nj), __fmul_rn(tot, tot)), gap));
        }
        a.u[i] = u_new;
        float* rec = a.merges + 4ll * nm;
        rec[0] = (float)i;
        rec[1] = (float)j;
        rec[2] = s_m;
        rec[3] = tot;
        a.sizes[i] = tot;
        a.sizes[j] = 0.0f;
        a.alive[j] = 0;
        a.bits[j >> 5] &= ~(1u << (j & 31));
        a.count[0] = len - 2;
        a.count[1] = nm + 1;
    }
    if (len > 2) return;
    // the chain is empty: its next tip is the first live slot
    __syncthreads();
    for (int w = threadIdx.x; w < (a.n + 31) >> 5; w += kTripThreads) {
        const unsigned word = __ldcg(a.bits + w);
        if (word) {
            atomicMin(&s_first, w * 32 + __ffs(word) - 1);
            break;
        }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        a.chain[0] = s_first;
        a.count[0] = 1;
    }
}

template <int M, int V>
__global__ void __launch_bounds__(kTripThreads, kTripBlocksPerSM) chain_trip_kernel(const Trip a) {
    const int len = a.count[0], nm = a.count[1], it = a.count[2];
    if (nm >= a.n_steps || it >= a.cap || a.count[3]) return;   // past the end: nothing
    if (len <= 0) {                                              // no tip: nothing is live
        if (blockIdx.x == 0 && threadIdx.x == 0) {
            a.count[2] = it + 1;
            a.count[3] = 1;
        }
        return;
    }
    const int top = a.chain[len - 1], prev = len >= 2 ? a.chain[len - 2] : -1;
    const float u_top = a.u[top], n_top = a.sizes[top];
    const unsigned long long key = block_min_key(trip_rows<M, V>(a, top, prev, u_top, n_top));
    __shared__ bool last;
    if (threadIdx.x == 0) {
        if (key != kTripKeyInit) atomicMin(a.sync, key);
        last = draw_ticket(a.sync + 1);
    }
    __syncthreads();
    if (!last) return;
    finish_trip<M>(a, len, top, prev, nm, it);
}

int sm_count(int device) {
    static int sms[64] = {};
    if (device < 0 || device >= 64) return 132;
    if (!sms[device]) cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount, device);
    return sms[device] > 0 ? sms[device] : 132;
}

// The float4 of the tip a lane keeps for this d and W (0: the scalar path).
int tip_width(const float* W, long long d) {
    if (d <= 0 || d % 4 != 0 || reinterpret_cast<uintptr_t>(W) % 16 != 0) return 0;
    const long long d4 = d / 4;
    return d4 <= kLanes ? 1 : d4 <= 2 * kLanes ? 2 : d4 <= kMaxSums * kLanes ? 4 : 0;
}

// Launch one trip, or (load_only) load the kernel such a launch takes.
template <int M>
struct TripLaunch {
    template <int V>
    static cudaError_t go(const Trip& a, int device, cudaStream_t stream, bool load_only) {
        if (load_only) {
            cudaFuncAttributes attr;
            return cudaFuncGetAttributes(&attr, (const void*)chain_trip_kernel<M, V>);
        }
        const long long rows = (long long)kGroups * (V > 0 ? kRows : 1);
        const long long want = (a.n + rows - 1) / rows;
        const long long most = (long long)kTripBlocksPerSM * sm_count(device);
        const unsigned blocks = (unsigned)(want < most ? want : most);
        chain_trip_kernel<M, V><<<blocks, kTripThreads, 0, stream>>>(a);
        return cudaGetLastError();
    }

    static cudaError_t run(const Trip& a, int device, cudaStream_t stream, bool load_only) {
        switch (tip_width(a.W, a.d)) {
            case 1: return go<1>(a, device, stream, load_only);
            case 2: return go<2>(a, device, stream, load_only);
            case 4: return go<4>(a, device, stream, load_only);
            default: return go<0>(a, device, stream, load_only);
        }
    }
};

cudaError_t trip(int method, const Trip& a, int device, cudaStream_t stream, bool load_only) {
    switch (method) {
        case kAverage: return TripLaunch<kAverage>::run(a, device, stream, load_only);
        case kWeighted: return TripLaunch<kWeighted>::run(a, device, stream, load_only);
        case kWard: return TripLaunch<kWard>::run(a, device, stream, load_only);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// One trip of the matrix-free chain, in place.  W: (n, d) float32; u, sizes:
// (n,) float32; alive: (n,) bool; bits: (ceil(n/32),) int32, alive as a
// bitmask; chain: (n + 1,) int32; merges: (n_steps, 4) float32; count: four
// int32 (chain length, merges, trips, stopped); sync: three int64, (~0, 0, 0)
// between launches.  `method` indexes linkage.METHODS (average, weighted or
// ward).  Launches on `stream` of CUDA device `device`; returns the CUDA
// error.
extern "C" int chain_trip(int device, int method, float* W, float* u, unsigned char* alive,
                          unsigned* bits, float* sizes, int* chain, float* merges, int* count,
                          unsigned long long* sync, long long n, long long d, long long n_steps,
                          long long cap, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (n <= 0) return 0;
    const Trip a{W, u, alive, bits, sizes, chain, merges, count, sync,
                 (int)n, (int)d, (int)n_steps, (int)cap};
    return (int)trip(method, a, device, stream, false);
}

// Load the kernel a trip on (W, d) takes, before a stream capture: CUDA
// loads kernels lazily, at their first launch, and a first load must not
// fall inside a capture.  Returns the CUDA error.
extern "C" int chain_trip_load(int device, int method, const float* W, long long d) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    sm_count(device);
    Trip a{};
    a.W = const_cast<float*>(W);
    a.d = (int)d;
    return (int)trip(method, a, device, 0, true);
}

namespace {

constexpr int kVoteRows = 4;   // rows a warp has in flight

struct Vote {
    const float* tip;            // (d,) the tip's summary
    const float* W;              // (rows, d) this rank's block of summaries
    const float* u;              // (n,) replicated
    const float* sizes;          // (n,) replicated
    const unsigned char* alive;  // (n,) bool, replicated
    float* out;                  // (3,) the vote: local min, first local argmin, prev's value
    unsigned long long* sync;    // the running minimum's key, the block ticket, prev's value
    long long rows, d, offset;   // the block holds slots [offset, offset + rows)
    long long top, prev;         // global slots; prev < 0: no previous element
};

// One rank's vote of one trip of the sharded chain: the masked row of the
// tip over the block, folded as it is built into the block's first minimum
// and one 64-bit atomicMin; the warp that holds prev stores its value; the
// last block by ticket writes the triple and resets the key and the ticket.
template <int M, bool kVec4>
__global__ void __launch_bounds__(kTripThreads, kTripBlocksPerSM) chain_vote_kernel(const Vote a) {
    const int lane = threadIdx.x & 31;
    const float u_top = __ldg(a.u + a.top), n_top = __ldg(a.sizes + a.top);
    const float* side_of = (M == kWard ? a.sizes : a.u) + a.offset;
    const unsigned char* alive = a.alive + a.offset;
    const long long top = a.top - a.offset, prev = a.prev < 0 ? -1 : a.prev - a.offset;
    const long long step = (long long)gridDim.x * kTripWarps * kVoteRows;
    unsigned long long best = kTripKeyInit;
    for (long long base = ((long long)blockIdx.x * kTripWarps + (threadIdx.x >> 5)) * kVoteRows;
         base < a.rows; base += step) {
        const float* y[kVoteRows];
        bool live[kVoteRows];
        float side[kVoteRows], sq[kVoteRows];
#pragma unroll
        for (int r = 0; r < kVoteRows; ++r) {
            const long long k = base + r;
            live[r] = k < a.rows && k != top && __ldg(alive + k);
            y[r] = a.W + (live[r] ? k : 0) * a.d;
            side[r] = live[r] ? __ldg(side_of + k) : 0.0f;
        }
        warp_rows_sq<kVec4, kVoteRows>(a.tip, y, live, a.d, lane, sq);
#pragma unroll
        for (int r = 0; r < kVoteRows; ++r) {
            const long long k = base + r;
            if (k >= a.rows) break;
            float v = CUDART_INF_F;
            if (live[r]) v = M == kWard ? summary_distance<M>(sq[r], 0.0f, u_top, side[r], n_top)
                                        : summary_distance<M>(sq[r], side[r], u_top, 0.0f, n_top);
            const unsigned long long key = trip_key(v, (int)k);
            best = key < best ? key : best;
            if (k == prev && lane == 0) {
                a.sync[2] = __float_as_uint(v);
                __threadfence();
            }
        }
    }
    const unsigned long long key = block_min_key(best);
    __shared__ bool last;
    if (threadIdx.x == 0) {
        if (key != kTripKeyInit) atomicMin(a.sync, key);
        last = draw_ticket(a.sync + 1);
    }
    __syncthreads();
    if (!last || threadIdx.x != 0) return;
    const bool mine = prev >= 0 && prev < a.rows;
    const float pv = mine ? __uint_as_float((unsigned)__ldcg(
                                reinterpret_cast<const long long*>(a.sync + 2)))
                          : CUDART_INF_F;
    const unsigned long long won = atomicExch(a.sync, kTripKeyInit);
    a.sync[1] = 0;
    a.out[0] = (won >> 32) == 0 ? CUDART_NAN_F : key_value(won);   // a NaN in the row: NaN
    a.out[1] = (float)(unsigned)(won & 0xffffffffull);
    a.out[2] = pv;
}

template <int M>
cudaError_t vote(const Vote& a, int device, cudaStream_t stream) {
    const bool vec4 = a.d % 4 == 0 && reinterpret_cast<uintptr_t>(a.tip) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(a.W) % 16 == 0;
    const long long rows = (long long)kTripWarps * kVoteRows;
    const long long want = (a.rows + rows - 1) / rows;
    const long long most = (long long)kTripBlocksPerSM * sm_count(device);
    const unsigned blocks = (unsigned)(want < most ? want : most);
    if (vec4) chain_vote_kernel<M, true><<<blocks, kTripThreads, 0, stream>>>(a);
    else chain_vote_kernel<M, false><<<blocks, kTripThreads, 0, stream>>>(a);
    return cudaGetLastError();
}

}  // namespace

// One rank's vote of one trip of the sharded matrix-free chain, in one
// launch.  tip: (d,) float32; W: (rows, d) float32, the rank's block, slots
// [offset, offset + rows); u, sizes: (n,) float32 and alive: (n,) bool,
// replicated; top and prev global slots (prev -1: none).  Writes into out
// (3,) float32 the masked row's minimum (dead slots and the tip +inf; NaN
// if the row holds one), its first local slot, and prev's masked value (+inf
// when prev is not in the block).  sync: three int64, (~0, 0, any) between
// launches.  `method` indexes linkage.METHODS (average, weighted or ward).
// Launches on `stream` of CUDA device `device`; returns the CUDA error.
extern "C" int chain_vote(int device, int method, const float* tip, const float* W,
                          const float* u, const float* sizes, const unsigned char* alive,
                          float* out, unsigned long long* sync, long long rows, long long d,
                          long long offset, long long top, long long prev, cudaStream_t stream) {
    const cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
    const Vote a{tip, W, u, sizes, alive, out, sync, rows, d, offset, top, prev};
    switch (method) {
        case kAverage: return (int)vote<kAverage>(a, device, stream);
        case kWeighted: return (int)vote<kWeighted>(a, device, stream);
        case kWard: return (int)vote<kWard>(a, device, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
