// Kernel B3's batch form, for sm_90a: one lockstep `lazy` merge of B stacked
// problems of n slots, one launch a merge of every lane.
//
// Replaces the batched use of the Pallas TPU kernel
// repro/kernels/lw_update.py::lw_update_pallas (the JAX package batches that
// kernel through pallas_call's vmap rule; the batched kernel engine's `lazy`
// variant makes one lockstep merge a launch).  Each lane's merge is the
// single entries' lazy_merge then lazy_rescan (lw_update.cu), bit for bit:
// the LW row written into row and column i, the cached row minima's
// invalidation, row i's first minimum, the stale rows rescanned, the next
// candidate and the bookkeeping.  A lane whose count has reached its limit
// (it made its merges, or it is padding) is a no-op: its count goes up by
// one, which then counts the lockstep merges, and nothing else of it is
// written.
//
// Bound: bytes, (33 + 4 s) n + 12 c a lane for s stale rows and c cache
// entries rewritten: rows i and j, alive, sizes and both caches read, row
// and column i written, each stale row read once, and both caches written
// for each stale row and each column whose minimum the invalidation lowers
// (on a complete-linkage state, few).  That is a few KB a lane, so a merge is latency, the
// launch and the chain of dependent round trips, until the lanes' column-i
// stores add up: n 4-byte stores a lane, each into another row, which the
// card takes at about one row in 80 ps whatever their width (a torch copy
// into one column of a (256, 1024, 1024) bucket takes ~21 µs, into a whole
// 32-byte sector of each row ~17, into one row ~3.3; chip_smoke
// --batch-kernel-times).  The design keeps the chain short:
//   - One launch, two phases.  A lane is owned by one block, or by a
//     thread-block cluster of up to 8 blocks where its rows are longer than
//     1024 slots (the host's plan, kernels/lw_update.py lazy_batch_plan).
//     The update (phase 1) gives each block a range of columns, up to 4 a
//     thread a pass, the first pass's loads issued while the liveness
//     bitmask is built; the rescan (phase 2) follows a barrier:
//     __syncthreads() in a block, cluster.sync() in a cluster, whose release
//     and acquire at cluster scope order one block's cache writes and
//     stale list before another's reads.
//   - Column i's stores last.  Where a block of 256 updates its columns in
//     one pass it keeps their column-i values in registers and stores them
//     after its rescans: issued first, they held the rescan's loads behind
//     them.  A rescan therefore skips
//     column i and folds in the row's value from the stale list, as
//     lw_merge_batch.cu folds in its merged column.
//   - No ticket, no global atomic, and the lane's sync words, stale list and
//     n_stale left alone.  A block lists its stale rows in shared memory (a
//     shared counter, one atomicAdd a warp); after the barrier every block
//     reads the cluster's counts and lists through distributed shared
//     memory and the stale rows are dealt out round robin to the row groups
//     of all its blocks, so a merge that leaves up to n - 2 rows stale keeps
//     every warp busy.  Each block's running minima reach block 0 through
//     distributed shared memory before the last cluster.sync(); the owner's
//     thread 0 then writes the record, count, alive, sizes, row i's cache,
//     the next candidate, dmin and rescanned.
//   - A stale row goes to a row group of T threads (a warp from n = 128 on),
//     in registers: 8 float4 a thread in flight, a row of 1024 floats in one
//     pass (lw_rows.cuh scan_row, which reads an unaligned row's head one by
//     one).  A longer row takes a warp several passes, so where a block has
//     fewer stale rows than that it rescans them one by one with all its
//     warps, a pass a row, as lazy_rescan does.
//   - The liveness after the merge (j dead) is a bitmask in shared memory,
//     built by warp ballots over coalesced byte loads; count, limit, the
//     candidate, dmin and the first liveness bytes are loaded together,
//     before the lane's state is known.
//   - No spills: the operands are one __grid_constant__ struct of base
//     pointers, a lane's pointers are formed from its index where used, and
//     the owner's count and rescanned wait in shared memory for the
//     epilogue.
#include <cooperative_groups.h>

#include "batch_lanes.cuh"
#include "first_min.cuh"
#include "lance_williams.cuh"
#include "last_block.cuh"
#include "lw_rows.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kPass = 4;         // columns of a thread's pass of the update (256 threads)
constexpr int kAliveLoads = 16;  // liveness bytes a thread loads at a time past the first pass

// The batch buffers' base pointers: lane b's slices sit at b n^2 (D), b n
// (alive, sizes, rmin, rarg), b cap 4 (merges), 2b (cand) and b (count,
// dmin, rescanned, limit).
struct LazyOperands {
    float* D;
    float* sizes;
    float* rmin;
    long long* rarg;
    long long* cand;
    float* dmin;
    long long* count;
    long long* rescanned;
    unsigned char* alive;
    float* merges;
    const long long* limit;
    long long cap;
    int n;
};

// Fold (k, c) into the running (key, col) of the next candidate: the least
// key; keys are distinct (a row each) but for kKeyInit, which row 0 keys at
// (+inf), and a col < 0 is none yet, which any col of an equal key replaces.
__device__ __forceinline__ void fold_key(unsigned long long k, int c, unsigned long long& key,
                                         int& col) {
    if (k < key || (k == key && col < 0)) {
        key = k;
        col = c;
    }
}

// The warp's (key, col) of fold_key, and its least row-i key; valid in lane 0.
__device__ __forceinline__ void warp_keys(unsigned long long& key, int& col,
                                          unsigned long long& key_i) {
    for (int off = 16; off > 0; off >>= 1) {
        const unsigned long long ok = __shfl_down_sync(0xffffffffu, key, off);
        const int oc = __shfl_down_sync(0xffffffffu, col, off);
        fold_key(ok, oc, key, col);
        key_i = min(key_i, __shfl_down_sync(0xffffffffu, key_i, off));
    }
}

// A thread's columns of a pass of the update (k = base + q THREADS + tid <
// hi): rows i and j, the size and the cached minimum, loaded together.
template <int P, int THREADS>
struct Columns {
    float dki[P], dkj[P], nk[P], rm[P];
    long long ra[P];

    __device__ __forceinline__ void load(const float* D, int n, int i, int j, const float* sizes,
                                         const float* rmin, const long long* rarg, int base,
                                         int hi) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const int k = base + q * THREADS + (int)threadIdx.x;
            if (k < hi) {
                dki[q] = D[(size_t)i * n + k];
                dkj[q] = D[(size_t)j * n + k];
                nk[q] = sizes[k];
                rm[q] = rmin[k];
                ra[q] = rarg[k];
            }
        }
    }
};

// One lockstep lazy merge.  A block owns a lane (a launch without a cluster:
// block x is lane x) or a cluster of k blocks does (block x is rank x % k of
// lane x / k).  THREADS a block, P columns a thread a pass of the update; a
// stale row is rescanned by a group of T threads, U float4 a thread a pass
// (blocks of fewer threads serve rows that take one float4 a thread; a block
// of a warp keeps to 64 registers, so that 32 of them fit an SM).
template <int M, int T, int THREADS>
__global__ void __launch_bounds__(THREADS, THREADS == 32 ? 32 : 512 / THREADS)
lazy_merge_batch_kernel(const __grid_constant__ LazyOperands a) {
    constexpr int kWarps = THREADS / 32, kGroups = THREADS / T;
    // a block of 256 serves rows of 256 slots and more; smaller ones a column a thread
    constexpr int P = THREADS >= 256 ? kPass : 1, U = THREADS >= 256 ? 8 : 1;
    // blocks of 256 may hold column i's stores back (smaller ones serve
    // buckets that stay in L2, and keep to their registers)
    constexpr bool kDefer = THREADS >= 256;
    extern __shared__ unsigned s_bits[];   // the liveness after the merge, then the stale list
    __shared__ int s_count;                // this block's stale rows
    __shared__ int s_base[kMaxCluster + 1];   // the cluster's stale rows before each block's
    __shared__ unsigned long long s_key[kWarps], s_key_i[kWarps];
    __shared__ int s_col[kWarps];
    __shared__ unsigned long long c_key[kMaxCluster], c_key_i[kMaxCluster];   // block 0's
    __shared__ int c_col[kMaxCluster];
    __shared__ long long s_state[2];   // the owner's count and rescanned, for the epilogue
    __shared__ float s_bv[kWarps];     // a row's first minimum of each warp
    __shared__ int s_bc[kWarps];

    // a launch without a cluster is one of clusters of one block
    cg::cluster_group cluster = cg::this_cluster();
    const unsigned blocks = cluster.num_blocks(), rank = cluster.block_rank();
    const unsigned lane = blockIdx.x / blocks;
    const int n = a.n, words = (n + 31) >> 5, tid = threadIdx.x;
    const int warp = tid >> 5, wl = tid & 31;
    const size_t row0 = (size_t)lane * n;
    const long long count = a.count[lane], limit = a.limit[lane];
    const long long cr = a.cand[2 * (size_t)lane], cc = a.cand[2 * (size_t)lane + 1];
    const float dij = a.dmin[lane];
    const long long rescanned = rank == 0 && tid == 0 ? a.rescanned[lane] : 0;
    bool alive0[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
        const int c = q * THREADS + tid;
        alive0[q] = c < n && a.alive[row0 + c];
    }
    if (count >= limit) {   // the lane made its merges, or is padding: a no-op, counted
        if (rank == 0 && tid == 0) a.count[lane] = count + 1;
        return;
    }
    if (rank == 0 && tid == 0) {   // out of registers until the epilogue
        s_state[0] = count;
        s_state[1] = rescanned;
    }
    const Merge m{(int)min(cr, cc), (int)max(cr, cc), dij, a.sizes[row0 + min(cr, cc)],
                  a.sizes[row0 + max(cr, cc)]};
    float* D = a.D + row0 * n;
    const float* sizes = a.sizes + row0;
    float* rmin = a.rmin + row0;
    long long* rarg = a.rarg + row0;

    // this block's columns [lo, hi), their first pass loaded while the
    // bitmask is built
    const int per = (n + (int)blocks - 1) / (int)blocks;
    const int lo = min(n, (int)rank * per), hi = min(n, lo + per);
    Columns<P, THREADS> x;
    x.load(D, n, m.i, m.j, sizes, rmin, rarg, lo, hi);

    // the liveness after the merge (j dead), a bitmask word a warp's ballot;
    // past the first P columns a thread, kAliveLoads bytes in flight
    auto bits_word = [&](int c0, bool alive_c) {   // c0 is warp-uniform
        if (c0 < n) {
            const unsigned word = __ballot_sync(0xffffffffu, alive_c && c0 + wl != m.j);
            if (wl == 0) s_bits[c0 >> 5] = word;
        }
    };
#pragma unroll
    for (int q = 0; q < P; ++q) bits_word(q * THREADS + 32 * warp, alive0[q]);
    for (int c1 = P * THREADS; c1 < n; c1 += kAliveLoads * THREADS) {
        bool al[kAliveLoads];
#pragma unroll
        for (int q = 0; q < kAliveLoads; ++q) {
            const int c = c1 + q * THREADS + tid;
            al[q] = c < n && a.alive[row0 + c];
        }
#pragma unroll
        for (int q = 0; q < kAliveLoads; ++q) bits_word(c1 + q * THREADS + 32 * warp, al[q]);
    }
    if (tid == 0) s_count = 0;
    __syncthreads();
    const bool live_i = m.i != m.j && is_live(s_bits, m.i);
    int* s_list = reinterpret_cast<int*>(s_bits + words);   // a row each
    float* s_vals = reinterpret_cast<float*>(s_list + per);  // its column-i value

    // phase 1: row i, the caches' invalidation, the stale rows listed with
    // their column-i value, row i's masked minimum; column i's stores wait
    // for the end of the rescan where the block's columns take one pass
    // (each goes into another row, and the card takes them slowly enough
    // that the rescan's loads would queue behind them)
    const bool defer = kDefer && hi - lo <= P * THREADS;
    float col_i[P];
    unsigned long long key = kKeyInit, key_i = kKeyInit;
    int col = -1;
    for (int base = lo; base < hi; base += P * THREADS) {
        if (base != lo) x.load(D, n, m.i, m.j, sizes, rmin, rarg, base, hi);
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const int k = base + q * THREADS + tid;
            const bool live_k = k < hi && is_live(s_bits, k);   // alive and not j
            const bool keep = live_k && k != m.i;
            const float v = keep ? lance_williams<M>(x.dki[q], x.dkj[q], m.dij, m.ni, m.nj,
                                                     x.nk[q])
                                 : 0.0f;
            bool push = false;
            col_i[q] = v;
            if (k < hi) {
                D[(size_t)m.i * n + k] = v;                 // row i
                if (!defer) D[(size_t)k * n + m.i] = v;   // column i
                if (keep) key_i = min(key_i, min_key(v, k));
                if (k != m.i) {   // row i's cache is the epilogue's
                    // engine._cache_invalidate: column i (+inf off the kept lanes)
                    const float cv = keep ? v : CUDART_INF_F;
                    const bool lower =
                        (cv < x.rm[q] || (cv == x.rm[q] && (long long)m.i < x.ra[q])) && k != m.j;
                    if (lower) {
                        x.rm[q] = cv;
                        x.ra[q] = m.i;
                        rmin[k] = cv;
                        rarg[k] = m.i;
                    }
                    push = live_k && !lower && (x.ra[q] == m.i || x.ra[q] == m.j);
                    if (live_k && !push) fold_key(min_key(x.rm[q], k), (int)x.ra[q], key, col);
                }
            }
            // the stale rows onto the block's list, one shared atomicAdd a warp
            const unsigned pushed = __ballot_sync(0xffffffffu, push);
            if (pushed) {
                const int leader = __ffs(pushed) - 1;
                int at = 0;
                if (wl == leader) at = atomicAdd(&s_count, __popc(pushed));
                at = __shfl_sync(0xffffffffu, at, leader);
                if (push) {
                    const int slot = at + __popc(pushed & ((1u << wl) - 1u));
                    s_list[slot] = k;
                    if (kDefer) s_vals[slot] = v;
                }
            }
        }
    }

    // phase 2: the cluster's stale rows, dealt out to every row group
    int total;
    if (blocks > 1) {
        cluster.sync();
        if (warp == 0) {   // each block's count, through distributed shared memory
            const int c = wl < (int)blocks ? *cluster.map_shared_rank(&s_count, wl) : 0;
            int upto = c;
            for (int off = 1; off < 32; off <<= 1) {
                const int o = __shfl_up_sync(0xffffffffu, upto, off);
                if (wl >= off) upto += o;
            }
            if (wl <= (int)blocks) s_base[wl] = upto - c;   // s_base[blocks]: the total
        }
        __syncthreads();
        total = s_base[blocks];
    } else {
        __syncthreads();
        total = s_count;
    }
    // the stale row t of the cluster, and (kDefer) its column-i value: row
    // r's cells but column i (which D may not hold yet) are scanned, and
    // column i's value is folded in after the row's reduction, as
    // lw_merge_batch.cu does
    auto stale_row = [&](int t, float& v) {
        if (blocks == 1) {
            if (kDefer) v = s_vals[t];
            return s_list[t];
        }
        int q = 0;
        while (t >= s_base[q + 1]) ++q;
        const int* list = q == (int)rank ? s_list : cluster.map_shared_rank(s_list, q);
        if (kDefer) v = reinterpret_cast<const float*>(list + per)[t - s_base[q]];
        return list[t - s_base[q]];
    };
    const Merge none{-1, -1, 0.0f, 0.0f, 0.0f};
    const Merge& skip = kDefer ? m : none;   // the columns a rescan skips but the row's
    auto finish = [&](int r, float v, float bv, int bc) {   // a rescanned row's cache and key
        if (kDefer && live_i && first_min_better(v, m.i, bv, bc)) {
            bv = v;
            bc = m.i;
        }
        if (bv == CUDART_INF_F) bc = 0;   // no cell below +inf: the first column
        rmin[r] = bv;
        rarg[r] = bc;
        fold_key(min_key(bv, r), bc, key, col);
    };
    // a row longer than a warp's pass (4 T U columns) goes to a whole block,
    // in one pass of up to 8 THREADS float4, where its blocks have fewer
    // rows each than a warp would take passes a row
    const int passes = (n + 4 * T * U - 1) / (4 * T * U);
    if (THREADS >= 256 && passes > 1 && (total + (int)blocks - 1) / (int)blocks < passes) {
        for (int t = rank; t < total; t += (int)blocks) {   // block-uniform
            float v;
            const int r = stale_row(t, v);
            float bv = CUDART_INF_F;
            int bc = INT_MAX;
            scan_row<THREADS, U>(D + (size_t)r * n, n, r, skip, s_bits, tid, bv, bc);
            warp_first_min(bv, bc);
            if (wl == 0) {
                s_bv[warp] = bv;
                s_bc[warp] = bc;
            }
            __syncthreads();
            if (tid == 0) {
                for (int w = 1; w < kWarps; ++w)
                    if (first_min_better(s_bv[w], s_bc[w], bv, bc)) { bv = s_bv[w]; bc = s_bc[w]; }
                finish(r, v, bv, bc);
            }
            __syncthreads();
        }
    } else {   // a row to each row group of T threads
        const int l = wl % T;
        for (int first = ((int)rank * THREADS + 32 * warp) / T; first < total;
             first += (int)blocks * kGroups) {
            const int t = first + wl / T;
            float v = 0.0f;
            const int r = t < total ? stale_row(t, v) : -1;
            float bv = CUDART_INF_F;
            int bc = INT_MAX;
            if (r >= 0) scan_row<T, U>(D + (size_t)r * n, n, r, skip, s_bits, l, bv, bc);
            group_first_min<T>(bv, bc);
            if (l == 0 && r >= 0) finish(r, v, bv, bc);
        }
    }
    if (defer) {   // column i, now that this block's rescans have read their rows
#pragma unroll
        for (int q = 0; q < P; ++q) {
            const int k = lo + q * THREADS + tid;
            if (k < hi) D[(size_t)k * n + m.i] = col_i[q];
        }
    }

    // the block's keys, then the cluster's in block 0
    warp_keys(key, col, key_i);
    if (wl == 0) {
        s_key[warp] = key;
        s_col[warp] = col;
        s_key_i[warp] = key_i;
    }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < kWarps; ++w) {
            fold_key(s_key[w], s_col[w], key, col);
            key_i = min(key_i, s_key_i[w]);
        }
    }
    if (blocks > 1) {
        if (tid == 0) {
            *cluster.map_shared_rank(&c_key[rank], 0) = key;
            *cluster.map_shared_rank(&c_col[rank], 0) = col;
            *cluster.map_shared_rank(&c_key_i[rank], 0) = key_i;
        }
        cluster.sync();   // releases the keys and every block's writes to block 0
        if (rank != 0) return;
        if (tid == 0) {
            for (unsigned q = 1; q < blocks; ++q) {
                fold_key(c_key[q], c_col[q], key, col);
                key_i = min(key_i, c_key_i[q]);
            }
        }
    }
    if (tid != 0) return;

    // the epilogue: row i's cache, the next candidate, the record, the bookkeeping
    if (live_i) {   // row i: its first minimum over the kept lanes, (+inf, 0) if none
        const float v = key_value(key_i);
        const int arg = (int)(key_i & 0xffffffffull);
        rmin[m.i] = v;
        rarg[m.i] = arg;
        fold_key(min_key(v, m.i), arg, key, col);
    }
    const int r = (int)(key & 0xffffffffull);
    if (col < 0) col = (int)__ldcg(rarg + r);   // every live row at +inf and row 0 dead
    a.cand[2 * (size_t)lane] = r;
    a.cand[2 * (size_t)lane + 1] = col;
    a.dmin[lane] = key_value(key);
    const float size = __fadd_rn(m.ni, m.nj);
    const long long t = s_state[0];
    if (t < a.cap) {
        float* rec = a.merges + ((size_t)lane * a.cap + t) * 4;
        rec[0] = (float)m.i;
        rec[1] = (float)m.j;
        rec[2] = m.dij;
        rec[3] = size;
    }
    a.count[lane] = t + 1;
    a.alive[row0 + m.j] = 0;
    a.sizes[row0 + m.j] = 0.0f;
    a.sizes[row0 + m.i] = size;
    a.rescanned[lane] = s_state[1] + total;
}

// The kernel of a plan (T threads a stale row, THREADS a block), or nullptr
// for a plan with none.  Whether a cluster owns a lane is the launch's.
template <int M>
const void* lazy_kernel(int group, int threads) {
    if (group == 4 && threads == 32) return (const void*)lazy_merge_batch_kernel<M, 4, 32>;
    if (group == 8 && threads == 32) return (const void*)lazy_merge_batch_kernel<M, 8, 32>;
    if (group == 16 && threads == 64) return (const void*)lazy_merge_batch_kernel<M, 16, 64>;
    if (group == 32 && threads == 128) return (const void*)lazy_merge_batch_kernel<M, 32, 128>;
    if (group == 32 && threads == 256) return (const void*)lazy_merge_batch_kernel<M, 32, 256>;
    return nullptr;
}

// The dynamic shared memory of a launch: the bitmask and a block's list of
// rows and their column-i values, room for each of its columns.
size_t lazy_shared_bytes(int n, int blocks) {
    return ((size_t)(n + 31) / 32 + 2 * (size_t)((n + blocks - 1) / blocks)) * sizeof(unsigned);
}

template <int M>
void launch_lazy_batch(const LazyOperands& a, long long lanes, int group, int threads, int blocks,
                       cudaStream_t stream, cudaError_t* err) {
    const void* fn = lazy_kernel<M>(group, threads);
    if (fn == nullptr || blocks < 1 || blocks > kMaxCluster || lanes * blocks > INT_MAX) {
        *err = cudaErrorInvalidValue;
        return;
    }
    *err = launch_lanes(fn, a, (unsigned)(lanes * blocks), threads, blocks,
                        lazy_shared_bytes(a.n, blocks), stream);
}

template <int M>
void load_lazy_batch(long long n, int group, int threads, int blocks, cudaFuncAttributes* attr,
                     int* per_sm, cudaError_t* err) {
    const void* fn = lazy_kernel<M>(group, threads);
    const size_t smem = lazy_shared_bytes((int)n, blocks);
    *err = fn == nullptr ? cudaErrorInvalidValue : allow_shared(fn, smem);
    if (*err == cudaSuccess) *err = cudaFuncGetAttributes(attr, fn);
    if (*err == cudaSuccess)
        *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, fn, threads, smem);
}

}  // namespace

// One lockstep lazy merge of B stacked problems, in place, each lane as
// lazy_merge then lazy_rescan (lw_update.cu) on its own slices: D (B, n, n);
// alive, sizes, rmin and rarg (B, n); merges (B, cap, 4); count, dmin and
// rescanned (B,); cand (B, 2); limit (B,) int64, the merges a lane makes (a
// lane whose count reached it only adds one to its count).  The plan:
// `group` threads a stale row, `threads` a block, `blocks` blocks a lane (a
// cluster when more than one).  On `stream` of CUDA device `device`; returns
// the CUDA error (cudaErrorInvalidValue for a plan with no kernel).
extern "C" int lazy_merge_batch(int device, int method, float* D, unsigned char* alive,
                                float* sizes, float* merges, long long cap, long long* count,
                                long long* cand, float* dmin, float* rmin, long long* rarg,
                                long long* rescanned, long long n, const long long* limit,
                                long long B, int group, int threads, int blocks,
                                cudaStream_t stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const LazyOperands a{D, sizes, rmin, rarg, cand, dmin, count, rescanned, alive, merges, limit,
                         cap, (int)n};
    LW_DISPATCH_METHOD(method, launch_lazy_batch, a, B, group, threads, blocks, stream, &err)
    return (int)err;
}

// Load the kernel of the plan (`group`, `threads`, `blocks`) at this n before
// a stream capture (CUDA loads kernels lazily, at their first launch, and a
// first load must not fall inside a capture), and allow it its shared
// memory.  Writes its registers a thread, local (spilled) bytes a thread and
// the blocks an SM holds; returns the CUDA error.
extern "C" int lazy_merge_batch_load(int device, int method, long long n, int group, int threads,
                                     int blocks, int* regs, int* local_bytes, int* blocks_per_sm) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    cudaFuncAttributes attr{};
    LW_DISPATCH_METHOD(method, load_lazy_batch, n, group, threads, blocks, &attr, blocks_per_sm,
                       &err)
    *regs = attr.numRegs;
    *local_bytes = (int)attr.localSizeBytes;
    return (int)err;
}
