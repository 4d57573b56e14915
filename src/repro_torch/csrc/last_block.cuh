// The last-block protocol of the resident kernels (lw_step.cu's merge entry,
// lw_update.cu's lazy merge, row_sq.cu's chain trip).
//
// Every block of a launch reads the loop state as it was before the launch
// and folds its candidate into a running minimum, a 64-bit key in device
// memory that atomicMin keeps.  Then thread 0 draws a ticket; the block that
// draws the last one sees every other block's work and writes the next
// state.  What makes that safe:
//   - the key travels by atomics alone, and its value half is the exact
//     float that won, so the last block need not read the value back from
//     the block that wrote it;
//   - a thread whose write another block reads after the ticket fences it
//     (__threadfence) before the block barrier that precedes the ticket;
//   - the ticket is drawn with release and acquire at device scope, so the
//     last block's reads that follow it see what the other blocks wrote
//     before theirs.
#pragma once

#include <cuda/atomic>

// The running minimum's key of (+inf, index 0): what an all-+inf scan gives.
constexpr unsigned long long kKeyInit = 0xFF80000000000000ull;

// (value, index) as a key whose unsigned order is (value, index)'s order;
// -0 keys as +0, since torch.min counts them equal.
__device__ __forceinline__ unsigned long long min_key(float v, int k) {
    unsigned u = __float_as_uint(v == 0.0f ? 0.0f : v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((unsigned long long)u << 32) | (unsigned)k;
}

// The value half of a key: the float that was keyed (+0 for -0).
__device__ __forceinline__ float key_value(unsigned long long key) {
    unsigned u = (unsigned)(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
    return __uint_as_float(u);
}

// Thread 0's ticket after the block barrier: true in the last of `blocks`
// blocks to draw one (a batched launch keeps a ticket a lane, drawn by the
// lane's blocks).  Release orders the block's writes before it, acquire
// the last block's reads after it.  The caller resets the ticket to 0.
__device__ __forceinline__ bool draw_ticket(unsigned long long* ticket, unsigned blocks) {
    cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> t(*ticket);
    return t.fetch_add(1ull, cuda::memory_order_acq_rel) == blocks - 1;
}

// The ticket of a launch whose whole grid draws one.
__device__ __forceinline__ bool draw_ticket(unsigned long long* ticket) {
    return draw_ticket(ticket, gridDim.x);
}
