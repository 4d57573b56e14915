// What the batch forms of kernels B2 and B3 (lw_merge_batch.cu,
// lazy_merge_batch.cu) share: a lane owned by one block or by a thread-block
// cluster of up to kMaxCluster blocks, and a launch that may take more than
// the default 48 KiB of dynamic shared memory.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCluster = 8;     // the portable cluster size

// Allow a bulk-copy kernel its buffers (above the 48 KiB default, with the
// most of the SM's memory as shared memory, so that two blocks fit); outside
// a stream capture, since the loader calls this before one.
cudaError_t allow_shared(const void* fn, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    const cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
}

}  // namespace
