// What the batch forms of kernels B1, B2 and B3 (argmin_batch.cu,
// lw_merge_batch.cu, lazy_merge_batch.cu) share: a lane owned by one block
// or by a thread-block cluster of up to kMaxCluster blocks, and a launch
// that may take more than the default 48 KiB of dynamic shared memory.
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

// Launch `fn`, whose one parameter is `arg`, on `grid` blocks of `threads`
// with `smem` bytes of dynamic shared memory, `cluster` blocks to a cluster
// (none when 1).  Outside a stream capture the kernel is allowed its shared
// memory first; inside one the loader has done so before the capture.
template <class Arg>
cudaError_t launch_lanes(const void* fn, const Arg& arg, unsigned grid, int threads, int cluster,
                         size_t smem, cudaStream_t stream) {
    cudaStreamCaptureStatus capturing = cudaStreamCaptureStatusNone;
    if (cudaStreamIsCapturing(stream, &capturing) != cudaSuccess) {
        (void)cudaGetLastError();   // unknown: leave the attribute to the loader
        capturing = cudaStreamCaptureStatusActive;
    }
    if (capturing == cudaStreamCaptureStatusNone) {
        const cudaError_t err = allow_shared(fn, smem);
        if (err != cudaSuccess) return err;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(grid);
    cfg.blockDim = dim3((unsigned)threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1] = {};
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = cluster > 1 ? 1 : 0;
    void* args[] = {const_cast<Arg*>(&arg)};
    return cudaLaunchKernelExC(&cfg, fn, args);
}

}  // namespace
