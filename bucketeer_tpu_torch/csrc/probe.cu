// Capability probe for Hopper (sm_90a): y = x + 1 over n int32 values.
//
// Replaces the TPU kernel _run_probe's pallas_call
// (bucketeer_tpu/codec/pallas/support.py:47, call at :56), which checks
// once per process that the backend can compile and run a kernel at all.
// Here the check proves that nvcc built code for this card's
// architecture, that the CUDA runtime loads it, and that a launch
// computes the right answer; kernels/support.py raises if any of that
// fails.
//
// What bounds it: launch latency; 8 values move 64 bytes. Nothing to
// design for: one thread per value.
//
// Plain C interface, bound with ctypes; the launch goes on the caller's
// stream and allocates nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const int32_t* __restrict__ x,
                             int32_t* __restrict__ y, int n) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] + 1;
}

}  // namespace

extern "C" int probe_launch(const void* x, int n, void* y, void* stream) {
    if (n <= 0) return 0;
    probe_kernel<<<(n + 127) / 128, 128, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(x), static_cast<int32_t*>(y), n);
    return static_cast<int>(cudaGetLastError());
}
