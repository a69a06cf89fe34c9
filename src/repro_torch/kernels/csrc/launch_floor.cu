// An empty kernel, the launch floor under the port's small kernels.
//
// Not a kernel of any path and not the port of a TPU kernel:
// chip_smoke.py :: times launches it as it launches the readout and k-WTA
// (one C call through ctypes, captured in a CUDA graph, at their blocks
// and threads), so that the time a launch costs with no work stands
// beside those rows. It does not replace their bounds.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One launch of `blocks` blocks of `threads` threads on the stream.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int launch_floor_launch(int blocks, int threads, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
