// An empty kernel: what one launch costs on the card, the floor under
// every kernel whose work bound is smaller.  The port's paths never launch
// it; chip_smoke.py's phase 5 times it as it times every kernel (CUDA
// events over CUDA-graph replays) and prints it beside them.

#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// One block of one warp on `stream`; returns the launch's error code.
extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
