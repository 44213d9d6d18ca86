// A kernel that does nothing, for timing the launch floor of a kernel's
// grids.  Launched with the blocks, threads and dynamic shared memory of the
// grids it stands for, it costs what their launch and block scheduling cost
// and nothing of their work.  chip_smoke.py builds it beside the port's
// kernels and times it at the chunkwise mLSTM's two passes; the port never
// calls it.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o launch_floor.so launch_floor.cu

#include <cuda_runtime.h>

__global__ void empty_kernel() {}

// n launches back to back on stream: launch i has blocks[i] blocks (a 1-D
// grid) of threads[i] threads with smem[i] bytes of dynamic shared memory.
// Returns the cudaError_t of the first failure (0 on success).
extern "C" int launch_floor(int n, const int* blocks, const int* threads,
                            const int* smem, void* stream) {
  int most = 0;
  for (int i = 0; i < n; ++i) most = smem[i] > most ? smem[i] : most;
  cudaError_t e = cudaFuncSetAttribute(
      empty_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (e != cudaSuccess) return (int)e;
  for (int i = 0; i < n; ++i) {
    empty_kernel<<<blocks[i], threads[i], smem[i],
                   static_cast<cudaStream_t>(stream)>>>();
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}
