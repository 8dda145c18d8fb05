// K10: the aliased in-place row probe.
//
// Replaces the TPU kernel `kern` of benchmarks/probe_alias.py (the
// pallas_call at :26): a sequential ("arbitrary") grid of `rows` programs
// over one [rows, cols] float32 buffer aliased from input to output;
// program i copies row max(i - 1, 0), adds 1 and writes the result to row
// i. Column 0 then shows whether a later program sees an earlier one's
// write through the alias: Gauss-Seidel order gives 1, 2, ..., rows from
// zeros, a snapshot gives all ones. No physics: it asks the ordering
// question behind K5's FoF sweep (csrc/fof_hook.cu), which is a Jacobi
// sweep because of its answer.
//
// Two modes, both in place:
//   blocks      one block a row. CUDA leaves the order of blocks, and
//               whether block i sees block i - 1's write, undefined: the
//               card's answer is what this mode reports;
//   sequential  one block walks the rows in turn (a __syncthreads between
//               rows), which must give 1, 2, ..., rows.
// Bound: the buffer is 4 KB read and 4 KB written at [8, 128], so a launch
// is bound by its latency, not by bytes or operations.

#include <cuda_runtime.h>

namespace {

__global__ void alias_probe_blocks(float* x, int cols) {
  const int i = blockIdx.x;
  const int src = i > 0 ? i - 1 : 0;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    x[(long long)i * cols + c] = x[(long long)src * cols + c] + 1.0f;
}

__global__ void alias_probe_sequential(float* x, int rows, int cols) {
  for (int i = 0; i < rows; ++i) {
    const int src = i > 0 ? i - 1 : 0;
    for (int c = threadIdx.x; c < cols; c += blockDim.x)
      x[(long long)i * cols + c] = x[(long long)src * cols + c] + 1.0f;
    __syncthreads();                     // row i is written before i + 1
  }
}

}  // namespace

extern "C" int lcdm_alias_probe(float* x, int rows, int cols, int sequential,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = cols < 128 ? (cols > 0 ? cols : 1) : 128;
  if (rows > 0) {
    if (sequential)
      alias_probe_sequential<<<1, threads, 0, s>>>(x, rows, cols);
    else
      alias_probe_blocks<<<rows, threads, 0, s>>>(x, cols);
  }
  return (int)cudaGetLastError();
}
