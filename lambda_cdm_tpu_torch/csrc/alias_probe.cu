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
//   sequential  one thread a column reads row 0 once, carries the value in
//               a register and writes x0 + 1, (x0 + 1) + 1, ... to rows 0,
//               1, ...: the float additions of Gauss-Seidel order, in that
//               order, so the buffer equals the plain version's bit for
//               bit, with no barrier and no dependent global read (the
//               parent walked the rows in one block, a __syncthreads and a
//               global read of the row before each row).
// Bound: the buffer is 4 KB read and 4 KB written at [8, 128], so a launch
// is bound by its latency, not by bytes or operations. launch_floor is the
// floor it is timed against, at K10's two launch shapes (rows x 128
// threads, and 1 x 128): an empty kernel, or (given a buffer) one that
// adds 1 to one float a thread, one read and one dependent write.

#include <cuda_runtime.h>

namespace {

__global__ void alias_probe_blocks(float* x, int cols) {
  const int i = blockIdx.x;
  const int src = i > 0 ? i - 1 : 0;
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    x[(long long)i * cols + c] = x[(long long)src * cols + c] + 1.0f;
}

__global__ void alias_probe_sequential(float* x, int rows, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float v = x[c];
  for (int i = 0; i < rows; ++i) {
    v += 1.0f;                           // row max(i - 1, 0) + 1
    x[(long long)i * cols + c] = v;
  }
}

__global__ void launch_floor(float* x) {
  if (x) x[blockIdx.x * blockDim.x + threadIdx.x] += 1.0f;
}

}  // namespace

extern "C" int lcdm_alias_probe(float* x, int rows, int cols, int sequential,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int threads = cols < 128 ? (cols > 0 ? cols : 1) : 128;
  if (rows > 0 && cols > 0) {
    if (sequential)
      alias_probe_sequential<<<(cols + threads - 1) / threads, threads, 0,
                               s>>>(x, rows, cols);
    else
      alias_probe_blocks<<<rows, threads, 0, s>>>(x, cols);
  }
  return (int)cudaGetLastError();
}

// the floor kernel at a launch shape (blocks x threads); x: null (empty)
// or a buffer of blocks * threads floats
extern "C" int lcdm_launch_floor(float* x, int blocks, int threads,
                                 void* stream) {
  launch_floor<<<blocks, threads, 0, (cudaStream_t)stream>>>(x);
  return (int)cudaGetLastError();
}
