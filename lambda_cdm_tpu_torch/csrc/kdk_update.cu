// The fast stepper's KDK updates over live slots (ops/kdk_update.py), and
// the stateless solvers' step over [N, 3] rows (the flat kernels, below).
//
// Replaces no TPU kernel: the JAX package's _fast_segment writes the kicks,
// the drift and the force's combine as array expressions that XLA fuses
// into its step. In PyTorch each operation of those expressions was a
// kernel of its own over every slot of the SoA [3, C, K] buckets (33.5M
// slots for 1M particles on the science run's plan: 402 MB a vector), so
// a step streamed the padding a dozen times. These kernels compute only
// the live slots k < counts[c] of the live-first layout:
//
//   open   v = bvel + (acc * h) * kf;  p = bpos + (v * dt) * df
//   kick   x = x + (y * s1) * s2   (the closing half kick: x = vel,
//          y = acc, s1 = h, s2 = kf; the force's combine acc_long + g
//          acc_short: x = acc_long, y = acc_short, s1 = g, s2 = 1, and the
//          product by 1 is exact)
//
// Each product and sum rounds on its own, in the order the plain PyTorch
// chain takes them (__fmul_rn / __fadd_rn: no FMA contraction), with the
// scalars rounded to float32 by the caller as PyTorch rounds a scalar
// operand, so every live slot is bit for bit the plain version's. Dead
// slots are neither read nor written: they keep the 0 they hold (the
// wrapper zeroes the open's new buffers with a memset: at z = 24 on the
// science plan that and the kernel take 0.296 ms, where the kernel also
// writing the dead slots took 0.325; at treepm_1m's 64 slots 0.063
// against 0.048; once a segment).
//
// Bound on the H100: the bytes of the live rows. The open reads 36 B and
// writes 24 B a row (60 MB at 1M rows: 0.018 ms at 3.35 TB/s), the kick
// reads 24 B and writes 12 B (0.011 ms); the open into new buffers also
// zeroes the dead slots, 24 B a dead slot (0.23 ms on the science plan's
// 32.5M dead slots).
//
// Design: blocks of 256 threads, each thread 8 slots 256 apart in a batch
// of 2,048 consecutive slots of the flat [C, K] layout, so a warp's loads
// and stores are whole lines. With K >= 2,048 (the science plan's 8,192)
// a block takes one cell and walks it in batches up to its count: at
// z = 24 one batch a cell of ~256 live rows, and no block for the ~97% of
// slots that are dead (0.042 ms for the open in place; a block a batch of
// the whole layout, 16,384 blocks mostly returning at once, took 0.085,
// against 0.018 of bytes). With smaller K a block takes one batch, several
// cells (treepm_1m's 64 slots: 32 cells a block). A thread loads all 8
// slots' operands before it stores any (the in-place forms alias input
// and output, so the compiler could not hoist a later slot's loads above
// an earlier slot's stores), keeping up to 72 loads in flight.
//
// The flat kernels are the stateless solvers' step (core/engine.py
// _kdk_steps -> physics/integrators.kdk_step_fused) on the SimState's
// [N, 3] positions, velocities and forces, where every value is live: the
// open (the half kick, the drift and the periodic wrap, torch.remainder's
// fmod and sign fix) and the closing half kick into new buffers, in the
// same rounding order as the chain of PyTorch operations they replace
// (ten launches a step; at 2,097,152 rows 0.16 ms of elementwise passes on
// an H100, against 60 + 36 B a row: 0.06 ms at 3.35 TB/s). A thread takes
// 8 values 256 apart.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;                        // slots a thread a batch
constexpr long long kBatch = kThreads * kRows;  // slots a block a batch

// A block's range of the flat [C, K] slots: with cap >= kBatch one cell
// (blockIdx.x), walked in batches up to its count; else the kBatch slots
// from blockIdx.x * kBatch, several cells, one batch.
struct Range {
  long long first, end;
};

__device__ __forceinline__ Range block_range(long long n, int cap,
                                             const int* __restrict__ counts) {
  if (cap >= kBatch) {
    const long long first = (long long)blockIdx.x * cap;
    return {first, first + __ldg(counts + blockIdx.x)};
  }
  const long long first = (long long)blockIdx.x * kBatch;
  return {first, first + kBatch < n ? first + kBatch : n};
}

// this thread's slots of the batch at b (b + threadIdx.x + j kThreads)
// and which of them are live slots of the block's range
__device__ __forceinline__ void thread_slots(long long b, long long end,
                                             int cap,
                                             const int* __restrict__ counts,
                                             long long (&s)[kRows],
                                             bool (&live)[kRows]) {
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    s[j] = b + threadIdx.x + (long long)j * kThreads;
    live[j] = false;
    if (s[j] < end) {
      const long long c = s[j] / cap;
      live[j] = s[j] - c * cap < __ldg(counts + c);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kdk_open_kernel(const float* bpos, const float* bvel, const float* acc,
                const int* __restrict__ counts, float* pos, float* vel,
                long long n, int cap, float h, float kf, float dt,
                float df) {
  const Range r = block_range(n, cap, counts);
  for (long long b = r.first; b < r.end; b += kBatch) {
    long long s[kRows];
    bool live[kRows];
    thread_slots(b, r.end, cap, counts, s, live);
    float p[3][kRows], v[3][kRows], a[3][kRows];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live[j]) {
          const long long i = d * n + s[j];
          p[d][j] = bpos[i];
          v[d][j] = bvel[i];
          a[d][j] = acc[i];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live[j]) {
          const long long i = d * n + s[j];
          const float vj = __fadd_rn(v[d][j],
                                     __fmul_rn(__fmul_rn(a[d][j], h), kf));
          vel[i] = vj;
          pos[i] = __fadd_rn(p[d][j], __fmul_rn(__fmul_rn(vj, dt), df));
        }
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kdk_kick_kernel(float* x, const float* __restrict__ y,
                const int* __restrict__ counts, long long n, int cap,
                float s1, float s2) {
  const Range r = block_range(n, cap, counts);
  for (long long b = r.first; b < r.end; b += kBatch) {
    long long s[kRows];
    bool live[kRows];
    thread_slots(b, r.end, cap, counts, s, live);
    float xv[3][kRows], yv[3][kRows];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live[j]) {
          xv[d][j] = x[d * n + s[j]];
          yv[d][j] = y[d * n + s[j]];
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (live[j])
          x[d * n + s[j]] = __fadd_rn(
              xv[d][j], __fmul_rn(__fmul_rn(yv[d][j], s1), s2));
      }
    }
  }
}

// The stateless solvers' step (physics/integrators.kdk_step_fused) over
// [N, 3] rows, flat: every one of the 3N values is live, kRows a thread
__global__ void __launch_bounds__(kThreads)
kdk_open_flat_kernel(const float* __restrict__ p, const float* __restrict__ v,
                     const float* __restrict__ a, float* __restrict__ pos,
                     float* __restrict__ vel, long long n, float h, float kf,
                     float dt, float df, float box, int wrap) {
  const long long first = (long long)blockIdx.x * kThreads * kRows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long i = first + threadIdx.x + (long long)j * kThreads;
    if (i < n) {
      const float vi = __fadd_rn(v[i], __fmul_rn(__fmul_rn(a[i], h), kf));
      float pi = __fadd_rn(p[i], __fmul_rn(__fmul_rn(vi, dt), df));
      if (wrap) {
        // torch.remainder's floor-mod: fmod, then the divisor's sign
        const float m = fmodf(pi, box);
        pi = (m != 0.0f && ((box < 0.0f) != (m < 0.0f))) ? __fadd_rn(m, box)
                                                         : m;
      }
      vel[i] = vi;
      pos[i] = pi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
kdk_kick_flat_kernel(const float* __restrict__ x, const float* __restrict__ y,
                     float* __restrict__ out, long long n, float s1,
                     float s2) {
  const long long first = (long long)blockIdx.x * kThreads * kRows;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long i = first + threadIdx.x + (long long)j * kThreads;
    if (i < n) out[i] = __fadd_rn(x[i], __fmul_rn(__fmul_rn(y[i], s1), s2));
  }
}

unsigned int blocks_for(int cells, int cap) {
  if (cap >= kBatch) return (unsigned int)cells;
  return (unsigned int)(((long long)cells * cap + kBatch - 1) / kBatch);
}

}  // namespace

// pos, vel: zeroed new buffers, or bpos and bvel themselves (in place);
// every vector SoA [3, cells, cap]
extern "C" int lcdm_kdk_open(const float* bpos, const float* bvel,
                             const float* acc, const int* counts, float* pos,
                             float* vel, int cells, int cap, float h,
                             float kf, float dt, float df, void* stream) {
  if (cells < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)cells * cap;
  if (n > 0)
    kdk_open_kernel<<<blocks_for(cells, cap), kThreads, 0,
                      (cudaStream_t)stream>>>(bpos, bvel, acc, counts, pos,
                                              vel, n, cap, h, kf, dt, df);
  return (int)cudaGetLastError();
}

// x += (y * s1) * s2 on the live slots, in place
extern "C" int lcdm_kdk_kick(float* x, const float* y, const int* counts,
                             int cells, int cap, float s1, float s2,
                             void* stream) {
  if (cells < 0 || cap < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)cells * cap;
  if (n > 0)
    kdk_kick_kernel<<<blocks_for(cells, cap), kThreads, 0,
                      (cudaStream_t)stream>>>(
        x, y, counts, n, cap, s1, s2);
  return (int)cudaGetLastError();
}

// the stateless step's opening half kick and drift (with the periodic
// wrap into [0, box) when `wrap`) over n = 3N flat values: new pos, vel
extern "C" int lcdm_kdk_open_flat(const float* p, const float* v,
                                  const float* a, float* pos, float* vel,
                                  long long n, float h, float kf, float dt,
                                  float df, float box, int wrap,
                                  void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    kdk_open_flat_kernel<<<(unsigned int)((n + kBatch - 1) / kBatch),
                           kThreads, 0, (cudaStream_t)stream>>>(
        p, v, a, pos, vel, n, h, kf, dt, df, box, wrap);
  return (int)cudaGetLastError();
}

// out = x + (y * s1) * s2 over n flat values (the closing half kick)
extern "C" int lcdm_kdk_kick_flat(const float* x, const float* y, float* out,
                                  long long n, float s1, float s2,
                                  void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n > 0)
    kdk_kick_flat_kernel<<<(unsigned int)((n + kBatch - 1) / kBatch),
                           kThreads, 0, (cudaStream_t)stream>>>(
        x, y, out, n, s1, s2);
  return (int)cudaGetLastError();
}
