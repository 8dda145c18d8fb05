// The stateless particle-mesh force's passes over particles and over the
// half spectrum (forces/pm.py pm_accelerations -> ops/pm_cic.py).
//
// Replaces no TPU kernel: the JAX package computes forces/pm.py's
// pm_accelerations in jnp, a CIC scatter-add, rfftn, the spectral gradient
// and three CIC gathers that XLA fuses. In PyTorch each operation of that
// chain was a kernel of its own: the deposit 8 index_add_ passes and each
// of the three gathers 8 indexed reads, every one recomputing the int64
// cell indices and the weights (~500 launches a step at 2,097,152
// particles on 256^3, 40% of an H100's time in index arithmetic). These
// kernels compute a particle's stencil once, in registers:
//
//   scatter   grid[c] += ((m * w_x) * w_y) * w_z over the 8 corners c
//   gradient  out = -i k_axis (G rho_k): re = k (G im), im = -(k (G re))
//   gather3   acc_d = scale * sum_c f_d[c] ((w_x * w_y) * w_z), d = x, y, z
//
// The stencil is analysis/power_spectrum.cic_deposit's and
// forces/pm.cic_gather's, cell-centred: u = (x / box) * ng, i0 =
// floor(u - 1/2), frac = (u - 1/2) - i0, the corners i0 and i0 + 1 wrapped
// into [0, ng) with weights 1 - frac and frac. Every product, sum and the
// division round on their own in the plain chain's order (__fdiv_rn,
// __fmul_rn, __fadd_rn: no FMA contraction), so a scatter term, a gradient
// value and a gather sum equal the plain version's; only the scatter's
// float atomics add a grid point's terms in another order (a few ulps of
// the point's sum, changing from run to run).
//
// Bound on the H100, by bytes: the scatter reads 16 B a particle and
// writes the ng^3 float32 grid (34 MB + 67 MB at 2M particles on 256^3:
// 0.030 ms at 3.35 TB/s), the gather reads three fields and 12 B a
// particle and writes 12 B (201 MB + 50 MB: 0.075 ms), a gradient pass
// reads rho_k and G and writes one half spectrum (67.6 + 33.8 + 67.6 MB:
// 0.050 ms). The particle passes are in fact bound by scattered traffic:
// the particles come in no spatial order, so each of the 8 corners is an
// atomic (scatter) or a 32-byte sector (gather) somewhere in a grid larger
// than the 50 MB L2. A z-pair of corners shares a sector but for the wrap.
//
// Design: one thread a particle (blocks of 256), its three axes' indices
// and weights in registers, no shared memory. The scatter's adds are
// fire-and-forget reductions (atomicAdd with its result unused compiles to
// RED). The gather loads all 24 values before the sums, in the plain
// chain's corner order, so a thread keeps 24 loads in flight. The gradient
// is one thread a complex value, walking the half spectrum in the memory
// order torch.fft.rfftn leaves it in on the card (a permutation of
// [ng, ng, nh], the last axis slowest), with G laid out alike
// (forces/pm.py _spectral): every access is coalesced, and the cuFFT passes
// of the c2r read the gradient without a copy. Its k comes from the 1-D
// wavevector of its axis.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// one axis of the stencil: the two wrapped indices and their weights
struct Axis {
  int i[2];
  float w[2];
};

__device__ __forceinline__ int wrap(int i, int ng) {
  const int r = i % ng;
  return r < 0 ? r + ng : r;
}

__device__ __forceinline__ Axis axis(float x, float box, int ng) {
  const float u = __fmul_rn(__fdiv_rn(x, box), (float)ng);
  const float t = __fsub_rn(u, 0.5f);
  const float f = floorf(t);
  const float frac = __fsub_rn(t, f);
  const int i0 = (int)f;
  Axis a;
  a.i[0] = wrap(i0, ng);
  a.i[1] = wrap(i0 + 1, ng);
  a.w[0] = __fsub_rn(1.0f, frac);
  a.w[1] = frac;
  return a;
}

__device__ __forceinline__ void stencil(const float* __restrict__ pos,
                                        long long p, float box, int ng,
                                        Axis (&ax)[3]) {
#pragma unroll
  for (int d = 0; d < 3; ++d) ax[d] = axis(__ldg(pos + 3 * p + d), box, ng);
}

__global__ void __launch_bounds__(kThreads)
pm_cic_scatter_kernel(const float* __restrict__ pos,
                      const float* __restrict__ mass, float* grid,
                      long long n, int ng, float box) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  Axis ax[3];
  stencil(pos, p, box, ng, ax);
  const float m = __ldg(mass + p);
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const float mx = __fmul_rn(m, ax[0].w[dx]);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float mxy = __fmul_rn(mx, ax[1].w[dy]);
      const long long row =
          ((long long)ax[0].i[dx] * ng + ax[1].i[dy]) * ng;
#pragma unroll
      for (int dz = 0; dz < 2; ++dz)
        atomicAdd(grid + row + ax[2].i[dz], __fmul_rn(mxy, ax[2].w[dz]));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
pm_cic_gather3_kernel(const float* __restrict__ pos,
                      const float* __restrict__ fx,
                      const float* __restrict__ fy,
                      const float* __restrict__ fz, float* __restrict__ acc,
                      long long n, int ng, float box, float scale) {
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (p >= n) return;
  Axis ax[3];
  stencil(pos, p, box, ng, ax);
  float v[3][8], w[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int dx = c >> 2, dy = (c >> 1) & 1, dz = c & 1;
    const long long idx =
        ((long long)ax[0].i[dx] * ng + ax[1].i[dy]) * ng + ax[2].i[dz];
    w[c] = __fmul_rn(__fmul_rn(ax[0].w[dx], ax[1].w[dy]), ax[2].w[dz]);
    v[0][c] = __ldg(fx + idx);
    v[1][c] = __ldg(fy + idx);
    v[2][c] = __ldg(fz + idx);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    float s = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) s = __fadd_rn(s, __fmul_rn(v[d][c], w[c]));
    acc[3 * p + d] = __fmul_rn(s, scale);
  }
}

__global__ void __launch_bounds__(kThreads)
pm_green_gradient_kernel(const float2* __restrict__ rho,
                         const float* __restrict__ green,
                         const float* __restrict__ k, float2* __restrict__ out,
                         unsigned int total, unsigned int ng, unsigned int nh,
                         unsigned int s0, unsigned int s1, unsigned int s2,
                         int axis_) {
  // e walks the three arrays' shared layout in memory order; in a dense
  // layout the index on an axis of stride s and size m is (e / s) % m
  const unsigned int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= total) return;
  const unsigned int idx = axis_ == 0   ? (e / s0) % ng
                           : axis_ == 1 ? (e / s1) % ng
                                        : (e / s2) % nh;
  const float kv = __ldg(k + idx);
  const float g = __ldg(green + e);
  const float2 c = rho[e];
  const float pr = __fmul_rn(g, c.x), pi = __fmul_rn(g, c.y);
  out[e] = make_float2(__fmul_rn(kv, pi), -__fmul_rn(kv, pr));
}

unsigned int blocks(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// grid [ng^3] (zeroed by the caller) += each particle's CIC terms;
// pos [n, 3], mass [n]
extern "C" int lcdm_pm_cic_scatter(const float* pos, const float* mass,
                                   float* grid, long long n, int ng,
                                   float box, void* stream) {
  if (n < 0 || ng < 1 || blocks(n) > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    pm_cic_scatter_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, mass, grid, n, ng, box);
  return (int)cudaGetLastError();
}

// acc [n, 3] = scale * the three fields [ng^3] CIC-gathered at pos [n, 3]
extern "C" int lcdm_pm_cic_gather3(const float* pos, const float* fx,
                                   const float* fy, const float* fz,
                                   float* acc, long long n, int ng, float box,
                                   float scale, void* stream) {
  if (n < 0 || ng < 1 || blocks(n) > 0x7fffffffu)
    return (int)cudaErrorInvalidValue;
  if (n > 0)
    pm_cic_gather3_kernel<<<blocks(n), kThreads, 0, (cudaStream_t)stream>>>(
        pos, fx, fy, fz, acc, n, ng, box, scale);
  return (int)cudaGetLastError();
}

// out [ng, ng, nh] complex = -i k_axis G rho; rho, green and out share
// one dense layout of element strides s0, s1, s2 (torch.fft.rfftn's on the
// card); k: the axis's 1-D wavevector (ng values for axes 0 and 1, nh for
// axis 2)
extern "C" int lcdm_pm_green_gradient(const void* rho, const float* green,
                                      const float* k, void* out, int ng,
                                      int nh, int s0, int s1, int s2,
                                      int axis, void* stream) {
  const long long total = (long long)ng * ng * nh;
  if (ng < 1 || nh < 1 || axis < 0 || axis > 2 || s0 < 1 || s1 < 1 ||
      s2 < 1 || total > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  pm_green_gradient_kernel<<<blocks(total), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const float2*)rho, green, k, (float2*)out, (unsigned int)total,
      (unsigned int)ng, (unsigned int)nh, (unsigned int)s0, (unsigned int)s1,
      (unsigned int)s2, axis);
  return (int)cudaGetLastError();
}
