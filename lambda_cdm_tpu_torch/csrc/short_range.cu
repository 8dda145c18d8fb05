// K3: TreePM short-range pair accelerations on cell buckets.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_short_range.py
// _short_kernel_v3 (vpu3), _short_kernel_v4b / _short_kernel_v4 (two
// z-cells per 128-lane row, capacity 64) and _short_kernel_v5 (the
// occupancy-windowed form for capacities > 128). Those variants exist for
// the TPU's lane tiling; they compute one function, which this kernel
// computes for any capacity:
//
//   acc_i = sum over the 27 periodic neighbour cells, over their live j,
//           of (m_j c1) max(r^-3 + Q(v), 0) dx,
//   dx = x_j + shift - x_i, r^2 = |dx|^2 + eps^2,
//   v = min(r^2 v_scale - 1, 1), Q the degree-10 even polynomial of
//   _poly_even_coeffs (coefficients passed in, highest first).
//
// The periodic shift (+-box) comes from the neighbour's CELL index
// wrapping, not from min-image on positions: positions drift unwrapped
// between rebuckets. Dead i slots are left at the output's zero fill.
//
// Design: one block per centre cell. Threads take its live i slots
// (looping in blockDim chunks when the cell holds more); each of the 27
// neighbour cells' live j (count, not capacity) is staged through shared
// memory in blockDim tiles with the shift already applied. Work is
// sum_cells ceil(n_i / blockDim) * sum_nbr n_j, so it tracks occupancy,
// not the padded capacity that grow-and-retry raises.
//
// Bound on the H100: float32 pair arithmetic (about 35 FLOP and one
// rsqrt per pair); each staged j is reused by the whole block.

#include <cuda_runtime.h>

namespace {

constexpr int kNumCoeffs = 11;   // degree-10 even polynomial

__global__ void short_range_kernel(const float* __restrict__ bpos,
                                   const float* __restrict__ bmass,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ chq,
                                   float* __restrict__ out,
                                   int nc, int cap, float box, float soft2,
                                   float v_scale, float c1) {
  extern __shared__ float4 tile[];
  const long long nslots = (long long)nc * nc * nc * cap;
  const int c = blockIdx.x;
  const int cx = c / (nc * nc), cy = (c / nc) % nc, cz = c % nc;
  const int ni = counts[c];

  float q[kNumCoeffs];
#pragma unroll
  for (int u = 0; u < kNumCoeffs; ++u) q[u] = chq[u];

  for (int ibase = 0; ibase < ni; ibase += blockDim.x) {
    const int i = ibase + threadIdx.x;
    const bool active = i < ni;
    const long long si = (long long)c * cap + i;
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (active) {
      xi = bpos[si];
      yi = bpos[nslots + si];
      zi = bpos[2 * nslots + si];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;

    for (int nb = 0; nb < 27; ++nb) {
      int nx = cx + nb / 9 - 1;
      int ny = cy + (nb / 3) % 3 - 1;
      int nz = cz + nb % 3 - 1;
      const float sx = nx < 0 ? -box : (nx >= nc ? box : 0.f);
      const float sy = ny < 0 ? -box : (ny >= nc ? box : 0.f);
      const float sz = nz < 0 ? -box : (nz >= nc ? box : 0.f);
      nx = (nx + nc) % nc;
      ny = (ny + nc) % nc;
      nz = (nz + nc) % nc;
      const int cn = (nx * nc + ny) * nc + nz;
      const int nj = counts[cn];

      for (int jbase = 0; jbase < nj; jbase += blockDim.x) {
        const int j = jbase + threadIdx.x;
        __syncthreads();                 // the previous tile is consumed
        if (j < nj) {
          const long long sj = (long long)cn * cap + j;
          tile[threadIdx.x] = make_float4(bpos[sj] + sx,
                                          bpos[nslots + sj] + sy,
                                          bpos[2 * nslots + sj] + sz,
                                          bmass[sj] * c1);
        }
        __syncthreads();
        if (active) {
          const int nt = min((int)blockDim.x, nj - jbase);
          for (int t = 0; t < nt; ++t) {
            const float4 p = tile[t];
            const float dx = p.x - xi;
            const float dy = p.y - yi;
            const float dz = p.z - zi;
            const float r2 = dx * dx + (dy * dy + (dz * dz + soft2));
            const float inv_r = rsqrtf(r2);
            const float v = fminf(r2 * v_scale - 1.0f, 1.0f);
            float qv = q[0];
#pragma unroll
            for (int u = 1; u < kNumCoeffs; ++u) qv = qv * v + q[u];
            const float f = fmaxf(inv_r * inv_r * inv_r + qv, 0.0f);
            const float w = p.w * f;
            ax += w * dx;
            ay += w * dy;
            az += w * dz;
          }
        }
      }
    }
    if (active) {
      out[si] = ax;
      out[nslots + si] = ay;
      out[2 * nslots + si] = az;
    }
  }
}

}  // namespace

extern "C" int lcdm_short_range(const float* bpos, const float* bmass,
                                const int* counts, const float* chq,
                                float* out, int nc, int cap, int threads,
                                float box, float soft2, float v_scale,
                                float c1, void* stream) {
  const int blocks = nc * nc * nc;
  if (blocks > 0) {
    short_range_kernel<<<blocks, threads, threads * sizeof(float4),
                         (cudaStream_t)stream>>>(
        bpos, bmass, counts, chq, out, nc, cap, box, soft2, v_scale, c1);
  }
  return (int)cudaGetLastError();
}
