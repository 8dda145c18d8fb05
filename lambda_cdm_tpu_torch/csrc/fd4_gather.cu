// K2: fused CIC x fd4 force gather from the potential grid.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_pm_rods.py
// _gather_kernel_occ (with counts) and _gather_kernel (without): the TPU
// DMAs a padded potential window per (cx, cy) rod and contracts it with
// fd4-convolved one-hot matrices on its matrix unit. Here one thread per
// live slot reads the potential directly.
//
// acc_a = -sum over the 8 CIC corners g of w_g * D_a phi(g), with the
// 4th-order difference D_a phi(g) = (8 (phi(g+e_a) - phi(g-e_a))
// - (phi(g+2e_a) - phi(g-2e_a))) / 12h and periodic indices; mesh
// coordinates u = x * scale as in K1. Along axis a the two corners share
// one line of 6 mesh points (i0-2 .. i0+3), so each axis costs 4 lines x
// 6 loads. Dead slots and slots whose lower corner left the home block
// window (the deposit's drop rule) get 0.
// The output is SoA [3, C, K]; g_const multiplies outside.
//
// Bound on the H100: 72 scattered 4-byte loads per particle from a
// potential that fits in the 50 MB L2 (28 MB at 192^3); neighbouring
// slots of a cell touch neighbouring mesh points.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}

__global__ void fd4_gather_kernel(const float* __restrict__ phi,
                                  const float* __restrict__ bpos,
                                  const int* __restrict__ counts,
                                  float* __restrict__ out,
                                  int nc, int cap, int ng, int margin,
                                  float scale, float inv_12h) {
  const long long nslots = (long long)nc * nc * nc * cap;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nslots) return;
  const int c = (int)(s / cap);
  const int k = (int)(s - (long long)c * cap);
  if (k >= counts[c]) return;           // output was zero-filled

  const int ppc = ng / nc;
  const int ell = ppc + 2 * (margin + 1);
  const int cell[3] = {c / (nc * nc), (c / nc) % nc, c % nc};

  int i0[3];
  float w[3][2];
  bool ok = true;
  for (int a = 0; a < 3; ++a) {
    // __fmul_rn: u is rounded before the -0.5 (no FMA contraction), as
    // in the plain version, so both find the same corners and weights
    const float u = __fmul_rn(bpos[a * nslots + s], scale);
    const float f0 = floorf(u - 0.5f);
    i0[a] = (int)f0;
    const float fr = (u - 0.5f) - f0;
    w[a][0] = 1.0f - fr;
    w[a][1] = fr;
    const int il = i0[a] - (cell[a] * ppc - (margin + 1));
    ok = ok && il >= 0 && il <= ell - 2;
  }
  if (!ok) return;

  // wrapped mesh indices i0-2 .. i0+3 per axis
  int idx[3][6];
  for (int a = 0; a < 3; ++a)
    for (int j = 0; j < 6; ++j) idx[a][j] = wrap(i0[a] - 2 + j, ng);

  const long long ng2 = (long long)ng * ng;
  float acc[3];
  for (int a = 0; a < 3; ++a) {
    const int b = (a + 1) % 3, e = (a + 2) % 3;   // the two other axes
    const long long stride[3] = {ng2, ng, 1};
    float sum = 0.0f;
    for (int db = 0; db < 2; ++db) {
      for (int de = 0; de < 2; ++de) {
        const long long base = idx[b][2 + db] * stride[b]
                             + idx[e][2 + de] * stride[e];
        float p[6];
        for (int j = 0; j < 6; ++j) p[j] = phi[base + idx[a][j] * stride[a]];
        // p[2] is phi(i0), p[3] is phi(i0+1)
        const float d0 = 8.0f * (p[3] - p[1]) - (p[4] - p[0]);
        const float d1 = 8.0f * (p[4] - p[2]) - (p[5] - p[1]);
        sum += (w[b][db] * w[e][de]) * (w[a][0] * d0 + w[a][1] * d1);
      }
    }
    acc[a] = -sum * inv_12h;
  }
  for (int a = 0; a < 3; ++a) out[a * nslots + s] = acc[a];
}

}  // namespace

extern "C" int lcdm_fd4_gather(const float* phi, const float* bpos,
                               const int* counts, float* out, int nc,
                               int cap, int ng, int margin, float scale,
                               float inv_12h, void* stream) {
  const long long nslots = (long long)nc * nc * nc * cap;
  const int threads = 256;
  const long long blocks = (nslots + threads - 1) / threads;
  if (blocks > 0) {
    fd4_gather_kernel<<<(unsigned)blocks, threads, 0,
                        (cudaStream_t)stream>>>(
        phi, bpos, counts, out, nc, cap, ng, margin, scale, inv_12h);
  }
  return (int)cudaGetLastError();
}
