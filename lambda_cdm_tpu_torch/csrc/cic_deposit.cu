// K1: CIC mass deposit of cell-bucketed particles onto the periodic PM mesh.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_pm_rods.py
// _deposit_kernel_occ (with counts) and _deposit_kernel (without), plus
// their assemble_rods x/y ghost fold: the TPU builds one-hot factor
// matrices per (cx, cy) rod and deposits with a matrix-unit GEMM into
// rod blocks that XLA folds afterwards. Here one thread per live slot
// does the 8 CIC corner atomicAdds straight into the global grid, so
// there are no rod blocks and no fold.
//
// Same function as the TPU kernel and the CPU reference
// (lambda_cdm_tpu/ops/bucketed_pm._cic_factors): u = x * scale with
// scale = ng / box rounded once to float32 (as the TPU kernel computes it),
// i0 = floor(u - 0.5), frac = u - 0.5 - i0; a live particle whose lower
// corner leaves its home cell's block window (origin c*ppc - (margin+1),
// 0 <= il <= ell - 2 on every axis) deposits nothing and counts one drop.
// Positions drift unwrapped between rebuckets, so corner indices can be
// -1 or ng and wrap periodically.
//
// Bound on the H100: the 8 float atomics per particle into a 28 MB grid
// (192^3) that stays in the 50 MB L2; particles of one cell are adjacent
// slots, so a warp's atomics hit a few neighbouring mesh cells.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int wrap(int i, int n) {
  return ((i % n) + n) % n;
}

__global__ void cic_deposit_kernel(const float* __restrict__ bpos,
                                   const float* __restrict__ bmass,
                                   const int* __restrict__ counts,
                                   float* __restrict__ grid,
                                   int* __restrict__ dropped,
                                   int nc, int cap, int ng, int margin,
                                   float scale) {
  const long long nslots = (long long)nc * nc * nc * cap;
  const long long s = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= nslots) return;
  const int c = (int)(s / cap);
  const int k = (int)(s - (long long)c * cap);
  if (k >= counts[c]) return;           // live-first: dead padding

  const int ppc = ng / nc;
  const int ell = ppc + 2 * (margin + 1);
  const int cell[3] = {c / (nc * nc), (c / nc) % nc, c % nc};

  int i0[3];
  float fr[3];
  bool ok = true;
  for (int a = 0; a < 3; ++a) {
    // __fmul_rn: u is rounded before the -0.5 (no FMA contraction), as
    // in the plain version, so both find the same corners and weights
    const float u = __fmul_rn(bpos[a * nslots + s], scale);
    const float f0 = floorf(u - 0.5f);
    i0[a] = (int)f0;
    fr[a] = (u - 0.5f) - f0;
    const int il = i0[a] - (cell[a] * ppc - (margin + 1));
    ok = ok && il >= 0 && il <= ell - 2;
  }
  if (!ok) {
    atomicAdd(dropped, 1);
    return;
  }
  const float m = bmass[s];
  for (int dx = 0; dx < 2; ++dx) {
    const float wx = dx ? fr[0] : 1.0f - fr[0];
    const long long ix = wrap(i0[0] + dx, ng);
    for (int dy = 0; dy < 2; ++dy) {
      const float wxy = wx * (dy ? fr[1] : 1.0f - fr[1]);
      const long long iy = wrap(i0[1] + dy, ng);
      for (int dz = 0; dz < 2; ++dz) {
        const float wz = dz ? fr[2] : 1.0f - fr[2];
        const long long iz = wrap(i0[2] + dz, ng);
        atomicAdd(&grid[(ix * ng + iy) * ng + iz], wxy * (wz * m));
      }
    }
  }
}

}  // namespace

extern "C" int lcdm_cic_deposit(const float* bpos, const float* bmass,
                                const int* counts, float* grid,
                                int* dropped, int nc, int cap, int ng,
                                int margin, float scale, void* stream) {
  const long long nslots = (long long)nc * nc * nc * cap;
  const int threads = 256;
  const long long blocks = (nslots + threads - 1) / threads;
  if (blocks > 0) {
    cic_deposit_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(
        bpos, bmass, counts, grid, dropped, nc, cap, ng, margin, scale);
  }
  return (int)cudaGetLastError();
}
