// K3: TreePM short-range pair accelerations on cell buckets.
//
// Replaces the TPU kernels of lambda_cdm_tpu/ops/pallas_short_range.py:
// _short_kernel_v3 (vpu3), _short_kernel_v4b / _short_kernel_v4 (two
// z-cells per 128-lane row, capacity 64), _short_kernel_v5 (the
// occupancy-windowed form for capacities > 128), _short_kernel_v2 (vpu2),
// _short_kernel (vpu) and _short_kernel_mxu (mxu). Those variants differ
// in lane tilings, which this kernel does not carry over, and in the split
// function, which it takes as a template argument (SPLIT):
//
//   acc_i = sum over the 27 periodic neighbour cells, over their live j,
//           of (m_j mscale) w(r) dx,
//   dx = x_j + shift - x_i, r^2 = |dx|^2 + eps^2, with w
//   kEven      (vpu3/4/4b/5): max(r^-3 + Q(min(r^2 p0 - 1, 1)), 0), Q the
//              degree-10 even polynomial of _poly_even_coeffs, mscale c1;
//   kFactored  (vpu2): (1 - t) h(t) r^-3, t = min(r, p1) p0 - 1, h the
//              degree-11 polynomial of _poly_r_coeffs;
//   kXPoly     (vpu, mxu): where(x < p1, max(S(x), 0), 0) r^-3, x = r p0,
//              S the degree-10 polynomial of forces.treepm._fit_short_poly
//              (the TPU mxu kernel computes this function as a GEMM on
//              centred coordinates, an MXU device not carried over).
// Coefficients are passed in, highest first.
//
// Liveness: every split reads live-first counts (the live slots of cell
// c are 0..counts[c]-1). The TPU vpu, vpu2 and mxu kernels read no
// counts and take any slot order with mass 0 as dead; the wrapper
// (ops/short_range.py) keeps that contract by moving each cell's live
// slots first before the launch when it is given no counts.
//
// The periodic shift (+-box) comes from the neighbour's CELL index
// wrapping, not from min-image on positions: positions drift unwrapped
// between rebuckets. Dead i slots are left at the output's zero fill.
//
// Design: one block per centre cell. Threads take its i slots (looping
// in blockDim chunks when the cell holds more); each of the 27 neighbour
// cells' live j slots is staged through shared memory in blockDim tiles
// with the shift already applied and the mass scaled. The work is
// sum_cells ceil(n_i / blockDim) * sum_nbr n_j, so it tracks occupancy,
// not the padded capacity that grow-and-retry raises.
//
// Bound on the H100: float32 pair arithmetic (about 35-40 FLOP and one
// rsqrt per pair); each staged j is reused by the whole block.

#include <cuda_runtime.h>

namespace {

constexpr int kEven = 0;
constexpr int kFactored = 1;
constexpr int kXPoly = 2;
constexpr int kMaxCoeffs = 12;

template <int SPLIT>
struct Split {
  static constexpr int kNumCoeffs = SPLIT == kFactored ? 12 : 11;
};

// the weight of one pair, without its mass
template <int SPLIT>
__device__ __forceinline__ float pair_weight(float r2, const float* q,
                                             float p0, float p1) {
  constexpr int nq = Split<SPLIT>::kNumCoeffs;
  const float inv_r = rsqrtf(r2);
  const float inv_r3 = inv_r * inv_r * inv_r;
  if (SPLIT == kEven) {
    const float v = fminf(r2 * p0 - 1.0f, 1.0f);
    float qv = q[0];
#pragma unroll
    for (int u = 1; u < nq; ++u) qv = qv * v + q[u];
    return fmaxf(inv_r3 + qv, 0.0f);
  }
  const float r = r2 * inv_r;
  if (SPLIT == kFactored) {
    const float t = fminf(r, p1) * p0 - 1.0f;
    float h = q[0];
#pragma unroll
    for (int u = 1; u < nq; ++u) h = h * t + q[u];
    return ((1.0f - t) * h) * inv_r3;
  }
  // the raw x-space coefficients are ill-conditioned (x^10 terms that
  // cancel), so an ulp of r or of a Horner step moves S: this form rounds
  // r^2 and Horner as the plain version does, without FMA contraction
  // (on the treepm_1m state, H100: 8.6e-5 of the max from the plain
  // version with FMAs, 3.3e-6 without, for +13% kernel time)
  const float x = r * p0;
  float s = q[0];
#pragma unroll
  for (int u = 1; u < nq; ++u) s = __fadd_rn(__fmul_rn(s, x), q[u]);
  s = x < p1 ? fmaxf(s, 0.0f) : 0.0f;
  return s * inv_r3;
}

template <int SPLIT>
__global__ void short_range_kernel(const float* __restrict__ bpos,
                                   const float* __restrict__ bmass,
                                   const int* __restrict__ counts,
                                   const float* __restrict__ coeffs,
                                   float* __restrict__ out,
                                   int nc, int cap, float box, float soft2,
                                   float p0, float p1, float mscale) {
  extern __shared__ float4 tile[];
  constexpr int nq = Split<SPLIT>::kNumCoeffs;
  const long long nslots = (long long)nc * nc * nc * cap;
  const int c = blockIdx.x;
  const int cx = c / (nc * nc), cy = (c / nc) % nc, cz = c % nc;
  const int ni = counts[c];

  float q[kMaxCoeffs];
#pragma unroll
  for (int u = 0; u < nq; ++u) q[u] = coeffs[u];

  for (int ibase = 0; ibase < ni; ibase += blockDim.x) {
    const int i = ibase + threadIdx.x;
    const long long si = (long long)c * cap + i;
    const bool active = i < ni;
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
                                          bmass[sj] * mscale);
        }
        __syncthreads();
        if (active) {
          const int nt = min((int)blockDim.x, nj - jbase);
          for (int t = 0; t < nt; ++t) {
            const float4 p = tile[t];
            const float dx = p.x - xi;
            const float dy = p.y - yi;
            const float dz = p.z - zi;
            // the x-space split amplifies an ulp of r: round r^2 as the
            // plain version does (no FMA contraction) for it
            const float r2 =
                SPLIT == kXPoly
                    ? __fadd_rn(__fmul_rn(dx, dx),
                                __fadd_rn(__fmul_rn(dy, dy),
                                          __fadd_rn(__fmul_rn(dz, dz),
                                                    soft2)))
                    : dx * dx + (dy * dy + (dz * dz + soft2));
            const float w = p.w * pair_weight<SPLIT>(r2, q, p0, p1);
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

template <int SPLIT>
void launch(const float* bpos, const float* bmass, const int* counts,
            const float* coeffs, float* out, int nc, int cap, int threads,
            float box, float soft2, float p0, float p1, float mscale,
            cudaStream_t stream) {
  short_range_kernel<SPLIT>
      <<<nc * nc * nc, threads, threads * sizeof(float4), stream>>>(
          bpos, bmass, counts, coeffs, out, nc, cap, box, soft2, p0, p1,
          mscale);
}

}  // namespace

// split: 0 even, 1 factored, 2 x-polynomial; counts: live-first
// occupancies for every split
extern "C" int lcdm_short_range(const float* bpos, const float* bmass,
                                const int* counts, const float* coeffs,
                                float* out, int nc, int cap, int threads,
                                int split, float box, float soft2, float p0,
                                float p1, float mscale, void* stream) {
  if (nc <= 0 || cap <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (split == kEven) {
    launch<kEven>(bpos, bmass, counts, coeffs, out, nc, cap, threads, box,
                  soft2, p0, p1, mscale, s);
  } else if (split == kFactored) {
    launch<kFactored>(bpos, bmass, counts, coeffs, out, nc, cap, threads,
                      box, soft2, p0, p1, mscale, s);
  } else if (split == kXPoly) {
    launch<kXPoly>(bpos, bmass, counts, coeffs, out, nc, cap, threads, box,
                   soft2, p0, p1, mscale, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
