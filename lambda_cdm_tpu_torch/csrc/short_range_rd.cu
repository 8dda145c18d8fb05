// K8: the rod-dense TreePM short-range pair sum.
//
// Replaces the TPU kernel lambda_cdm_tpu/ops/pallas_short_range_rd.py
// _rd_kernel (via pallas_short_range_rd). Particles sit in ncell^2 rods
// (one per (cx, cy) cell column) of k_rod slots, z-sorted and live-first;
// pts [R, k_rod] float4 holds (x, y, z, m c1). Rod r's 16-row chunk t has
// 27 window-table entries, tables[(r * nch + t) * 27 + e],
//   entry = start_tile * 1024 + ntiles * 4 + zsel,
// for neighbour rod e / 3 (the (dx, dy) offsets in x-major order) and
// segment e % 3; it covers slots [start_tile * 128, (start_tile +
// ntiles) * 128) of that rod, with the j z shifted by +box (zsel 1) or
// -box (zsel 2). For each live slot i of chunk t:
//
//   acc_i = sum over the 27 entries, over the covered j, of
//           (m_j c1) max(r^-3 + Q(min(r^2 v_scale - 1, 1)), 0) dx,
//   dx = (x_j + shift) - x_i, the x/y shift from the neighbour rod's index
//   wrapping, the z shift folded into the i side as the TPU kernel does
//   (dz = z_j - (z_i + zshift)), Q the degree-10 even polynomial of
//   short_range._poly_even_coeffs (coefficients passed in, highest
//   first). Dead i slots are left at the output's zero fill.
//
// Design: one warp per chunk, four chunks a block of 128 threads, grid
// (R, ceil(nch / 4)); a warp whose chunk holds no live slot returns at
// once. Lane l takes row l % 16 of the chunk and every second covered j
// (l / 16 picks the parity), so the two half-warps split each entry's
// range and the warp's control flow is uniform (all lanes read the same
// table entry). j is read as one 16-byte __ldg per pair, broadcast to the
// 16 lanes of a half-warp and reused from L1/L2 by the rod's other chunks;
// one shuffle sums the two halves at the end.
//
// Bound on the H100: float32 pair arithmetic (about 35-40 FLOP and one
// rsqrt per pair), ~2,250 pair tests a live particle at the 1M bench
// geometry (ncell 24, k_rod 3072).

#include <cuda_runtime.h>

namespace {

constexpr int kCh = 16;          // i rows a chunk
constexpr int kEnt = 27;         // table entries a chunk
constexpr int kNumCoeffs = 11;   // degree-10 even polynomial
constexpr int kWarps = 4;        // chunks a block

__global__ void short_range_rd_kernel(const float4* __restrict__ pts,
                                      const int* __restrict__ counts,
                                      const int* __restrict__ tables,
                                      const float* __restrict__ coeffs,
                                      float* __restrict__ out, int nc,
                                      int k_rod, float box, float soft2,
                                      float v_scale) {
  const int r = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nch = k_rod / kCh;
  const int t = blockIdx.y * kWarps + warp;
  const int cnt = counts[r];
  if (t >= nch || t * kCh >= cnt) return;          // uniform a warp

  float q[kNumCoeffs];
#pragma unroll
  for (int u = 0; u < kNumCoeffs; ++u) q[u] = coeffs[u];

  const int i = t * kCh + (lane % kCh);
  const int half = lane / kCh;
  const bool active = i < cnt;
  const float4 pi = pts[(long long)r * k_rod + i];
  const int cx = r / nc, cy = r % nc;
  const int* ent_row = tables + ((long long)r * nch + t) * kEnt;
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int e = 0; e < kEnt; ++e) {
    const int ent = ent_row[e];
    const int zsel = ent % 4;
    const int ntiles = (ent / 4) % 256;
    const int st = ent / 1024;
    if (ntiles == 0) continue;
    const int nb = e / 3;
    const int rx = cx + nb / 3 - 1, ry = cy + nb % 3 - 1;
    const float sx = rx < 0 ? -box : (rx >= nc ? box : 0.f);
    const float sy = ry < 0 ? -box : (ry >= nc ? box : 0.f);
    const float izs = pi.z + (zsel == 1 ? -box : (zsel == 2 ? box : 0.f));
    const int nbr = ((rx + nc) % nc) * nc + (ry + nc) % nc;
    const float4* rod = pts + (long long)nbr * k_rod;
    const int j_end = (st + ntiles) * 128;
    for (int j = st * 128 + half; j < j_end; j += 2) {
      const float4 p = __ldg(rod + j);
      const float dx = (p.x + sx) - pi.x;
      const float dy = (p.y + sy) - pi.y;
      const float dz = p.z - izs;
      const float r2 = dx * dx + (dy * dy + (dz * dz + soft2));
      const float inv_r = rsqrtf(r2);
      const float v = fminf(r2 * v_scale - 1.0f, 1.0f);
      float qv = q[0];
#pragma unroll
      for (int u = 1; u < kNumCoeffs; ++u) qv = qv * v + q[u];
      const float w = p.w * fmaxf(inv_r * inv_r * inv_r + qv, 0.0f);
      ax += w * dx;
      ay += w * dy;
      az += w * dz;
    }
  }
  ax += __shfl_xor_sync(0xffffffffu, ax, kCh);
  ay += __shfl_xor_sync(0xffffffffu, ay, kCh);
  az += __shfl_xor_sync(0xffffffffu, az, kCh);
  if (active && half == 0) {
    float* o = out + ((long long)r * k_rod + i) * 3;
    o[0] = ax;
    o[1] = ay;
    o[2] = az;
  }
}

}  // namespace

extern "C" int lcdm_short_range_rd(const float* pts, const int* counts,
                                   const int* tables, const float* coeffs,
                                   float* out, int nc, int k_rod, float box,
                                   float soft2, float v_scale,
                                   void* stream) {
  const int nch = k_rod / kCh;
  if (nc > 0 && nch > 0) {
    const dim3 grid(nc * nc, (nch + kWarps - 1) / kWarps);
    short_range_rd_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(pts), counts, tables, coeffs, out,
        nc, k_rod, box, soft2, v_scale);
  }
  return (int)cudaGetLastError();
}
