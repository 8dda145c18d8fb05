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
// Bound on the H100: float32 pair arithmetic (44 FLOP a covered pair test,
// one rsqrt), ~2,250 tests a live particle at the 1M bench geometry (ncell
// 24, k_rod 3072). A pair issues about 29 instructions (24 FADD / FMUL /
// FFMA, two FMNMX, the MUFU, one shared load), so the issue rate, not the
// bytes, is the limit: ~2.0 ms at 1.98 GHz for those pairs, against the
// bound's 1.46 (which counts an FMA as two operations).
//
// Design.
// - Work items: a group of kGroup = 8 consecutive 16-row chunks of one rod
//   (a warp each), only groups with a live row. A one-block plan kernel lists them
//   on the card (no host sync), the full groups first, then the partial
//   ones by live rows, most first; persistent blocks (as many as stay
//   resident) take them in that order through an atomic counter. The
//   items' order decides no sum.
// - The rows are z-sorted, so the group's chunks cover almost the same
//   tiles of each neighbour rod. A warp loads its chunk's 27 entries in
//   one coalesced load (lane e entry e) and a ballot keeps the non-empty
//   ones, so an empty segment costs a lane nothing; the block takes the
//   union of the group's tile ranges per entry and stages those tiles in
//   shared memory with 16-byte cp.async copies, kStageTiles = 32 at a time
//   (a pass; a larger union, clustered data, streams through in passes).
//   The passes split the union's list of tiles, entry by entry, so no
//   stage size changes the order of a sum.
// - One buffer: while a block waits for its copies, the SM's two other
//   blocks sum. Two 16-tile buffers, the next pass copied while one is
//   summed, read 2.88-2.90 ms at row 13 against 2.80-2.82 (kernel_ab.py,
//   PERF.md): the union then takes two passes, two more barriers a group.
// - Each warp still sums exactly its own chunk's coverage, entry by
//   entry, tile by tile: lane l takes row l % 16 and the j of parity l /
//   16; it carries kIlp = 4 partial sums, partial u taking the j = l / 16
//   + 2u (mod 8), so four pairs are in flight a lane. The partials are
//   added in order (((p0 + p1) + p2) + p3), then the two half-warps by one
//   shuffle. No atomics touch a sum: two calls give equal bytes.
// - At row 13's geometry (H100, 700 W) groups of 8 chunks with 4 partial
//   sums read 2.82 ms (kernel_ab.py, PERF.md), 2 partial sums 2.99 and
//   groups of 4 chunks 3.28: three blocks an SM of four warps each.
// - The j positions are read from shared memory as one 16-byte broadcast
//   load a pair; an entry whose neighbour rod wraps in x or y adds the
//   shift to x_j as the plain version does (a separate loop, so the
//   others pay nothing for it). The coefficients sit in the constant bank
//   (__grid_constant__), where an FFMA reads them as operands.

#include <cuda_runtime.h>

namespace {

constexpr int kCh = 16;          // i rows a chunk
constexpr int kEnt = 27;         // table entries a chunk
constexpr int kTile = 128;       // j slots a table tile
constexpr int kNumCoeffs = 11;   // degree-10 even polynomial
constexpr int kMaxCoeffs = 12;   // the host array's length
constexpr int kGroup = 8;        // chunks a work item (a warp each)
constexpr int kIlp = 4;          // partial sums a lane
constexpr int kPlanHeader = 2;   // plan: [items, work counter, items...]
constexpr int kPlanThreads = 1024;
constexpr int kStageTiles = 32;  // tiles staged at a time (2 KB each)
constexpr int kStageBytes = kStageTiles * kTile * sizeof(float4);
constexpr int kNoTile = 1 << 24;  // above every tile index

struct Coeffs {
  float q[kMaxCoeffs];
};

// the plan: plan[0] items, plan[1] the work counter (0), then the items
// (r * (nch / kGroup) + g) of every group with a live row, the full groups
// first, then the partial ones by live rows, most first (within a class
// in no fixed order)
__global__ void __launch_bounds__(kPlanThreads)
rd_plan_kernel(const int* __restrict__ counts, int nrods, int k_rod,
               int* __restrict__ plan) {
  constexpr int rows = kGroup * kCh;
  __shared__ int hist[rows + 1];
  __shared__ int cursor[rows + 1];
  const int gpr = k_rod / rows;
  for (int b = threadIdx.x; b <= rows; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  for (int r = threadIdx.x; r < nrods; r += blockDim.x) {
    const int c = min(counts[r], k_rod);
    if (c / rows) atomicAdd(&hist[rows], c / rows);
    if (c % rows) atomicAdd(&hist[c % rows], 1);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int b = rows; b > 0; --b) {
      cursor[b] = run;
      run += hist[b];
    }
    plan[0] = run;
    plan[1] = 0;
  }
  __syncthreads();
  int* items = plan + kPlanHeader;
  for (int r = threadIdx.x; r < nrods; r += blockDim.x) {
    const int c = min(counts[r], k_rod);
    const int q = c / rows;
    if (q) {
      const int p = atomicAdd(&cursor[rows], q);
      for (int g = 0; g < q; ++g) items[p + g] = r * gpr + g;
    }
    if (c % rows) items[atomicAdd(&cursor[c % rows], 1)] = r * gpr + q;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// the pairs of one lane's row against n staged slots from s (n a multiple
// of 128): j = half, half + 2, ...; partial u takes j = half + 2u mod 8
template <bool kShift>
__device__ __forceinline__ void pairs(const float4* __restrict__ s, int n,
                                      int half, float4 pi, float izs,
                                      float sx, float sy, const Coeffs& c,
                                      float soft2, float v_scale,
                                      float (&ax)[kIlp], float (&ay)[kIlp],
                                      float (&az)[kIlp]) {
  for (int j = half; j < n; j += 2 * kIlp) {
#pragma unroll
    for (int u = 0; u < kIlp; ++u) {
      const float4 p = s[j + 2 * u];
      const float dx = kShift ? (p.x + sx) - pi.x : p.x - pi.x;
      const float dy = kShift ? (p.y + sy) - pi.y : p.y - pi.y;
      const float dz = p.z - izs;
      const float r2 = dx * dx + (dy * dy + (dz * dz + soft2));
      const float inv_r = rsqrtf(r2);
      const float v = fminf(r2 * v_scale - 1.0f, 1.0f);
      float qv = c.q[0];
#pragma unroll
      for (int k = 1; k < kNumCoeffs; ++k) qv = qv * v + c.q[k];
      const float w = p.w * fmaxf(inv_r * inv_r * inv_r + qv, 0.0f);
      ax[u] += w * dx;
      ay[u] += w * dy;
      az[u] += w * dz;
    }
  }
}

__global__ void __launch_bounds__(kGroup * 32)
short_range_rd_kernel(const float4* __restrict__ pts,
                      const int* __restrict__ counts,
                      const int* __restrict__ tables,
                      const __grid_constant__ Coeffs coeffs,
                      int* __restrict__ plan, float* __restrict__ out,
                      int nc, int k_rod, float box, float soft2,
                      float v_scale) {
  extern __shared__ float4 stage[];           // kStageTiles * kTile slots
  __shared__ int e_st[kGroup][kEnt], e_end[kGroup][kEnt];
  __shared__ int u_st[kEnt], u_off[kEnt + 1], u_rod[kEnt];
  __shared__ float u_sx[kEnt], u_sy[kEnt];
  __shared__ int s_item;
  const unsigned full = 0xffffffffu;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int half = lane >> 4;
  const int nch = k_rod / kCh, gpr = nch / kGroup;
  const int n_items = plan[0];
  const int* items = plan + kPlanHeader;

  for (;;) {
    if (threadIdx.x == 0) {
      const int k = atomicAdd(plan + 1, 1);
      s_item = k < n_items ? items[k] : -1;
    }
    __syncthreads();
    const int item = s_item;
    if (item < 0) break;                     // uniform a block
    const int r = item / gpr;
    const int t = (item - r * gpr) * kGroup + warp;
    const int cnt = counts[r];
    const bool live = t * kCh < cnt;         // uniform a warp

    // the chunk's 27 entries, lane e holding entry e
    int st = 0, nt = 0, zsel = 0;
    if (live && lane < kEnt) {
      const int ent = tables[((long long)r * nch + t) * kEnt + lane];
      zsel = ent & 3;
      nt = (ent >> 2) & 255;
      st = ent >> 10;
    }
    const unsigned mask = __ballot_sync(full, nt > 0);
    // an empty entry: [kNoTile, 0), so hi - lo never overflows
    if (lane < kEnt) {
      e_st[warp][lane] = nt > 0 ? st : kNoTile;
      e_end[warp][lane] = nt > 0 ? st + nt : 0;
    }
    __syncthreads();
    // the group's union of tiles an entry, its rod, shift and offset in
    // the group's list of tiles
    if (warp == 0) {
      int lo = kNoTile, hi = 0;
      if (lane < kEnt) {
#pragma unroll
        for (int w = 0; w < kGroup; ++w) {
          lo = min(lo, e_st[w][lane]);
          hi = max(hi, e_end[w][lane]);
        }
      }
      const int n = hi > lo ? hi - lo : 0;
      int incl = n;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(full, incl, d);
        if (lane >= d) incl += v;
      }
      if (lane < kEnt) {
        const int nb = lane / 3;
        const int rx = r / nc + nb / 3 - 1, ry = r % nc + nb % 3 - 1;
        u_st[lane] = lo;
        u_off[lane] = incl - n;
        u_rod[lane] = ((rx + nc) % nc) * nc + (ry + nc) % nc;
        u_sx[lane] = rx < 0 ? -box : (rx >= nc ? box : 0.f);
        u_sy[lane] = ry < 0 ? -box : (ry >= nc ? box : 0.f);
      }
      if (lane == kEnt - 1) u_off[kEnt] = incl;
    }
    __syncthreads();
    const int total = u_off[kEnt];

    const int i = t * kCh + (lane & (kCh - 1));
    const float4 pi = pts[(long long)r * k_rod + i];
    float ax[kIlp], ay[kIlp], az[kIlp];
#pragma unroll
    for (int u = 0; u < kIlp; ++u) ax[u] = ay[u] = az[u] = 0.f;

    for (int p0 = 0; p0 < total; p0 += kStageTiles) {
      const int p1 = min(total, p0 + kStageTiles);
      // stage tiles [p0, p1) of the group's list
      for (int e = 0; e < kEnt; ++e) {
        const int k0 = max(u_off[e], p0), k1 = min(u_off[e + 1], p1);
        if (k0 >= k1) continue;
        const float4* src = pts + (long long)u_rod[e] * k_rod
                            + (long long)(u_st[e] + k0 - u_off[e]) * kTile;
        float4* dst = stage + (k0 - p0) * kTile;
        const int n = (k1 - k0) * kTile;
        for (int u = threadIdx.x; u < n; u += kGroup * 32)
          cp_async16(dst + u, src + u);
      }
      asm volatile("cp.async.wait_all;\n" ::: "memory");
      __syncthreads();
      if (live) {
        unsigned m = mask;
        while (m) {
          const int e = __ffs(m) - 1;
          m &= m - 1;
          const int est = __shfl_sync(full, st, e);
          const int ent_n = __shfl_sync(full, nt, e);
          const int ez = __shfl_sync(full, zsel, e);
          const int a0 = u_off[e] + est - u_st[e];
          const int k0 = max(a0, p0), k1 = min(a0 + ent_n, p1);
          if (k0 >= k1) continue;              // uniform a warp
          const float4* s = stage + (k0 - p0) * kTile;
          const int n = (k1 - k0) * kTile;
          const float izs =
              pi.z + (ez == 1 ? -box : (ez == 2 ? box : 0.f));
          const float sx = u_sx[e], sy = u_sy[e];
          if (sx != 0.f || sy != 0.f)
            pairs<true>(s, n, half, pi, izs, sx, sy, coeffs, soft2,
                        v_scale, ax, ay, az);
          else
            pairs<false>(s, n, half, pi, izs, sx, sy, coeffs, soft2,
                         v_scale, ax, ay, az);
        }
      }
      __syncthreads();                         // the stage is consumed
    }
    if (live) {
#pragma unroll
      for (int u = 1; u < kIlp; ++u) {
        ax[0] += ax[u];
        ay[0] += ay[u];
        az[0] += az[u];
      }
      ax[0] += __shfl_xor_sync(full, ax[0], kCh);
      ay[0] += __shfl_xor_sync(full, ay[0], kCh);
      az[0] += __shfl_xor_sync(full, az[0], kCh);
      if (half == 0 && i < cnt) {
        float* o = out + ((long long)r * k_rod + i) * 3;
        o[0] = ax[0];
        o[1] = ay[0];
        o[2] = az[0];
      }
    }
  }
}

}  // namespace

// K8's plan (see rd_plan_kernel) into plan, int32 of 2 + R k_rod / (16
// kGroup) entries; group: the caller's kGroup (a mismatch is refused)
extern "C" int lcdm_short_range_rd_plan(const int* counts, int* plan,
                                        int nrods, int k_rod, int group,
                                        void* stream) {
  if (group != kGroup || k_rod % (kCh * kGroup))
    return (int)cudaErrorInvalidValue;
  if (nrods > 0)
    rd_plan_kernel<<<1, kPlanThreads, 0, (cudaStream_t)stream>>>(
        counts, nrods, k_rod, plan);
  return (int)cudaGetLastError();
}

// pts [R, k_rod] float4; counts [R]; tables [R, k_rod / 16, 27]; coeffs:
// the 11 coefficients in host memory (kMaxCoeffs, highest first); plan:
// lcdm_short_range_rd_plan's, whose counter this call consumes; out [R,
// k_rod, 3], zero-filled by the caller; group: the caller's kGroup.
// Persistent blocks: as many as stay resident on the card.
extern "C" int lcdm_short_range_rd(const float* pts, const int* counts,
                                   const int* tables,
                                   const float* host_coeffs, int* plan,
                                   float* out, int nc, int k_rod, int group,
                                   float box, float soft2, float v_scale,
                                   void* stream) {
  if (group != kGroup || k_rod % (kCh * kGroup))
    return (int)cudaErrorInvalidValue;
  if (nc <= 0 || k_rod <= 0) return (int)cudaGetLastError();
  Coeffs coeffs;
  for (int u = 0; u < kMaxCoeffs; ++u) coeffs.q[u] = host_coeffs[u];
  // the stage is above the 48 KB a launch may take without asking
  cudaError_t err = cudaFuncSetAttribute(
      short_range_rd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kStageBytes);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, short_range_rd_kernel, kGroup * 32, kStageBytes);
  const int items = nc * nc * (k_rod / (kCh * kGroup));
  int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (blocks > items) blocks = items;
  short_range_rd_kernel<<<blocks, kGroup * 32, kStageBytes,
                          (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(pts), counts, tables, coeffs, plan,
      out, nc, k_rod, box, soft2, v_scale);
  return (int)cudaGetLastError();
}
