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
// Design: the work is split by live rows, not by cells. A unit is a chunk
// of at most kUnitRows = 32 live rows of one cell, and one warp takes one
// unit: lane r holds row r, and each of the 27 neighbour cells' live j
// slots passes through the warp's own 32-slot tile in shared memory, with
// the shift applied and the mass scaled, behind __syncwarp only. A cell
// of 8,000 rows is 250 units spread over the card, not one block walking
// it alone while the card idles; a cell of 30 rows is one unit whose
// lanes are nearly all live, whatever the capacity.
//
// Heaviest first: the plan (lcdm_short_range_plan: two small kernels on
// the counts, no host sync) orders the non-empty cells by the class
// floor(log2(neighbour load)), heavy to light, then by cell id, and
// numbers their units in that order; persistent warps take units from a
// counter in that order, so the heaviest units start first and the tail
// is the lightest. The counter orders the work only: each target's sum is
// one warp's, over neighbour 0..26 and j ascending, written once; no
// atomics touch the output, so the result is deterministic. The work is
// sum_units 32-lane warps times the unit's neighbour load, so it tracks
// occupancy, not the padded capacity that grow-and-retry raises.
//
// Inside a unit: lanes 0..26 hold the 27 neighbour cells (id, shift, live
// count), read once; the next j chunk's loads are issued before the
// current chunk's pairs, so their latency hides behind them; the split's
// coefficients are kernel parameters, read by the FFMAs from the constant
// bank; the rsqrt skips rsqrtf's guard for denormal input (r^2 >= eps^2).
//
// Bound on the H100: float32 pair arithmetic (about 35-40 FLOP and one
// rsqrt per pair); each staged j is reused by the 32 rows of a unit.

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

// rsqrtf without its guard for denormal input (r^2 >= eps^2 > 0 here):
// the same MUFU.RSQ result for every normal r^2, one compare fewer a pair
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the weight of one pair, without its mass
template <int SPLIT>
__device__ __forceinline__ float pair_weight(float r2, const float* q,
                                             float p0, float p1) {
  constexpr int nq = Split<SPLIT>::kNumCoeffs;
  const float inv_r = rsqrt_normal(r2);
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

constexpr int kUnitRows = 32;      // = ops/short_range.UNIT_ROWS
constexpr int kWarps = 4;          // warps a block of the pair kernel
constexpr int kPlanThreads = 1024;
constexpr int kClasses = 32;
// the plan, int32 (= ops/short_range.unit_plan_plain's layout): a header
// [work counter, non-empty cells L, units U, 0], then per cell its class
// (-1 when empty), then the L non-empty cells in unit order, then the
// first unit of each of them
constexpr int kWork = 0, kLive = 1, kUnits = 2, kHeader = 4;

__device__ __forceinline__ int neighbour(int cx, int cy, int cz, int nb,
                                         int nc, float box, float* sx,
                                         float* sy, float* sz) {
  int nx = cx + nb / 9 - 1;
  int ny = cy + (nb / 3) % 3 - 1;
  int nz = cz + nb % 3 - 1;
  *sx = nx < 0 ? -box : (nx >= nc ? box : 0.f);
  *sy = ny < 0 ? -box : (ny >= nc ? box : 0.f);
  *sz = nz < 0 ? -box : (nz >= nc ? box : 0.f);
  nx = (nx + nc) % nc;
  ny = (ny + nc) % nc;
  nz = (nz + nc) % nc;
  return (nx * nc + ny) * nc + nz;
}

// plan 1: each cell's class, floor(log2(live slots of its 27 neighbours)),
// or -1 for an empty cell
__global__ void plan_classes(const int* __restrict__ counts,
                             int* __restrict__ cls, int nc) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc * nc * nc) return;
  if (counts[c] <= 0) {
    cls[c] = -1;
    return;
  }
  const int cx = c / (nc * nc), cy = (c / nc) % nc, cz = c % nc;
  int load = 0;
  float sx, sy, sz;
  for (int nb = 0; nb < 27; ++nb)
    load += counts[neighbour(cx, cy, cz, nb, nc, 0.f, &sx, &sy, &sz)];
  cls[c] = 31 - __clz(load);
}

// exclusive scan of one value a thread over the block (kPlanThreads)
__device__ int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) warp_sums[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sums[lane] = w;                // inclusive over warps
  }
  __syncthreads();
  const int out = inc - v + (warp > 0 ? warp_sums[warp - 1] : 0);
  __syncthreads();
  return out;
}

// plan 2 (one block): the non-empty cells ordered by class, heavy to
// light, then by cell id (a stable counting sort: chunks of kPlanThreads
// cells in id order, each cell's rank among the lower lanes and warps of
// its class); the first unit of each; the totals; the counter zeroed
__global__ void __launch_bounds__(kPlanThreads)
plan_order(const int* __restrict__ counts, int* __restrict__ plan,
           int ncells) {
  __shared__ int hist[kClasses];
  __shared__ int cursor[kClasses];
  __shared__ int wcnt[kPlanThreads / 32][kClasses];
  __shared__ int warp_sums[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int* cls = plan + kHeader;
  int* order = plan + kHeader + ncells;
  int* ustart = plan + kHeader + 2 * ncells;
  if (tid < kClasses) hist[tid] = 0;
  __syncthreads();
  for (int c = tid; c < ncells; c += kPlanThreads)
    if (cls[c] >= 0) atomicAdd(&hist[cls[c]], 1);
  __syncthreads();
  if (tid == 0) {
    int pos = 0;
    for (int k = kClasses - 1; k >= 0; --k) {
      cursor[k] = pos;
      pos += hist[k];
    }
    plan[kLive] = pos;
  }
  __syncthreads();
  for (int base = 0; base < ncells; base += kPlanThreads) {
    const int c = base + tid;
    const int k = c < ncells ? cls[c] : -1;
    wcnt[warp][lane] = 0;
    __syncwarp();
    const unsigned same = __match_any_sync(0xffffffffu, k);
    const int rank = __popc(same & ((1u << lane) - 1u));
    if (k >= 0 && rank == 0) wcnt[warp][k] = __popc(same);
    __syncthreads();
    if (k >= 0) {
      int pos = cursor[k] + rank;
      for (int w = 0; w < warp; ++w) pos += wcnt[w][k];
      order[pos] = c;
    }
    __syncthreads();
    if (tid < kClasses) {
      int add = 0;
      for (int w = 0; w < kPlanThreads / 32; ++w) add += wcnt[w][tid];
      cursor[tid] += add;
    }
    __syncthreads();
  }
  // units: ceil(rows / kUnitRows) a cell, numbered in the order above
  const int live = plan[kLive];
  const int per = (live + kPlanThreads - 1) / kPlanThreads;
  const int s0 = min(live, tid * per), s1 = min(live, s0 + per);
  int local = 0;
  for (int s = s0; s < s1; ++s)
    local += (counts[order[s]] + kUnitRows - 1) / kUnitRows;
  int run = block_exclusive_scan(local, warp_sums);
  for (int s = s0; s < s1; ++s) {
    ustart[s] = run;
    run += (counts[order[s]] + kUnitRows - 1) / kUnitRows;
  }
  if (tid == kPlanThreads - 1) plan[kUnits] = run;
  if (tid == 0) {
    plan[kWork] = 0;
    plan[kHeader - 1] = 0;
  }
}

// the split's coefficients, passed by value: kernel parameters sit in the
// constant bank, which an FFMA reads as an operand, so Horner's rule holds
// no coefficient in a register
struct Coeffs {
  float q[kMaxCoeffs];
};

// one lane's j of neighbour nb (of the unit's table, one neighbour a lane:
// cell, shift, live count) in the chunk from jbase: shifted, mass scaled
__device__ __forceinline__ float4 fetch_j(const float* __restrict__ bpos,
                                          const float* __restrict__ bmass,
                                          long long nslots, int cap, int nb,
                                          int jbase, int nj, int my_cn,
                                          float my_sx, float my_sy,
                                          float my_sz, float mscale) {
  const unsigned full = 0xffffffffu;
  const int cn = __shfl_sync(full, my_cn, nb);
  const float sx = __shfl_sync(full, my_sx, nb);
  const float sy = __shfl_sync(full, my_sy, nb);
  const float sz = __shfl_sync(full, my_sz, nb);
  const int j = jbase + (threadIdx.x & 31);
  if (j >= nj) return make_float4(0.f, 0.f, 0.f, 0.f);
  const long long sj = (long long)cn * cap + j;
  return make_float4(bpos[sj] + sx, bpos[nslots + sj] + sy,
                     bpos[2 * nslots + sj] + sz, bmass[sj] * mscale);
}

template <int SPLIT>
__global__ void __launch_bounds__(kWarps * 32, 8)
short_range_kernel(const float* __restrict__ bpos,
                   const float* __restrict__ bmass,
                   const int* __restrict__ counts,
                   const __grid_constant__ Coeffs coeffs,
                   int* __restrict__ plan, float* __restrict__ out,
                   int nc, int cap, float box, float soft2, float p0,
                   float p1, float mscale) {
  __shared__ float4 tiles[kWarps][kUnitRows];
  const unsigned full = 0xffffffffu;
  const int ncells = nc * nc * nc;
  const long long nslots = (long long)ncells * cap;
  const int lane = threadIdx.x & 31;
  float4* tile = tiles[threadIdx.x >> 5];
  const int live = plan[kLive], units = plan[kUnits];
  const int* order = plan + kHeader + ncells;
  const int* ustart = plan + kHeader + 2 * ncells;

  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(plan + kWork, 1);
    u = __shfl_sync(full, u, 0);
    if (u >= units) break;
    int lo = 0, hi = live - 1;         // the last cell whose first unit <= u
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (ustart[mid] <= u) lo = mid; else hi = mid - 1;
    }
    const int c = order[lo];
    const int cx = c / (nc * nc), cy = (c / nc) % nc, cz = c % nc;
    const int i = (u - ustart[lo]) * kUnitRows + lane;
    const long long si = (long long)c * cap + i;
    const bool active = i < counts[c];
    float xi = 0.f, yi = 0.f, zi = 0.f;
    if (active) {
      xi = bpos[si];
      yi = bpos[nslots + si];
      zi = bpos[2 * nslots + si];
    }
    // the unit's 27 neighbours, lane nb holding neighbour nb
    int my_cn = 0, my_nj = 0;
    float my_sx = 0.f, my_sy = 0.f, my_sz = 0.f;
    if (lane < 27) {
      my_cn = neighbour(cx, cy, cz, lane, nc, box, &my_sx, &my_sy, &my_sz);
      my_nj = counts[my_cn];
    }
    float ax = 0.f, ay = 0.f, az = 0.f;

    // j chunks of kUnitRows over neighbours 0..26 in order; the next
    // chunk's loads are issued before the current chunk's pairs
    int nb = 0, jbase = 0;
    int nj = __shfl_sync(full, my_nj, 0);
    while (nj == 0 && ++nb < 27) nj = __shfl_sync(full, my_nj, nb);
    float4 next = make_float4(0.f, 0.f, 0.f, 0.f);
    if (nb < 27)
      next = fetch_j(bpos, bmass, nslots, cap, nb, 0, nj, my_cn, my_sx,
                     my_sy, my_sz, mscale);
    while (nb < 27) {
      const int nt = min(kUnitRows, nj - jbase);
      tile[lane] = next;
      __syncwarp();
      jbase += kUnitRows;
      if (jbase >= nj) {
        jbase = 0;
        do {
          nj = ++nb < 27 ? __shfl_sync(full, my_nj, nb) : 0;
        } while (nb < 27 && nj == 0);
      }
      if (nb < 27)
        next = fetch_j(bpos, bmass, nslots, cap, nb, jbase, nj, my_cn,
                       my_sx, my_sy, my_sz, mscale);
      if (active) {
#pragma unroll 4
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
          const float w = p.w * pair_weight<SPLIT>(r2, coeffs.q, p0, p1);
          ax += w * dx;
          ay += w * dy;
          az += w * dz;
        }
      }
      __syncwarp();                      // the tile is consumed
    }
    if (active) {
      out[si] = ax;
      out[nslots + si] = ay;
      out[2 * nslots + si] = az;
    }
  }
}

// persistent blocks: as many as stay resident on the card
template <int SPLIT>
int launch(const float* bpos, const float* bmass, const int* counts,
           const Coeffs& coeffs, int* plan, float* out, int nc, int cap,
           float box, float soft2, float p0, float p1, float mscale,
           cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, short_range_kernel<SPLIT>, kWarps * 32, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  short_range_kernel<SPLIT><<<blocks, kWarps * 32, 0, stream>>>(
      bpos, bmass, counts, coeffs, plan, out, nc, cap, box, soft2, p0, p1,
      mscale);
  return (int)cudaGetLastError();
}

}  // namespace

// the plan of lcdm_short_range (int32, kHeader + 3 nc^3 entries)
extern "C" int lcdm_short_range_plan(const int* counts, int* plan, int nc,
                                     void* stream) {
  if (nc <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int ncells = nc * nc * nc;
  plan_classes<<<(ncells + 255) / 256, 256, 0, s>>>(counts, plan + kHeader,
                                                     nc);
  plan_order<<<1, kPlanThreads, 0, s>>>(counts, plan, ncells);
  return (int)cudaGetLastError();
}

// split: 0 even, 1 factored, 2 x-polynomial; coeffs: its coefficients,
// highest first, in host memory (kMaxCoeffs, unused ones 0); counts:
// live-first occupancies for every split; plan: lcdm_short_range_plan's,
// whose counter this call consumes
extern "C" int lcdm_short_range(const float* bpos, const float* bmass,
                                const int* counts, const float* host_coeffs,
                                int* plan, float* out, int nc, int cap,
                                int split, float box, float soft2, float p0,
                                float p1, float mscale, void* stream) {
  if (nc <= 0 || cap <= 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  Coeffs coeffs;
  for (int u = 0; u < kMaxCoeffs; ++u) coeffs.q[u] = host_coeffs[u];
  if (split == kEven)
    return launch<kEven>(bpos, bmass, counts, coeffs, plan, out, nc, cap,
                         box, soft2, p0, p1, mscale, s);
  if (split == kFactored)
    return launch<kFactored>(bpos, bmass, counts, coeffs, plan, out, nc,
                             cap, box, soft2, p0, p1, mscale, s);
  if (split == kXPoly)
    return launch<kXPoly>(bpos, bmass, counts, coeffs, plan, out, nc, cap,
                          box, soft2, p0, p1, mscale, s);
  return (int)cudaErrorInvalidValue;
}
