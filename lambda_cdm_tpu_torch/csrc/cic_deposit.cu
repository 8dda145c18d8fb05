// K1: CIC mass deposit of cell-bucketed particles onto the periodic PM mesh.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_pm_rods.py
// _deposit_kernel_occ (with counts) and _deposit_kernel (without), plus
// their assemble_rods x/y ghost fold: the TPU builds one-hot factor
// matrices per (cx, cy) rod and deposits with a matrix-unit GEMM into
// rod blocks that XLA folds afterwards. None of that layout is carried
// over: there are no rod blocks and no fold.
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
// Design: what bounds it is the rate at which L2 applies the global float
// adds a particle makes into a grid that stays in the 50 MB L2 (28 MB at
// 192^3): 8 scalar adds a row in the old kernel, which also ran a thread
// for every padded slot. (PyTorch's index_add_ of the same 8 adds a row
// takes longer than either kernel: kernel_ab.py.)
// * Work follows live rows: one block a tile of tile^3 cells
//   (ops/pm_rods.tile_plan), its threads walking the tile's live rows laid
//   end to end in cell order; no thread exists for a dead slot.
// * Each tile sums its rows in a shared window of win = tile * ppc + 2
//   (margin + 1) points a side (every corner the drop rule admits for its
//   cells), then adds each nonzero point to the grid once, aligned pairs
//   of points in one F32x2 reduction (sm_90 REDG.ADD.F32x2): neighbouring
//   rows' corners merge, and a halo's thousands of adds to a few points
//   become one each. Shared float atomics are compare-and-swap loops on
//   sm_90 that spin under a halo's contention, while 32-bit integer adds
//   are native (ATOMS.ADD); so the window holds exact 64-bit fixed-point
//   sums in two 32-bit words (the low word's carry, read from the returned
//   old value, goes to the high word). The scale is a power of two: 2^62
//   over the tile's rows times their largest mass (a first pass over the
//   masses) bounds every sum, and a term is rounded to within 2^-62 of
//   that bound.
// * Where the window does not fit (windowed 0: ppc > 12 at margin 1),
//   each row goes straight to the grid, the two z corners of a line in one
//   F32x2 reduction when they form an aligned pair: 6 reductions a row,
//   the same 8 elements. (An F32x4 around an odd pair, padded with zeros,
//   ran slower: the L2 adds every element.)
// * Drops are counted in shared memory, one global add a block.
// The global adds land in an order that changes from run to run, so the
// grid is not bit-reproducible: a point is a float32 sum of the same terms
// as the plain version's (each tile's part of it summed exactly and
// rounded once), in another order.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTileCells = 8;   // tile <= 2

// i in [-n, 2n) -> [0, n)
__device__ __forceinline__ int wrap_once(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// add a at line[iz] and b at line[iz + 1] (periodic): one F32x2
// reduction when iz is even (line is a multiple of ng, so for even ng the
// pair is 8-byte aligned and does not wrap), else two scalar adds
__device__ __forceinline__ void push_pair(float* grid, long long line,
                                          int iz, int ng, float a, float b) {
  if ((ng & 1) == 0 && (iz & 1) == 0) {
    atomicAdd(reinterpret_cast<float2*>(grid + line + iz),
              make_float2(a, b));
  } else {
    atomicAdd(grid + line + iz, a);
    atomicAdd(grid + line + wrap_once(iz + 1, ng), b);
  }
}

__global__ void __launch_bounds__(kThreads)
cic_deposit_kernel(const float* __restrict__ bpos,
                   const float* __restrict__ bmass,
                   const int* __restrict__ counts, float* __restrict__ grid,
                   int* __restrict__ dropped, int nc, int cap, int ng,
                   int margin, int tile, int windowed, float scale) {
  extern __shared__ unsigned window[];     // [2][win^3]: low, high words
  __shared__ int first[kMaxTileCells + 1];  // rows before each cell
  __shared__ int cell_id[kMaxTileCells];
  __shared__ int cell_xyz[kMaxTileCells];   // (cx << 20) | (cy << 10) | cz
  __shared__ int n_drop;
  __shared__ int m_max_bits;                // the largest mass (float bits)

  const long long nslots = (long long)nc * nc * nc * cap;
  const int ppc = ng / nc;
  const int ell = ppc + 2 * (margin + 1);
  const int win = tile * ppc + 2 * (margin + 1);
  const int nwin = win * win * win;
  const int nt = nc / tile, ncells = tile * tile * tile;
  const int t[3] = {(int)blockIdx.x / (nt * nt), ((int)blockIdx.x / nt) % nt,
                    (int)blockIdx.x % nt};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int wo[3];                                // the window's first point
#pragma unroll
  for (int a = 0; a < 3; ++a) wo[a] = t[a] * tile * ppc - (margin + 1);

  if (threadIdx.x < ncells) {
    const int j = threadIdx.x;
    const int cx = t[0] * tile + j / (tile * tile);
    const int cy = t[1] * tile + (j / tile) % tile;
    const int cz = t[2] * tile + j % tile;
    const int c = (cx * nc + cy) * nc + cz;
    cell_id[j] = c;
    cell_xyz[j] = (cx << 20) | (cy << 10) | cz;
    first[j + 1] = counts[c];
  }
  if (threadIdx.x == 0) {
    n_drop = 0;
    m_max_bits = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    first[0] = 0;
    for (int j = 0; j < ncells; ++j) first[j + 1] += first[j];
  }
  __syncthreads();
  const int total = first[ncells];
  const bool use_window = windowed && total > 0;
  unsigned* lo = window;
  unsigned* hi = window + nwin;
  float to_fixed = 0.0f;
  if (use_window) {
    // the largest mass of the tile's rows: a warp a cell
    float m_max = 0.0f;
    for (int j = warp; j < ncells; j += kWarps)
      for (int k = lane; k < first[j + 1] - first[j]; k += 32)
        m_max = fmaxf(m_max, bmass[(long long)cell_id[j] * cap + k]);
    for (int d = 16; d > 0; d >>= 1)
      m_max = fmaxf(m_max, __shfl_xor_sync(0xffffffffu, m_max, d));
    if (lane == 0) atomicMax(&m_max_bits, __float_as_int(m_max));
    for (int i = threadIdx.x; i < 2 * nwin; i += kThreads) window[i] = 0u;
    __syncthreads();
    // the fixed-point scale 2^k: every sum is at most total * m_max * 2^k
    // < 2^62
    const float bound = (float)total * __int_as_float(m_max_bits);
    to_fixed = ldexpf(1.0f, bound > 0.0f ? min(126, 61 - ilogbf(bound))
                                         : 0);
  }

  for (int r = threadIdx.x; r < total; r += kThreads) {
    int j = 0;
    while (first[j + 1] <= r) ++j;
    const int xyz = cell_xyz[j];
    const int cell[3] = {xyz >> 20, (xyz >> 10) & 1023, xyz & 1023};
    const long long s = (long long)cell_id[j] * cap + (r - first[j]);

    int i0[3];
    float fr[3];
    bool ok = true;
#pragma unroll
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
      atomicAdd(&n_drop, 1);
      continue;
    }
    const float m = bmass[s];
    const float wz0 = (1.0f - fr[2]) * m, wz1 = fr[2] * m;
#pragma unroll
    for (int dx = 0; dx < 2; ++dx) {
      const float wx = dx ? fr[0] : 1.0f - fr[0];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const float wxy = wx * (dy ? fr[1] : 1.0f - fr[1]);
        if (use_window) {
          const int p = ((i0[0] + dx - wo[0]) * win + i0[1] + dy - wo[1])
                        * win + (i0[2] - wo[2]);
#pragma unroll
          for (int dz = 0; dz < 2; ++dz) {
            const unsigned long long f =
                __float2ull_rn(wxy * (dz ? wz1 : wz0) * to_fixed);
            const unsigned add = (unsigned)f;
            const unsigned old = atomicAdd(&lo[p + dz], add);
            const unsigned up = (unsigned)(f >> 32) + (old + add < old);
            if (up) atomicAdd(&hi[p + dz], up);
          }
        } else {
          const long long line =
              ((long long)wrap_once(i0[0] + dx, ng) * ng
               + wrap_once(i0[1] + dy, ng)) * ng;
          push_pair(grid, line, wrap_once(i0[2], ng), ng, wxy * wz0,
                    wxy * wz1);
        }
      }
    }
  }

  if (use_window) {
    __syncthreads();
    // each nonzero point once, as the float32 of its sum: with even ng a
    // thread takes one aligned pair of mesh points that a window line
    // overlaps and adds both in one F32x2 reduction (a point outside the
    // window adds 0), else one point. The magic divisions are exact for
    // i < 2^32 / win^2.
    const float from_fixed = 1.0f / to_fixed;
    const bool pairs = (ng & 1) == 0;
    const int q0 = pairs ? wo[2] >> 1 : wo[2];      // floor(wo / 2)
    const int nq = pairs ? ((wo[2] + win - 1) >> 1) - q0 + 1 : win;
    const unsigned m_nq = 0xffffffffu / nq + 1;
    const unsigned m_win = 0xffffffffu / win + 1;
    auto point = [&](int line, int l) -> float {
      if (l < 0 || l >= win) return 0.0f;
      const int i = line * win + l;
      return __ull2float_rn(((unsigned long long)hi[i] << 32) | lo[i])
             * from_fixed;
    };
    for (int i = threadIdx.x; i < win * win * nq; i += kThreads) {
      const int line = (int)__umulhi((unsigned)i, m_nq);
      const int x = (int)__umulhi((unsigned)line, m_win);
      const int y = line - x * win;
      const long long base = ((long long)wrap_once(wo[0] + x, ng) * ng
                              + wrap_once(wo[1] + y, ng)) * ng;
      if (pairs) {
        const int z2 = (q0 + i - line * nq) * 2;    // unwrapped pair start
        const float2 v = make_float2(point(line, z2 - wo[2]),
                                     point(line, z2 + 1 - wo[2]));
        if (v.x != 0.0f || v.y != 0.0f)
          atomicAdd(reinterpret_cast<float2*>(grid + base
                                              + wrap_once(z2, ng)), v);
      } else {
        const int l = i - line * nq;
        const float v = point(line, l);
        if (v != 0.0f) atomicAdd(grid + base + wrap_once(wo[2] + l, ng), v);
      }
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_drop) atomicAdd(dropped, n_drop);
}

}  // namespace

// tile: cells a side of a block's tile (1 or 2, dividing nc); windowed:
// each tile sums in its window (tile * ng / nc + 2 (margin + 1))^3, two
// words a point, else pushes its rows to the grid. grid must be
// zero-filled.
extern "C" int lcdm_cic_deposit(const float* bpos, const float* bmass,
                                const int* counts, float* grid,
                                int* dropped, int nc, int cap, int ng,
                                int margin, float scale, int tile,
                                int windowed, void* stream) {
  if (tile < 1 || tile > 2 || nc % tile) return (int)cudaErrorInvalidValue;
  const int nt = nc / tile;
  const int win = tile * (ng / nc) + 2 * (margin + 1);
  const size_t smem =
      windowed ? 2 * (size_t)win * win * win * sizeof(unsigned) : 0;
  // ops/pm_rods.tile_plan keeps a window within 32 KB: under the 48 KB a
  // block takes without raising the function's limit
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cic_deposit_kernel<<<nt * nt * nt, kThreads, smem,
                       (cudaStream_t)stream>>>(
      bpos, bmass, counts, grid, dropped, nc, cap, ng, margin, tile,
      windowed, scale);
  return (int)cudaGetLastError();
}
