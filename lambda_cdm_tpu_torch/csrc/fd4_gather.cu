// K2: fused CIC x fd4 force gather from the potential grid.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_pm_rods.py
// _gather_kernel_occ (with counts) and _gather_kernel (without): the TPU
// DMAs a padded potential window per (cx, cy) rod and contracts it with
// fd4-convolved one-hot matrices on its matrix unit. None of that layout
// is carried over.
//
// acc_a = -sum over the 8 CIC corners g of w_g * D_a phi(g), with the
// 4th-order difference D_a phi(g) = (8 (phi(g+e_a) - phi(g-e_a))
// - (phi(g+2e_a) - phi(g-2e_a))) / 12h and periodic indices; mesh
// coordinates u = x * scale as in K1. Along axis a the two corners share
// one line of 6 mesh points (i0-2 .. i0+3). Dead slots and slots whose
// lower corner left the home block window (the deposit's drop rule) get
// 0. The output is SoA [3, C, K]; g_const multiplies outside.
//
// Design (what bounds it and what the design does about it):
// * Work follows live rows: one block a tile of tile^3 cells
//   (ops/pm_rods.tile_plan); the block's threads walk the tile's live
//   rows, the cells' rows laid end to end, so no thread exists for a dead
//   slot and a cell of 8,000 rows is one block's loop, not 8,000 idle
//   slots' threads. The block writes each live row once; the wrapper's
//   memset gives the dead slots their 0 (as fast as the kernel writing
//   them on the science plan, faster at 1M/192^3 and on a clustered state:
//   kernel_ab.py).
// * The potential window in shared memory: every corner and stencil
//   point the drop rule admits for the tile's cells lies in a cube of
//   win = tile * ppc + 2 (margin + 1) + 4 points a side, from the tile's
//   first cell's block origin - 2. The block stages that cube once with
//   cp.async copies, 16 bytes each where the window's z lines are whole
//   aligned quads (each point's periodic index from three small tables
//   computed once), and a row then reads its 56 distinct points (8
//   corners + 4 lines x 4 stencil ends on each axis) from shared memory
//   instead of 72 scattered global loads. A window too large for a block
//   (ppc > 30: degenerate plans only) is read from global memory through
//   the same tables (kStaged false).
// * Each row's arithmetic is the old kernel's, in the same order, so the
//   output is bit for bit the old kernel's (kernel_ab.py hashes it).
//
// Bound on the H100: the potential read once (28 MB at 192^3) and 24 B a
// live row written; the staging rereads each tile's window from L2 (~33
// floats a live row at the 1M/192^3 plan) and the rows' shared loads
// (56 a row, random banks) follow.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTileCells = 8;   // tile <= 2

constexpr int kMaxDevices = 64;

// Lift fn's dynamic shared-memory limit to smem where that exceeds the
// 48 KB default: once a device and function (again only for a larger
// size), since cudaFuncSetAttribute is host work the stepper would
// otherwise pay at every launch. `allowed` is fn's record, per device.
cudaError_t allow_smem(const void* fn, size_t smem,
                       size_t (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

// i in [-n, 2n) -> [0, n): the window overhangs the mesh by less than ng
__device__ __forceinline__ int wrap_once(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads)
fd4_gather_kernel(const float* __restrict__ phi,
                  const float* __restrict__ bpos,
                  const int* __restrict__ counts, float* __restrict__ out,
                  int nc, int cap, int ng, int margin, int tile,
                  float scale, float inv_12h) {
  extern __shared__ __align__(16) float window[];   // win^3 (kStaged)
  const int win = tile * (ng / nc) + 2 * (margin + 1) + 4;
  // [3][win] wrapped offsets, after the window
  int* offs = reinterpret_cast<int*>(window + (kStaged ? win * win * win
                                                        : 0));
  __shared__ int first[kMaxTileCells + 1];  // rows before each cell
  __shared__ int cell_id[kMaxTileCells];
  __shared__ int cell_xyz[kMaxTileCells];   // (cx << 20) | (cy << 10) | cz

  const long long nslots = (long long)nc * nc * nc * cap;
  const int ppc = ng / nc;
  const int ell = ppc + 2 * (margin + 1);
  const int nt = nc / tile, ncells = tile * tile * tile;
  const int t[3] = {(int)blockIdx.x / (nt * nt), ((int)blockIdx.x / nt) % nt,
                    (int)blockIdx.x % nt};
  // the window's first point on each axis (tile origin - margin - 3)
  int wo[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) wo[a] = t[a] * tile * ppc - (margin + 1) - 2;

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
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int stride = a == 0 ? ng * ng : (a == 1 ? ng : 1);
    for (int l = threadIdx.x; l < win; l += kThreads)
      offs[a * win + l] = wrap_once(wo[a] + l, ng) * stride;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    first[0] = 0;
    for (int j = 0; j < ncells; ++j) first[j + 1] += first[j];
  }
  if (kStaged) {
    // asynchronous copies straight into shared memory (cp.async, no
    // register round trip), every copy of the thread in flight at once:
    // 16 bytes a copy where the window's z lines are whole aligned quads
    // of the mesh (the 1M/192^3 and science plans), else 4; coalesced
    // along z. The magic divisions are exact for i < 2^32 / win^2.
    const bool quads = win % 4 == 0 && ng % 4 == 0 && (wo[2] & 3) == 0;
    const int q = quads ? 4 : 1, per_line = win / q;
    const unsigned m_line = 0xffffffffu / per_line + 1;
    const unsigned m_win = 0xffffffffu / win + 1;
    const int n = win * win * per_line;
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int line = per_line > 1 ? (int)__umulhi((unsigned)i, m_line)
                                    : i;
      const int z = (i - line * per_line) * q;
      const int x = (int)__umulhi((unsigned)line, m_win);
      const int y = line - x * win;
      const unsigned dst = (unsigned)__cvta_generic_to_shared(
          window + line * win + z);
      const float* src = phi + offs[x] + offs[win + y] + offs[2 * win + z];
      if (quads)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                     :: "r"(dst), "l"(src));
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(dst), "l"(src));
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  }
  __syncthreads();

  const int total = first[ncells];
  for (int r = threadIdx.x; r < total; r += kThreads) {
    int j = 0;
    while (first[j + 1] <= r) ++j;
    const int c = cell_id[j];
    const long long s = (long long)c * cap + (r - first[j]);
    const int xyz = cell_xyz[j];
    const int cell[3] = {xyz >> 20, (xyz >> 10) & 1023, xyz & 1023};

    int i0[3];
    float w[3][2];
    bool ok = true;
#pragma unroll
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
    if (!ok) continue;                  // dropped: the memset's 0
    // local coordinates of the lower corner: 2 .. win - 4 on each axis
    int l[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) l[a] = i0[a] - wo[a];
    auto at = [&](int x, int y, int z) -> float {
      if (kStaged) return window[(x * win + y) * win + z];
      return phi[offs[x] + offs[win + y] + offs[2 * win + z]];
    };
    float core[2][2][2];
#pragma unroll
    for (int dx = 0; dx < 2; ++dx)
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dz = 0; dz < 2; ++dz)
          core[dx][dy][dz] = at(l[0] + dx, l[1] + dy, l[2] + dz);

    float acc[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int b = (a + 1) % 3, e = (a + 2) % 3;   // the two other axes
      float sum = 0.0f;
#pragma unroll
      for (int db = 0; db < 2; ++db) {
#pragma unroll
        for (int de = 0; de < 2; ++de) {
          int q[3];
          q[b] = l[b] + db;
          q[e] = l[e] + de;
          int d[3] = {0, 0, 0};
          d[b] = db;
          d[e] = de;
          // the line along a: p[j] = phi(i0 - 2 + j); p[2], p[3] are
          // corners
          float p[6];
#pragma unroll
          for (int jj = 0; jj < 6; ++jj) {
            if (jj == 2 || jj == 3) {
              d[a] = jj - 2;
              p[jj] = core[d[0]][d[1]][d[2]];
            } else {
              q[a] = l[a] - 2 + jj;
              p[jj] = at(q[0], q[1], q[2]);
            }
          }
          const float d0 = 8.0f * (p[3] - p[1]) - (p[4] - p[0]);
          const float d1 = 8.0f * (p[4] - p[2]) - (p[5] - p[1]);
          sum += (w[b][db] * w[e][de]) * (w[a][0] * d0 + w[a][1] * d1);
        }
      }
      acc[a] = -sum * inv_12h;
    }
    for (int a = 0; a < 3; ++a) out[a * nslots + s] = acc[a];
  }

}

template <bool kStaged>
cudaError_t launch(const float* phi, const float* bpos, const int* counts,
                   float* out, int nc, int cap, int ng, int margin,
                   int tile, float scale, float inv_12h, size_t smem,
                   cudaStream_t s) {
  const int nt = nc / tile;
  static size_t allowed[kMaxDevices];
  const cudaError_t err =
      allow_smem((const void*)fd4_gather_kernel<kStaged>, smem, allowed);
  if (err != cudaSuccess) return err;
  fd4_gather_kernel<kStaged><<<nt * nt * nt, kThreads, smem, s>>>(
      phi, bpos, counts, out, nc, cap, ng, margin, tile, scale, inv_12h);
  return cudaGetLastError();
}

}  // namespace

// tile: cells a side of a block's tile (1 or 2, dividing nc); staged:
// the window fits in shared memory. out must be zero-filled: the kernel
// writes live rows only
extern "C" int lcdm_fd4_gather(const float* phi, const float* bpos,
                               const int* counts, float* out, int nc,
                               int cap, int ng, int margin, float scale,
                               float inv_12h, int tile, int staged,
                               void* stream) {
  if (tile < 1 || tile > 2 || nc % tile) return (int)cudaErrorInvalidValue;
  const int win = tile * (ng / nc) + 2 * (margin + 1) + 4;
  size_t smem = 3 * (size_t)win * sizeof(int);
  cudaStream_t s = (cudaStream_t)stream;
  if (staged) {
    smem += (size_t)win * win * win * sizeof(float);
    return (int)launch<true>(phi, bpos, counts, out, nc, cap, ng, margin,
                             tile, scale, inv_12h, smem, s);
  }
  return (int)launch<false>(phi, bpos, counts, out, nc, cap, ng, margin,
                            tile, scale, inv_12h, smem, s);
}
