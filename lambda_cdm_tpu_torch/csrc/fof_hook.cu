// K5: one friends-of-friends min-label sweep on cell buckets.
//
// Replaces the TPU kernel lambda_cdm_tpu/ops/pallas_fof.py
// _fof_hook_kernel (with _fof_rod_body). For every live slot i of an
// active cell c:
//
//   out[i] = min(lab[i], min over the live slots j of the 27 periodic
//            neighbour cells of c with r^2(i, j) < b^2 of lab[j]),
//   d = (x_j + shift) - x_i, r^2 = (dx^2 + dy^2) + dz^2,
//
// where the neighbour of c at offset o is cell (c + o) mod ncell, shifted
// by box * floor((c + o) / ncell) per axis (right for any ncell >= 1:
// on lattices of one or two cells a neighbour appears under several
// shifts). Dead rows and inactive cells are not touched: the caller
// passes `out` as a copy of `lab`. Every live j links, whether its cell is
// active or not.
//
// The TPU kernel is a Gauss-Seidel sweep: its grid runs in order through
// an input/output-aliased HBM buffer, so later rods read earlier rods'
// fresh labels. Blocks on the card run in parallel and in no order, so
// this is a Jacobi sweep that reads `lab` and writes `out`: it is
// deterministic and equals the plain version (ops/fof_hook.fof_hook_plain)
// slot for slot; the fixpoint of the caller's hook-and-compress loop
// (every label its component's least particle index) is unchanged, only
// the number of rounds may grow. The arithmetic uses __fsub_rn /
// __fmul_rn / __fadd_rn so that nvcc contracts nothing into an FMA: r^2
// rounds as the plain version's does and the strict `<` test decides the
// same links.
//
// Design (the parent ran a block of 64 threads per chunk of 64 live rows,
// staging every j of the 27 neighbours through shared memory behind two
// block barriers a 64-j tile, whatever the cell's size, and tested every
// j against every i):
//
// * One warp a unit. The work is K3's plan of units (ops/short_range.
//   unit_plan over the counts of the active cells: at most 32 live rows
//   of one cell a unit, heaviest first, built on the card with no host
//   sync); persistent warps take units from the plan's counter in that
//   order. Lane r holds row r; lanes 0..26 hold the 27 neighbour cells
//   (id, shift, live count). A neighbour's j pass 32 at a time through the
//   warp's own shared buffer, one coalesced load a lane with the shift
//   added by __fadd_rn, behind __syncwarp only; the next batch's load is
//   in flight while this one is tested.
// * Skip j that cannot win. A batch whose least label is not below the
//   largest current minimum of the unit's live rows is skipped whole (two
//   warp reductions): no j of it lowers any minimum, so the output does
//   not change. A finer skip, a warp vote on each j against every lane's
//   current minimum, cost more than it saved (on the H100 at 1M
//   clustered: kernel ~0.80 against ~0.71 ms a first sweep), as did a
//   ballot of the batch's j against the largest minimum.
//
// Labels are integers and min is order-free, so the output is the same
// bytes as the parent's and the plain version's on every input.
//
// Bound on the H100: the pair tests, sum over live i of active cells of
// sum over its 27 neighbour cells of n_j (8 float operations each), and
// the bytes of positions and labels (16 B per live slot read, the label
// lattice copied to `out`). A pair test issues ~16 instructions (the
// shared load, 8 float operations, the compare and select, the loop), so
// the kernel is bound by instruction issue well above the operations
// bound; the wrapper's plan and its copy of the label lattice add about a
// quarter on the 1M clustered plan (PERF.md).

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kUnitRows = 32;   // = ops/short_range.UNIT_ROWS
constexpr int kWarps = 4;       // warps a block
// the plan's layout (ops/short_range.unit_plan_plain; kHeader, kWork,
// kLive, kUnits in short_range.cu)
constexpr int kWork = 0, kLive = 1, kUnits = 2, kHeader = 4;

struct __align__(16) JSlot {
  float x, y, z;
  int lab;
};

// lane nb's neighbour cell of (cx, cy, cz) and its shift
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

// this lane's j of neighbour nb in the batch from jbase, shifted; the
// label INT_MAX past the neighbour's live rows (it wins no min)
__device__ __forceinline__ JSlot fetch_j(const float* __restrict__ bx,
                                         const float* __restrict__ by,
                                         const float* __restrict__ bz,
                                         const int* __restrict__ lab,
                                         int cap, int nb, int jbase, int nj,
                                         int my_cn, float my_sx, float my_sy,
                                         float my_sz) {
  const unsigned full = 0xffffffffu;
  const int cn = __shfl_sync(full, my_cn, nb);
  const float sx = __shfl_sync(full, my_sx, nb);
  const float sy = __shfl_sync(full, my_sy, nb);
  const float sz = __shfl_sync(full, my_sz, nb);
  const int j = jbase + (threadIdx.x & 31);
  JSlot s = {0.f, 0.f, 0.f, INT_MAX};
  if (j < nj) {
    const long long sj = (long long)cn * cap + j;
    s.x = __fadd_rn(bx[sj], sx);
    s.y = __fadd_rn(by[sj], sy);
    s.z = __fadd_rn(bz[sj], sz);
    s.lab = lab[sj];
  }
  return s;
}

__global__ void __launch_bounds__(kWarps * 32)
fof_hook_kernel(const float* __restrict__ bx, const float* __restrict__ by,
                const float* __restrict__ bz, const int* __restrict__ lab,
                const int* __restrict__ counts, int* __restrict__ plan,
                int* __restrict__ out, int nc, int cap, float box,
                float b2) {
  __shared__ JSlot tiles[kWarps][kUnitRows];
  const unsigned full = 0xffffffffu;
  const int ncells = nc * nc * nc;
  const int lane = threadIdx.x & 31;
  JSlot* tile = tiles[threadIdx.x >> 5];
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
    const bool row_live = i < counts[c];
    float xi = 0.f, yi = 0.f, zi = 0.f;
    int m = INT_MIN;                   // a dead lane wants nothing
    if (row_live) {
      xi = bx[si];
      yi = by[si];
      zi = bz[si];
      m = lab[si];
    }
    // the unit's 27 neighbours, lane nb holding neighbour nb
    int my_cn = 0, my_nj = 0;
    float my_sx = 0.f, my_sy = 0.f, my_sz = 0.f;
    if (lane < 27) {
      my_cn = neighbour(cx, cy, cz, lane, nc, box, &my_sx, &my_sy, &my_sz);
      my_nj = counts[my_cn];
    }

    // batches of 32 j over neighbours 0..26 in order; the next batch's
    // load is issued before the current batch is tested
    int nb = 0, jbase = 0;
    int nj = __shfl_sync(full, my_nj, 0);
    while (nj == 0 && ++nb < 27) nj = __shfl_sync(full, my_nj, nb);
    JSlot next = {0.f, 0.f, 0.f, INT_MAX};
    if (nb < 27)
      next = fetch_j(bx, by, bz, lab, cap, nb, 0, nj, my_cn, my_sx, my_sy,
                     my_sz);
    while (nb < 27) {
      const int nt = min(kUnitRows, nj - jbase);
      const JSlot cur = next;
      jbase += kUnitRows;
      if (jbase >= nj) {
        jbase = 0;
        do {
          nj = ++nb < 27 ? __shfl_sync(full, my_nj, nb) : 0;
        } while (nb < 27 && nj == 0);
      }
      if (nb < 27)
        next = fetch_j(bx, by, bz, lab, cap, nb, jbase, nj, my_cn, my_sx,
                       my_sy, my_sz);
      // the whole batch is skipped when its least label lowers no row
      if (__reduce_min_sync(full, cur.lab) >= __reduce_max_sync(full, m))
        continue;
      tile[lane] = cur;
      __syncwarp();
      for (int t = 0; t < nt; ++t) {
        const JSlot p = tile[t];
        const float dx = __fsub_rn(p.x, xi);
        const float dy = __fsub_rn(p.y, yi);
        const float dz = __fsub_rn(p.z, zi);
        const float r2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                             __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
        if (r2 < b2 && p.lab < m) m = p.lab;
      }
      __syncwarp();                      // the buffer is consumed
    }
    if (row_live) out[si] = m;
  }
}

}  // namespace

// plan: ops/short_range.unit_plan of the counts of the active cells (its
// counter is consumed); counts: every cell's live rows (the j side)
extern "C" int lcdm_fof_hook(const float* bx, const float* by,
                             const float* bz, const int* lab,
                             const int* counts, int* plan, int* out, int nc,
                             int cap, float box, float b2, void* stream) {
  if (nc <= 0 || cap <= 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fof_hook_kernel,
                                                kWarps * 32, 0);
  const int blocks = sms * per_sm > 0 ? sms * per_sm : 1;
  fof_hook_kernel<<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      bx, by, bz, lab, counts, plan, out, nc, cap, box, b2);
  return (int)cudaGetLastError();
}
