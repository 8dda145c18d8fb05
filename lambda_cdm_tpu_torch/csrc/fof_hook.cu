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
// passes `out` as a copy of `lab`.
//
// Design. The TPU kernel is a Gauss-Seidel sweep: its grid runs in order
// through an input/output-aliased HBM buffer, so later rods read earlier
// rods' fresh labels. Blocks on the card run in parallel and in no order,
// so this is a Jacobi sweep that reads `lab` and writes `out`: it is
// deterministic and equals the plain version (ops/fof_hook.fof_hook_plain)
// slot for slot; the fixpoint of the caller's hook-and-compress loop (every
// label its component's least particle index) is unchanged, only the
// number of rounds may grow. The arithmetic uses __fsub_rn / __fmul_rn /
// __fadd_rn so that nvcc contracts nothing into an FMA: r^2 rounds as the
// plain version's does and the strict `<` test decides the same links.
//
// Work list: one block of kThreads threads per (active cell, chunk of
// kThreads live rows), built by the wrapper from counts and the active
// mask, so empty and inactive cells launch nothing and a dense halo core
// is spread over many blocks instead of one. Each block stages the live
// j of its 27 neighbour cells through shared memory in tiles of kThreads
// (position with the shift applied, and label).
//
// Bound on the H100: the pair tests, sum over live i of active cells of
// sum over its 27 neighbour cells of n_j (8 float operations each), and
// the bytes of positions and labels (16 B per live slot read, the label
// lattice copied to `out`). Clustered states are bound by the pair tests
// of their dense cells; the tiles reuse each staged j for a whole block.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;   // must equal ops/fof_hook.THREADS

struct __align__(16) JSlot {
  float x, y, z;
  int lab;
};

__global__ void fof_hook_kernel(const float* __restrict__ bx,
                                const float* __restrict__ by,
                                const float* __restrict__ bz,
                                const int* __restrict__ lab,
                                const int* __restrict__ counts,
                                const int* __restrict__ chunk_cell,
                                const int* __restrict__ chunk_base,
                                int* __restrict__ out, int nc, int cap,
                                float box, float b2) {
  __shared__ JSlot tile[kThreads];
  const int c = chunk_cell[blockIdx.x];
  const int i = chunk_base[blockIdx.x] + threadIdx.x;
  const int cx = c / (nc * nc), cy = (c / nc) % nc, cz = c % nc;
  const bool live = i < counts[c];
  const long long si = (long long)c * cap + i;
  float xi = 0.f, yi = 0.f, zi = 0.f;
  int m = 0;
  if (live) {
    xi = bx[si];
    yi = by[si];
    zi = bz[si];
    m = lab[si];
  }

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

    for (int jbase = 0; jbase < nj; jbase += kThreads) {
      const int j = jbase + threadIdx.x;
      __syncthreads();                   // the previous tile is consumed
      if (j < nj) {
        const long long sj = (long long)cn * cap + j;
        JSlot s;
        s.x = __fadd_rn(bx[sj], sx);
        s.y = __fadd_rn(by[sj], sy);
        s.z = __fadd_rn(bz[sj], sz);
        s.lab = lab[sj];
        tile[threadIdx.x] = s;
      }
      __syncthreads();
      if (live) {
        const int nt = min(kThreads, nj - jbase);
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
      }
    }
  }
  if (live) out[si] = m;
}

}  // namespace

extern "C" int lcdm_fof_hook(const float* bx, const float* by,
                             const float* bz, const int* lab,
                             const int* counts, const int* chunk_cell,
                             const int* chunk_base, int* out, int nchunks,
                             int nc, int cap, float box, float b2,
                             void* stream) {
  if (nchunks > 0) {
    fof_hook_kernel<<<nchunks, kThreads, 0, (cudaStream_t)stream>>>(
        bx, by, bz, lab, counts, chunk_cell, chunk_base, out, nc, cap, box,
        b2);
  }
  return (int)cudaGetLastError();
}
