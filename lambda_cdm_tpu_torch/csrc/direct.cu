// K4 and K4s: softened O(N^2) direct-sum accelerations with the minimum
// image.
//
// K4 replaces the TPU kernels lambda_cdm_tpu/ops/pallas_direct.py
// _direct_kernel (variant v1) and _direct_kernel_v2 (v2). For every
// particle i < n:
//
//   a_i = oscale * sum_j m_j (r^2)^(-3/2) d,   d = x_j - x_i,
//   v1: d -= box * rint(d / box) (the quotient of a true division,
//       rounded half to even), r^2 = ((dx^2 + dy^2) + dz^2) + eps^2;
//   v2: coordinates arrive in box units, d -= rint(d),
//       r^2 = dx^2 + (dy^2 + (dz^2 + eps^2)),
//
// with oscale = G (v1) or G / box^2 (v2). The self pair has d = 0 and adds
// nothing; eps > 0 keeps it finite. Design: one thread per i (kThreads a
// block); the j particles pass through shared memory in tiles of kThreads
// float4 (x, y, z, m); the sums stay in registers, each tile's summed
// apart and then added to the total (on the H100 one float32 running sum
// over 1e5 pairs drifted 1.8e-5 of the largest |a| from the plain tree
// reduction; the TPU kernel also sums per tile); the ragged last tile is
// cut by its count, so there is no zero-mass padding. The TPU kernel's
// [4, Np] lane layout, its padding to 2048-wide j tiles and its VMEM
// accumulator tiles are TPU workarounds and are not carried over.
//
// The image is that of the true quotient d / box, as forces/direct's
// min_image (the CPU solver) takes it. The TPU kernel's d * (1/box) can
// round to the other side of a half-integer for a pair half a box apart;
// on an initial-condition lattice such pairs are common, and those flips
// alone moved an 8-step 4096-particle run's velocities 1.2e-4 of max |v|
// away from the CPU run (card against CPU), against 1.2e-6 without them.
// The quotient costs two FMAs a component, no division (see quotient()).
//
// K4s replaces _direct_kernel_sym (variants sym and sym2): the same
// accelerations, with K4's image, each unordered pair evaluated once
// (Newton's third law). Tiles of kSymTile particles; P tiles, made odd,
// so that the TPU's half-matrix wrap (tile p against q = (p + k) mod P,
// k = 0..(P-1)/2) covers every unordered tile pair exactly once. Here that wrap is a
// schedule: one block per (p, k). A block keeps the row forces
// m_i m_j f d of its i tile in registers and writes them to a row
// partial; for k >= 1 it reduces the column forces over its i (a warp
// shuffle tree, then the warps in order through shared memory) and writes
// them negated to a column partial of tile q. A second pass sums, for each
// particle, its half + 1 row partials and half column partials in a fixed
// order and divides by the mass once (zero mass gives 0). No atomics:
// the result is deterministic. sym2 passes coordinates in box units with
// box = 1.
//
// Bound on the H100: operations. About 22 float operations and one rsqrt
// (on the SFUs) per ordered pair, n^2 pairs for K4 and n^2 / 2 for K4s,
// against 67 TFLOP/s of FP32: 1e10 pairs at 100k particles is about
// 3.3 ms for K4. Bytes are negligible (16 B a particle in, 12 B out; K4s
// adds its partials, 24 B a particle per tile pair). The design keeps each
// staged j in shared memory for a whole block of i and all sums in
// registers; the Gram form of r^2 that would put the pairs on the tensor
// cores loses the softened r^2 to cancellation in float32, so the pairs
// stay on the FP32 units.
//
// K9 (pair_potential) is the pair sum of the potential energy, which the
// JAX package leaves to XLA (lambda_cdm_tpu/forces/direct.py
// potential_energy, a lax.scan over row blocks; no TPU kernel):
//
//   S = sum_{i < j} m_i m_j (r^2)^(-1/2),  r^2 = |d|^2 + eps^2,
//
// pairs with r^2 <= eps^2 + 1e-30 (the self pair) left out, as the plain
// version leaves them; the wrapper returns U = -G S. Design:
//
// * Each unordered pair once. Tiles of kPairTile particles, P of them,
//   made odd; one block per (p, k), k = 0..(P-1)/2, sums tile p against
//   tile q = (p + k) mod P, which covers every unordered tile pair once
//   (K4s's half-matrix wrap). The diagonal block (k = 0) takes j > i.
//   There is nothing to scatter back to j, so the symmetric form costs no
//   partials beyond one number a block.
// * No rounding on the 16/clk pipe. d / box rounded to the nearest
//   integer is one FMA into the magic constant 1.5 * 2^23 and one
//   subtraction (exact for |d / box| < 2^22; the wrapper checks it),
//   where rintf is an FRND and K4's quotient adds two FMAs. It rounds
//   d * (1/box) unrounded, not the true quotient d / box: the two differ
//   only for a pair within an ulp of half a box, whose two images have
//   the same |d| to an ulp, so a potential term moves by an ulp (a force
//   would flip sign, which is why K4 keeps the quotient). r^2 is rounded
//   as the plain version rounds it, so the exclusion compare sees the
//   plain version's r^2. One rsqrt a pair is what is left on the SFUs.
// * Register blocking: a thread holds kPairRows i rows, so each j read
//   from shared memory feeds kPairRows pairs.
// * Deterministic: each row's terms over a tile summed in float32, times
//   m_i in float64 (the plain version rounds m_i m_j to float32 first:
//   with equal masses that offsets every term alike, 3.5e-8 of |U| on the
//   science run's final state), in float64 from there; the block's rows
//   reduced in float64
//   through shared memory in a fixed order, one partial a block; the
//   wrapper adds the partials with one torch.sum. No atomics: two calls
//   on one state give the same S bit for bit (the Layzer-Irvine ledger
//   differences U between samples).
//
// Bound: operations, n(n-1)/2 pairs at about 22 float operations and one
// rsqrt each (5e11 pairs at 1M particles).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // must equal ops/direct.THREADS
constexpr int kSymTile = 256;   // must equal ops/direct.SYM_TILE
constexpr int kSymWarps = kSymTile / 32;
constexpr int kPairThreads = 128;
constexpr int kPairRows = 4;     // i rows a thread
constexpr int kPairTile = kPairThreads * kPairRows;  // = ops/direct.PAIR_TILE
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

// d / box rounded as a true division rounds it, without dividing: with
// inv_box the correctly rounded 1/box, q = d * inv_box lies within about
// an ulp of the quotient, the remainder d - q * box is exact in one FMA,
// and q + remainder * inv_box rounds to the quotient (Markstein's
// correction, the last step of IEEE division in software): two FMAs,
// where __fdiv_rn adds a reciprocal on the SFUs and a slow-path branch.
__device__ __forceinline__ float quotient(float d, float box,
                                          float inv_box) {
  const float q = __fmul_rn(d, inv_box);
  return __fmaf_rn(__fmaf_rn(-q, box, d), inv_box, q);
}

// The minimum image of one component: d - box * rint(d / box). box * rint
// is exact for |rint| <= 2, so the FMA the subtraction contracts into
// rounds as the plain version's multiply and subtract.
__device__ __forceinline__ float wrap(float d, float box, float inv_box) {
  return d - box * rintf(quotient(d, box, inv_box));
}

template <bool kScaled, bool kPeriodic>
__global__ void direct_kernel(const float4* __restrict__ pts,
                              float* __restrict__ out, int n, float box,
                              float soft2, float oscale) {
  __shared__ float4 tile[kThreads];
  const float inv_box = __frcp_rn(box);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const float4 pi = i < n ? pts[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  float ax = 0.f, ay = 0.f, az = 0.f;

  for (int jbase = 0; jbase < n; jbase += kThreads) {
    const int j = jbase + threadIdx.x;
    __syncthreads();                     // the previous tile is consumed
    if (j < n) tile[threadIdx.x] = pts[j];
    __syncthreads();
    const int nt = min(kThreads, n - jbase);
    float tx = 0.f, ty = 0.f, tz = 0.f;  // this tile's sums
#pragma unroll 4
    for (int t = 0; t < nt; ++t) {
      const float4 p = tile[t];
      float dx = p.x - pi.x;
      float dy = p.y - pi.y;
      float dz = p.z - pi.z;
      if (kPeriodic) {
        if (kScaled) {
          dx -= rintf(dx);
          dy -= rintf(dy);
          dz -= rintf(dz);
        } else {
          dx = wrap(dx, box, inv_box);
          dy = wrap(dy, box, inv_box);
          dz = wrap(dz, box, inv_box);
        }
      }
      const float r2 = kScaled ? dx * dx + (dy * dy + (dz * dz + soft2))
                               : dx * dx + dy * dy + dz * dz + soft2;
      const float inv_r = rsqrtf(r2);
      const float w = p.w * (inv_r * inv_r * inv_r);
      tx += w * dx;
      ty += w * dy;
      tz += w * dz;
    }
    ax += tx;
    ay += ty;
    az += tz;
  }
  if (i < n) {
    out[3 * i] = ax * oscale;
    out[3 * i + 1] = ay * oscale;
    out[3 * i + 2] = az * oscale;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;                              // lane 0 holds the sum
}

// Partials are [slot][3][kSymTile]: row slot p * (half + 1) + k, column
// slot p * half + (k - 1) (targeting tile (p + k) mod P).
template <bool kPeriodic>
__global__ void direct_sym_pairs(const float4* __restrict__ pts,
                                 float* __restrict__ rowpart,
                                 float* __restrict__ colpart, int n,
                                 int ntiles, int half, float box,
                                 float soft2) {
  __shared__ float4 tile[kSymTile];
  __shared__ float colbuf[kSymWarps][3][kSymTile];
  const float inv_box = __frcp_rn(box);
  const int p = blockIdx.x / (half + 1);
  const int k = blockIdx.x % (half + 1);
  const int q = (p + k) % ntiles;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = p * kSymTile + tid;
  const bool active = i < n;
  const float4 pi = active ? pts[i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const int j = q * kSymTile + tid;
  if (j < n) tile[tid] = pts[j];
  __syncthreads();
  const int nt = max(0, min(kSymTile, n - q * kSymTile));

  float fx = 0.f, fy = 0.f, fz = 0.f;
  for (int t = 0; t < nt; ++t) {
    const float4 pj = tile[t];
    float dx = pj.x - pi.x;
    float dy = pj.y - pi.y;
    float dz = pj.z - pi.z;
    if (kPeriodic) {
      dx = wrap(dx, box, inv_box);
      dy = wrap(dy, box, inv_box);
      dz = wrap(dz, box, inv_box);
    }
    const float r2 = dx * dx + (dy * dy + (dz * dz + soft2));
    const float inv_r = rsqrtf(r2);
    const float w = active ? (pj.w * pi.w) * (inv_r * inv_r * inv_r) : 0.f;
    const float tx = w * dx, ty = w * dy, tz = w * dz;
    fx += tx;
    fy += ty;
    fz += tz;
    if (k > 0) {                         // uniform across the block
      const float cx = warp_sum(tx);
      const float cy = warp_sum(ty);
      const float cz = warp_sum(tz);
      if (lane == 0) {
        colbuf[warp][0][t] = cx;
        colbuf[warp][1][t] = cy;
        colbuf[warp][2][t] = cz;
      }
    }
  }
  float* row = rowpart + (long long)blockIdx.x * 3 * kSymTile;
  row[tid] = fx;
  row[kSymTile + tid] = fy;
  row[2 * kSymTile + tid] = fz;
  if (k > 0) {
    __syncthreads();
    float* col = colpart + ((long long)p * half + (k - 1)) * 3 * kSymTile;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float s = 0.f;
      if (tid < nt) {
#pragma unroll
        for (int w = 0; w < kSymWarps; ++w) s += colbuf[w][c][tid];
      }
      col[c * kSymTile + tid] = -s;
    }
  }
}

__global__ void direct_sym_reduce(const float4* __restrict__ pts,
                                  const float* __restrict__ rowpart,
                                  const float* __restrict__ colpart,
                                  float* __restrict__ out, int n,
                                  int ntiles, int half, float oscale) {
  const int t = blockIdx.x, tid = threadIdx.x;
  const int i = t * kSymTile + tid;
  if (i >= n) return;
  float f[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k <= half; ++k) {
    const float* row = rowpart + ((long long)t * (half + 1) + k) * 3
                                     * kSymTile;
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] += row[c * kSymTile + tid];
  }
  for (int k = 1; k <= half; ++k) {
    const int p = (t - k + ntiles) % ntiles;
    const float* col = colpart + ((long long)p * half + (k - 1)) * 3
                                     * kSymTile;
#pragma unroll
    for (int c = 0; c < 3; ++c) f[c] += col[c * kSymTile + tid];
  }
  const float m = pts[i].w;
  const float inv_m = m > 0.f ? 1.0f / m : 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) out[3 * i + c] = f[c] * inv_m * oscale;
}

// K9: the minimum image of one component, d - box * rint(d * (1/box)):
// the FMA rounds d * inv_box + kMagic once, to an integer plus kMagic.
__device__ __forceinline__ float wrap_magic(float d, float box,
                                            float inv_box) {
  const float r = __fsub_rn(__fmaf_rn(d, inv_box, kMagic), kMagic);
  return __fmaf_rn(-box, r, d);
}

// K9: rsqrtf without its guard for denormal input: the same MUFU.RSQ
// result for every normal r^2, one compare fewer a pair. Only a taken
// pair's result is used, and a taken r^2 exceeds eps^2 + 1e-30, a normal
// float; r^2 = 0 (coincident particles at softening 0) gives +inf, which
// the select drops.
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K9: rows of tile p against the staged tile; kDiag: the block's own
// tile, pairs j > i only.
template <bool kDiag>
__device__ __forceinline__ void pair_rows(const float4* tile, const float4* pi,
                                          float* ts, int tid, float box,
                                          float inv_box, float soft2,
                                          float thr) {
#pragma unroll 2
  for (int t = 0; t < kPairTile; ++t) {
    const float4 p = tile[t];
#pragma unroll
    for (int r = 0; r < kPairRows; ++r) {
      const float dx = wrap_magic(p.x - pi[r].x, box, inv_box);
      const float dy = wrap_magic(p.y - pi[r].y, box, inv_box);
      const float dz = wrap_magic(p.z - pi[r].z, box, inv_box);
      // rounded as the plain version's sum over the three components
      const float r2 = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dx, dx),
                                                     __fmul_rn(dy, dy)),
                                           __fmul_rn(dz, dz)), soft2);
      const bool take = kDiag ? (r2 > thr && t > r * kPairThreads + tid)
                              : r2 > thr;
      // select the rsqrt, not the mass: a left-out pair may have r2 = 0
      ts[r] = __fmaf_rn(p.w, take ? rsqrt_normal(r2) : 0.f, ts[r]);
    }
  }
}

// K9: one float64 partial of S per (p, k) block.
__global__ void __launch_bounds__(kPairThreads, 8)
pair_potential_kernel(const float4* __restrict__ pts,
                      double* __restrict__ partial, int n, int ntiles,
                      float box, float soft2, float thr) {
  __shared__ float4 tile[kPairTile];
  __shared__ double red[kPairThreads];
  const int half = (ntiles - 1) / 2;
  const int p = blockIdx.x / (half + 1);
  const int k = blockIdx.x % (half + 1);
  const int q = (p + k) % ntiles;
  const int tid = threadIdx.x;
  if (p * kPairTile >= n || q * kPairTile >= n) {  // the odd count's pad
    if (tid == 0) partial[blockIdx.x] = 0.0;
    return;
  }
  const float inv_box = __frcp_rn(box);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // padding rows and columns: mass 0 at the origin, terms exactly 0
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    const int j = q * kPairTile + r * kPairThreads + tid;
    tile[r * kPairThreads + tid] = j < n ? pts[j] : zero;
  }
  float4 pi[kPairRows];
  float ts[kPairRows];
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    const int i = p * kPairTile + r * kPairThreads + tid;
    pi[r] = i < n ? pts[i] : zero;
    ts[r] = 0.f;
  }
  __syncthreads();
  if (k == 0)
    pair_rows<true>(tile, pi, ts, tid, box, inv_box, soft2, thr);
  else
    pair_rows<false>(tile, pi, ts, tid, box, inv_box, soft2, thr);
  double total = 0.0;
#pragma unroll
  for (int r = 0; r < kPairRows; ++r)
    total += (double)pi[r].w * (double)ts[r];
  red[tid] = total;
  __syncthreads();
#pragma unroll
  for (int s = kPairThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] += red[tid + s];
    __syncthreads();
  }
  if (tid == 0) partial[blockIdx.x] = red[0];
}

}  // namespace

extern "C" int lcdm_direct(const float4* pts, float* out, int n,
                           int scaled, int periodic, float box, float soft2,
                           float oscale, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  cudaStream_t s = (cudaStream_t)stream;
  if (blocks > 0) {
    if (scaled && periodic)
      direct_kernel<true, true><<<blocks, kThreads, 0, s>>>(
          pts, out, n, box, soft2, oscale);
    else if (scaled)
      direct_kernel<true, false><<<blocks, kThreads, 0, s>>>(
          pts, out, n, box, soft2, oscale);
    else if (periodic)
      direct_kernel<false, true><<<blocks, kThreads, 0, s>>>(
          pts, out, n, box, soft2, oscale);
    else
      direct_kernel<false, false><<<blocks, kThreads, 0, s>>>(
          pts, out, n, box, soft2, oscale);
  }
  return (int)cudaGetLastError();
}

extern "C" int lcdm_direct_sym(const float4* pts, float* rowpart,
                               float* colpart, float* out, int n,
                               int ntiles, int periodic, float box,
                               float soft2, float oscale, void* stream) {
  const int half = (ntiles - 1) / 2;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0) return (int)cudaGetLastError();
  const int pair_blocks = ntiles * (half + 1);
  if (periodic)
    direct_sym_pairs<true><<<pair_blocks, kSymTile, 0, s>>>(
        pts, rowpart, colpart, n, ntiles, half, box, soft2);
  else
    direct_sym_pairs<false><<<pair_blocks, kSymTile, 0, s>>>(
        pts, rowpart, colpart, n, ntiles, half, box, soft2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  direct_sym_reduce<<<ntiles, kSymTile, 0, s>>>(pts, rowpart, colpart, out,
                                                n, ntiles, half, oscale);
  return (int)cudaGetLastError();
}

// partial: ntiles * ((ntiles - 1) / 2 + 1) doubles, ntiles odd
extern "C" int lcdm_pair_potential(const float4* pts, double* partial, int n,
                                   int ntiles, float box, float soft2,
                                   float thr, void* stream) {
  const int blocks = ntiles * ((ntiles - 1) / 2 + 1);
  if (n > 0 && blocks > 0)
    pair_potential_kernel<<<blocks, kPairThreads, 0, (cudaStream_t)stream>>>(
        pts, partial, n, ntiles, box, soft2, thr);
  return (int)cudaGetLastError();
}
