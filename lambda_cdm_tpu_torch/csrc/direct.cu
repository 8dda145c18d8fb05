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
// nothing; eps > 0 keeps it finite. The TPU kernel's [4, Np] lane layout,
// its padding to 2048-wide j tiles and its VMEM accumulator tiles are TPU
// workarounds and are not carried over.
//
// Design (the parent ran one thread per i, 128 a block: 84 blocks at
// direct_10k's 10,648 particles left 48 of the 132 SMs idle, and three
// FRND a pair on the 16/clk pipe):
//
// * Fill the card at small N. A block takes a tile of kTileRows i rows
//   against one of S slices of the j range (whole kJTile tiles), S =
//   ops/direct.j_slices(n): about TARGET_BLOCKS (11 an SM) blocks in all,
//   S = 1 from about 100k particles up. With S > 1 each block writes its
//   slice's sums to a [S, n, 3] partial buffer and a second kernel adds
//   them in slice order 0..S-1 and scales them; with S = 1 the block
//   writes the result.
//   No float atomics: two calls on one input give equal bytes.
// * Register blocking. Lane l of a warp holds the kRows rows l, l + 32,
//   l + 64, l + 96 of the tile; warp w takes j 32w..32w+31 of every
//   kJTile tile of the slice, staged by the warp itself in its own
//   32-slot shared buffer behind __syncwarp (the next sub-tile's load is
//   in flight while this one's pairs run), so each j read from shared
//   memory feeds kRows pairs and no block barrier stands in the j loop.
//   Each 32-j sub-tile is summed apart and then added to the warp's total
//   (on the H100 one float32 running sum over 1e5 pairs drifted 1.8e-5 of
//   the largest |a| from the plain tree reduction; the TPU kernel also
//   sums per tile); the block adds its four warps' totals in warp order
//   through shared memory. The ragged last tile is cut by its count, so
//   there is no zero-mass padding. The order differs from the parent's
//   (one thread per i over j in order), so the result is not the parent's
//   bytes, even at S = 1.
// * No FRND in the loop: rint(q) is (q + 1.5 * 2^23) - 1.5 * 2^23, two
//   FADDs rounded to nearest (the constant is even, so ties go to even, as
//   rintf sends them), exact for |q| < 2^22. The wrapper does not read the
//   positions back to check that (K4 runs once a step): each block tests
//   the positions it stages, and a position 2^21 boxes or more from the
//   origin -- the only way to reach |q| >= 2^22 -- sets a flag on the
//   device, which ops/direct.check_range reads where the caller already
//   synchronises (the engine's chunk end) and raises there.
// * The rsqrt skips rsqrtf's guard for denormal input: r^2 >= eps^2, a
//   normal float for any softening the solvers take.
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
// accelerations, each unordered pair evaluated once (Newton's third law):
// the pair force m_i m_j r^-3 d is added to row i and subtracted from
// column j, and each particle's sum is divided by its mass once at the end
// (zero mass gives 0). sym2 passes coordinates in box units with box = 1;
// the two variants are one kernel. The image is that of the true quotient,
// d - box * rint(d / box), as the plain version takes it.
//
// Design (the parent ran one block per (p, k) tile pair, one i row a
// thread, and reduced the three column forces of every pair over the
// warp: 15 SHFL and 15 FADD a lane a pair, 32 results a clock an SM on
// the shuffle pipe, about 9 of its 13.07 ms at 100k on the H100):
//
// * The TPU's half-matrix wrap as a schedule: tiles of kSymTile
//   particles, P of them, made odd, tile p against q = (p + k) mod P for
//   k = 0..(P-1)/2 covers every unordered tile pair once. A block takes
//   tile p against a run of consecutive k (ops/direct.sym_schedule:
//   ops/direct.sym_runs(n) runs a tile, about SYM_BLOCKS blocks in all;
//   at 100k 391 tiles x 26 runs = 10,166 blocks, 2 resident an SM).
// * Register blocking: each of the 8 warps holds the whole i tile, kSymRows
//   = 8 rows a lane (rows l, l + 32, ..., l + 224), and takes the 32
//   columns 32w..32w+31 of each j tile, staged by the warp itself in its
//   own shared buffer behind __syncwarp (the next tile's load in flight):
//   no block barrier in the run, and each column read feeds 8 pairs.
// * Column sums without per-pair reductions: at step s lane l takes
//   column (l + s) mod 32 and adds its 8 rows' terms to the three sums it
//   carries for that column; after the step every lane passes its sums to
//   lane l - 1 (3 SHFL a step, 8 pairs). After 32 steps lane c holds
//   column c's sums over the warp's 256 rows, added lane c, c - 1, ...,
//   c - 31 in turn, and writes them negated to the column partial of
//   (p, k). A column's sums are complete in one warp: nothing is reduced
//   across warps for columns.
// * Rows: each tile's 32 terms a row are summed apart, then added to the
//   run's total in registers; at the run's end the 8 warps' totals are
//   added in warp order through shared memory into one row partial a
//   (p, run). The diagonal block (k = 0) holds both orderings of each
//   pair: it adds rows only and writes no column partial.
// * Partials: rows [P runs][3][kSymTile], columns [P half][3][kSymTile]
//   (column slot p * half + k - 1, for tile (p + k) mod P). A second pass
//   (direct_sym_reduce, one thread a particle and component) adds, in this
//   order, the particle's row partials run by run, then its column
//   partials k = 1..half, divides by the mass and scales. No atomics: two
//   calls give equal bytes. A tile edge of 512 (the TPU's) would halve the
//   column partials (234 -> 117 MB at 100k, ~0.07 ms of traffic) but needs
//   2 x 8 rows a lane or a cross-warp column add every k; not taken.
// * The image without FRND or a quotient: for |d| below 1.5 boxes,
//   rint(d / box) is sign(d) when |d| exceeds T = the largest float whose
//   quotient by box rounds to at most 0.5, else 0 (the quotient is
//   monotone in d; its tie at 0.5 goes to even, 0). So d - box rint(d /
//   box) is one FMA, d - f copysign(box, d) with f = (|d| > T) in {0, 1}:
//   the bits of the quotient's image (ops/direct.image_thresholds computes
//   T on the host). A warp takes that path for a tile when every |d| it
//   can meet is at most T2 (the largest float whose quotient stays below
//   1.5): each lane tests its column against the i tile's bounds, which
//   the warp reduces once a block, and the warp votes. Otherwise (positions
//   spread over more than 1.5 boxes) it takes the quotient and rintf,
//   exact at any range. No range flag is needed.
// * rsqrt_normal: r^2 >= eps^2, a normal float for the solvers' softening.
//
// Bound on the H100: operations. The JAX package's cost estimates count 22
// float operations an ordered pair for K4 and 26 an unordered pair for K4s
// (an FMA as two), against 67 TFLOP/s of FP32: 1e10 ordered pairs at 100k
// particles is 3.28 ms for K4, 5e9 unordered pairs 1.94 ms for K4s. Bytes
// are small: 16 B a particle in, 12 B out, and K4s's partials (234 MB of
// columns at 100k, written and read once, ~0.14 ms). The Gram form of r^2
// that would put the pairs on the tensor cores loses the softened r^2 to
// cancellation in float32, so the pairs stay on the FP32 units, and what
// limits them is the issue rate, one warp instruction a clock a scheduler
// (132 x 128 lanes x 1.98 GHz = 3.35e13 lane instructions a second).
//
// K4s on the H100 80GB HBM3 at 700 W, 100k particles, softening 0.05
// (kernel_ab.py --only k4, the parent in the same call): 5.37 ms for sym
// and for sym2 (parent 13.08), of which the pair kernel 5.24 ms and the
// reduce 0.12 ms. Its fast loop (cuobjdump -sass, kernel_ab.py
// --sass-out) issues 223 instructions a step of 8 pairs, 27.9 a pair: 12
// FFMA (image 3, r^2 3, sums 6), 4 FMUL (w), 3 FADD (d), 3 FSET and 3
// LOP3 (image), 1 MUFU.RSQ, and the step's LDS.128, 3 SHFL and ~7 integer
// and branch instructions. 5e9 pairs x 27.9 in 5.24 ms is 2.66e13 a
// second, 79% of the issue rate. The step loop is not unrolled: unrolled
// twice (the same 27.9 a pair, a function half as large again) it read
// 5.71 ms, four times 5.48. Half the bound (3.88 ms) is out of reach for
// the exact image: the bound is 13 FP32 instructions a pair, the image
// alone is 9 and the column sums 3 more than a row-only sum, so even at
// the full issue rate 27.9 take 4.16 ms. The quotient with rintf read 7.38
// ms (FRND, a quarter-rate pipe, 3 a pair) and with the magic constant
// 7.20 ms (+9 FP32 a pair) against 5.70 for the threshold, the same
// bytes; sym2's d - rint(d) costs the same three instructions a component,
// so sym2 reads as sym.
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
//
// Cross forms (the multi-rank ring of parallel/sharded.py, whose JAX
// counterpart lambda_cdm_tpu/parallel/sharded.py runs each ring step as
// XLA: _partial_direct and the sharded_energy step body). K4 takes its n
// targets and its m sources as two arrays: the solver passes one array
// twice (the same loads from the same addresses, so the same bytes as
// before), the ring the rows a rank holds against the block it holds at
// this ring step. K9's cross form (pair_potential_cross_kernel) sums
// every ordered (target, source) pair of the two sets, n m pairs, with
// K9's arithmetic and exclusion guard; the symmetric kernel is untouched.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;    // a block of K4 (ops/direct.THREADS)
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;         // i rows a lane
constexpr int kTileRows = 32 * kRows;  // i rows a block (TILE_ROWS)
constexpr int kJTile = 128;      // j tile (= ops/direct.J_TILE), kWarps x 32
constexpr int kSymTile = 256;    // must equal ops/direct.SYM_TILE
constexpr int kSymThreads = 256;  // a block of K4s
constexpr int kSymWarps = kSymThreads / 32;
constexpr int kSymRows = kSymTile / 32;  // i rows a lane: a warp holds the tile
constexpr int kPairThreads = 128;
constexpr int kPairRows = 4;     // i rows a thread
constexpr int kPairTile = kPairThreads * kPairRows;  // = ops/direct.PAIR_TILE
constexpr float kMagic = 12582912.0f;  // 1.5 * 2^23

static_assert(kJTile == kWarps * 32, "a warp takes 32 j of each tile");
static_assert(kSymWarps * 32 == kSymTile,
              "K4s's warp w takes columns 32w..32w+31 of each j tile");

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

// rintf(q) for |q| < 2^22 without FRND: adding 1.5 * 2^23 rounds q to an
// integer (ties to even, the constant being even), subtracting it is exact
__device__ __forceinline__ float round_magic(float q) {
  return __fadd_rn(__fadd_rn(q, kMagic), -kMagic);
}

// The minimum image of one component: d - box * rint(d / box). box * rint
// is exact for |rint| <= 2, so the FMA the subtraction contracts into
// rounds as the plain version's multiply and subtract.
__device__ __forceinline__ float wrap(float d, float box, float inv_box) {
  return d - box * round_magic(quotient(d, box, inv_box));
}

// K4s's image: the same function with rintf, exact at any range
__device__ __forceinline__ float wrap_rint(float d, float box,
                                           float inv_box) {
  return d - box * rintf(quotient(d, box, inv_box));
}

// K4s's image for |d| <= T2 (see the design note): rint(d / box) is
// sign(d) (|d| > half_t), so the image is d - box or d + box rounded once,
// or d; fma(-1, s, d) rounds d - s once, fma(-0, s, d) is d. PTX set gives
// f as 1.0f or 0.0f in one FSET (a C ?: compiled to FSETP, SEL and an
// int-to-float conversion).
__device__ __forceinline__ float wrap_near(float d, float box,
                                           float half_t) {
  float f;
  asm("set.gt.f32.f32 %0, %1, %2;" : "=f"(f) : "f"(fabsf(d)), "f"(half_t));
  return __fmaf_rn(-f, copysignf(box, d), d);
}

// whether a staged position lies where round_magic may be inexact: every
// |x| < limit = 2^21 boxes keeps every |d / box| below 2^22
__device__ __forceinline__ bool out_of_range(float4 p, float limit) {
  return fabsf(p.x) >= limit || fabsf(p.y) >= limit || fabsf(p.z) >= limit;
}

// rsqrtf without its guard for denormal input: the same MUFU.RSQ result
// for every normal argument
__device__ __forceinline__ float rsqrt_normal(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// K4: block (i tile, j slice); see the design note above. The n targets
// are pts, the m sources src (the same array for the solver; the ring of
// parallel/sharded passes the block it holds). out: [n, 3] when nslices
// == 1, else partial [nslices, n, 3] (unscaled sums).
template <bool kScaled, bool kPeriodic>
__global__ void __launch_bounds__(kThreads, 6)
direct_kernel(const float4* __restrict__ pts, const float4* __restrict__ src,
              float* __restrict__ out, int* __restrict__ flag, int n, int m,
              int nslices, float box, float soft2, float oscale,
              float limit) {
  __shared__ float4 tiles[kWarps][32];
  __shared__ float sums[kWarps][3][kTileRows];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float inv_box = __frcp_rn(box);
  const int i0 = blockIdx.x * kTileRows;
  const int ntj = (m + kJTile - 1) / kJTile;
  const int s = blockIdx.y;
  const int j0 = (int)((long long)s * ntj / nslices) * kJTile;
  const int j1 = min(m, (int)((long long)(s + 1) * ntj / nslices) * kJTile);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 pi[kRows];
  float ax[kRows], ay[kRows], az[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = i0 + 32 * r + lane;
    pi[r] = i < n ? pts[i] : zero;
    ax[r] = ay[r] = az[r] = 0.f;
  }
  float4* tile = tiles[warp];
  bool bad = false;
  int jb = j0 + 32 * warp;               // this warp's sub-tile of each tile
  float4 next = jb + lane < j1 ? src[jb + lane] : zero;
  for (; jb < j1; jb += kJTile) {
    const int nt = min(32, j1 - jb);
    if (kPeriodic) bad |= out_of_range(next, limit);
    tile[lane] = next;
    __syncwarp();
    const int jn = jb + kJTile + lane;
    next = jn < j1 ? src[jn] : zero;
    float tx[kRows], ty[kRows], tz[kRows];  // this sub-tile's sums
#pragma unroll
    for (int r = 0; r < kRows; ++r) tx[r] = ty[r] = tz[r] = 0.f;
#pragma unroll 2
    for (int t = 0; t < nt; ++t) {
      const float4 p = tile[t];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float dx = p.x - pi[r].x;
        float dy = p.y - pi[r].y;
        float dz = p.z - pi[r].z;
        if (kPeriodic) {
          if (kScaled) {
            dx -= round_magic(dx);
            dy -= round_magic(dy);
            dz -= round_magic(dz);
          } else {
            dx = wrap(dx, box, inv_box);
            dy = wrap(dy, box, inv_box);
            dz = wrap(dz, box, inv_box);
          }
        }
        const float r2 = kScaled ? dx * dx + (dy * dy + (dz * dz + soft2))
                                 : dx * dx + dy * dy + dz * dz + soft2;
        const float inv_r = rsqrt_normal(r2);
        const float w = p.w * (inv_r * inv_r * inv_r);
        tx[r] += w * dx;
        ty[r] += w * dy;
        tz[r] += w * dz;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      ax[r] += tx[r];
      ay[r] += ty[r];
      az[r] += tz[r];
    }
    __syncwarp();                        // the sub-tile is consumed
  }
  if (kPeriodic && __any_sync(full, bad) && lane == 0) *flag = 1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    sums[warp][0][32 * r + lane] = ax[r];
    sums[warp][1][32 * r + lane] = ay[r];
    sums[warp][2][32 * r + lane] = az[r];
  }
  __syncthreads();
  // warp w adds the four warps' totals of rows 32w..32w+31 in warp order
  const int row = 32 * warp + lane;
  const int i = i0 + row;
  if (i >= n) return;
  float* dst = nslices == 1 ? out + 3 * (long long)i
                            : out + 3 * ((long long)s * n + i);
  const float scale = nslices == 1 ? oscale : 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = sums[0][c][row];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sums[w][c][row];
    dst[c] = v * scale;
  }
}

// K4's second pass (S > 1): the slices' sums of each output float, added
// in slice order and scaled
__global__ void direct_reduce(const float* __restrict__ partial,
                              float* __restrict__ out, int n3, int nslices,
                              float oscale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n3) return;
  float v = partial[k];
  for (int s = 1; s < nslices; ++s) v += partial[(long long)s * n3 + k];
  out[k] = v * oscale;
}

// K4s: one pair's terms with the image kImg (0 none, 1 wrap_near, 2
// wrap_rint): the row's sums take +w d, the column's kCols sums too (the
// column partial is written negated)
template <int kImg, bool kCols>
__device__ __forceinline__ void sym_pair(float4 pj, float4 pi, float box,
                                         float inv_box, float soft2,
                                         float half_t, float& tx, float& ty,
                                         float& tz, float& cx, float& cy,
                                         float& cz) {
  float dx = pj.x - pi.x;
  float dy = pj.y - pi.y;
  float dz = pj.z - pi.z;
  if (kImg == 1) {
    dx = wrap_near(dx, box, half_t);
    dy = wrap_near(dy, box, half_t);
    dz = wrap_near(dz, box, half_t);
  } else if (kImg == 2) {
    dx = wrap_rint(dx, box, inv_box);
    dy = wrap_rint(dy, box, inv_box);
    dz = wrap_rint(dz, box, inv_box);
  }
  const float r2 = dx * dx + (dy * dy + (dz * dz + soft2));
  const float inv_r = rsqrt_normal(r2);
  const float w = (pj.w * pi.w) * (inv_r * inv_r * inv_r);
  tx = __fmaf_rn(w, dx, tx);
  ty = __fmaf_rn(w, dy, ty);
  tz = __fmaf_rn(w, dz, tz);
  if (kCols) {
    cx = __fmaf_rn(w, dx, cx);
    cy = __fmaf_rn(w, dy, cy);
    cz = __fmaf_rn(w, dz, cz);
  }
}

// K4s: the warp's 8 rows a lane against its 32 staged columns. kCols
// (k >= 1): lane l takes column (l + s) mod 32 at step s and passes its
// column sums to lane l - 1 after it (see the design note); the diagonal
// block (!kCols) runs its nt real columns in order, rows only.
struct SymArgs {
  const float4* tile;                    // the warp's 32 staged columns
  const float4* pi;                      // the lane's kSymRows rows
  int lane, nt;                          // nt: real columns (!kCols)
  float box, inv_box, soft2, half_t;
};

template <int kImg, bool kCols>
__device__ __forceinline__ void sym_sub_tile(const SymArgs& a, float* tx,
                                             float* ty, float* tz, float& cx,
                                             float& cy, float& cz) {
  const unsigned full = 0xffffffffu;
  if (kCols) {
    const int src = (a.lane + 1) & 31;
#pragma unroll 1                     // see the design note
    for (int s = 0; s < 32; ++s) {
      const float4 pj = a.tile[(a.lane + s) & 31];
#pragma unroll
      for (int r = 0; r < kSymRows; ++r)
        sym_pair<kImg, true>(pj, a.pi[r], a.box, a.inv_box, a.soft2,
                             a.half_t, tx[r], ty[r], tz[r], cx, cy, cz);
      cx = __shfl_sync(full, cx, src);
      cy = __shfl_sync(full, cy, src);
      cz = __shfl_sync(full, cz, src);
    }
  } else {
#pragma unroll 2
    for (int t = 0; t < a.nt; ++t) {
      const float4 pj = a.tile[t];
#pragma unroll
      for (int r = 0; r < kSymRows; ++r)
        sym_pair<kImg, false>(pj, a.pi[r], a.box, a.inv_box, a.soft2,
                              a.half_t, tx[r], ty[r], tz[r], cx, cy, cz);
    }
  }
}

// K4s: block (p, run) of ops/direct.sym_schedule; see the design note.
// rowpart [P runs][3][kSymTile], colpart [P half][3][kSymTile].
template <bool kPeriodic>
__global__ void __launch_bounds__(kSymThreads, 2)
direct_sym_pairs(const float4* __restrict__ pts, float* __restrict__ rowpart,
                 float* __restrict__ colpart, int n, int ntiles, int runs,
                 float box, float soft2, float half_t, float span_t) {
  __shared__ float4 stage[kSymWarps][32];
  __shared__ float sums[kSymWarps][3][kSymTile];
  const unsigned full = 0xffffffffu;
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = (ntiles - 1) / 2;
  const int p = blockIdx.x / runs, run = blockIdx.x % runs;
  const int i0 = p * kSymTile;
  if (i0 >= n) return;                  // the odd count's pad tile
  const int k0 = (int)((long long)run * (half + 1) / runs);
  const int k1 = (int)((long long)(run + 1) * (half + 1) / runs);
  const float inv_box = __frcp_rn(box);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // the i tile (every warp holds all of it; padding rows: mass 0 at the
  // origin, terms exactly 0) and its real rows' bounds
  float4 pi[kSymRows];
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  float ax[kSymRows], ay[kSymRows], az[kSymRows];
#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    const int i = i0 + 32 * r + lane;
    pi[r] = i < n ? pts[i] : zero;
    ax[r] = ay[r] = az[r] = 0.f;
    if (i < n) {
      lo[0] = fminf(lo[0], pi[r].x); hi[0] = fmaxf(hi[0], pi[r].x);
      lo[1] = fminf(lo[1], pi[r].y); hi[1] = fmaxf(hi[1], pi[r].y);
      lo[2] = fminf(lo[2], pi[r].z); hi[2] = fmaxf(hi[2], pi[r].z);
    }
  }
  if (kPeriodic) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        lo[c] = fminf(lo[c], __shfl_xor_sync(full, lo[c], off));
        hi[c] = fmaxf(hi[c], __shfl_xor_sync(full, hi[c], off));
      }
    }
  }
  float4* tile = stage[warp];
  int q = (p + k0) % ntiles;
  int j = q * kSymTile + 32 * warp + lane;
  float4 next = j < n ? pts[j] : zero;   // padding columns: mass 0
  for (int k = k0; k < k1; ++k) {
    const int jb = q * kSymTile + 32 * warp;  // this warp's columns
    const float4 pj = next;
    tile[lane] = pj;
    __syncwarp();
    const int qn = q + 1 == ntiles ? 0 : q + 1;
    if (k + 1 < k1) {
      j = qn * kSymTile + 32 * warp + lane;
      next = j < n ? pts[j] : zero;
    }
    const int nt = min(32, n - jb);
    if (nt > 0) {                        // uniform across the warp
      // the near image holds where every |d| this column meets is at most
      // span_t; padding columns add nothing either way
      const bool near = !kPeriodic || jb + lane >= n ||
          (fmaxf(hi[0] - pj.x, pj.x - lo[0]) <= span_t &&
           fmaxf(hi[1] - pj.y, pj.y - lo[1]) <= span_t &&
           fmaxf(hi[2] - pj.z, pj.z - lo[2]) <= span_t);
      const bool exact = kPeriodic && !__all_sync(full, near);
      float tx[kSymRows], ty[kSymRows], tz[kSymRows];  // this tile's sums
#pragma unroll
      for (int r = 0; r < kSymRows; ++r) tx[r] = ty[r] = tz[r] = 0.f;
      float cx = 0.f, cy = 0.f, cz = 0.f;
      const SymArgs a{tile, pi, lane, nt, box, inv_box, soft2, half_t};
      if (k == 0) {                      // the diagonal block: rows only
        if (!kPeriodic)
          sym_sub_tile<0, false>(a, tx, ty, tz, cx, cy, cz);
        else if (!exact)
          sym_sub_tile<1, false>(a, tx, ty, tz, cx, cy, cz);
        else
          sym_sub_tile<2, false>(a, tx, ty, tz, cx, cy, cz);
      } else {
        if (!kPeriodic)
          sym_sub_tile<0, true>(a, tx, ty, tz, cx, cy, cz);
        else if (!exact)
          sym_sub_tile<1, true>(a, tx, ty, tz, cx, cy, cz);
        else
          sym_sub_tile<2, true>(a, tx, ty, tz, cx, cy, cz);
        float* col = colpart + ((long long)p * half + (k - 1)) * 3 * kSymTile
                     + 32 * warp + lane;
        col[0] = -cx;
        col[kSymTile] = -cy;
        col[2 * kSymTile] = -cz;
      }
#pragma unroll
      for (int r = 0; r < kSymRows; ++r) {
        ax[r] += tx[r];
        ay[r] += ty[r];
        az[r] += tz[r];
      }
    }
    __syncwarp();                        // the staged columns are consumed
    q = qn;
  }
  // the run's row partial: the warps' totals of each row in warp order
#pragma unroll
  for (int r = 0; r < kSymRows; ++r) {
    sums[warp][0][32 * r + lane] = ax[r];
    sums[warp][1][32 * r + lane] = ay[r];
    sums[warp][2][32 * r + lane] = az[r];
  }
  __syncthreads();
  const int row = threadIdx.x;
  float* dst = rowpart + ((long long)p * runs + run) * 3 * kSymTile + row;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float v = sums[0][c][row];
#pragma unroll
    for (int w = 1; w < kSymWarps; ++w) v += sums[w][c][row];
    dst[c * kSymTile] = v;
  }
}

// K4s's second pass, one thread a particle i of tile t and component c
// (blockIdx.y): its row partials in run order, then its column partials
// k = 1..half (written by tile (t - k) mod P, the pad tile writing none),
// divided by the mass (0 for zero mass) and scaled
__global__ void direct_sym_reduce(const float4* __restrict__ pts,
                                  const float* __restrict__ rowpart,
                                  const float* __restrict__ colpart,
                                  float* __restrict__ out, int n,
                                  int ntiles, int runs, float oscale) {
  const int t = blockIdx.x, c = blockIdx.y, tid = threadIdx.x;
  const int i = t * kSymTile + tid;
  if (i >= n) return;
  const int half = (ntiles - 1) / 2;
  const float* row = rowpart + (long long)t * runs * 3 * kSymTile
                     + c * kSymTile + tid;
  float f = 0.f;
  for (int r = 0; r < runs; ++r) f += row[(long long)r * 3 * kSymTile];
  const float* col = colpart + c * kSymTile + tid;
#pragma unroll 4
  for (int k = 1; k <= half; ++k) {
    const int p = t >= k ? t - k : t - k + ntiles;
    if (p * kSymTile < n)
      f += col[((long long)p * half + (k - 1)) * 3 * kSymTile];
  }
  const float m = pts[i].w;
  const float inv_m = m > 0.f ? 1.0f / m : 0.f;
  out[3 * i + c] = f * inv_m * oscale;
}

// K9: the minimum image of one component, d - box * rint(d * (1/box)):
// the FMA rounds d * inv_box + kMagic once, to an integer plus kMagic.
__device__ __forceinline__ float wrap_magic(float d, float box,
                                            float inv_box) {
  const float r = __fsub_rn(__fmaf_rn(d, inv_box, kMagic), kMagic);
  return __fmaf_rn(-box, r, d);
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
      // rsqrt_normal: a taken r2 exceeds eps^2 + 1e-30, a normal float;
      // r2 = 0 (coincident particles at softening 0) gives +inf, dropped
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

// K9's cross form: S = sum over every ordered pair (i target, j source)
// of m_i m_j (r^2)^(-1/2), pairs with r^2 <= thr left out, the per-step
// sum of the ring energy (parallel/sharded.sharded_energy; the JAX ring's
// guard r2 <= soft2 + 1e-30). Block (p, q): target tile p against source
// tile q, every pair (there is no half-matrix to take: the two sets
// differ); one float64 partial a block, summed as the symmetric form
// sums its block.
__global__ void __launch_bounds__(kPairThreads, 8)
pair_potential_cross_kernel(const float4* __restrict__ pts,
                            const float4* __restrict__ src,
                            double* __restrict__ partial, int n, int m,
                            float box, float soft2, float thr) {
  __shared__ float4 tile[kPairTile];
  __shared__ double red[kPairThreads];
  const int tq = (m + kPairTile - 1) / kPairTile;
  const int p = blockIdx.x / tq;
  const int q = blockIdx.x % tq;
  const int tid = threadIdx.x;
  const float inv_box = __frcp_rn(box);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  // padding rows and columns: mass 0 at the origin, terms exactly 0
#pragma unroll
  for (int r = 0; r < kPairRows; ++r) {
    const int j = q * kPairTile + r * kPairThreads + tid;
    tile[r * kPairThreads + tid] = j < m ? src[j] : zero;
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

// K4: n targets pts, m sources src (src == pts, m == n for the solver);
// nslices = ops/direct.j_slices(n, m); partial: [nslices, n, 3] floats
// when nslices > 1 (unused otherwise); flag: one int the kernel sets to 1
// when a staged source lies at or past limit (periodic only)
extern "C" int lcdm_direct(const float4* pts, const float4* src, float* out,
                           float* partial, int* flag, int n, int m,
                           int nslices, int scaled, int periodic, float box,
                           float soft2, float oscale, float limit,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 0 || nslices < 1) return (int)cudaGetLastError();
  if (m <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n + kTileRows - 1) / kTileRows, nslices);
  float* dst = nslices == 1 ? out : partial;
  if (scaled && periodic)
    direct_kernel<true, true><<<grid, kThreads, 0, s>>>(
        pts, src, dst, flag, n, m, nslices, box, soft2, oscale, limit);
  else if (scaled)
    direct_kernel<true, false><<<grid, kThreads, 0, s>>>(
        pts, src, dst, flag, n, m, nslices, box, soft2, oscale, limit);
  else if (periodic)
    direct_kernel<false, true><<<grid, kThreads, 0, s>>>(
        pts, src, dst, flag, n, m, nslices, box, soft2, oscale, limit);
  else
    direct_kernel<false, false><<<grid, kThreads, 0, s>>>(
        pts, src, dst, flag, n, m, nslices, box, soft2, oscale, limit);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nslices == 1) return (int)err;
  direct_reduce<<<(3 * n + 255) / 256, 256, 0, s>>>(partial, out, 3 * n,
                                                   nslices, oscale);
  return (int)cudaGetLastError();
}

// K4s: ntiles = ops/direct.sym_tiles(n) (odd), runs = sym_runs(n) runs of
// k a tile; rowpart [ntiles runs][3][kSymTile] and colpart [ntiles half][3]
// [kSymTile] floats; half_t and span_t from ops/direct.image_thresholds
extern "C" int lcdm_direct_sym(const float4* pts, float* rowpart,
                               float* colpart, float* out, int n,
                               int ntiles, int runs, int periodic, float box,
                               float soft2, float oscale, float half_t,
                               float span_t, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (ntiles < 1 || ntiles % 2 == 0 || runs < 1 || runs > (ntiles + 1) / 2)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = ntiles * runs;
  if (periodic)
    direct_sym_pairs<true><<<blocks, kSymThreads, 0, s>>>(
        pts, rowpart, colpart, n, ntiles, runs, box, soft2, half_t, span_t);
  else
    direct_sym_pairs<false><<<blocks, kSymThreads, 0, s>>>(
        pts, rowpart, colpart, n, ntiles, runs, box, soft2, half_t, span_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  direct_sym_reduce<<<dim3(ntiles, 3), kSymTile, 0, s>>>(
      pts, rowpart, colpart, out, n, ntiles, runs, oscale);
  return (int)cudaGetLastError();
}

// src == nullptr: the symmetric sum over the n particles pts, each
// unordered pair once; partial: ntiles * ((ntiles - 1) / 2 + 1) doubles,
// ntiles odd. Otherwise the cross form: n targets pts against m sources
// src, every ordered pair; ntiles = ceil(n / kPairTile) target tiles,
// partial: ntiles * ceil(m / kPairTile) doubles.
extern "C" int lcdm_pair_potential(const float4* pts, const float4* src,
                                   double* partial, int n, int m, int ntiles,
                                   float box, float soft2, float thr,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (src == nullptr) {
    const int blocks = ntiles * ((ntiles - 1) / 2 + 1);
    if (n > 0 && blocks > 0)
      pair_potential_kernel<<<blocks, kPairThreads, 0, s>>>(
          pts, partial, n, ntiles, box, soft2, thr);
    return (int)cudaGetLastError();
  }
  if (ntiles != (n + kPairTile - 1) / kPairTile) return (int)cudaErrorInvalidValue;
  const int blocks = ntiles * ((m + kPairTile - 1) / kPairTile);
  if (n > 0 && m > 0)
    pair_potential_cross_kernel<<<blocks, kPairThreads, 0, s>>>(
        pts, src, partial, n, m, box, soft2, thr);
  return (int)cudaGetLastError();
}
