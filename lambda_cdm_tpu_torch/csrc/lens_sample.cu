// K6/K7: periodic bilinear sampling of a lens plane's field stack, and the
// ray tracer's loop over the lens planes built on it.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_lens_sample.py
// _lens_sample_kernel (K6, via pallas_bilinear_sample) and
// _lens_sample_kernel_win (K7, via pallas_bilinear_sample_xwin). Both
// compute one function: for every ray r and channel f of fields [F, ng, ng]
// (y the fast axis, as field[ix, iy] in the JAX package),
//
//   g = xy[r] / extent * ng, v = g - 0.5, i0 = floor(v), (wx, wy) = v - i0,
//   out[f, r] = v00 (1 - wx)(1 - wy) + v10 wx (1 - wy)
//               + v01 (1 - wx) wy + v11 wx wy,
//   vab = fields[f, (i0x + a) mod ng, (i0y + b) mod ng].
//
// The kernel forms g itself, as the plain version's grid_coords does: a
// true division by the extent (a 0-d tensor there, IEEE division on the
// card; PyTorch's division by a Python scalar would multiply by the
// reciprocal), then the product by ng, each rounded on its own
// (__fdiv_rn, __fmul_rn: no FMA can move floor(v)); the weights are
// combined with __fmul_rn / __fadd_rn in the plain version's order, so the
// kernel equals it bit for bit. One launch a call.
//
// The trace (lcdm_lens_trace) runs raytracing/lensing.trace_rays's loop
// over the L lens planes for every ray in one launch, the ray's state
// (theta, kappa and the distortion matrix A) in registers; each plane l is
// the loop body (its plain version ops/lens_sample.plane_step_plain):
//
//   p = theta * chi_l (+ x_offset on x), wrapped into [0, box) by
//       torch.remainder's rule (fmod, plus box where the signs differ and
//       the remainder is nonzero) on the K6 route, unwrapped on K7's;
//   (ax, ay, dl[, uxx, uxy, uyy]) = the samples of plane l at p;
//   theta += -(ax, ay) / chi_l;  kappa += (dl w_l) d_chi;
//   A <- (I - U) A, U = [[uxx, uxy], [uxy, uyy]] (with the Jacobian);
//
// every product, quotient and sum rounded on its own in PyTorch's order
// (PyTorch runs each elementwise op as its own kernel, so nothing of the
// plain step is contracted). theta starts at theta0 (never written), kappa
// at 0, A at I; at the end the kernel writes the bundle: theta, beta =
// theta chi_s, kappa and, with the Jacobian, gamma, mu, omega and
// kappa_jac (ops/lens_sample.finish_plain). chi_l and w_l are read on the
// card from the planes' vectors: a trace is one launch and no host sync.
//
// Design. Everything else in the TPU kernels serves the MXU: the one-hot
// Wx @ fields GEMM, its bf16x3 split, the single-pass "fast" Hessian
// channels, the 2048-ray tile and K7's x window that shrinks the GEMM
// depth. On Hopper a gather costs O(1) a ray at any ng, so this is one
// thread per ray looping over the F channels, four __ldg loads a channel.
// K7's entry hands x unwrapped (any sign and magnitude): `unwrapped` takes
// the non-negative integer mod for every index; K6's entry promises
// g in [0, ng], where one compare wraps the index (any other value still
// takes the mod, so no input reads out of bounds). Output is [F, R],
// channel-major, so each channel's store is coalesced; on grid-ordered
// bundles (meshgrid 'ij') neighbouring rays read neighbouring y.
//
// Bound on the H100: bytes. Rays in (8 B), samples out (4F B) and the
// stack read once (4 F ng^2 B): 2.1 MB at R = 65,536, F = 3, ng = 256,
// 0.63 us at 3.35 TB/s; a trace reads theta0 and every plane's stack once
// and writes the bundle (20 or 44 B a ray). One plane's stack
// (0.8 MB at F = 3, 256^2; 3 MB at 512^2) stays in the 50 MB L2, so at
// these sizes a launch is bound by its latency (a few us), not by HBM.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int wrap_mod(int i, int ng) {
  return ((i % ng) + ng) % ng;
}

// i in [-1, ng] (K6's promise): one compare; anything else: the mod
__device__ __forceinline__ int wrap_near(int i, int ng) {
  if (i >= 0 && i < ng) return i;
  if (i == -1) return ng - 1;
  if (i == ng) return 0;
  return wrap_mod(i, ng);
}

// torch.remainder(a, b) on floats: fmod, then + b where the signs differ
// and the remainder is nonzero
__device__ __forceinline__ float torch_remainder(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.f && ((b < 0.f) != (m < 0.f))) m = __fadd_rn(m, b);
  return m;
}

// A scalar handed either as a pointer to a 0-d device tensor or by value
__device__ __forceinline__ float scalar(const float* p, float v) {
  return p != nullptr ? *p : v;
}

// The four corners and weights of one point in grid units g
struct Corners {
  long long r0, r1;   // row offsets (x) of the corners
  int y0, y1;
  float wx, wy, ux, uy;
};

template <bool kUnwrapped>
__device__ __forceinline__ Corners corners(float gx, float gy, int ng) {
  Corners c;
  const float vx = __fsub_rn(gx, 0.5f);
  const float vy = __fsub_rn(gy, 0.5f);
  const float fx = floorf(vx);
  const float fy = floorf(vy);
  c.wx = __fsub_rn(vx, fx);
  c.wy = __fsub_rn(vy, fy);
  const int ix = (int)fx;
  const int iy = (int)fy;
  int x0, x1;
  if (kUnwrapped) {
    x0 = wrap_mod(ix, ng);
    x1 = wrap_mod(ix + 1, ng);
    c.y0 = wrap_mod(iy, ng);
    c.y1 = wrap_mod(iy + 1, ng);
  } else {
    x0 = wrap_near(ix, ng);
    x1 = wrap_near(ix + 1, ng);
    c.y0 = wrap_near(iy, ng);
    c.y1 = wrap_near(iy + 1, ng);
  }
  c.ux = __fsub_rn(1.0f, c.wx);
  c.uy = __fsub_rn(1.0f, c.wy);
  c.r0 = (long long)x0 * ng;
  c.r1 = (long long)x1 * ng;
  return c;
}

// ((v00 (1-wx))(1-wy) + (v10 wx)(1-wy)) + (v01 (1-wx)) wy + (v11 wx) wy
__device__ __forceinline__ float sample(const float* __restrict__ fp,
                                        const Corners& c) {
  const float v00 = __ldg(fp + c.r0 + c.y0);
  const float v10 = __ldg(fp + c.r1 + c.y0);
  const float v01 = __ldg(fp + c.r0 + c.y1);
  const float v11 = __ldg(fp + c.r1 + c.y1);
  float s = __fadd_rn(__fmul_rn(__fmul_rn(v00, c.ux), c.uy),
                      __fmul_rn(__fmul_rn(v10, c.wx), c.uy));
  s = __fadd_rn(s, __fmul_rn(__fmul_rn(v01, c.ux), c.wy));
  return __fadd_rn(s, __fmul_rn(__fmul_rn(v11, c.wx), c.wy));
}

// xy / extent * ng, each step rounded on its own (grid_coords)
__device__ __forceinline__ float grid(float x, float extent, float fng) {
  return __fmul_rn(__fdiv_rn(x, extent), fng);
}

template <bool kUnwrapped>
__global__ void lens_sample_kernel(const float* __restrict__ fields,
                                   const float2* __restrict__ xy,
                                   const float* __restrict__ extent_p,
                                   float extent_v, float* __restrict__ out,
                                   int n_fields, int ng, int n_rays) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float extent = scalar(extent_p, extent_v);
  const float fng = (float)ng;
  const float2 p = xy[r];
  const Corners c = corners<kUnwrapped>(grid(p.x, extent, fng),
                                        grid(p.y, extent, fng), ng);
  const long long plane = (long long)ng * ng;
  for (int f = 0; f < n_fields; ++f)
    out[(long long)f * n_rays + r] = sample(fields + f * plane, c);
}

// The bundle a trace reads and writes (ray-major [R] vectors; theta0,
// theta, beta and gamma [R, 2] interleaved as PyTorch lays them out)
struct Bundle {
  const float2* theta0;   // the caller's initial angles (never written)
  float2* theta;          // the angles at the source plane
  float* kappa;
  float2* beta;           // theta chi_s
  float2* gamma;          // with the Jacobian
  float* mu;
  float* omega;
  float* kappa_jac;
};

template <bool kUnwrapped, bool kJacobian>
__global__ void lens_trace_kernel(const float* __restrict__ fields_l,
                                  int n_planes, int n_fields, int ng,
                                  const __grid_constant__ Bundle b,
                                  int n_rays,
                                  const float* __restrict__ chi_planes,
                                  const float* __restrict__ weights,
                                  const float* box_p, float box_v,
                                  const float* dchi_p, float dchi_v,
                                  const float* chis_p, float chis_v,
                                  float x_offset) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float box = scalar(box_p, box_v);
  const float dchi = scalar(dchi_p, dchi_v);
  const float fng = (float)ng;
  const long long plane_sz = (long long)ng * ng;
  float2 t = b.theta0[r];
  float k = 0.f;
  float a00 = 1.f, a01 = 0.f, a10 = 0.f, a11 = 1.f;
  for (int l = 0; l < n_planes; ++l) {
    const float* fields = fields_l + l * n_fields * plane_sz;
    const float chi = __ldg(chi_planes + l);
    float px = __fmul_rn(t.x, chi);
    float py = __fmul_rn(t.y, chi);
    if (x_offset != 0.f) px = __fadd_rn(px, x_offset);
    if (!kUnwrapped) {
      px = torch_remainder(px, box);
      py = torch_remainder(py, box);
    }
    const Corners c = corners<kUnwrapped>(grid(px, box, fng),
                                          grid(py, box, fng), ng);
    const float ax = sample(fields, c);
    const float ay = sample(fields + plane_sz, c);
    const float dl = sample(fields + 2 * plane_sz, c);
    // theta + (-(ax, ay) / chi_l); kappa + (dl * w_l) * d_chi
    t = make_float2(__fadd_rn(t.x, __fdiv_rn(-ax, chi)),
                    __fadd_rn(t.y, __fdiv_rn(-ay, chi)));
    k = __fadd_rn(k, __fmul_rn(__fmul_rn(dl, __ldg(weights + l)), dchi));
    if (kJacobian) {
      const float uxx = sample(fields + 3 * plane_sz, c);
      const float uxy = sample(fields + 4 * plane_sz, c);
      const float uyy = sample(fields + 5 * plane_sz, c);
      // a - (u a + u' a'), as trace_rays writes each entry
      const float n00 = __fsub_rn(a00, __fadd_rn(__fmul_rn(uxx, a00),
                                                 __fmul_rn(uxy, a10)));
      const float n01 = __fsub_rn(a01, __fadd_rn(__fmul_rn(uxx, a01),
                                                 __fmul_rn(uxy, a11)));
      const float n10 = __fsub_rn(a10, __fadd_rn(__fmul_rn(uxy, a00),
                                                 __fmul_rn(uyy, a10)));
      const float n11 = __fsub_rn(a11, __fadd_rn(__fmul_rn(uxy, a01),
                                                 __fmul_rn(uyy, a11)));
      a00 = n00;
      a01 = n01;
      a10 = n10;
      a11 = n11;
    }
  }
  b.theta[r] = t;
  b.kappa[r] = k;
  const float chis = scalar(chis_p, chis_v);
  b.beta[r] = make_float2(__fmul_rn(t.x, chis), __fmul_rn(t.y, chis));
  if (!kJacobian) return;
  // g1 = 0.5 (a11 - a00), g2 = -0.5 (a01 + a10), mu = 1 / det,
  // omega = 0.5 (a10 - a01), kappa_jac = 1 - 0.5 (a00 + a11)
  b.gamma[r] = make_float2(__fmul_rn(0.5f, __fsub_rn(a11, a00)),
                           __fmul_rn(-0.5f, __fadd_rn(a01, a10)));
  const float det = __fsub_rn(__fmul_rn(a00, a11), __fmul_rn(a01, a10));
  b.mu[r] = __fdiv_rn(1.0f, det);
  b.omega[r] = __fmul_rn(0.5f, __fsub_rn(a10, a01));
  b.kappa_jac[r] = __fsub_rn(1.0f, __fmul_rn(0.5f, __fadd_rn(a00, a11)));
}

}  // namespace

// xy [R, 2] raw points; extent: a 0-d device tensor (extent_p) or, when
// extent_p is null, the float32 value extent_v
extern "C" int lcdm_lens_sample(const float* fields, const float* xy,
                                const float* extent_p, float extent_v,
                                float* out, int n_fields, int ng,
                                int n_rays, int unwrapped, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    const float2* p = reinterpret_cast<const float2*>(xy);
    const cudaStream_t s = (cudaStream_t)stream;
    if (unwrapped)
      lens_sample_kernel<true><<<blocks, kThreads, 0, s>>>(
          fields, p, extent_p, extent_v, out, n_fields, ng, n_rays);
    else
      lens_sample_kernel<false><<<blocks, kThreads, 0, s>>>(
          fields, p, extent_p, extent_v, out, n_fields, ng, n_rays);
  }
  return (int)cudaGetLastError();
}

// The whole trace (see above): fields_l [L, F, ng, ng] (F >= 3, >= 6 with
// the Jacobian); theta0 / theta / beta / gamma [R, 2], the other vectors
// [R]; chi_planes and weights [L] on the card; box, d_chi and chi_s each a
// 0-d device tensor or (null pointer) a value; the K6 route (unwrapped 0)
// wraps the impact positions, the K7 route does not.
extern "C" int lcdm_lens_trace(const float* fields_l, int n_planes,
                               int n_fields, int ng, const float* theta0,
                               float* theta, float* kappa, float* beta,
                               float* gamma, float* mu, float* omega,
                               float* kappa_jac, int n_rays,
                               const float* chi_planes, const float* weights,
                               const float* box_p, float box_v,
                               const float* dchi_p, float dchi_v,
                               const float* chis_p, float chis_v,
                               float x_offset, int unwrapped, int jacobian,
                               void* stream) {
  if (n_rays > 0) {
    const Bundle b{reinterpret_cast<const float2*>(theta0),
                   reinterpret_cast<float2*>(theta), kappa,
                   reinterpret_cast<float2*>(beta),
                   reinterpret_cast<float2*>(gamma), mu, omega, kappa_jac};
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    const cudaStream_t s = (cudaStream_t)stream;
#define LCDM_TRACE(U, J)                                                     \
  lens_trace_kernel<U, J><<<blocks, kThreads, 0, s>>>(                       \
      fields_l, n_planes, n_fields, ng, b, n_rays, chi_planes, weights,      \
      box_p, box_v, dchi_p, dchi_v, chis_p, chis_v, x_offset)
    if (unwrapped && jacobian)
      LCDM_TRACE(true, true);
    else if (unwrapped)
      LCDM_TRACE(true, false);
    else if (jacobian)
      LCDM_TRACE(false, true);
    else
      LCDM_TRACE(false, false);
#undef LCDM_TRACE
  }
  return (int)cudaGetLastError();
}
