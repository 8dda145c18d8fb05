// K6/K7: periodic bilinear sampling of a lens plane's field stack.
//
// Replaces the TPU kernels lambda_cdm_tpu/ops/pallas_lens_sample.py
// _lens_sample_kernel (K6, via pallas_bilinear_sample) and
// _lens_sample_kernel_win (K7, via pallas_bilinear_sample_xwin). Both
// compute one function: for every ray r and channel f of fields [F, ng, ng]
// (y the fast axis, as field[ix, iy] in the JAX package),
//
//   v = g[r] - 0.5, i0 = floor(v), (wx, wy) = v - i0,
//   out[f, r] = v00 (1 - wx)(1 - wy) + v10 wx (1 - wy)
//               + v01 (1 - wx) wy + v11 wx wy,
//   vab = fields[f, (i0x + a) mod ng, (i0y + b) mod ng],
//
// where g = xy / extent * ng are the rays' grid coordinates, computed by
// the wrapper (ops/lens_sample.py) as the plain version computes them.
// The kernel only subtracts 0.5 (exact), so no FMA can move floor(v); the
// weights are combined with __fmul_rn / __fadd_rn in the plain version's
// order, so the kernel equals it bit for bit.
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
// 0.63 us at 3.35 TB/s; one plane's stack (0.8 MB at F = 3, 256^2; 3 MB
// at 512^2) stays in the 50 MB L2, so at these sizes a launch is bound by
// its latency (a few us), not by HBM.

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

template <bool kUnwrapped>
__global__ void lens_sample_kernel(const float* __restrict__ fields,
                                   const float2* __restrict__ g,
                                   float* __restrict__ out, int n_fields,
                                   int ng, int n_rays) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays) return;
  const float2 p = g[r];
  const float vx = __fsub_rn(p.x, 0.5f);
  const float vy = __fsub_rn(p.y, 0.5f);
  const float fx = floorf(vx);
  const float fy = floorf(vy);
  const float wx = __fsub_rn(vx, fx);
  const float wy = __fsub_rn(vy, fy);
  const int ix = (int)fx;
  const int iy = (int)fy;
  int x0, x1, y0, y1;
  if (kUnwrapped) {
    x0 = wrap_mod(ix, ng);
    x1 = wrap_mod(ix + 1, ng);
    y0 = wrap_mod(iy, ng);
    y1 = wrap_mod(iy + 1, ng);
  } else {
    x0 = wrap_near(ix, ng);
    x1 = wrap_near(ix + 1, ng);
    y0 = wrap_near(iy, ng);
    y1 = wrap_near(iy + 1, ng);
  }
  const float ux = __fsub_rn(1.0f, wx);
  const float uy = __fsub_rn(1.0f, wy);
  const long long plane = (long long)ng * ng;
  const long long r0 = (long long)x0 * ng, r1 = (long long)x1 * ng;
  for (int f = 0; f < n_fields; ++f) {
    const float* fp = fields + f * plane;
    const float v00 = __ldg(fp + r0 + y0);
    const float v10 = __ldg(fp + r1 + y0);
    const float v01 = __ldg(fp + r0 + y1);
    const float v11 = __ldg(fp + r1 + y1);
    // ((v00 (1-wx))(1-wy) + (v10 wx)(1-wy)) + (v01 (1-wx)) wy + (v11 wx) wy
    float s = __fadd_rn(__fmul_rn(__fmul_rn(v00, ux), uy),
                        __fmul_rn(__fmul_rn(v10, wx), uy));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(v01, ux), wy));
    s = __fadd_rn(s, __fmul_rn(__fmul_rn(v11, wx), wy));
    out[(long long)f * n_rays + r] = s;
  }
}

}  // namespace

extern "C" int lcdm_lens_sample(const float* fields, const float* g,
                                float* out, int n_fields, int ng,
                                int n_rays, int unwrapped, void* stream) {
  if (n_rays > 0) {
    const int blocks = (n_rays + kThreads - 1) / kThreads;
    const float2* g2 = reinterpret_cast<const float2*>(g);
    if (unwrapped) {
      lens_sample_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
          fields, g2, out, n_fields, ng, n_rays);
    } else {
      lens_sample_kernel<false><<<blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(
          fields, g2, out, n_fields, ng, n_rays);
    }
  }
  return (int)cudaGetLastError();
}
