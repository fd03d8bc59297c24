// Fused composite-prior (TV + L1 + box) ADMM stencil, forward only.
//
// Replaces the TPU kernel `fused_admm_stencil_composite` /
// `_fwd_kernel_composite` of admm_deconv_tpu/ops/pallas/stencil_kernels.py,
// the whole non-FFT section of the composite solver's fast loop
// (ops/composite.py).  Templated on the prox mode and on the storage type of
// the duals and outputs (float or __nv_bfloat16).
//
// Per plane, circular in H and W, with the per-plane table
// (tau_tv, tau_l1, ratio = rho2 / rho1):
//   TV split, as the forward stencil (stencil_fwd.cu):
//     v1 = D x + u1;  z1 = prox(v1, tau_tv);  u1' = v1 - z1;  w = z1 - u1'
//     q1 = (wx - wx[:, c+1]) + (wy - wy[r+1, :])
//   identity split, elementwise:
//     v2 = x + u2;  z2 = clip(sign(v2) * max(|v2| - tau_l1, 0), lo, hi)
//     u2' = v2 - z2
//   q = q1 + ratio * (z2 - u2')
// and the kernel writes (q, ux', uy', u2'), each stored in the dual type.
// x is always fp32 and all arithmetic is fp32.
//
// What bounds it on an H100: memory bandwidth.  Each pixel needs x, ux, uy,
// u2 read once and q, ux', uy', u2' written once: 32 B per pixel with fp32
// duals, 4 + 3*2 + 4*2 = 18 B with bf16.  At the 1080p batch-4 solve's 12
// planes of 1080 x 1920 that is ~796 MB (fp32) or ~448 MB (bf16) per call,
// ~0.238 ms or ~0.134 ms at the data sheet's 3.35 TB/s.
//
// Design: the forward stencil's, one thread per output pixel: the TV split
// is recomputed at (r, c), (r, c+1) and (r+1, c) from x's pixel, upper, left
// and lower neighbours and the duals at the pixel and the one below (all but
// one read of each from L1/L2); the identity split reads u2 once.  Rows
// (N*H) ride gridDim.x, column blocks gridDim.y; offsets are 64-bit.
// Outputs go to fresh buffers: updating the duals in place would race with
// the neighbour threads that read ux[r, c+1] and uy[r+1, c].
//
// Build with --fmad=false: the plain torch version rounds after every
// operation, and contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include "prox_math.cuh"

namespace {

using namespace admm;

constexpr int kThreads = 256;

template <int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_composite_kernel(const float* __restrict__ x,
                             const T* __restrict__ ux,
                             const T* __restrict__ uy,
                             const T* __restrict__ u2,
                             const float* __restrict__ table,
                             T* __restrict__ q, T* __restrict__ ux_out,
                             T* __restrict__ uy_out, T* __restrict__ u2_out,
                             int h, int w, int has_bounds, float lo,
                             float hi) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= w) return;
  const int64_t row = blockIdx.x;  // plane * h + r
  const int64_t plane = row / h;
  const int r = static_cast<int>(row - plane * h);
  const int ra = r == 0 ? h - 1 : r - 1;
  const int rb = r == h - 1 ? 0 : r + 1;
  const int cl = c == 0 ? w - 1 : c - 1;
  const int cr = c == w - 1 ? 0 : c + 1;
  const int64_t base = plane * h * static_cast<int64_t>(w);
  const int64_t off_r = base + static_cast<int64_t>(r) * w;
  const int64_t off_a = base + static_cast<int64_t>(ra) * w;
  const int64_t off_b = base + static_cast<int64_t>(rb) * w;
  const float tau_tv = table[3 * plane];
  const float tau_l1 = table[3 * plane + 1];
  const float ratio = table[3 * plane + 2];

  float wx0, wy0, uxn0, uyn0;  // at (r, c): the pixel this thread writes
  tv_split_pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, c, cl,
                       tau_tv, wx0, wy0, uxn0, uyn0);
  float wx1, wy1, uxn1, uyn1;  // at (r, c+1): only wx is used
  tv_split_pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, cr, c,
                       tau_tv, wx1, wy1, uxn1, uyn1);
  float wx2, wy2, uxn2, uyn2;  // at (r+1, c): only wy is used
  tv_split_pixel<MODE>(x + off_b, x + off_r, ux + off_b, uy + off_b, c, cl,
                       tau_tv, wx2, wy2, uxn2, uyn2);
  const float q1 = (wx0 - wx1) + (wy0 - wy2);

  const int64_t i = off_r + c;
  const float v2 = x[i] + load_f32(u2 + i);
  float z2 = sign(v2) * fmaxf(fabsf(v2) - tau_l1, 0.f);
  if (has_bounds) z2 = fminf(fmaxf(z2, lo), hi);
  const float u2n = v2 - z2;

  store(q + i, q1 + ratio * (z2 - u2n));
  store(ux_out + i, uxn0);
  store(uy_out + i, uyn0);
  store(u2_out + i, u2n);
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const void* u2, const float* table, void* q, void* ux_out,
                   void* uy_out, void* u2_out, int64_t n, int h, int w,
                   int has_bounds, float lo, float hi, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n * h), (w + kThreads - 1) / kThreads);
  const T* a = static_cast<const T*>(ux);
  const T* b = static_cast<const T*>(uy);
  const T* c = static_cast<const T*>(u2);
  T* o0 = static_cast<T*>(q);
  T* o1 = static_cast<T*>(ux_out);
  T* o2 = static_cast<T*>(uy_out);
  T* o3 = static_cast<T*>(u2_out);
  switch (mode) {
    case kAniso:
      stencil_composite_kernel<kAniso, T><<<grid, kThreads, 0, stream>>>(
          x, a, b, c, table, o0, o1, o2, o3, h, w, has_bounds, lo, hi);
      break;
    case kIso:
      stencil_composite_kernel<kIso, T><<<grid, kThreads, 0, stream>>>(
          x, a, b, c, table, o0, o1, o2, o3, h, w, has_bounds, lo, hi);
      break;
    case kHard:
      stencil_composite_kernel<kHard, T><<<grid, kThreads, 0, stream>>>(
          x, a, b, c, table, o0, o1, o2, o3, h, w, has_bounds, lo, hi);
      break;
    case kGauss:
      stencil_composite_kernel<kGauss, T><<<grid, kThreads, 0, stream>>>(
          x, a, b, c, table, o0, o1, o2, o3, h, w, has_bounds, lo, hi);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the composite stencil on `stream` and returns cudaGetLastError()
// (0 on success).  `mode`: 0 aniso, 1 iso, 2 hard, 3 gauss.  `bf16`: 0 when
// the duals and outputs are float, 1 when they are __nv_bfloat16.  Every
// array is a contiguous (n, h, w) plane stack; `table` is a contiguous
// (n, 3) float array of (tau_tv, tau_l1, ratio).  With `has_bounds` 0 the
// box (lo, hi) is not applied.
int admm_stencil_composite(const void* x, const void* ux, const void* uy,
                           const void* u2, const void* table, void* q,
                           void* ux_out, void* uy_out, void* u2_out,
                           int64_t n, int h, int w, int mode, int bf16,
                           int has_bounds, float lo, float hi, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(table);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, u2, tp, q, ux_out, uy_out,
                                 u2_out, n, h, w, has_bounds, lo, hi, s);
  }
  return launch<float>(mode, xp, ux, uy, u2, tp, q, ux_out, uy_out, u2_out, n,
                       h, w, has_bounds, lo, hi, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
