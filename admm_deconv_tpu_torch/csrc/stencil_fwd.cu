// Fused ADMM stencil, forward: D -> prox -> dual ascent -> D^T in one pass.
//
// Replaces the TPU kernels behind `fused_admm_stencil` and
// `fused_admm_stencil_mixed` in admm_deconv_tpu/ops/pallas/stencil_kernels.py:
// the blocked `_fwd_kernel` (called from `_fwd_pallas`) and the manual-DMA
// `_fwd_kernel_dma` / `_fwd_dma_body` (called from `_fwd_pallas_dma`), both
// built on `_stencil_math`.  One kernel covers both, templated on the prox
// mode and on the storage type of the duals (float or __nv_bfloat16).
//
// Per plane, circular in H and W:
//   vx = x - x[:, c-1] + ux,  vy = x - x[r-1, :] + uy
//   z  = prox(v, tau);  u' = v - z;  w = z - u'
//   q  = (wx - wx[:, c+1]) + (wy - wy[r+1, :])
// and the kernel writes (q, ux', uy').  x is always fp32, all arithmetic is
// fp32, and q, ux', uy' are stored in the dual type (bf16 with
// round-to-nearest-even, as torch and JAX round).
//
// What bounds it on an H100: memory bandwidth.  Each pixel needs at least
// x, ux, uy read once and q, ux', uy' written once: 24 B per pixel with fp32
// duals, 14 B with bf16 duals.  At the 1080p batch-4 shape (12 planes of
// 1080 x 1920) that is ~597 MB (fp32) or ~348 MB (bf16) per call, so
// ~0.18 ms or ~0.10 ms at the data sheet's 3.35 TB/s.  A few FLOPs per
// byte put it far below the compute roof.
//
// Design: one thread per output pixel.  The thread recomputes v at
// (r, c), (r, c+1) and (r+1, c): 7 reads of x and 3 each of ux and uy, of
// which all but one of each come from L1/L2 because neighbouring threads
// and row blocks read the same lines.  Rows (N*H) ride gridDim.x, column
// blocks gridDim.y; offsets are 64-bit.  Outputs go to fresh buffers: the
// TPU kernel updates ux/uy in place, which on a GPU would race with the
// neighbour threads that read ux[r, c+1] and uy[r+1, c].
//
// Build with --fmad=false: the plain torch version rounds after every
// operation, and contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include "prox_math.cuh"

namespace {

using namespace admm;

template <int MODE, typename T>
__global__ void stencil_fwd_kernel(const float* __restrict__ x,
                                   const T* __restrict__ ux,
                                   const T* __restrict__ uy,
                                   const float* __restrict__ tau,
                                   T* __restrict__ q, T* __restrict__ ux_out,
                                   T* __restrict__ uy_out, int h, int w) {
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
  const float t = tau[plane];

  float wx0, wy0, uxn0, uyn0;  // at (r, c): the pixel this thread writes
  tv_split_pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, c, cl, t,
                       wx0, wy0, uxn0, uyn0);
  float wx1, wy1, uxn1, uyn1;  // at (r, c+1): only wx is used
  tv_split_pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, cr, c, t,
                       wx1, wy1, uxn1, uyn1);
  float wx2, wy2, uxn2, uyn2;  // at (r+1, c): only wy is used
  tv_split_pixel<MODE>(x + off_b, x + off_r, ux + off_b, uy + off_b, c, cl, t,
                       wx2, wy2, uxn2, uyn2);

  const int64_t i = off_r + c;
  store(q + i, (wx0 - wx1) + (wy0 - wy2));
  store(ux_out + i, uxn0);
  store(uy_out + i, uyn0);
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const float* tau, void* q, void* ux_out, void* uy_out,
                   int64_t n, int h, int w, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>(n * h), (w + kThreads - 1) / kThreads);
  const T* uxp = static_cast<const T*>(ux);
  const T* uyp = static_cast<const T*>(uy);
  T* qp = static_cast<T*>(q);
  T* uxo = static_cast<T*>(ux_out);
  T* uyo = static_cast<T*>(uy_out);
  switch (mode) {
    case kAniso:
      stencil_fwd_kernel<kAniso, T><<<grid, kThreads, 0, stream>>>(
          x, uxp, uyp, tau, qp, uxo, uyo, h, w);
      break;
    case kIso:
      stencil_fwd_kernel<kIso, T><<<grid, kThreads, 0, stream>>>(
          x, uxp, uyp, tau, qp, uxo, uyo, h, w);
      break;
    case kHard:
      stencil_fwd_kernel<kHard, T><<<grid, kThreads, 0, stream>>>(
          x, uxp, uyp, tau, qp, uxo, uyo, h, w);
      break;
    case kGauss:
      stencil_fwd_kernel<kGauss, T><<<grid, kThreads, 0, stream>>>(
          x, uxp, uyp, tau, qp, uxo, uyo, h, w);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the stencil on `stream` and returns cudaGetLastError() (0 on
// success).  `mode`: 0 aniso, 1 iso, 2 hard, 3 gauss.  `bf16`: 0 when the
// duals and outputs are float, 1 when they are __nv_bfloat16.  Every array
// is a contiguous (n, h, w) plane stack; `tau` holds n floats.
int admm_stencil_fwd(const void* x, const void* ux, const void* uy,
                     const void* tau, void* q, void* ux_out, void* uy_out,
                     int64_t n, int h, int w, int mode, int bf16,
                     void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, tp, q, ux_out, uy_out, n,
                                 h, w, s);
  }
  return launch<float>(mode, xp, ux, uy, tp, q, ux_out, uy_out, n, h, w, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
