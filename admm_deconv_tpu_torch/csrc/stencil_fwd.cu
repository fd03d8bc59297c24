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
// Design: the row march of stencil_march.cuh, whose edge rows are the
// plane's own rows h - 1 (above row 0) and 0 (below row h - 1); the
// geometry (strip height, warps a block, grid) comes from the caller
// (ops/kernels/stencil_kernels.py, `march_geometry`).  Outputs go to fresh
// buffers: the TPU kernel updates ux/uy in place, which on a GPU would race
// with the neighbour strips that read row r0 of the duals.
//
// Build with --fmad=false: the plain torch version rounds after every
// operation, and contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include "stencil_march.cuh"

namespace {

using namespace admm;

constexpr int kMaxThreads = 256;

template <int MODE, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    stencil_fwd_kernel(const float* __restrict__ x, const T* __restrict__ ux,
                       const T* __restrict__ uy, const float* __restrict__ tau,
                       int64_t tau_stride, T* __restrict__ q, T* __restrict__ ux_out,
                       T* __restrict__ uy_out, int h, int w, int rows, int strips, bool vec) {
  const int64_t hw = static_cast<int64_t>(h) * w;
  const EdgeRows<T> wrap{x + hw - w, x, ux, uy, hw};
  march_strip<MODE>(x, ux, uy, wrap, tau, tau_stride, q, ux_out, uy_out, h, w, rows, strips,
                    vec);
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const float* tau, int64_t tau_stride, void* q, void* ux_out,
                   void* uy_out, int64_t n, int h, int w, int rows, int strips, int chunks,
                   int threads, bool vec, cudaStream_t stream) {
  if (threads % 32 != 0 || threads > kMaxThreads || n * strips > 65535) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(chunks, static_cast<unsigned>(n * strips));
  const T* uxp = static_cast<const T*>(ux);
  const T* uyp = static_cast<const T*>(uy);
  T* qp = static_cast<T*>(q);
  T* uxo = static_cast<T*>(ux_out);
  T* uyo = static_cast<T*>(uy_out);
  switch (mode) {
    case kAniso:
      stencil_fwd_kernel<kAniso, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kIso:
      stencil_fwd_kernel<kIso, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kHard:
      stencil_fwd_kernel<kHard, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kGauss:
      stencil_fwd_kernel<kGauss, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
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
// is a contiguous (n, h, w) plane stack; plane p's tau is
// tau[p * tau_stride] (0 for one tau).  The grid is (chunks, n * strips)
// blocks of `threads`, each marching `rows` rows; `vec` is 1 when every row
// takes 16-byte accesses (w % 4 == 0, aligned pointers).
int admm_stencil_fwd(const void* x, const void* ux, const void* uy, const void* tau,
                     void* q, void* ux_out, void* uy_out, int64_t n, int h, int w,
                     int mode, int bf16, int64_t tau_stride, int rows, int strips,
                     int chunks, int threads, int vec, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, tp, tau_stride, q, ux_out, uy_out, n, h,
                                 w, rows, strips, chunks, threads, vec != 0, s);
  }
  return launch<float>(mode, xp, ux, uy, tp, tau_stride, q, ux_out, uy_out, n, h, w, rows,
                       strips, chunks, threads, vec != 0, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
