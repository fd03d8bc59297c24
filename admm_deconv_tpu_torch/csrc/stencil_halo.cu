// Fused ADMM stencil over an H-tile, forward: D -> prox -> dual ascent ->
// D^T in one pass, with the tile's neighbour rows given by the caller.
//
// Replaces the TPU kernel behind `fused_admm_stencil_halo` in
// admm_deconv_tpu/ops/pallas/stencil_kernels.py: the blocked
// `_fwd_kernel_halo` and the manual-DMA `_fwd_kernel_halo_dma`.  The tiled
// solver (parallel/tiling.py) splits each image's H axis over a tile mesh;
// this kernel runs the per-iteration stencil on one tile.
//
// Per plane of a tile of h rows, circular in W only:
//   row -1 (above row 0)      is x_top, the previous tile's last x row;
//   row h  (below row h - 1)  is (x_bot, ux_bot, uy_bot), the next tile's
//                              first rows;
// everything else is stencil_fwd.cu's arithmetic:
//   vx = x - x[:, c-1] + ux,  vy = x - x[r-1, :] + uy
//   z  = prox(v, tau);  u' = v - z;  w = z - u'
//   q  = (wx - wx[:, c+1]) + (wy - wy[r+1, :])
// and the kernel writes (q, ux', uy') for the tile's rows.  With the
// tile's own wrap rows as halos it equals stencil_fwd.cu bit for bit.
//
// What bounds it on an H100: memory bandwidth, as stencil_fwd.cu.  Each
// pixel needs x, ux, uy read once and q, ux', uy' written once: 24 B per
// pixel with fp32 duals, 14 B with bf16 duals; the four halo rows add 16 B
// per plane column.  At 12 planes of 1080 x 1920 that is ~0.18 ms (fp32)
// or ~0.10 ms (bf16) at the data sheet's 3.35 TB/s.
//
// Design: the row march of stencil_march.cuh, the one routine of
// stencil_fwd.cu, with the halo rows as its edge rows; one-row tiles (h = 1)
// take both from the halos.  The halo rows are fp32 for both dual types
// (bf16 values widen exactly, as the JAX solver's concatenate promotes
// them); each halo array's planes lie `halo_stride` floats apart, so the
// four rows can be views into one slab.  Outputs go to fresh buffers (the
// TPU kernel updates ux/uy in place, which would race here with the
// neighbour strips that read a dual row).
//
// Build with --fmad=false, as stencil_fwd.cu.

#include <stdint.h>

#include "stencil_march.cuh"

namespace {

using namespace admm;

constexpr int kMaxThreads = 256;

template <int MODE, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    stencil_halo_kernel(const float* __restrict__ x, const T* __restrict__ ux,
                        const T* __restrict__ uy, const EdgeRows<float> halos,
                        const float* __restrict__ tau, int64_t tau_stride,
                        T* __restrict__ q, T* __restrict__ ux_out, T* __restrict__ uy_out,
                        int h, int w, int rows, int strips, bool vec) {
  march_strip<MODE>(x, ux, uy, halos, tau, tau_stride, q, ux_out, uy_out, h, w, rows, strips,
                    vec);
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const EdgeRows<float>& halos, const float* tau, int64_t tau_stride,
                   void* q, void* ux_out, void* uy_out, int64_t n, int h, int w, int rows,
                   int strips, int chunks, int threads, bool vec, cudaStream_t stream) {
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
      stencil_halo_kernel<kAniso, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, halos, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kIso:
      stencil_halo_kernel<kIso, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, halos, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kHard:
      stencil_halo_kernel<kHard, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, halos, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    case kGauss:
      stencil_halo_kernel<kGauss, T><<<grid, threads, 0, stream>>>(
          x, uxp, uyp, halos, tau, tau_stride, qp, uxo, uyo, h, w, rows, strips, vec);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the tile stencil on `stream` and returns cudaGetLastError() (0 on
// success).  `mode`: 0 aniso, 1 iso, 2 hard, 3 gauss.  `bf16`: 0 when the
// duals and outputs are float, 1 when they are __nv_bfloat16.  x, ux, uy
// and the outputs are contiguous (n, h, w) plane stacks; plane p's tau is
// tau[p * tau_stride] (0 for one tau); each halo is n float rows of w,
// `halo_stride` floats apart.  The grid is (chunks, n * strips) blocks of
// `threads`, each marching `rows` rows; `vec` is 1 when every row, halos
// included, takes 16-byte accesses.
int admm_stencil_halo(const void* x, const void* ux, const void* uy, const void* x_top,
                      const void* x_bot, const void* ux_bot, const void* uy_bot,
                      const void* tau, void* q, void* ux_out, void* uy_out, int64_t n, int h,
                      int w, int mode, int bf16, int64_t tau_stride, int rows, int strips,
                      int chunks, int threads, int vec, int64_t halo_stride, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  const EdgeRows<float> halos{static_cast<const float*>(x_top),
                              static_cast<const float*>(x_bot),
                              static_cast<const float*>(ux_bot),
                              static_cast<const float*>(uy_bot), halo_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, halos, tp, tau_stride, q, ux_out, uy_out,
                                 n, h, w, rows, strips, chunks, threads, vec != 0, s);
  }
  return launch<float>(mode, xp, ux, uy, halos, tp, tau_stride, q, ux_out, uy_out, n, h, w,
                       rows, strips, chunks, threads, vec != 0, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
