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
// Design: stencil_fwd.cu's.  One thread per output pixel recomputes v at
// (r, c), (r, c+1) and (r+1, c); rows (N*h) ride gridDim.x, column blocks
// gridDim.y; offsets are 64-bit; outputs go to fresh buffers (the TPU
// kernel updates ux/uy in place, which would race here with the threads
// that read a neighbour's duals).  Only the row pointers differ: row 0
// takes its row above from x_top, row h - 1 its row below from the bottom
// halos.  In a one-row tile (h = 1) one thread does both.  The halo rows
// are fp32 for both dual types (bf16 values widen exactly, as the JAX
// solver's concatenate promotes them); each halo array's planes lie
// `halo_stride` floats apart, so the four rows can be views into one slab.
//
// Build with --fmad=false, as stencil_fwd.cu.

#include <stdint.h>

#include "prox_math.cuh"

namespace {

using namespace admm;

template <int MODE, typename T>
__global__ void stencil_halo_kernel(const float* __restrict__ x,
                                    const T* __restrict__ ux,
                                    const T* __restrict__ uy,
                                    const float* __restrict__ x_top,
                                    const float* __restrict__ x_bot,
                                    const float* __restrict__ ux_bot,
                                    const float* __restrict__ uy_bot,
                                    int64_t halo_stride,
                                    const float* __restrict__ tau,
                                    T* __restrict__ q, T* __restrict__ ux_out,
                                    T* __restrict__ uy_out, int h, int w) {
  const int c = blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= w) return;
  const int64_t row = blockIdx.x;  // plane * h + r
  const int64_t plane = row / h;
  const int r = static_cast<int>(row - plane * h);
  const int cl = c == 0 ? w - 1 : c - 1;
  const int cr = c == w - 1 ? 0 : c + 1;
  const int64_t off_r = plane * h * static_cast<int64_t>(w) +
                        static_cast<int64_t>(r) * w;
  const int64_t off_halo = plane * halo_stride;
  const float* xr = x + off_r;
  const float* xa = r == 0 ? x_top + off_halo : xr - w;
  const float t = tau[plane];

  float wx0, wy0, uxn0, uyn0;  // at (r, c): the pixel this thread writes
  tv_split_pixel<MODE>(xr, xa, ux + off_r, uy + off_r, c, cl, t, wx0, wy0,
                       uxn0, uyn0);
  float wx1, wy1, uxn1, uyn1;  // at (r, c+1): only wx is used
  tv_split_pixel<MODE>(xr, xa, ux + off_r, uy + off_r, cr, c, t, wx1, wy1,
                       uxn1, uyn1);
  float wx2, wy2, uxn2, uyn2;  // at (r+1, c): only wy is used
  if (r == h - 1) {
    tv_split_pixel<MODE>(x_bot + off_halo, xr, ux_bot + off_halo,
                         uy_bot + off_halo, c, cl, t, wx2, wy2, uxn2, uyn2);
  } else {
    tv_split_pixel<MODE>(xr + w, xr, ux + off_r + w, uy + off_r + w, c, cl, t,
                         wx2, wy2, uxn2, uyn2);
  }

  const int64_t i = off_r + c;
  store(q + i, (wx0 - wx1) + (wy0 - wy2));
  store(ux_out + i, uxn0);
  store(uy_out + i, uyn0);
}

struct Halos {
  const float* x_top;
  const float* x_bot;
  const float* ux_bot;
  const float* uy_bot;
  int64_t stride;
};

template <int MODE, typename T>
void launch_mode(dim3 grid, int threads, cudaStream_t stream, const float* x,
                 const void* ux, const void* uy, const Halos& hal,
                 const float* tau, void* q, void* ux_out, void* uy_out, int h,
                 int w) {
  stencil_halo_kernel<MODE, T><<<grid, threads, 0, stream>>>(
      x, static_cast<const T*>(ux), static_cast<const T*>(uy), hal.x_top,
      hal.x_bot, hal.ux_bot, hal.uy_bot, hal.stride, tau, static_cast<T*>(q),
      static_cast<T*>(ux_out), static_cast<T*>(uy_out), h, w);
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const Halos& hal, const float* tau, void* q, void* ux_out,
                   void* uy_out, int64_t n, int h, int w, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const dim3 grid(static_cast<unsigned>(n * h), (w + kThreads - 1) / kThreads);
  switch (mode) {
    case kAniso:
      launch_mode<kAniso, T>(grid, kThreads, stream, x, ux, uy, hal, tau, q,
                             ux_out, uy_out, h, w);
      break;
    case kIso:
      launch_mode<kIso, T>(grid, kThreads, stream, x, ux, uy, hal, tau, q,
                           ux_out, uy_out, h, w);
      break;
    case kHard:
      launch_mode<kHard, T>(grid, kThreads, stream, x, ux, uy, hal, tau, q,
                            ux_out, uy_out, h, w);
      break;
    case kGauss:
      launch_mode<kGauss, T>(grid, kThreads, stream, x, ux, uy, hal, tau, q,
                             ux_out, uy_out, h, w);
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
// and the outputs are contiguous (n, h, w) plane stacks; `tau` holds n
// floats; each halo is n float rows of w, `halo_stride` floats apart.
int admm_stencil_halo(const void* x, const void* ux, const void* uy,
                      const void* x_top, const void* x_bot, const void* ux_bot,
                      const void* uy_bot, const void* tau, void* q,
                      void* ux_out, void* uy_out, int64_t n, int h, int w,
                      int mode, int bf16, int64_t halo_stride, void* stream) {
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  const Halos hal{static_cast<const float*>(x_top),
                  static_cast<const float*>(x_bot),
                  static_cast<const float*>(ux_bot),
                  static_cast<const float*>(uy_bot), halo_stride};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, hal, tp, q, ux_out, uy_out,
                                 n, h, w, s);
  }
  return launch<float>(mode, xp, ux, uy, hal, tp, q, ux_out, uy_out, n, h, w,
                       s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
