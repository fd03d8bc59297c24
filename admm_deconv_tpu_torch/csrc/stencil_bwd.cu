// Fused ADMM stencil, backward: the VJP of D -> prox -> dual -> D^T in one
// pass.
//
// Replaces the TPU kernel `_bwd_pallas` / `_bwd_kernel` of
// admm_deconv_tpu/ops/pallas/stencil_kernels.py, the backward half of the
// custom VJP behind `fused_admm_stencil` and `fused_admm_stencil_mixed`.
// Templated on the prox mode and on the storage type of the duals and the
// cotangents (float or __nv_bfloat16).
//
// Per plane, circular in H and W, with residuals (x, ux, uy, tau) and
// cotangents (gq, gux, guy) of the outputs (q, ux', uy'):
//   v   = D x + u                       (recomputed, not saved)
//   wb  = D gq
//   zb  = 2 wb - gu
//   vb  = gu - wb + J_prox(v, tau)^T zb
//   xbar = D^T vb,  ubar = vb,  taub = sum over the plane of (dz/dtau) zb
// All arithmetic is fp32; xbar is stored fp32 and ubar in the dual type.
// A null output pointer skips that output (the gradient nobody asked for).
//
// What bounds it on an H100: memory bandwidth.  Each pixel needs x, ux, uy,
// gq, gux, guy read once and xbar, uxbar, uybar written once: 36 B per
// pixel with fp32 duals and cotangents, 22 B with bf16.  At the 1080p
// TV-layer step's 6 planes of 1080 x 1920 that is ~448 MB (fp32), so
// ~0.134 ms at the data sheet's 3.35 TB/s, against a few dozen FLOPs a
// pixel.
//
// Design: one thread per output pixel, as in the forward.  The thread
// recomputes v and wb at (r, c), (r, c+1) and (r+1, c), from which
// xbar[r, c] = vbx[r, c] - vbx[r, c+1] + vby[r, c] - vby[r+1, c]; all but one
// read of each input come from L1/L2, shared with the neighbour threads.
// The tau cotangent needs a sum over the plane.  A block covers one row
// segment, so it never straddles two planes: each block sums its threads'
// terms (warp shuffles, then shared memory, in a fixed order) into one cell
// of an (N, blocks_per_plane) fp32 table, and the wrapper sums the table's
// rows with torch.sum.  No float atomics: the result is deterministic.
//
// Build with --fmad=false: the plain torch version rounds after every
// operation, and contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include "prox_math.cuh"

namespace {

using namespace admm;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// vb at one pixel, and its tau term.  `xr`/`gqr`/`uxr`... are the pixel's
// rows, `xa`/`gqa` the rows above; `c`/`cm` the column and its left
// neighbour.
template <int MODE, typename T>
__device__ __forceinline__ void pixel(const float* xr, const float* xa,
                                      const T* uxr, const T* uyr,
                                      const T* gqr, const T* gqa,
                                      const T* guxr, const T* guyr, int c,
                                      int cm, float tau, float& vbx,
                                      float& vby, float& taub) {
  const float xc = xr[c];
  const float vx = (xc - xr[cm]) + load_f32(uxr + c);
  const float vy = (xc - xa[c]) + load_f32(uyr + c);
  const float gc = load_f32(gqr + c);
  const float wbx = gc - load_f32(gqr + cm);
  const float wby = gc - load_f32(gqa + c);
  const float gx = load_f32(guxr + c);
  const float gy = load_f32(guyr + c);
  const float zbx = 2.f * wbx - gx;
  const float zby = 2.f * wby - gy;
  float pvx, pvy;
  prox_vjp<MODE>(vx, vy, tau, zbx, zby, pvx, pvy, taub);
  vbx = (gx - wbx) + pvx;
  vby = (gy - wby) + pvy;
}

template <int MODE, typename T>
__global__ void __launch_bounds__(kThreads)
    stencil_bwd_kernel(const float* __restrict__ x, const T* __restrict__ ux,
                       const T* __restrict__ uy, const float* __restrict__ tau,
                       const T* __restrict__ gq, const T* __restrict__ gux,
                       const T* __restrict__ guy, float* __restrict__ xbar,
                       T* __restrict__ uxbar, T* __restrict__ uybar,
                       float* __restrict__ taub_part, int h, int w) {
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const int64_t row = blockIdx.x;  // plane * h + r
  const int64_t plane = row / h;
  const int r = static_cast<int>(row - plane * h);
  float taub0 = 0.f;
  if (c < w) {
    const int ra = r == 0 ? h - 1 : r - 1;
    const int rb = r == h - 1 ? 0 : r + 1;
    const int cl = c == 0 ? w - 1 : c - 1;
    const int cr = c == w - 1 ? 0 : c + 1;
    const int64_t base = plane * h * static_cast<int64_t>(w);
    const int64_t off_r = base + static_cast<int64_t>(r) * w;
    const int64_t off_a = base + static_cast<int64_t>(ra) * w;
    const int64_t off_b = base + static_cast<int64_t>(rb) * w;
    const float t = tau[plane];

    float vbx0, vby0;  // at (r, c): the pixel this thread writes
    pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, gq + off_r,
                gq + off_a, gux + off_r, guy + off_r, c, cl, t, vbx0, vby0,
                taub0);
    const int64_t i = off_r + c;
    if (xbar != nullptr) {
      float vbx1, vby1, tb1;  // at (r, c+1): only vbx is used
      pixel<MODE>(x + off_r, x + off_a, ux + off_r, uy + off_r, gq + off_r,
                  gq + off_a, gux + off_r, guy + off_r, cr, c, t, vbx1, vby1,
                  tb1);
      float vbx2, vby2, tb2;  // at (r+1, c): only vby is used
      pixel<MODE>(x + off_b, x + off_r, ux + off_b, uy + off_b, gq + off_b,
                  gq + off_r, gux + off_b, guy + off_b, c, cl, t, vbx2, vby2,
                  tb2);
      xbar[i] = (vbx0 - vbx1) + (vby0 - vby2);
    }
    if (uxbar != nullptr) {
      store(uxbar + i, vbx0);
      store(uybar + i, vby0);
    }
  }
  if (taub_part == nullptr) return;  // uniform over the grid

  // Block sum of the tau terms: within each warp, then over the warps.
  __shared__ float warp_sums[kWarps];
  float s = taub0;
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? warp_sums[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) {
      taub_part[row * gridDim.y + blockIdx.y] = s;
    }
  }
}

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const float* tau, const void* gq, const void* gux,
                   const void* guy, float* xbar, void* uxbar, void* uybar,
                   float* taub_part, int64_t n, int h, int w,
                   cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n * h), (w + kThreads - 1) / kThreads);
  const T* uxp = static_cast<const T*>(ux);
  const T* uyp = static_cast<const T*>(uy);
  const T* gqp = static_cast<const T*>(gq);
  const T* gxp = static_cast<const T*>(gux);
  const T* gyp = static_cast<const T*>(guy);
  T* uxb = static_cast<T*>(uxbar);
  T* uyb = static_cast<T*>(uybar);
#define ADMM_BWD_LAUNCH(M)                                                   \
  stencil_bwd_kernel<M, T><<<grid, kThreads, 0, stream>>>(                   \
      x, uxp, uyp, tau, gqp, gxp, gyp, xbar, uxb, uyb, taub_part, h, w)
  switch (mode) {
    case kAniso:
      ADMM_BWD_LAUNCH(kAniso);
      break;
    case kIso:
      ADMM_BWD_LAUNCH(kIso);
      break;
    case kHard:
      ADMM_BWD_LAUNCH(kHard);
      break;
    case kGauss:
      ADMM_BWD_LAUNCH(kGauss);
      break;
    default:
      return cudaErrorInvalidValue;
  }
#undef ADMM_BWD_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the backward stencil on `stream` and returns cudaGetLastError()
// (0 on success).  `mode`: 0 aniso, 1 iso, 2 hard, 3 gauss.  `bf16`: 0 when
// the duals, cotangents and ubar are float, 1 when they are __nv_bfloat16;
// x, tau and xbar are always float.  Every plane array is a contiguous
// (n, h, w) stack; `tau` holds n floats; `taub_part` is an (n, h * ceil(w /
// 256)) float table of per-block partial sums.  `xbar`, `uxbar`/`uybar`
// (together) and `taub_part` may each be null, and are then not written.
int admm_stencil_bwd(const void* x, const void* ux, const void* uy,
                     const void* tau, const void* gq, const void* gux,
                     const void* guy, void* xbar, void* uxbar, void* uybar,
                     void* taub_part, int64_t n, int h, int w, int mode,
                     int bf16, void* stream) {
  if ((uxbar == nullptr) != (uybar == nullptr)) return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  float* xb = static_cast<float*>(xbar);
  float* tb = static_cast<float*>(taub_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, tp, gq, gux, guy, xb, uxbar,
                                 uybar, tb, n, h, w, s);
  }
  return launch<float>(mode, xp, ux, uy, tp, gq, gux, guy, xb, uxbar, uybar,
                       tb, n, h, w, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
