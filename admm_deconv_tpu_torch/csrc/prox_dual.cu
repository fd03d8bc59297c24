// Fused prox + dual ascent over the gradient pair, elementwise.
//
// Replaces the TPU kernel `_prox_dual_pallas` / `_kernel` of
// admm_deconv_tpu/ops/pallas/prox_kernels.py, the forward of
// `fused_prox_dual`.  Templated on the prox mode.  Per element:
//   vx = dxx + ux,  vy = dxy + uy
//   z  = prox(v, tau);  ux' = vx - zx,  uy' = vy - zy
// and the kernel writes (zx, zy, ux', uy'), all fp32.  tau is one float per
// plane (a scalar tau is one plane covering the whole array).
//
// What bounds it on an H100: memory bandwidth.  Each element reads 4 floats
// and writes 4: 32 B.  At the 1080p batch-4 solve's 12 planes of
// 1080 x 1920 that is ~796 MB per call, ~0.238 ms at the data sheet's
// 3.35 TB/s, against a handful of FLOPs per element.
//
// Design: one thread per element, neighbouring threads on neighbouring
// addresses, so every load and store is coalesced and each byte moves once.
// The plane rides gridDim.y, so a thread reads its plane's tau without an
// integer division; a grid-stride loop over the plane covers any plane size.
// Offsets are 64-bit.  Outputs go to fresh buffers.
//
// Build with --fmad=false: the plain torch version rounds after every
// operation, and contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include "prox_math.cuh"

namespace {

using namespace admm;

constexpr int kThreads = 256;
// Blocks per plane: enough to fill the card many times over at any plane
// count; larger planes loop.
constexpr int64_t kMaxBlocksPerPlane = 1 << 16;

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    prox_dual_kernel(const float* __restrict__ dxx,
                     const float* __restrict__ dxy,
                     const float* __restrict__ ux,
                     const float* __restrict__ uy,
                     const float* __restrict__ tau, float* __restrict__ zx,
                     float* __restrict__ zy, float* __restrict__ ux_out,
                     float* __restrict__ uy_out, int64_t plane_size) {
  const int64_t plane = blockIdx.y;
  const float t = tau[plane];
  const int64_t base = plane * plane_size;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < plane_size; j += stride) {
    const int64_t i = base + j;
    const float vx = dxx[i] + ux[i];
    const float vy = dxy[i] + uy[i];
    float a, b;
    prox<MODE>(vx, vy, t, a, b);
    zx[i] = a;
    zy[i] = b;
    ux_out[i] = vx - a;
    uy_out[i] = vy - b;
  }
}

}  // namespace

extern "C" {

// Launches the prox-dual step on `stream` and returns cudaGetLastError()
// (0 on success).  Every array holds n_planes * plane_size contiguous
// floats; `tau` holds n_planes floats (n_planes <= 65535).  `mode`: 0
// aniso, 1 iso, 2 hard, 3 gauss.
int admm_prox_dual(const void* dxx, const void* dxy, const void* ux,
                   const void* uy, const void* tau, void* zx, void* zy,
                   void* ux_out, void* uy_out, int64_t n_planes,
                   int64_t plane_size, int mode, void* stream) {
  if (n_planes < 1 || n_planes > 65535 || plane_size < 1) {
    return cudaErrorInvalidValue;
  }
  int64_t blocks = (plane_size + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocksPerPlane) blocks = kMaxBlocksPerPlane;
  const dim3 grid(static_cast<unsigned>(blocks),
                  static_cast<unsigned>(n_planes));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(dxx);
  const float* b = static_cast<const float*>(dxy);
  const float* c = static_cast<const float*>(ux);
  const float* d = static_cast<const float*>(uy);
  const float* t = static_cast<const float*>(tau);
  float* o0 = static_cast<float*>(zx);
  float* o1 = static_cast<float*>(zy);
  float* o2 = static_cast<float*>(ux_out);
  float* o3 = static_cast<float*>(uy_out);
  switch (mode) {
    case kAniso:
      prox_dual_kernel<kAniso><<<grid, kThreads, 0, s>>>(a, b, c, d, t, o0,
                                                         o1, o2, o3,
                                                         plane_size);
      break;
    case kIso:
      prox_dual_kernel<kIso><<<grid, kThreads, 0, s>>>(a, b, c, d, t, o0, o1,
                                                       o2, o3, plane_size);
      break;
    case kHard:
      prox_dual_kernel<kHard><<<grid, kThreads, 0, s>>>(a, b, c, d, t, o0, o1,
                                                        o2, o3, plane_size);
      break;
    case kGauss:
      prox_dual_kernel<kGauss><<<grid, kThreads, 0, s>>>(a, b, c, d, t, o0,
                                                         o1, o2, o3,
                                                         plane_size);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
