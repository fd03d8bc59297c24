// Prox math, element access and the forward stencil's per-pixel TV split,
// shared by the kernels.
//
// The device twin of ops/kernels/prox_math.py: `prox<MODE>` is z = prox(v,
// tau) and `prox_vjp<MODE>` its analytic VJP, with the masks and the 1e-12
// floor of admm_deconv_tpu/ops/pallas/prox_math.py.  Every expression keeps
// the plain torch version's order of operations; built with --fmad=false,
// each operation rounds where torch's does.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace admm {

enum ProxMode { kAniso = 0, kIso = 1, kHard = 2, kGauss = 3 };

constexpr float kEps = 1e-12f;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float sign(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// z = prox(v, tau), the formulas of ops/prox.py.
template <int MODE>
__device__ __forceinline__ void prox(float vx, float vy, float tau, float& zx,
                                     float& zy) {
  if (MODE == kAniso) {
    zx = sign(vx) * fmaxf(fabsf(vx) - tau, 0.f);
    zy = sign(vy) * fmaxf(fabsf(vy) - tau, 0.f);
  } else if (MODE == kIso) {
    const float r = sqrtf(vx * vx + vy * vy);
    const float scale = fmaxf(1.f - tau / fmaxf(r, kEps), 0.f);
    zx = scale * vx;
    zy = scale * vy;
  } else if (MODE == kHard) {
    zx = fabsf(vx) > tau ? vx : 0.f;
    zy = fabsf(vy) > tau ? vy : 0.f;
  } else {
    const float r2 = vx * vx + vy * vy;
    const float scale = 0.5f - 0.5f * expf(-r2 / (2.f * tau * tau));
    zx = scale * vx;
    zy = scale * vy;
  }
}

// VJP of z = prox(v, tau): from the cotangents (zbx, zby) give
// (vbx, vby) and this pixel's term of the tau cotangent.  Below a
// threshold the gradient is exactly zero (iso at v = 0 stays finite).
template <int MODE>
__device__ __forceinline__ void prox_vjp(float vx, float vy, float tau,
                                         float zbx, float zby, float& vbx,
                                         float& vby, float& taub) {
  if (MODE == kAniso) {
    vbx = (fabsf(vx) > tau ? 1.f : 0.f) * zbx;
    vby = (fabsf(vy) > tau ? 1.f : 0.f) * zby;
    taub = -(sign(vx) * vbx + sign(vy) * vby);
  } else if (MODE == kIso) {
    const float r = sqrtf(vx * vx + vy * vy);
    const float rs = fmaxf(r, kEps);
    const float active = r > tau ? 1.f : 0.f;
    const float dot = vx * zbx + vy * zby;
    const float scale = 1.f - tau / rs;
    const float rs3 = rs * rs * rs;
    vbx = active * (scale * zbx + tau * dot * vx / rs3);
    vby = active * (scale * zby + tau * dot * vy / rs3);
    taub = -active * dot / rs;
  } else if (MODE == kHard) {
    vbx = (fabsf(vx) > tau ? 1.f : 0.f) * zbx;
    vby = (fabsf(vy) > tau ? 1.f : 0.f) * zby;
    taub = 0.f;
  } else {
    const float r2 = vx * vx + vy * vy;
    const float e = expf(-r2 / (2.f * tau * tau));
    const float scale = 0.5f - 0.5f * e;
    const float ds_dr2 = e / (4.f * tau * tau);
    const float dot = vx * zbx + vy * zby;
    vbx = scale * zbx + 2.f * ds_dr2 * dot * vx;
    vby = scale * zby + 2.f * ds_dr2 * dot * vy;
    taub = -(0.5f * e * r2 / (tau * tau * tau)) * dot;
  }
}

// The forward stencil's TV split at one pixel: v = D x + u, z = prox(v,
// tau), u' = v - z and w = z - u' (= 2z - v).  `xr` is the pixel's row of
// x, `xa` the row above; `c`/`cm` the column and its left neighbour.
template <int MODE, typename T>
__device__ __forceinline__ void tv_split_pixel(const float* xr,
                                               const float* xa, const T* uxr,
                                               const T* uyr, int c, int cm,
                                               float tau, float& wx,
                                               float& wy, float& uxn,
                                               float& uyn) {
  const float xc = xr[c];
  const float vx = (xc - xr[cm]) + load_f32(uxr + c);
  const float vy = (xc - xa[c]) + load_f32(uyr + c);
  float zx, zy;
  prox<MODE>(vx, vy, tau, zx, zy);
  uxn = vx - zx;
  uyn = vy - zy;
  wx = zx - uxn;
  wy = zy - uyn;
}

}  // namespace admm
