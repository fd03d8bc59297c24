// The x-update's complex right-hand side, C * (B + rho * F), in place into F.
//
// No TPU kernel stands behind this one: the JAX package's x-update
// (admm_deconv_tpu/ops/solver.py:386, `_solve_spectral`) is jnp that XLA
// fuses.  Torch runs the same line as three elementwise passes over the
// (N, H, W/2+1) complex64 spectrum between the two cuFFT calls:
//   rho * F       reads  8 B a bin, writes 8 B;
//   B + ...       reads 16 B,       writes 8 B;
//   C * ...       reads  8 B,       writes 8 B (C broadcast from L2):
// 56 B a bin.  This pass reads F and B once and writes F once, 24 B a bin,
// with C (4 MB at 1080p) read from L2.
//
// What bounds it on an H100: memory bandwidth.  At the 1080p batch-4
// solve's 12 x 1080 x 961 bins that is ~299 MB a call, ~0.089 ms at the
// data sheet's 3.35 TB/s, against 6 flops a bin.
//
// Arithmetic.  C and rho are real.  Torch promotes a real operand of a
// complex product to (a, 0), and (a, 0) * (x, y) = (a x - 0 y, a y + 0 x),
// which is round(a x), round(a y) for every finite x, y (up to the sign of
// an exact zero).  So each part of each bin is computed as
//   t = rho * Fr;  s = Br + t;  out = C * s      (and the same for Fi, Bi),
// rounded after every operation: built with --fmad=false, no a*b+c is
// contracted into an FMA.  The result is the composition's bits.
//
// Design.  F and B are read as float4, two bins a load, neighbouring
// threads on neighbouring addresses, over a grid-stride loop with 64-bit
// indices.  Storage need not start 16-byte aligned: when F and B lie at
// the same offset from 16 bytes, a head bin is done alone and the pairs
// follow; a tail bin is done alone when the count left is odd.  When their
// offsets differ, every bin is done alone (8-byte loads).  A thread finds
// its bin's plane and in-plane index once, by a division, and steps both
// forward without dividing again.  C is indexed by the in-plane index, or
// by the bin where there is a C a plane; rho by the plane where there is a
// rho a plane.

#include <stdint.h>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// Resident blocks an SM at 256 threads: the grid is sized to fill the card
// once and loop, so a thread's one division is spread over many bins.
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ void rhs_part(float& f, float b, float c, float rho) {
  const float t = rho * f;
  const float s = b + t;
  f = c * s;
}

// Where flat bin i lies: its plane p and its index k within the plane.
struct Where {
  int64_t p, k;
};

__device__ __forceinline__ Where where(int64_t i, int64_t plane_bins) {
  const int64_t p = i / plane_bins;
  return {p, i - p * plane_bins};
}

// Step (p, k) forward by `step` bins, given step = sp * plane_bins + sk
// with sk < plane_bins.
__device__ __forceinline__ void advance(Where& w, int64_t sp, int64_t sk,
                                        int64_t plane_bins) {
  w.p += sp;
  w.k += sk;
  if (w.k >= plane_bins) {
    w.k -= plane_bins;
    ++w.p;
  }
}

__device__ __forceinline__ void one_bin(float2* __restrict__ f,
                                        const float2* __restrict__ b,
                                        const float* __restrict__ c,
                                        const float* __restrict__ rho,
                                        int64_t i, Where w, int c_per_plane,
                                        int rho_per_plane) {
  float2 v = f[i];
  const float2 u = b[i];
  const float cv = c[c_per_plane ? i : w.k];
  const float r = rho[rho_per_plane ? w.p : 0];
  rhs_part(v.x, u.x, cv, r);
  rhs_part(v.y, u.y, cv, r);
  f[i] = v;
}

// Every bin alone: F and B at different offsets from 16 bytes.
__global__ void __launch_bounds__(kThreads)
    spectral_rhs_bins(float2* __restrict__ f, const float2* __restrict__ b,
                      const float* __restrict__ c,
                      const float* __restrict__ rho, int64_t total,
                      int64_t plane_bins, int c_per_plane, int rho_per_plane) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  Where w = where(i, plane_bins);
  const int64_t sp = stride / plane_bins;
  const int64_t sk = stride - sp * plane_bins;
  for (; i < total; i += stride) {
    one_bin(f, b, c, rho, i, w, c_per_plane, rho_per_plane);
    advance(w, sp, sk, plane_bins);
  }
}

// Two bins a load: bins [head, head + 2 pairs) as float4, the head bin
// (head is 0 or 1) and a tail bin by the grid's first thread.
__global__ void __launch_bounds__(kThreads)
    spectral_rhs_pairs(float2* __restrict__ f, const float2* __restrict__ b,
                       const float* __restrict__ c,
                       const float* __restrict__ rho, int64_t total,
                       int64_t head, int64_t pairs, int64_t plane_bins,
                       int c_per_plane, int rho_per_plane) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (first == 0) {
    for (int64_t i = 0; i < head; ++i) {
      one_bin(f, b, c, rho, i, where(i, plane_bins), c_per_plane, rho_per_plane);
    }
    for (int64_t i = head + 2 * pairs; i < total; ++i) {
      one_bin(f, b, c, rho, i, where(i, plane_bins), c_per_plane, rho_per_plane);
    }
  }
  if (first >= pairs) return;
  float4* __restrict__ f4 = reinterpret_cast<float4*>(f + head);
  const float4* __restrict__ b4 = reinterpret_cast<const float4*>(b + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  // The pair's first bin, and its plane and in-plane index.
  int64_t i = head + 2 * first;
  Where w = where(i, plane_bins);
  const int64_t sp = (2 * stride) / plane_bins;
  const int64_t sk = 2 * stride - sp * plane_bins;
  for (int64_t g = first; g < pairs; g += stride) {
    float4 v = f4[g];
    const float4 u = b4[g];
    // The second bin may open the next plane (an odd plane size).
    Where w1 = {w.p, w.k + 1};
    if (w1.k == plane_bins) {
      w1.k = 0;
      ++w1.p;
    }
    const float c0 = c[c_per_plane ? i : w.k];
    const float c1 = c[c_per_plane ? i + 1 : w1.k];
    const float r0 = rho[rho_per_plane ? w.p : 0];
    const float r1 = rho[rho_per_plane ? w1.p : 0];
    rhs_part(v.x, u.x, c0, r0);
    rhs_part(v.y, u.y, c0, r0);
    rhs_part(v.z, u.z, c1, r1);
    rhs_part(v.w, u.w, c1, r1);
    f4[g] = v;
    i += 2 * stride;
    advance(w, sp, sk, plane_bins);
  }
}

}  // namespace

extern "C" {

// Computes f = c * (b + rho * f) on `stream` and returns cudaGetLastError()
// (0 on success).  `f` and `b` hold `total` contiguous complex64 bins (8-byte
// aligned), `plane_bins` to a plane; `c` holds plane_bins floats, or total
// with `c_per_plane`; `rho` one float, or one a plane with `rho_per_plane`.
int admm_spectral_rhs(void* f, const void* b, const void* c, const void* rho,
                      int64_t total, int64_t plane_bins, int c_per_plane,
                      int rho_per_plane, void* stream) {
  if (total < 1 || plane_bins < 1 || total % plane_bins != 0) {
    return cudaErrorInvalidValue;
  }
  const uintptr_t fa = reinterpret_cast<uintptr_t>(f);
  const uintptr_t ba = reinterpret_cast<uintptr_t>(b);
  if (fa % 8 != 0 || ba % 8 != 0) return cudaErrorMisalignedAddress;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return err;
  const int64_t max_blocks = static_cast<int64_t>(sms) * kBlocksPerSm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float2* fb = static_cast<float2*>(f);
  const float2* bb = static_cast<const float2*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* rf = static_cast<const float*>(rho);
  if (fa % 16 == ba % 16) {
    const int64_t head = static_cast<int64_t>((fa % 16) / 8);
    const int64_t pairs = total > head ? (total - head) / 2 : 0;
    int64_t blocks = (pairs + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    if (blocks < 1) blocks = 1;
    spectral_rhs_pairs<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        fb, bb, cf, rf, total, head, pairs, plane_bins, c_per_plane,
        rho_per_plane);
  } else {
    int64_t blocks = (total + kThreads - 1) / kThreads;
    if (blocks > max_blocks) blocks = max_blocks;
    spectral_rhs_bins<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        fb, bb, cf, rf, total, plane_bins, c_per_plane, rho_per_plane);
  }
  return cudaGetLastError();
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
