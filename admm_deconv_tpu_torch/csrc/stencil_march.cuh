// The fused ADMM forward stencil as one row march, shared by stencil_fwd.cu
// (the circular stencil) and stencil_halo.cu (an H-tile whose neighbour
// rows the caller gives).
//
// Per plane, W circular:
//   vx = x - x[:, c-1] + ux,  vy = x - x[r-1, :] + uy
//   z  = prox(v, tau);  u' = v - z;  w = z - u'
//   q  = (wx - wx[:, c+1]) + (wy - wy[r+1, :])
// and the march writes (q, ux', uy').  Row -1 (above row 0) is `x_top` and
// row h (below row h - 1) is (`x_bot`, `ux_bot`, `uy_bot`): the circular
// stencil passes the plane's own rows h - 1 and 0, the tile stencil the
// neighbour tiles' rows, so the two are equal by construction.
//
// What bounds it on an H100: memory bandwidth.  Each pixel needs x, ux, uy
// read once and q, ux', uy' written once (24 B with fp32 duals, 14 B with
// bf16), against 20-odd fp32 operations: far below the compute roof, and
// there is no matrix product, so the tensor cores (wgmma) have nothing to do.
//
// Design.  A block owns a strip of `rows` rows of one plane and a chunk of
// columns; each thread owns V = 4 consecutive columns and walks down the
// strip.  At each step it splits row r + 1 (v, z, u', w) once, writes row
// r's q, ux', uy', and carries row r + 1's w and x in registers as the next
// step's row r.  So a strip of S rows does S + 1 splits (not 3S), reads x on
// rows r0 - 1 .. r0 + S and the duals on rows r0 .. r0 + S, each once, with
// 16-byte loads of x and of fp32 duals (8 bytes for four bf16) and stores
// as wide.  The loads of row r + 2 are issued before the arithmetic of row
// r + 1 (a second register buffer), so each thread keeps a row in flight.
// The column neighbours come by warp shuffle: x(r, c - 1) from the lane
// before, wx(r, c + V) from the lane after.  Lane 0 reads its left x from
// memory (an L1/L2 hit), and the thread at a warp's end (lane 31, or the
// one holding column w - 1) also splits the column after its own, wrapping
// in W; no shared memory and no barrier.  Rows or widths the 16-byte
// accesses do not fit (w % 4 != 0, an unaligned pointer: `vec` false) take
// element-wise accesses in the same march.
//
// Arithmetic: `split` is `tv_split_pixel`'s (prox_math.cuh) order of
// operations on values, and q keeps its expression.  Built with
// --fmad=false, every output rounds where the plain torch version's does.

#pragma once

#include <stdint.h>

#include "prox_math.cuh"

namespace admm {

constexpr int kVec = 4;  // columns a thread owns
constexpr unsigned kFullMask = 0xffffffffu;

// The rows a plane reads beyond its own: x above row 0 and x, ux, uy below
// row h - 1; plane p's rows lie at p * stride elements.
template <typename H>
struct EdgeRows {
  const float* x_top;
  const float* x_bot;
  const H* ux_bot;
  const H* uy_bot;
  int64_t stride;
};

// Four dual values as they are loaded: converted to fp32 only where used,
// so a load in flight is never waited on early.
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  float4 v;
};
template <>
struct Pack<__nv_bfloat16> {
  uint2 v;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float4 load4(const float* p, int c, int k, bool vec) {
  if (vec) return *reinterpret_cast<const float4*>(p + c);
  return make_float4(p[c], k > 1 ? p[c + 1] : 0.f, k > 2 ? p[c + 2] : 0.f,
                     k > 3 ? p[c + 3] : 0.f);
}

__device__ __forceinline__ Pack<float> load_pack(const float* p, int c, int k, bool vec) {
  return {load4(p, c, k, vec)};
}

__device__ __forceinline__ Pack<__nv_bfloat16> load_pack(const __nv_bfloat16* p, int c,
                                                         int k, bool vec) {
  if (vec) return {*reinterpret_cast<const uint2*>(p + c)};
  const unsigned short* s = reinterpret_cast<const unsigned short*>(p + c);
  const unsigned b0 = s[0], b1 = k > 1 ? s[1] : 0u, b2 = k > 2 ? s[2] : 0u,
                 b3 = k > 3 ? s[3] : 0u;
  return {make_uint2(b0 | (b1 << 16), b2 | (b3 << 16))};
}

__device__ __forceinline__ void unpack(const Pack<float>& p, float (&o)[kVec]) {
  o[0] = p.v.x;
  o[1] = p.v.y;
  o[2] = p.v.z;
  o[3] = p.v.w;
}

// bf16 is the top half of an fp32: the widening is exact.
__device__ __forceinline__ void unpack(const Pack<__nv_bfloat16>& p, float (&o)[kVec]) {
  o[0] = __uint_as_float(p.v.x << 16);
  o[1] = __uint_as_float(p.v.x & 0xffff0000u);
  o[2] = __uint_as_float(p.v.y << 16);
  o[3] = __uint_as_float(p.v.y & 0xffff0000u);
}

__device__ __forceinline__ void store4(float* p, int c, int k, bool vec,
                                       const float (&v)[kVec]) {
  if (vec) {
    *reinterpret_cast<float4*>(p + c) = make_float4(v[0], v[1], v[2], v[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < k) p[c + i] = v[i];
  }
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, int c, int k, bool vec,
                                       const float (&v)[kVec]) {
  unsigned short b[kVec];
#pragma unroll
  for (int i = 0; i < kVec; ++i) b[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
  if (vec) {
    *reinterpret_cast<uint2*>(p + c) = make_uint2(b[0] | (unsigned(b[1]) << 16),
                                                  b[2] | (unsigned(b[3]) << 16));
    return;
  }
  unsigned short* s = reinterpret_cast<unsigned short*>(p + c);
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    if (i < k) s[i] = b[i];
  }
}

// tv_split_pixel's arithmetic on values: `xl` is the pixel's left
// neighbour, `xa` the pixel above.
template <int MODE>
__device__ __forceinline__ void split(float xc, float xl, float xa, float ux, float uy,
                                      float tau, float& wx, float& wy, float& uxn,
                                      float& uyn) {
  const float vx = (xc - xl) + ux;
  const float vy = (xc - xa) + uy;
  float zx, zy;
  prox<MODE>(vx, vy, tau, zx, zy);
  uxn = vx - zx;
  uyn = vy - zy;
  wx = zx - uxn;
  wy = zy - uyn;
}

// One row as loaded, for the thread's columns c .. c + 3 (the first k of
// them in the plane): x, and the duals unless the row is row h (those are
// read from the edge rows where they are used); `xl` is x(c - 1) (lane 0
// only); `xe`, `uxe`, `uye` the extra column's values (the end threads).
template <typename T>
struct Row {
  float4 x;
  Pack<T> ux, uy;
  float xl, xe;
  T uxe, uye;
};

// A row's split: w, and the dual updates, at the thread's columns, and wx
// at the extra column.
struct Split {
  float wx[kVec], wy[kVec], uxn[kVec], uyn[kVec];
  float wxe;
};

// The march of one strip (blockIdx.y) and column chunk (blockIdx.x); the
// grid is (chunks, planes * strips) of blocks of whole warps.  `rows` is
// the strip height S and `strips` the strips of a plane.  x, the duals and
// the outputs are contiguous (n, h, w) stacks; tau[p * tau_stride] is
// plane p's threshold.
template <int MODE, typename T, typename H>
__device__ __forceinline__ void march_strip(const float* __restrict__ x,
                                            const T* __restrict__ ux,
                                            const T* __restrict__ uy,
                                            const EdgeRows<H> edge,
                                            const float* __restrict__ tau,
                                            int64_t tau_stride, T* __restrict__ q,
                                            T* __restrict__ ux_out,
                                            T* __restrict__ uy_out, int h, int w,
                                            int rows, int strips, bool vec) {
  const int lane = threadIdx.x & 31;
  const int c = (blockIdx.x * blockDim.x + threadIdx.x) * kVec;
  const int64_t plane = blockIdx.y / strips;
  const int r0 = static_cast<int>(blockIdx.y - plane * strips) * rows;
  const int r1 = min(r0 + rows, h);
  if (r0 >= h) return;  // a whole block: every lane of its warps leaves
  // Lanes past the row's end stay in the march (the shuffles need every
  // lane) but load and store nothing.
  const int k = c < w ? min(kVec, w - c) : 0;
  const bool end = k > 0 && (lane == 31 || c + k == w);
  const int ce = c + k == w ? 0 : c + k;  // the column after the thread's
  const int cl = c == 0 ? w - 1 : c - 1;
  const int64_t base = plane * h * static_cast<int64_t>(w);
  const int64_t edge_off = plane * edge.stride;
  const float t = tau[plane * tau_stride];

  auto x_row = [&](int r) -> const float* {
    if (r < 0) return edge.x_top + edge_off;
    if (r >= h) return edge.x_bot + edge_off;
    return x + base + static_cast<int64_t>(r) * w;
  };
  auto load_row = [&](int r, bool duals) {
    Row<T> row{};
    if (k == 0) return row;
    const float* xp = x_row(r);
    row.x = load4(xp, c, k, vec);
    if (lane == 0) row.xl = xp[cl];
    if (end) row.xe = xp[ce];
    if (duals && r < h) {
      const int64_t off = base + static_cast<int64_t>(r) * w;
      row.ux = load_pack(ux + off, c, k, vec);
      row.uy = load_pack(uy + off, c, k, vec);
      if (end) {
        row.uxe = ux[off + ce];
        row.uye = uy[off + ce];
      }
    }
    return row;
  };
  // Split row r from its loaded values and x of the row above.
  auto split_row = [&](int r, const Row<T>& row, const float (&xa)[kVec], float xea) {
    float xv[kVec], uxv[kVec], uyv[kVec];
    xv[0] = row.x.x;
    xv[1] = row.x.y;
    xv[2] = row.x.z;
    xv[3] = row.x.w;
    float uxe, uye;
    if (r < h) {
      unpack(row.ux, uxv);
      unpack(row.uy, uyv);
      uxe = to_f32(row.uxe);
      uye = to_f32(row.uye);
    } else if (k > 0) {  // row h: the edge rows, read here
      const H* uxb = edge.ux_bot + edge_off;
      const H* uyb = edge.uy_bot + edge_off;
      Pack<H> px = load_pack(uxb, c, k, vec), py = load_pack(uyb, c, k, vec);
      unpack(px, uxv);
      unpack(py, uyv);
      uxe = end ? to_f32(uxb[ce]) : 0.f;
      uye = end ? to_f32(uyb[ce]) : 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) uxv[i] = uyv[i] = 0.f;
      uxe = uye = 0.f;
    }
    float xl = __shfl_up_sync(kFullMask, xv[3], 1);
    if (lane == 0) xl = row.xl;
    Split s;
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const float left = i == 0 ? xl : xv[i > 0 ? i - 1 : 0];
      split<MODE>(xv[i], left, xa[i], uxv[i], uyv[i], t, s.wx[i], s.wy[i], s.uxn[i], s.uyn[i]);
    }
    s.wxe = 0.f;
    if (end) {
      const float xlast = k == 4 ? xv[3] : k == 3 ? xv[2] : k == 2 ? xv[1] : xv[0];
      float wye, uxne, uyne;
      split<MODE>(row.xe, xlast, xea, uxe, uye, t, s.wxe, wye, uxne, uyne);
    }
    return s;
  };

  // x above the strip, then its first row's split.
  float xa[kVec], xea;
  {
    const Row<T> above = load_row(r0 - 1, false);
    xa[0] = above.x.x;
    xa[1] = above.x.y;
    xa[2] = above.x.z;
    xa[3] = above.x.w;
    xea = above.xe;
  }
  const Row<T> first = load_row(r0, true);
  Row<T> next = load_row(r0 + 1, true);
  Split s0 = split_row(r0, first, xa, xea);
  xa[0] = first.x.x;
  xa[1] = first.x.y;
  xa[2] = first.x.z;
  xa[3] = first.x.w;
  xea = first.xe;

  for (int r = r0; r < r1; ++r) {
    // Row r + 2's loads go out before row r + 1's arithmetic.
    Row<T> after{};
    if (r + 2 <= r1) after = load_row(r + 2, true);
    const Split s1 = split_row(r + 1, next, xa, xea);

    float right[kVec];
    right[0] = s0.wx[1];
    right[1] = s0.wx[2];
    right[2] = s0.wx[3];
    right[3] = __shfl_down_sync(kFullMask, s0.wx[0], 1);
    if (end) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (i == k - 1) right[i] = s0.wxe;
      }
    }
    if (k > 0) {
      float qv[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) qv[i] = (s0.wx[i] - right[i]) + (s0.wy[i] - s1.wy[i]);
      const int64_t off = base + static_cast<int64_t>(r) * w;
      store4(q + off, c, k, vec, qv);
      store4(ux_out + off, c, k, vec, s0.uxn);
      store4(uy_out + off, c, k, vec, s0.uyn);
    }
    s0 = s1;
    xa[0] = next.x.x;
    xa[1] = next.x.y;
    xa[2] = next.x.z;
    xa[3] = next.x.w;
    xea = next.xe;
    next = after;
  }
}

}  // namespace admm
