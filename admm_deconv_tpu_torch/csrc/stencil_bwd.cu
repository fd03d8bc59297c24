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
// Its floor on an H100 is memory bandwidth.  Each pixel needs x, ux, uy,
// gq, gux, guy read once and xbar, uxbar, uybar written once: 36 B per
// pixel with fp32 duals and cotangents, 22 B with bf16.  At the 1080p
// TV-layer step's 6 planes of 1080 x 1920 that is ~448 MB (fp32), so
// ~0.134 ms at the data sheet's 3.35 TB/s, against a few dozen FLOPs a
// pixel.  What bounds it in practice is the latency of each row's chain of
// arithmetic (below).
//
// Design: a row march, the forward's (stencil_march.cuh) mirrored.  vb at
// row r needs x and gq at rows r and r - 1 and the duals and cotangents at
// row r; xbar at row r needs vb at rows r and r + 1 and columns c and
// c + 1.  A block owns a strip of rows of one plane and a column chunk;
// each thread owns V consecutive columns and walks down the strip.  At
// each step it computes row r + 1's (vbx, vby, tau terms) once, writes row
// r's xbar, uxbar and uybar, and carries row r + 1's vb (and its x and gq,
// the next row's row above) in registers.  So a strip of S rows evaluates
// vb on S + 1 rows (a one-thread-per-pixel design evaluates it three
// times a pixel), and reads x and gq on rows r0 - 1 .. r0 + S and
// the duals and cotangents on rows r0 .. r0 + S, each once; the loads of
// row r + 2 go out before the arithmetic of row r + 1.  Column neighbours
// come by warp shuffle: x(r, c - 1) and gq(r, c - 1) from the lane before
// (lane 0 reads them from memory), vbx(r, c + V) from the lane after.
//   V = 4 (wide rows): 16-byte loads and stores (8 bytes for four bf16),
//   as the forward; the thread at a warp's end (lane 31, or the one
//   holding column w - 1) also evaluates the column after its own,
//   wrapping in W.  Widths or pointers the wide accesses do not fit (`vec`
//   false) take element-wise accesses in the same march.
//   V = 1 (rows of at most 1024 columns): one block a row, so that many
//   more threads share a small stack; each warp's lane 0 leaves its vbx
//   in shared memory, and after one barrier a row the lane before it (the
//   last lane of the previous warp, or the thread at column w - 1) reads
//   it: nobody evaluates a column twice.  The march is bound by the
//   latency of each row's arithmetic (the iso VJP's sqrt and four IEEE
//   divisions) more than by bytes, so the small stacks want the threads.
//
// The tau cotangent is a table of partial sums, one cell per row and
// 256-column segment, summed by the wrapper with torch.sum.  Its order is
// fixed, and is that of the kernel this one replaced, a thread a pixel in
// blocks of 256 (so its bits do not move): within each 32-column group,
// halving with a[j] += a[j + l] for l = 16, 8, 4, 2, 1; over a segment's 8
// group sums, each plus 0.f twice (that kernel's idle lanes), then halving
// for l = 4, 2, 1.  With V columns a thread, l = 16 .. V are shuffles at
// lane offsets 16 / V .. 1 of each of the thread's terms and l = V / 2 .. 1
// the thread's own sums ((t0 + t2) + (t1 + t3) at V = 4); a segment is one
// chunk of 8 / V warps (fewer where the row is narrower: the missing
// groups are 0), whose group sums meet in shared memory once a strip.  No
// float atomics: the result is deterministic.  ops/kernels/
// stencil_kernels.py's `_taub_partials_plain` emulates the order.
//
// xbar, uxbar and uybar keep that kernel's per-pixel expressions
// (`pixel`), so they too are the same bits.  Build with
// --fmad=false: the plain torch version rounds after every operation, and
// contracting a*b+c into an FMA would move the kernel off it.

#include <stdint.h>

#include <type_traits>

#include "stencil_march.cuh"

namespace {

using namespace admm;

constexpr int kSegment = 256;           // columns of one cell of the tau table
constexpr int kGroups = kSegment / 32;  // its 32-column groups

// A row's values at a thread's V columns as loaded (V = 4: the march
// header's packs, 16- or 8-byte accesses; V = 1: one element).
template <typename T, int V>
using Cols = std::conditional_t<V == 4, Pack<T>, T>;

template <int V, typename T>
__device__ __forceinline__ Cols<T, V> load_cols(const T* p, int c, int k, bool vec) {
  if constexpr (V == 4) {
    return load_pack(p, c, k, vec);
  } else {
    return p[c];
  }
}

template <int V, typename T>
__device__ __forceinline__ void unpack_cols(const Cols<T, V>& v, float (&o)[V]) {
  if constexpr (V == 4) {
    unpack(v, o);
  } else {
    o[0] = to_f32(v);
  }
}

template <int V, typename T>
__device__ __forceinline__ void store_cols(T* p, int c, int k, bool vec, const float (&v)[V]) {
  if constexpr (V == 4) {
    store4(p, c, k, vec, v);
  } else {
    store(p + c, v[0]);
  }
}

// vb at one pixel and its tau term: `xc`/`gc` are x and gq at the pixel,
// `xl`/`gl` at its left neighbour, `xa`/`ga` above it.
template <int MODE>
__device__ __forceinline__ void pixel(float xc, float xl, float xa, float ux, float uy,
                                      float gc, float gl, float ga, float gx, float gy,
                                      float tau, float& vbx, float& vby, float& taub) {
  const float vx = (xc - xl) + ux;
  const float vy = (xc - xa) + uy;
  const float wbx = gc - gl;
  const float wby = gc - ga;
  const float zbx = 2.f * wbx - gx;
  const float zby = 2.f * wby - gy;
  float pvx, pvy;
  prox_vjp<MODE>(vx, vy, tau, zbx, zby, pvx, pvy, taub);
  vbx = (gx - wbx) + pvx;
  vby = (gy - wby) + pvy;
}

// One row as loaded, for the thread's columns c .. c + V - 1 (the first k
// of them in the plane): x and gq, and the duals and cotangents unless it
// is only the row above a strip; `xl`/`gl` are x and gq at c - 1 (lane 0
// only); `xe`, `ge`, ... the extra column's values (the `extra` threads).
template <typename T, int V>
struct Row {
  Cols<float, V> x;
  Cols<T, V> gq, ux, uy, gux, guy;
  float xl, gl, xe, ge;
  T uxe, uye, guxe, guye;
};

// x and gq of a row as the row below reads them, as floats.
template <int V>
struct Above {
  float x[V], g[V];
  float xe, ge;
};

// A row's vb at the thread's columns, their tau terms (0 beyond w), and
// vbx at the extra column.
template <int V>
struct Vb {
  float vbx[V], vby[V], tb[V];
  float vbxe;
};

// The march of one strip (blockIdx.x) and column block (blockIdx.y); the
// grid is (planes * strips, column blocks) of blocks of whole chunks of
// `chunk_warps` warps, V columns a thread; a chunk is one 256-column
// segment of the tau table (or the whole row where it is narrower).  `rows`
// is the strip height S.  Every plane array is a contiguous (n, h, w)
// stack; tau[p * tau_stride] is plane p's threshold; `taub_part` is the
// (n, h * ceil(w / 256)) table.  Dynamic shared memory: vbx at each warp's
// first column for two rows, then the block's chunks x rows x 8 group sums.
template <int MODE, typename T, int V>
__global__ void __launch_bounds__(V == 1 ? 1024 : 256)
    stencil_bwd_kernel(const float* __restrict__ x, const T* __restrict__ ux,
                       const T* __restrict__ uy, const float* __restrict__ tau,
                       int64_t tau_stride, const T* __restrict__ gq,
                       const T* __restrict__ gux, const T* __restrict__ guy,
                       float* __restrict__ xbar, T* __restrict__ uxbar,
                       T* __restrict__ uybar, float* __restrict__ taub_part, int h, int w,
                       int rows, int strips, int chunk_warps, bool vec) {
  extern __shared__ float shared[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int c = (blockIdx.y * blockDim.x + threadIdx.x) * V;
  const int64_t plane = blockIdx.x / strips;
  const int r0 = static_cast<int>(blockIdx.x - plane * strips) * rows;
  if (r0 >= h) return;  // a whole block: every lane of its warps leaves
  const int r1 = min(r0 + rows, h);
  // Lanes past the row's end stay in the march (the shuffles and barriers
  // need every lane) but load and store nothing, and their tau terms are 0.
  const int k = c < w ? min(V, w - c) : 0;
  const bool last = k > 0 && c + k == w;  // holds column w - 1
  // The column after the thread's last (column 0 after w - 1) is the first
  // of the next thread, or of thread 0 where one block holds the whole row.
  // At 4 columns a thread its vbx comes by shuffle within the warp, and the
  // warp's last thread evaluates it itself (`extra`); at 1 column a thread
  // also through shared memory from another warp of the block (one barrier
  // a row), and only a thread whose next column lies in another block
  // evaluates it.
  const bool extra = k > 0 && (V == 4 ? lane == 31 || last
                                      : gridDim.y > 1 && (threadIdx.x == blockDim.x - 1 || last));
  const int src = last ? 0 : threadIdx.x + 1;
  const bool cross = k > 0 && !extra && (src >> 5) != warp;
  const int src_lane = cross || extra || k == 0 ? lane : (src & 31);
  const int ce = last ? 0 : c + k;
  const int cl = c == 0 ? w - 1 : c - 1;
  const int64_t base = plane * h * static_cast<int64_t>(w);
  const float t = tau[plane * tau_stride];
  const int chunk_threads = 32 * chunk_warps;
  const int chunk_local = threadIdx.x / chunk_threads;
  const int warp_in_chunk = (threadIdx.x % chunk_threads) >> 5;
  float* lead = shared;  // [2][warps] at 1 column a thread
  float* sums = shared + (V == 1 ? 2 * warps : 0) + chunk_local * rows * kGroups;

  auto load_row = [&](int r, bool duals) {
    Row<T, V> row{};
    if (k == 0) return row;
    r = r < 0 ? r + h : (r >= h ? r - h : r);  // circular in H
    const int64_t off = base + static_cast<int64_t>(r) * w;
    row.x = load_cols<V>(x + off, c, k, vec);
    row.gq = load_cols<V>(gq + off, c, k, vec);
    if (lane == 0) {
      row.xl = x[off + cl];
      row.gl = to_f32(gq[off + cl]);
    }
    if (extra) {
      row.xe = x[off + ce];
      row.ge = to_f32(gq[off + ce]);
    }
    if (duals) {
      row.ux = load_cols<V>(ux + off, c, k, vec);
      row.uy = load_cols<V>(uy + off, c, k, vec);
      row.gux = load_cols<V>(gux + off, c, k, vec);
      row.guy = load_cols<V>(guy + off, c, k, vec);
      if (extra) {
        row.uxe = ux[off + ce];
        row.uye = uy[off + ce];
        row.guxe = gux[off + ce];
        row.guye = guy[off + ce];
      }
    }
    return row;
  };
  auto above_of = [&](const Row<T, V>& row) {
    Above<V> a;
    unpack_cols<V, float>(row.x, a.x);
    unpack_cols<V, T>(row.gq, a.g);
    a.xe = row.xe;
    a.ge = row.ge;
    return a;
  };
  // vb of a row from its loaded values and x, gq of the row above.
  auto vb_row = [&](const Row<T, V>& row, const Above<V>& a) {
    float xv[V], gv[V], uxv[V], uyv[V], gxv[V], gyv[V];
    unpack_cols<V, float>(row.x, xv);
    unpack_cols<V, T>(row.gq, gv);
    unpack_cols<V, T>(row.ux, uxv);
    unpack_cols<V, T>(row.uy, uyv);
    unpack_cols<V, T>(row.gux, gxv);
    unpack_cols<V, T>(row.guy, gyv);
    float xl = __shfl_up_sync(kFullMask, xv[V - 1], 1);
    float gl = __shfl_up_sync(kFullMask, gv[V - 1], 1);
    if (lane == 0) {
      xl = row.xl;
      gl = row.gl;
    }
    Vb<V> s;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      pixel<MODE>(xv[i], i == 0 ? xl : xv[i > 0 ? i - 1 : 0], a.x[i], uxv[i], uyv[i], gv[i],
                  i == 0 ? gl : gv[i > 0 ? i - 1 : 0], a.g[i], gxv[i], gyv[i], t, s.vbx[i],
                  s.vby[i], s.tb[i]);
      if (i >= k) s.tb[i] = 0.f;
    }
    s.vbxe = 0.f;
    if (extra) {
      float xlast = xv[0], glast = gv[0];
#pragma unroll
      for (int i = 1; i < V; ++i) {
        if (i == k - 1) {
          xlast = xv[i];
          glast = gv[i];
        }
      }
      float vbye, tbe;
      pixel<MODE>(row.xe, xlast, a.xe, to_f32(row.uxe), to_f32(row.uye), row.ge, glast, a.ge,
                  to_f32(row.guxe), to_f32(row.guye), t, s.vbxe, vbye, tbe);
    }
    return s;
  };
  // vbx at the column after the thread's last, in the row `s` holds;
  // `buf` alternates by row, so one barrier a row keeps the slots apart.
  auto after_last = [&](const Vb<V>& s, int buf) {
    const float shuffled = __shfl_sync(kFullMask, s.vbx[0], src_lane);
    if (V == 1 && warps > 1) {  // uniform over the block
      if (lane == 0) lead[buf * warps + warp] = s.vbx[0];
      __syncthreads();
    }
    if (extra) return s.vbxe;
    return cross ? lead[buf * warps + (src >> 5)] : shuffled;
  };

  Above<V> above = above_of(load_row(r0 - 1, false));
  const Row<T, V> first = load_row(r0, true);
  Row<T, V> next = load_row(r0 + 1, true);
  Vb<V> s0 = vb_row(first, above);
  float n0 = after_last(s0, r0 & 1);
  above = above_of(first);

  for (int r = r0; r < r1; ++r) {
    // Row r + 2's loads go out before row r + 1's arithmetic.
    Row<T, V> after{};
    if (r + 2 <= r1) after = load_row(r + 2, true);
    const Vb<V> s1 = vb_row(next, above);
    const float n1 = after_last(s1, (r + 1) & 1);

    if (k > 0) {
      const int64_t off = base + static_cast<int64_t>(r) * w;
      if (xbar != nullptr) {
        float xb[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float right = i + 1 < k ? s0.vbx[i + 1 < V ? i + 1 : 0] : n0;
          xb[i] = (s0.vbx[i] - right) + (s0.vby[i] - s1.vby[i]);
        }
        store_cols<V>(xbar + off, c, k, vec, xb);
      }
      if (uxbar != nullptr) {
        store_cols<V>(uxbar + off, c, k, vec, s0.vbx);
        store_cols<V>(uybar + off, c, k, vec, s0.vby);
      }
    }
    if (taub_part != nullptr) {
      // Levels 16 .. V of a 32-column group across lanes (offsets 16 / V
      // .. 1), then levels V / 2 .. 1 within the thread.
      float a[V];
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] = s0.tb[i];
#pragma unroll
      for (int off = 16 / V; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < V; ++i) a[i] = a[i] + __shfl_down_sync(kFullMask, a[i], off);
      }
#pragma unroll
      for (int l = V / 2; l > 0; l >>= 1) {
#pragma unroll
        for (int i = 0; i < l; ++i) a[i] = a[i] + a[i + l];
      }
      if (lane % (32 / V) == 0) {
        sums[(r - r0) * kGroups + warp_in_chunk * V + lane / (32 / V)] = (a[0] + 0.f) + 0.f;
      }
    }
    s0 = s1;
    n0 = n1;
    above = above_of(next);
    next = after;
  }

  if (taub_part == nullptr) return;  // uniform over the grid
  __syncthreads();
  // One thread a row of the strip: the segment's 8 group sums (+0 for a
  // group past a narrow row's chunk), halved.
  const int groups = chunk_warps * V;
  const int segments = gridDim.y * (blockDim.x / chunk_threads);
  const int segment = blockIdx.y * (blockDim.x / chunk_threads) + chunk_local;
  for (int rr = threadIdx.x % chunk_threads; rr < r1 - r0; rr += chunk_threads) {
    const float* g = sums + rr * kGroups;
    float b[kGroups / 2];
#pragma unroll
    for (int j = 0; j < kGroups / 2; ++j) {
      b[j] = (j < groups ? g[j] : 0.f) + (j + kGroups / 2 < groups ? g[j + kGroups / 2] : 0.f);
    }
    taub_part[(plane * h + r0 + rr) * segments + segment] = (b[0] + b[2]) + (b[1] + b[3]);
  }
}

template <typename T, int V>
cudaError_t launch_cols(int mode, const float* x, const T* ux, const T* uy, const float* tau,
                        int64_t tau_stride, const T* gq, const T* gux, const T* guy,
                        float* xbar, T* uxbar, T* uybar, float* taub_part, int64_t n, int h,
                        int w, int rows, int strips, int col_blocks, int threads,
                        int chunk_warps, bool vec, cudaStream_t stream) {
  const int chunk_threads = 32 * chunk_warps;
  const int chunk_cols = chunk_threads * V;
  const int segments = (w + kSegment - 1) / kSegment;
  if (chunk_warps < 1 || chunk_cols > kSegment ||
      (chunk_cols < kSegment && (segments > 1 || chunk_cols < w)) ||
      threads % chunk_threads != 0 || threads > (V == 1 ? 1024 : 256) || rows < 1 ||
      static_cast<int64_t>(rows) * strips < h || n * strips > INT32_MAX ||
      col_blocks > 65535 || col_blocks * (threads / chunk_threads) != segments) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * ((V == 1 ? 2 * (threads / 32) : 0) +
                                       (threads / chunk_threads) * rows * kGroups);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n * strips), col_blocks);
#define ADMM_BWD_LAUNCH(M)                                                                 \
  stencil_bwd_kernel<M, T, V><<<grid, threads, smem, stream>>>(                            \
      x, ux, uy, tau, tau_stride, gq, gux, guy, xbar, uxbar, uybar, taub_part, h, w, rows, \
      strips, chunk_warps, vec)
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

template <typename T>
cudaError_t launch(int mode, const float* x, const void* ux, const void* uy,
                   const float* tau, int64_t tau_stride, const void* gq, const void* gux,
                   const void* guy, float* xbar, void* uxbar, void* uybar, float* taub_part,
                   int64_t n, int h, int w, int rows, int strips, int col_blocks,
                   int threads, int chunk_warps, int cols, bool vec, cudaStream_t stream) {
  const T* uxp = static_cast<const T*>(ux);
  const T* uyp = static_cast<const T*>(uy);
  const T* gqp = static_cast<const T*>(gq);
  const T* gxp = static_cast<const T*>(gux);
  const T* gyp = static_cast<const T*>(guy);
  T* uxb = static_cast<T*>(uxbar);
  T* uyb = static_cast<T*>(uybar);
  if (cols == 4) {
    return launch_cols<T, 4>(mode, x, uxp, uyp, tau, tau_stride, gqp, gxp, gyp, xbar, uxb,
                             uyb, taub_part, n, h, w, rows, strips, col_blocks, threads,
                             chunk_warps, vec, stream);
  }
  if (cols == 1) {
    return launch_cols<T, 1>(mode, x, uxp, uyp, tau, tau_stride, gqp, gxp, gyp, xbar, uxb,
                             uyb, taub_part, n, h, w, rows, strips, col_blocks, threads,
                             chunk_warps, false, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the backward stencil on `stream` and returns cudaGetLastError()
// (0 on success).  `mode`: 0 aniso, 1 iso, 2 hard, 3 gauss.  `bf16`: 0 when
// the duals, cotangents and ubar are float, 1 when they are __nv_bfloat16;
// x, tau and xbar are always float.  Every plane array is a contiguous
// (n, h, w) stack; plane p's tau is tau[p * tau_stride] (0 for one tau);
// `taub_part` is an (n, h * ceil(w / 256)) float table of partial sums.
// `xbar`, `uxbar`/`uybar` (together) and `taub_part` may each be null, and
// are then not written.  The grid is (n * strips, col_blocks) blocks of
// `threads`, each marching `rows` rows over chunks of `chunk_warps` warps,
// `cols` (1 or 4) columns a thread; `vec` is 1 when every row takes 16-byte
// accesses (w % 4 == 0, aligned pointers).
int admm_stencil_bwd(const void* x, const void* ux, const void* uy, const void* tau,
                     const void* gq, const void* gux, const void* guy, void* xbar,
                     void* uxbar, void* uybar, void* taub_part, int64_t n, int h, int w,
                     int mode, int bf16, int64_t tau_stride, int rows, int strips,
                     int col_blocks, int threads, int chunk_warps, int cols, int vec,
                     void* stream) {
  if ((uxbar == nullptr) != (uybar == nullptr)) return cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* tp = static_cast<const float*>(tau);
  float* xb = static_cast<float*>(xbar);
  float* tb = static_cast<float*>(taub_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch<__nv_bfloat16>(mode, xp, ux, uy, tp, tau_stride, gq, gux, guy, xb, uxbar,
                                 uybar, tb, n, h, w, rows, strips, col_blocks, threads,
                                 chunk_warps, cols, vec != 0, s);
  }
  return launch<float>(mode, xp, ux, uy, tp, tau_stride, gq, gux, guy, xb, uxbar, uybar, tb,
                       n, h, w, rows, strips, col_blocks, threads, chunk_warps, cols,
                       vec != 0, s);
}

const char* admm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
