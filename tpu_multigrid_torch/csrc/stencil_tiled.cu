// Hand-written Hopper (sm_90a) x-tiled kernels for lattices past the L2.
//
// Ports of the x-tiled Pallas TPU kernels in tpu_multigrid/ops/pallas_stencil.py:
//   links_tiled_kernel<T, kUpdate> <- _u_update_tile_kernel (B5a, :711;
//                                     Jacobi, or one red/black half-sweep
//                                     in place)
//   links_tiled_kernel<T, kResid>  <- _u_resid_tile_kernel  (B5b, :703)
//   links_tiled_kernel<T, kApply>  <- _u_apply_tile_kernel  (B5c, :695)
//   dense_tiled_kernel<T, N>       <- _tiled_update_kernel  (B6, :358; n in
//                                     {1,2,4}, batch axis with per-operand
//                                     batch strides)
//   dense_apply_tiled_kernel<T, N> <- _tiled_apply_kernel   (B7b, :236)
// Layouts are stencil.cu's: U[2][L][L], phi/r/v/out[B][n][L][L],
// D[B][5][n][n][L][L], D0inv[B][n][n][L][L], site (x, y) at x*L + y.
//
// What bounds them on the H100: bytes. At L=2048 the level-0 links set is
// ~270 MB (c64) and level 1's dense D ~670 MB, far past the 50 MB L2, so
// what one launch reads is gone before the next: every word of U, r, phi, D
// and D0inv comes from HBM once per pass (a red/black half-sweep reads the
// whole of U and phi and half of r, D and D0inv, whose sectors it still
// fetches whole). The SpMVs move 5n^2 + 2n words a site (B7b: D, v in,
// out) and 6 (B5c: U, v in, out); their neighbour reads of v come from
// the staged tile, so each word of v crosses HBM once.
//
// Design: each block of 32 x 8 threads owns a TX x TY tile of sites
// (TX <= 16, TY <= 32). It stages that tile of phi, plus a one-site periodic
// halo in x and y, into shared memory with coalesced row loads, and computes
// every update of the tile from there. A thread owns two sites, (x, y) and
// (x + 8, y); the 32 threads of a warp cover 32 consecutive y. U and r are
// read once per site straight into registers (U_x at x-1 and U_y at y-1 for
// the -x and -y hops, wrapped), issued before the barrier so that they are
// in flight together with the staging; D and D0inv are read in the update.
// Colour parity comes from the global (x + y), never from tile-local
// coordinates. A tile is clipped to the lattice, so tiles need not divide L
// and a lattice may be smaller than one tile.
//
// A first version that also staged U, with one load and one store per
// staged element (two integer divisions each), ran the links sweep at
// L=2048 1.6x slower than stencil.cu's global kernel; this one is as fast
// or faster (PERF.md).
//
// A red/black half-sweep writes only its colour, in place, as in stencil.cu:
// with even L a site of one colour reads only the other colour, which no
// block writes in that launch (a block may stage a neighbour's site of the
// colour being written, but never reads it). The colour barrier across the
// grid is the launch boundary.
//
// Kept simple on purpose: no TMA, no cp.async ring, no persistent blocks and
// no fusing of sweeps.

#include "cplx.cuh"

namespace {

using tmg::cplx;
using tmg::mk;
using tmg::scale;

constexpr int kThreadsY = 32;  // threadIdx.x: consecutive y (one warp)
constexpr int kThreadsX = 8;   // threadIdx.y: x
constexpr int kThreads = kThreadsY * kThreadsX;
constexpr int kRows = 2;                       // sites a thread owns, along x
constexpr int kMaxTX = kThreadsX * kRows;      // 16
constexpr int kMaxTY = kThreadsY;              // 32
constexpr int kHaloRows = (kMaxTX + 2 + kThreadsX - 1) / kThreadsX;  // 3

struct Tile {
  int x0, y0;  // origin of the tile on the lattice
  int tx, ty;  // its extent, clipped to the lattice
};

__device__ __forceinline__ Tile tile_of(int TX, int TY, int L) {
  Tile t;
  t.x0 = blockIdx.y * TX;
  t.y0 = blockIdx.x * TY;
  t.tx = min(TX, L - t.x0);
  t.ty = min(TY, L - t.y0);
  return t;
}

// Periodic index of i in [-1, L].
__device__ __forceinline__ int wrap(int i, int L) {
  return i < 0 ? i + L : (i >= L ? i - L : i);
}

// Stage P planes of the tile's phi with its one-site halo: lattice rows
// x0-1 .. x0+tx and columns y0-1 .. y0+ty, wrapped periodically, at
// sm[p * plane + i * pitch + j] for site (x0 + i - 1, y0 + j - 1). Warp w
// takes rows w, w + 8, w + 16; lane l column y0 + l, and lanes 0 and 1 the
// halo columns y0 - 1 and y0 + ty. Every load of a thread is issued before
// its first store.
template <typename T, int P>
__device__ __forceinline__ void stage_phi(cplx<T>* sm, int plane, int pitch,
                                          const cplx<T>* __restrict__ src,
                                          size_t LL, int L, const Tile& t) {
  const int lane = threadIdx.x;
  const bool mid = lane < t.ty;
  const bool halo = lane < 2;
  const int gy = mid ? t.y0 + lane : 0;
  const int hy = lane == 0 ? wrap(t.y0 - 1, L) : wrap(t.y0 + t.ty, L);
  const int hj = lane == 0 ? 0 : t.ty + 1;
  cplx<T> v[P][kHaloRows], h[P][kHaloRows];
#pragma unroll
  for (int u = 0; u < kHaloRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    if (i >= t.tx + 2) continue;
    const cplx<T>* row = src + (size_t)wrap(t.x0 - 1 + i, L) * L;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (mid) v[p][u] = row[p * LL + gy];
      if (halo) h[p][u] = row[p * LL + hy];
    }
  }
#pragma unroll
  for (int u = 0; u < kHaloRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    if (i >= t.tx + 2) continue;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (mid) sm[p * plane + i * pitch + lane + 1] = v[p][u];
      if (halo) sm[p * plane + i * pitch + hj] = h[p][u];
    }
  }
}

// What the links kernel writes at a site.
enum LinksMode { kUpdate, kResid, kApply };

// Links-only Wilson on one tile. kResid: out = r - (2+m) phi - hop(phi) at
// every site; kApply: out = (2+m) phi + hop(phi) at every site (r is not
// read). kUpdate: the smoother update (r - hop(phi)) / (2+m), relaxed by
// omega: colour < 0 Jacobi into a separate out, colour 0/1 that colour's
// sites in place (out == phi).
//
// A thread owns sites (x0 + threadIdx.y + 8u, y0 + threadIdx.x), u < 2. It
// loads their links (U_x at x and x-1, U_y at y and y-1: the -x and -y hops
// read the neighbour's link) and r into registers before the barrier, so
// those loads are in flight with the staging of phi [2][TX+2][TY+2].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    links_tiled_kernel(const cplx<T>* __restrict__ U, const cplx<T>* phi,
                       const cplx<T>* __restrict__ r, cplx<T>* out, int L,
                       T diag, T omega, int colour, int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const int vp = TY + 2;
  const int vpl = (TX + 2) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  const int j = threadIdx.x;
  const int y = t.y0 + j;

  bool act[kRows];
  cplx<T> ux[kRows], uxm[kRows], uy[kRows], uym[kRows], rv[kRows][2];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    const int x = t.x0 + i;
    act[u] = i < t.tx && j < t.ty && (colour < 0 || ((x + y) & 1) == colour);
    if (act[u]) {
      const size_t s = (size_t)x * L + y;
      ux[u] = U[s];
      uxm[u] = U[(size_t)wrap(x - 1, L) * L + y];
      uy[u] = U[LL + s];
      uym[u] = U[LL + (size_t)x * L + wrap(y - 1, L)];
      if constexpr (MODE != kApply) {
        rv[u][0] = r[s];
        rv[u][1] = r[LL + s];
      }
    }
  }
  stage_phi<T, 2>(sv, vpl, vp, phi, LL, L, t);
  __syncthreads();

#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    if (!act[u]) continue;
    const int i = threadIdx.y + u * kThreadsX;
    const cplx<T>* c0 = sv + (i + 1) * vp + (j + 1);
    const cplx<T>* c1 = c0 + vpl;
    cplx<T> h[2];
    tmg::wilson_hop_core(ux[u], uxm[u], uy[u], uym[u], c0[vp], c1[vp],
                         c0[-vp], c1[-vp], c0[1], c1[1], c0[-1], c1[-1], h[0],
                         h[1]);
    const size_t s = (size_t)(t.x0 + i) * L + y;
    const cplx<T> v[2] = {*c0, *c1};
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if constexpr (MODE == kResid) {
        out[k * LL + s] = rv[u][k] - scale(diag, v[k]) - h[k];
      } else if constexpr (MODE == kApply) {
        out[k * LL + s] = scale(diag, v[k]) + h[k];
      } else {
        const cplx<T> d = rv[u][k] - h[k];
        cplx<T> upd = mk<T>(d.re / diag, d.im / diag);
        if (omega != T(1)) upd = v[k] + scale(omega, upd - v[k]);
        out[k * LL + s] = upd;
      }
    }
  }
}

// Dense 5-point block stencil update on one tile of batch entry blockIdx.z:
//   upd = -D0inv (sum_{mu != 0} D_mu phi(x + mu) - r), relaxed by omega;
// colour < 0 Jacobi into a separate out, colour 0/1 in place. Sites per
// thread as in links_tiled_kernel; phi [N][TX+2][TY+2] staged. D and D0inv
// (5 n^2 words a site) are read in the update itself, where their loads
// keep enough bytes in flight.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    dense_tiled_kernel(const cplx<T>* __restrict__ D,
                       const cplx<T>* __restrict__ Dinv, const cplx<T>* phi,
                       const cplx<T>* __restrict__ r, cplx<T>* out, int L,
                       long long d_bstride, long long dinv_bstride,
                       long long r_bstride, int colour, T omega, int TX,
                       int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  const cplx<T>* Db = D + b * (size_t)d_bstride;
  const cplx<T>* Dib = Dinv + b * (size_t)dinv_bstride;
  const cplx<T>* rb = r + b * (size_t)r_bstride;
  const cplx<T>* pb = phi + b * (N * LL);
  cplx<T>* ob = out + b * (N * LL);
  const int vp = TY + 2;
  const int vpl = (TX + 2) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  stage_phi<T, N>(sv, vpl, vp, pb, LL, L, t);
  __syncthreads();

  const int j = threadIdx.x;
  const int y = t.y0 + j;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    const int x = t.x0 + i;
    if (i >= t.tx || j >= t.ty) continue;
    if (colour >= 0 && ((x + y) & 1) != colour) continue;
    const cplx<T>* c = sv + (i + 1) * vp + (j + 1);
    const size_t s = (size_t)x * L + y;
    cplx<T> a[N];
#pragma unroll
    for (int p = 0; p < N; ++p) a[p] = mk<T>(T(0), T(0));
#pragma unroll
    for (int d = 1; d < 5; ++d) {  // +x, -x, +y, -y
      const int o = d == 1 ? vp : d == 2 ? -vp : d == 3 ? 1 : -1;
      cplx<T> v[N];
#pragma unroll
      for (int q = 0; q < N; ++q) v[q] = c[q * vpl + o];
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int q = 0; q < N; ++q)
          a[p] = a[p] + Db[((size_t)(d * N + p) * N + q) * LL + s] * v[q];
    }
#pragma unroll
    for (int q = 0; q < N; ++q) a[q] = a[q] - rb[q * LL + s];
#pragma unroll
    for (int p = 0; p < N; ++p) {
      cplx<T> acc = mk<T>(T(0), T(0));
#pragma unroll
      for (int q = 0; q < N; ++q)
        acc = acc + Dib[(size_t)(p * N + q) * LL + s] * a[q];
      cplx<T> upd = mk<T>(-acc.re, -acc.im);
      const cplx<T> old = c[p * vpl];
      if (omega != T(1)) upd = old + scale(omega, upd - old);
      ob[p * LL + s] = upd;
    }
  }
}

// Dense 5-point block SpMV on one tile of batch entry blockIdx.z (B7b):
//   out = sum_{mu = 0..4} D_mu v(x + mu).
// Sites per thread as in links_tiled_kernel; v [N][TX+2][TY+2] staged with
// its periodic halo (every neighbour is read, not one colour's), D read
// once per site straight from global memory. D and v each shared by the
// batch (stride 0) or batched; out is batched and must not alias v.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
    dense_apply_tiled_kernel(const cplx<T>* __restrict__ D,
                             const cplx<T>* __restrict__ v,
                             cplx<T>* __restrict__ out, int L,
                             long long d_bstride, long long v_bstride, int TX,
                             int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  const cplx<T>* Db = D + b * (size_t)d_bstride;
  cplx<T>* ob = out + b * (N * LL);
  const int vp = TY + 2;
  const int vpl = (TX + 2) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  stage_phi<T, N>(sv, vpl, vp, v + b * (size_t)v_bstride, LL, L, t);
  __syncthreads();

  const int j = threadIdx.x;
  const int y = t.y0 + j;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    if (i >= t.tx || j >= t.ty) continue;
    const cplx<T>* c = sv + (i + 1) * vp + (j + 1);
    const size_t s = (size_t)(t.x0 + i) * L + y;
    cplx<T> a[N];
#pragma unroll
    for (int p = 0; p < N; ++p) a[p] = mk<T>(T(0), T(0));
#pragma unroll
    for (int d = 0; d < 5; ++d) {  // same, +x, -x, +y, -y
      const int o = d == 0 ? 0 : d == 1 ? vp : d == 2 ? -vp : d == 3 ? 1 : -1;
      cplx<T> w[N];
#pragma unroll
      for (int q = 0; q < N; ++q) w[q] = c[q * vpl + o];
#pragma unroll
      for (int p = 0; p < N; ++p)
#pragma unroll
        for (int q = 0; q < N; ++q)
          a[p] = a[p] + Db[((size_t)(d * N + p) * N + q) * LL + s] * w[q];
    }
#pragma unroll
    for (int p = 0; p < N; ++p) ob[p * LL + s] = a[p];
  }
}

// Grid over (y tiles, x tiles, batch), or cudaErrorInvalidValue for a tile
// or batch the kernels do not take.
inline int grid_of(int L, int TX, int TY, int B, dim3& grid) {
  if (L < 1 || TX < 1 || TX > kMaxTX || TY < 1 || TY > kMaxTY || B < 1 ||
      B > 65535 || (L + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)((L + TY - 1) / TY), (unsigned)((L + TX - 1) / TX),
              (unsigned)B);
  return 0;
}

template <typename T, int MODE>
int links_tiled(const void* U, const void* phi, const void* r, void* out,
                int L, double m, double omega, int colour, int TX, int TY,
                void* stream) {
  const size_t smem = sizeof(cplx<T>) * 2 * (size_t)(TX + 2) * (TY + 2);
  dim3 grid;
  const int err = grid_of(L, TX, TY, 1, grid);
  if (err) return err;
  links_tiled_kernel<T, MODE>
      <<<grid, dim3(kThreadsY, kThreadsX), smem, (cudaStream_t)stream>>>(
          (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
          (cplx<T>*)out, L, T(2.0 + m), T(omega), colour, TX, TY);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int dense_tiled_n(const void* D, const void* Dinv, const void* phi,
                  const void* r, void* out, int B, int L, long long d_bs,
                  long long dinv_bs, long long r_bs, int colour,
                  double omega, int TX, int TY, void* stream) {
  const size_t smem = sizeof(cplx<T>) * N * (size_t)(TX + 2) * (TY + 2);
  dim3 grid;
  const int err = grid_of(L, TX, TY, B, grid);
  if (err) return err;
  dense_tiled_kernel<T, N>
      <<<grid, dim3(kThreadsY, kThreadsX), smem, (cudaStream_t)stream>>>(
          (const cplx<T>*)D, (const cplx<T>*)Dinv, (const cplx<T>*)phi,
          (const cplx<T>*)r, (cplx<T>*)out, L, d_bs, dinv_bs, r_bs, colour,
          T(omega), TX, TY);
  return (int)cudaGetLastError();
}

template <typename T>
int dense_tiled(const void* D, const void* Dinv, const void* phi,
                const void* r, void* out, int B, int n, int L, long long d_bs,
                long long dinv_bs, long long r_bs, int colour, double omega,
                int TX, int TY, void* stream) {
  switch (n) {
    case 1:
      return dense_tiled_n<T, 1>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                 r_bs, colour, omega, TX, TY, stream);
    case 2:
      return dense_tiled_n<T, 2>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                 r_bs, colour, omega, TX, TY, stream);
    case 4:
      return dense_tiled_n<T, 4>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                 r_bs, colour, omega, TX, TY, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int N>
int dense_apply_tiled_n(const void* D, const void* v, void* out, int B, int L,
                        long long d_bs, long long v_bs, int TX, int TY,
                        void* stream) {
  const size_t smem = sizeof(cplx<T>) * N * (size_t)(TX + 2) * (TY + 2);
  dim3 grid;
  const int err = grid_of(L, TX, TY, B, grid);
  if (err) return err;
  dense_apply_tiled_kernel<T, N>
      <<<grid, dim3(kThreadsY, kThreadsX), smem, (cudaStream_t)stream>>>(
          (const cplx<T>*)D, (const cplx<T>*)v, (cplx<T>*)out, L, d_bs, v_bs,
          TX, TY);
  return (int)cudaGetLastError();
}

template <typename T>
int dense_apply_tiled(const void* D, const void* v, void* out, int B, int n,
                      int L, long long d_bs, long long v_bs, int TX, int TY,
                      void* stream) {
  switch (n) {
    case 1:
      return dense_apply_tiled_n<T, 1>(D, v, out, B, L, d_bs, v_bs, TX, TY,
                                       stream);
    case 2:
      return dense_apply_tiled_n<T, 2>(D, v, out, B, L, d_bs, v_bs, TX, TY,
                                       stream);
    case 4:
      return dense_apply_tiled_n<T, 4>(D, v, out, B, L, d_bs, v_bs, TX, TY,
                                       stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/cuda_stencil.py). Each entry
// launches on the given stream, does not synchronise, allocates nothing and
// returns the CUDA error of its launch (cudaErrorInvalidValue for a tile the
// kernel does not take).
extern "C" {

int tmg_links_residual_tiled_c64(const void* U, const void* phi,
                                 const void* r, void* out, int L, double m,
                                 int TX, int TY, void* stream) {
  return links_tiled<float, kResid>(U, phi, r, out, L, m, 1.0, -1, TX, TY,
                                    stream);
}
int tmg_links_residual_tiled_c128(const void* U, const void* phi,
                                  const void* r, void* out, int L, double m,
                                  int TX, int TY, void* stream) {
  return links_tiled<double, kResid>(U, phi, r, out, L, m, 1.0, -1, TX, TY,
                                     stream);
}

int tmg_links_update_tiled_c64(const void* U, const void* phi, const void* r,
                               void* out, int L, double m, double omega,
                               int colour, int TX, int TY, void* stream) {
  return links_tiled<float, kUpdate>(U, phi, r, out, L, m, omega, colour, TX,
                                     TY, stream);
}
int tmg_links_update_tiled_c128(const void* U, const void* phi, const void* r,
                                void* out, int L, double m, double omega,
                                int colour, int TX, int TY, void* stream) {
  return links_tiled<double, kUpdate>(U, phi, r, out, L, m, omega, colour, TX,
                                      TY, stream);
}

int tmg_dense_update_tiled_c64(const void* D, const void* Dinv,
                               const void* phi, const void* r, void* out,
                               int B, int n, int L, long long d_bs,
                               long long dinv_bs, long long r_bs, int colour,
                               double omega, int TX, int TY, void* stream) {
  return dense_tiled<float>(D, Dinv, phi, r, out, B, n, L, d_bs, dinv_bs,
                            r_bs, colour, omega, TX, TY, stream);
}
int tmg_dense_update_tiled_c128(const void* D, const void* Dinv,
                                const void* phi, const void* r, void* out,
                                int B, int n, int L, long long d_bs,
                                long long dinv_bs, long long r_bs,
                                int colour, double omega, int TX, int TY,
                                void* stream) {
  return dense_tiled<double>(D, Dinv, phi, r, out, B, n, L, d_bs, dinv_bs,
                             r_bs, colour, omega, TX, TY, stream);
}

int tmg_links_apply_tiled_c64(const void* U, const void* v, void* out, int L,
                              double m, int TX, int TY, void* stream) {
  return links_tiled<float, kApply>(U, v, nullptr, out, L, m, 1.0, -1, TX,
                                    TY, stream);
}
int tmg_links_apply_tiled_c128(const void* U, const void* v, void* out,
                               int L, double m, int TX, int TY,
                               void* stream) {
  return links_tiled<double, kApply>(U, v, nullptr, out, L, m, 1.0, -1, TX,
                                     TY, stream);
}

int tmg_dense_apply_tiled_c64(const void* D, const void* v, void* out, int B,
                              int n, int L, long long d_bs, long long v_bs,
                              int TX, int TY, void* stream) {
  return dense_apply_tiled<float>(D, v, out, B, n, L, d_bs, v_bs, TX, TY,
                                  stream);
}
int tmg_dense_apply_tiled_c128(const void* D, const void* v, void* out,
                               int B, int n, int L, long long d_bs,
                               long long v_bs, int TX, int TY,
                               void* stream) {
  return dense_apply_tiled<double>(D, v, out, B, n, L, d_bs, v_bs, TX, TY,
                                   stream);
}

}  // extern "C"
