// Hand-written Hopper (sm_90a) kernels for the multigrid smoother path.
//
// Ports of the Pallas TPU kernels in tpu_multigrid/ops/pallas_stencil.py:
//   links_out_kernel<T, false> <- _u_resid_vmem_kernel  (B2, :662)
//   links_out_kernel<T, true>  <- _u_apply_vmem_kernel  (B8, :656)
//   links_update_kernel    <- _u_smooth_vmem_kernel  (B1; one launch per
//                             Jacobi sweep or per red/black half-sweep)
//   dense_update_kernel    <- _rbgs_kernel (B3) and _jacobi_kernel (B4)
//   dense_apply_kernel     <- _apply_d_kernel        (B7a, :64)
//
// Layouts are the JAX package's, row-major and contiguous:
//   U[2][L][L], phi/r/v/out[B][n][L][L], D[B][5][n][n][L][L],
//   D0inv[B][n][n][L][L]
// with site (x, y) at x*L + y and directions 0=same, 1=+x, 2=-x, 3=+y, 4=-y.
// A batch stride of 0 shares D, D0inv, r or v across the batch.
//
// Complex numbers are interleaved (re, im) pairs, i.e. torch's complex64 /
// complex128 storage (csrc/cplx.cuh); every kernel is a template on the real
// type.
//
// What bounds them on the H100: bytes. One thread per lattice site; the four
// periodic neighbours are read straight from global memory and the reuse is
// served by L2 (the whole level-0 working set at L=256 is ~2 MB). Per site a
// links sweep moves ~4.5 complex words (U 2, r 2, phi 2 read, phi 2 written,
// each half-sweep touching half the sites) and a dense n=4 sweep ~26
// (D 16 + D0inv 4 per site on top of the fields) — the same accounting as
// the TPU kernels' docstrings. Correctness first: no shared-memory tiling,
// TMA or wgmma here. Levels whose sweep streams more than the L2 holds take
// the x-tiled kernels of stencil_tiled.cu instead (ops/cuda_stencil.u_mode,
// smoother_mode).
//
// Red/black half-updates are written IN PLACE in phi. That is safe: on the
// 5-point stencil with even L, a site of one colour reads only sites of the
// other colour (its four neighbours) plus itself, and only threads of its
// own colour write, each to its own site. The colour barrier across the
// whole grid is the launch boundary, so each RB sweep is two launches.

#include "cplx.cuh"

namespace {

using tmg::conj_mul;
using tmg::cplx;
using tmg::mk;
using tmg::scale;
using tmg::times_i;

struct Nbrs {
  size_t s, xp, xm, yp, ym;
};

__device__ __forceinline__ Nbrs neighbours(int x, int y, int L) {
  const int xp = (x + 1 == L) ? 0 : x + 1;
  const int xm = (x == 0) ? L - 1 : x - 1;
  const int yp = (y + 1 == L) ? 0 : y + 1;
  const int ym = (y == 0) ? L - 1 : y - 1;
  Nbrs n;
  n.s = (size_t)x * L + y;
  n.xp = (size_t)xp * L + y;
  n.xm = (size_t)xm * L + y;
  n.yp = (size_t)x * L + yp;
  n.ym = (size_t)x * L + ym;
  return n;
}

// Site of thread t: every site for colour < 0 (Jacobi / residual), else the
// t-th site of that colour ((x + y) % 2 == colour; L even).
__device__ __forceinline__ void site_of(size_t t, int L, int colour, int& x,
                                        int& y) {
  if (colour < 0) {
    x = (int)(t / L);
    y = (int)(t % L);
  } else {
    const int half = L / 2;
    x = (int)(t / half);
    y = 2 * (int)(t % half) + ((x + colour) & 1);
  }
}

// The links-only Wilson hop (tmg::wilson_hop_core) at site n, reading the
// links and the neighbour spinors from global memory.
template <typename T>
__device__ __forceinline__ void wilson_hop(const cplx<T>* __restrict__ U,
                                           const cplx<T>* v, size_t LL,
                                           const Nbrs& n, cplx<T>& h0,
                                           cplx<T>& h1) {
  tmg::wilson_hop_core(U[n.s], U[n.xm], U[LL + n.s], U[LL + n.ym], v[n.xp],
                       v[LL + n.xp], v[n.xm], v[LL + n.xm], v[n.yp],
                       v[LL + n.yp], v[n.ym], v[LL + n.ym], h0, h1);
}

// APPLY (B8): out = (2+m) v + hop(v), the links-only D_U v (r is not
// read). Else (B2) the residual out = r - (2+m) v - hop(v). One thread per
// site; 6 complex words a site for the apply (U 2, v 2, out 2), the
// neighbour reads of v served by L2.
template <typename T, bool APPLY>
__global__ void links_out_kernel(const cplx<T>* __restrict__ U,
                                 const cplx<T>* __restrict__ phi,
                                 const cplx<T>* __restrict__ r,
                                 cplx<T>* __restrict__ out, int L, T diag) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t LL = (size_t)L * L;
  if (t >= LL) return;
  int x, y;
  site_of(t, L, -1, x, y);
  const Nbrs n = neighbours(x, y, L);
  cplx<T> h0, h1;
  wilson_hop(U, phi, LL, n, h0, h1);
  if constexpr (APPLY) {
    out[n.s] = scale(diag, phi[n.s]) + h0;
    out[LL + n.s] = scale(diag, phi[LL + n.s]) + h1;
  } else {
    out[n.s] = r[n.s] - scale(diag, phi[n.s]) - h0;
    out[LL + n.s] = r[LL + n.s] - scale(diag, phi[LL + n.s]) - h1;
  }
}

// upd = (r - hop(phi)) / (2+m);  out = upd (omega == 1) or
// phi + omega (upd - phi). colour < 0: Jacobi, out is a separate buffer;
// colour 0/1: that colour's half-update, out == phi (in place, see above).
template <typename T>
__global__ void links_update_kernel(const cplx<T>* __restrict__ U,
                                    const cplx<T>* phi,
                                    const cplx<T>* __restrict__ r,
                                    cplx<T>* out, int L, T diag, T omega,
                                    int colour) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t LL = (size_t)L * L;
  if (t >= (colour < 0 ? LL : LL / 2)) return;
  int x, y;
  site_of(t, L, colour, x, y);
  const Nbrs n = neighbours(x, y, L);
  cplx<T> h[2];
  wilson_hop(U, phi, LL, n, h[0], h[1]);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const size_t i = k * LL + n.s;
    const cplx<T> d = r[i] - h[k];
    cplx<T> upd = mk<T>(d.re / diag, d.im / diag);
    if (omega != T(1)) upd = phi[i] + scale(omega, upd - phi[i]);
    out[i] = upd;
  }
}

// Dense 5-point block stencil update for one (batch, site):
//   upd = -D0inv (sum_{mu != 0} D_mu phi(x + mu) - r)
template <typename T, int N>
__global__ void dense_update_kernel(const cplx<T>* __restrict__ D,
                                    const cplx<T>* __restrict__ Dinv,
                                    const cplx<T>* phi,
                                    const cplx<T>* __restrict__ r,
                                    cplx<T>* out, int B, int L,
                                    long long d_bstride,
                                    long long dinv_bstride,
                                    long long r_bstride, int colour,
                                    T omega) {
  const size_t LL = (size_t)L * L;
  const size_t per = colour < 0 ? LL : LL / 2;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * per) return;
  const size_t b = t / per;
  int x, y;
  site_of(t - b * per, L, colour, x, y);
  const Nbrs n = neighbours(x, y, L);

  const cplx<T>* Db = D + b * (size_t)d_bstride;
  const cplx<T>* Dib = Dinv + b * (size_t)dinv_bstride;
  const cplx<T>* pb = phi + b * (N * LL);
  const cplx<T>* rb = r + b * (size_t)r_bstride;
  cplx<T>* ob = out + b * (N * LL);

  const size_t nb[5] = {n.s, n.xp, n.xm, n.yp, n.ym};
  cplx<T> a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = mk<T>(T(0), T(0));
#pragma unroll
  for (int d = 1; d < 5; ++d) {
    cplx<T> v[N];
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] = pb[j * LL + nb[d]];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        a[i] = a[i] + Db[((size_t)(d * N + i) * N + j) * LL + n.s] * v[j];
  }
#pragma unroll
  for (int j = 0; j < N; ++j) a[j] = a[j] - rb[j * LL + n.s];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    cplx<T> acc = mk<T>(T(0), T(0));
#pragma unroll
    for (int j = 0; j < N; ++j)
      acc = acc + Dib[(size_t)(i * N + j) * LL + n.s] * a[j];
    cplx<T> upd = mk<T>(-acc.re, -acc.im);
    const size_t k = i * LL + n.s;
    if (omega != T(1)) upd = pb[k] + scale(omega, upd - pb[k]);
    ob[k] = upd;
  }
}

// Dense 5-point block SpMV for one (batch, site) (B7a):
//   out = sum_{mu = 0..4} D_mu v(x + mu)
// D and v each shared by the batch (stride 0) or batched; out is batched.
// One thread per site: D's 5 n^2 words of the site are read once,
// coalesced along y; the neighbour reads of v come from L2.
template <typename T, int N>
__global__ void dense_apply_kernel(const cplx<T>* __restrict__ D,
                                   const cplx<T>* __restrict__ v,
                                   cplx<T>* __restrict__ out, int B, int L,
                                   long long d_bstride,
                                   long long v_bstride) {
  const size_t LL = (size_t)L * L;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)B * LL) return;
  const size_t b = t / LL;
  int x, y;
  site_of(t - b * LL, L, -1, x, y);
  const Nbrs n = neighbours(x, y, L);

  const cplx<T>* Db = D + b * (size_t)d_bstride;
  const cplx<T>* vb = v + b * (size_t)v_bstride;
  cplx<T>* ob = out + b * (N * LL);

  const size_t nb[5] = {n.s, n.xp, n.xm, n.yp, n.ym};
  cplx<T> a[N];
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = mk<T>(T(0), T(0));
#pragma unroll
  for (int d = 0; d < 5; ++d) {
    cplx<T> w[N];
#pragma unroll
    for (int j = 0; j < N; ++j) w[j] = vb[j * LL + nb[d]];
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j)
        a[i] = a[i] + Db[((size_t)(d * N + i) * N + j) * LL + n.s] * w[j];
  }
#pragma unroll
  for (int i = 0; i < N; ++i) ob[i * LL + n.s] = a[i];
}

constexpr int kThreads = 256;

inline unsigned blocks_for(size_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

template <typename T, bool APPLY>
int links_out(const void* U, const void* phi, const void* r, void* out,
              int L, double m, void* stream) {
  const size_t LL = (size_t)L * L;
  links_out_kernel<T, APPLY><<<blocks_for(LL), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
      (cplx<T>*)out, L, T(2.0 + m));
  return (int)cudaGetLastError();
}

template <typename T>
int links_update(const void* U, const void* phi, const void* r, void* out,
                 int L, double m, double omega, int colour, void* stream) {
  const size_t LL = (size_t)L * L;
  links_update_kernel<T><<<blocks_for(colour < 0 ? LL : LL / 2), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
      (cplx<T>*)out, L, T(2.0 + m), T(omega), colour);
  return (int)cudaGetLastError();
}

template <typename T, int N>
int dense_update_n(const void* D, const void* Dinv, const void* phi,
                   const void* r, void* out, int B, int L, long long d_bs,
                   long long dinv_bs, long long r_bs, int colour,
                   double omega, void* stream) {
  const size_t LL = (size_t)L * L;
  const size_t work = (size_t)B * (colour < 0 ? LL : LL / 2);
  dense_update_kernel<T, N><<<blocks_for(work), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (const cplx<T>*)D, (const cplx<T>*)Dinv, (const cplx<T>*)phi,
      (const cplx<T>*)r, (cplx<T>*)out, B, L, d_bs, dinv_bs, r_bs, colour,
      T(omega));
  return (int)cudaGetLastError();
}

template <typename T>
int dense_update(const void* D, const void* Dinv, const void* phi,
                 const void* r, void* out, int B, int n, int L,
                 long long d_bs, long long dinv_bs, long long r_bs,
                 int colour, double omega, void* stream) {
  switch (n) {
    case 1:
      return dense_update_n<T, 1>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                  r_bs, colour, omega, stream);
    case 2:
      return dense_update_n<T, 2>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                  r_bs, colour, omega, stream);
    case 4:
      return dense_update_n<T, 4>(D, Dinv, phi, r, out, B, L, d_bs, dinv_bs,
                                  r_bs, colour, omega, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int N>
int dense_apply_n(const void* D, const void* v, void* out, int B, int L,
                  long long d_bs, long long v_bs, void* stream) {
  const size_t work = (size_t)B * L * L;
  dense_apply_kernel<T, N><<<blocks_for(work), kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const cplx<T>*)D, (const cplx<T>*)v, (cplx<T>*)out, B, L, d_bs, v_bs);
  return (int)cudaGetLastError();
}

template <typename T>
int dense_apply(const void* D, const void* v, void* out, int B, int n, int L,
                long long d_bs, long long v_bs, void* stream) {
  switch (n) {
    case 1:
      return dense_apply_n<T, 1>(D, v, out, B, L, d_bs, v_bs, stream);
    case 2:
      return dense_apply_n<T, 2>(D, v, out, B, L, d_bs, v_bs, stream);
    case 4:
      return dense_apply_n<T, 4>(D, v, out, B, L, d_bs, v_bs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/cuda_stencil.py). Each entry
// launches on the given stream, does not synchronise, allocates nothing and
// returns cudaGetLastError() of its launch.
extern "C" {

int tmg_links_residual_c64(const void* U, const void* phi, const void* r,
                           void* out, int L, double m, void* stream) {
  return links_out<float, false>(U, phi, r, out, L, m, stream);
}
int tmg_links_residual_c128(const void* U, const void* phi, const void* r,
                            void* out, int L, double m, void* stream) {
  return links_out<double, false>(U, phi, r, out, L, m, stream);
}

int tmg_links_apply_c64(const void* U, const void* v, void* out, int L,
                        double m, void* stream) {
  return links_out<float, true>(U, v, nullptr, out, L, m, stream);
}
int tmg_links_apply_c128(const void* U, const void* v, void* out, int L,
                         double m, void* stream) {
  return links_out<double, true>(U, v, nullptr, out, L, m, stream);
}

int tmg_links_update_c64(const void* U, const void* phi, const void* r,
                         void* out, int L, double m, double omega, int colour,
                         void* stream) {
  return links_update<float>(U, phi, r, out, L, m, omega, colour, stream);
}
int tmg_links_update_c128(const void* U, const void* phi, const void* r,
                          void* out, int L, double m, double omega,
                          int colour, void* stream) {
  return links_update<double>(U, phi, r, out, L, m, omega, colour, stream);
}

int tmg_dense_update_c64(const void* D, const void* Dinv, const void* phi,
                         const void* r, void* out, int B, int n, int L,
                         long long d_bs, long long dinv_bs, long long r_bs,
                         int colour, double omega, void* stream) {
  return dense_update<float>(D, Dinv, phi, r, out, B, n, L, d_bs, dinv_bs,
                             r_bs, colour, omega, stream);
}
int tmg_dense_update_c128(const void* D, const void* Dinv, const void* phi,
                          const void* r, void* out, int B, int n, int L,
                          long long d_bs, long long dinv_bs, long long r_bs,
                          int colour, double omega, void* stream) {
  return dense_update<double>(D, Dinv, phi, r, out, B, n, L, d_bs, dinv_bs,
                              r_bs, colour, omega, stream);
}

int tmg_dense_apply_c64(const void* D, const void* v, void* out, int B,
                        int n, int L, long long d_bs, long long v_bs,
                        void* stream) {
  return dense_apply<float>(D, v, out, B, n, L, d_bs, v_bs, stream);
}
int tmg_dense_apply_c128(const void* D, const void* v, void* out, int B,
                         int n, int L, long long d_bs, long long v_bs,
                         void* stream) {
  return dense_apply<double>(D, v, out, B, n, L, d_bs, v_bs, stream);
}

}  // extern "C"
