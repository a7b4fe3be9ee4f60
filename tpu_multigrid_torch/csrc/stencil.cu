// Hand-written Hopper (sm_90a) kernels for the multigrid smoother path.
//
// Ports of the Pallas TPU kernels in tpu_multigrid/ops/pallas_stencil.py:
//   links_out_kernel<T, false>        <- _u_resid_vmem_kernel  (B2, :662)
//   links_out_kernel<T, true>         <- _u_apply_vmem_kernel  (B8, :656)
//   links_update_kernel<T, STAGED>    <- _u_smooth_vmem_kernel (B1, :669)
//   dense_update_kernel<T, N, STAGED> <- _rbgs_kernel (B3, :125) and
//                                        _jacobi_kernel (B4, :86)
//   dense_apply_kernel<T, N>          <- _apply_d_kernel       (B7a, :64)
//
// Layouts are the JAX package's, row-major and contiguous:
//   U[2][L][L], phi/r/v/out[B][n][L][L], D[B][5][n][n][L][L],
//   D0inv[B][n][n][L][L]
// with site (x, y) at x*L + y and directions 0=same, 1=+x, 2=-x, 3=+y, 4=-y.
// A batch stride of 0 shares D, D0inv, r or v across the batch. The links
// U are always shared by the batch (a batch of right-hand sides on one
// gauge configuration).
//
// Complex numbers are interleaved (re, im) pairs, i.e. torch's complex64 /
// complex128 storage (csrc/cplx.cuh); every kernel is a template on the real
// type.
//
// What bounds them on the H100: bytes. The SpMV and residual kernels
// (links_out_kernel, dense_apply_kernel) give one thread a site and read the
// four periodic neighbours straight from global memory; L2 serves the
// reuse (the level-0 set at L=256 is ~2 MB). Levels whose sweep streams
// more than the L2 holds take the x-tiled kernels of stencil_tiled.cu
// instead (ops/cuda_stencil.u_mode, smoother_mode).
//
// The two smoothers are persistent: one cooperative launch runs all
// n_sweeps of a smooth call, as the TPU kernels run them in one call (see
// the notes at links_update_kernel and dense_update_kernel).

#include <cooperative_groups.h>

#include "cplx.cuh"

namespace {

namespace cg = cooperative_groups;

using tmg::cp_async;
using tmg::cp_async_wait;
using tmg::cplx;
using tmg::mk;
using tmg::scale;

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

// Site (x, y) of thread t of a one-thread-per-site kernel.
__device__ __forceinline__ void site_of(size_t t, int L, int& x, int& y) {
  x = (int)(t / L);
  y = (int)(t % L);
}

// ---- loads -------------------------------------------------------------
//
// phi is written by other blocks between the grid barriers of a persistent
// smoother, and an SM's L1 is not coherent with other SMs' writes: every
// read of phi there goes through L2 only (ld.global.cg). The read-only
// operands (U, D, D0inv, r) come from shared memory when staged, else
// through the non-coherent read-only path (ld.global.nc).

template <typename T>
struct Vec2;
template <>
struct Vec2<float> {
  using type = float2;
};
template <>
struct Vec2<double> {
  using type = double2;
};

template <typename T>
__device__ __forceinline__ cplx<T> ld_cg(const cplx<T>* p) {
  const auto v = __ldcg(reinterpret_cast<const typename Vec2<T>::type*>(p));
  return mk<T>(v.x, v.y);
}

template <typename T>
__device__ __forceinline__ cplx<T> ld_nc(const cplx<T>* p) {
  const auto v = __ldg(reinterpret_cast<const typename Vec2<T>::type*>(p));
  return mk<T>(v.x, v.y);
}

// A read-only operand: from shared memory (STAGED) or global memory.
template <bool STAGED, typename T>
__device__ __forceinline__ cplx<T> ld_ro(const cplx<T>* p) {
  if constexpr (STAGED) {
    return *p;
  } else {
    return ld_nc(p);
  }
}

template <typename T>
__device__ __forceinline__ cplx<T> shfl(cplx<T> v, int lane, int width) {
  return mk<T>(__shfl_sync(0xffffffffu, v.re, lane, width),
               __shfl_sync(0xffffffffu, v.im, lane, width));
}

// Where sweep h of a persistent smoother reads phi and writes it.
// Red-black (2 n_sweeps half-sweeps, colours 0, 1, 0, ...): half-sweep 0
// reads the caller's phi and writes out (its colour updated, the other
// colour copied); every later one updates out in place. Jacobi (n_sweeps
// sweeps): ping-pong between out and scratch, so that the last sweep
// writes out; sweep 0 reads the caller's phi.
template <typename T>
struct Pass {
  const cplx<T>* src;
  cplx<T>* dst;
  int colour;
};

template <typename T>
__device__ __forceinline__ Pass<T> pass_of(int h, bool rb, int n_sweeps,
                                           const cplx<T>* phi, cplx<T>* out,
                                           cplx<T>* scratch) {
  Pass<T> p;
  if (rb) {
    p.colour = h & 1;
    p.src = h == 0 ? phi : out;
    p.dst = out;
  } else {
    p.colour = -1;
    p.dst = ((n_sweeps - 1 - h) & 1) ? scratch : out;
    p.src = h == 0 ? phi
                   : (((n_sweeps - h) & 1) ? scratch : out);
  }
  return p;
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
// (batch entry, site); 6 complex words a site for the apply (U 2, v 2,
// out 2), the neighbour reads of v served by L2. phi and out [B][2][L][L],
// r batched (r_bstride 2 L^2) or shared (0), U shared by the batch: its
// words are read once from HBM and B times from L2.
template <typename T, bool APPLY>
__global__ void links_out_kernel(const cplx<T>* __restrict__ U,
                                 const cplx<T>* __restrict__ phi,
                                 const cplx<T>* __restrict__ r,
                                 cplx<T>* __restrict__ out, int L, T diag,
                                 int B, long long r_bstride) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t LL = (size_t)L * L;
  if (t >= (size_t)B * LL) return;
  const size_t b = t / LL;
  int x, y;
  site_of(t - b * LL, L, x, y);
  const Nbrs n = neighbours(x, y, L);
  phi += b * 2 * LL;
  out += b * 2 * LL;
  if constexpr (!APPLY) r += b * (size_t)r_bstride;
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

// ---- B1: the links-only Wilson smoother, one launch per smooth -----------
//
// Replaces _u_smooth_vmem_kernel (pallas_stencil.py:669), which runs all
// n_sweeps of a smooth in one call with the lattice in VMEM.
//
//   upd = (r - hop(phi)) / (2+m);  phi <- upd (omega == 1) or
//   phi + omega (upd - phi)
//
// What bounds it: bytes, once per smooth: U (2 words a site), r (2), phi in
// (2) and out (2), 8 complex words a site (1.25 us at L=256 c64 against
// 3.35 TB/s). The first design (one launch per red/black half-sweep, phi
// cloned first: 9 launches for rbgs x4) re-read U and r from L2 every
// launch: rbgs x4 at L=256 c64 took 0.2182 ms a call (18.5 us of device
// time); this one 0.0614 ms (22.1 us), same H100 80GB HBM3 at 700 W, in
// turns (scripts/torch_smoother_ab.py; PERF.md).
//
// Design: one cooperative launch. Block g owns `rows` consecutive rows
// g = x B + b of the B L (x, batch entry) rows for every sweep, the batch
// entries of one x next to each other, so that a band reads the shared U's
// rows once for all of its batch entries; a grid barrier
// (cooperative_groups grid sync) takes the place of the launch boundary
// between half-sweeps. STAGED: the block first copies, with cp.async, the
// U_y rows x_lo .. x_hi of its band, the U_x rows x_lo-1 .. x_hi (the -x
// hop reads U_x(x-1)) and r_0, r_1 of each of its rows into shared memory,
// (2 nx + 1 + 2 rows) L words with nx <= (rows + B - 2) / B + 1 the x rows
// a band of `rows` can touch ((4 rows + 1) L at B = 1), and reads them from
// there in every sweep. Else (a band past the shared memory) it reads them
// from global memory each sweep, in the same launch. One thread per site,
// 128 a block; at L=256 the 256 one-row blocks (10 KB of shared memory
// each in c64) give every SM work. phi is read through L2 only. Registers
// (-Xptxas -v, staged / streamed): 40 / 43 in c64, 58 / 56 in c128, no
// spills. A batch of 8 right-hand sides at L=256 (2048 rows, one a block)
// takes 73 us of device time a rbgs x4 call against 22 us unbatched, same
// H100 (chip_smoke.py; PERF.md).
//
// Red/black half-updates are written in place in out: with even L a site of
// one colour reads only the other colour (its four neighbours) and itself,
// and only threads of its own colour write, each its own site; the grid
// barrier separates the colours. Half-sweep 0 reads the caller's phi and
// also copies the other colour into out (the copy the first design made
// with a separate clone).
// The most x rows a band of `rows` consecutive (x, batch entry) rows
// touches (at most L).
__host__ __device__ __forceinline__ int band_xrows(int rows, int B, int L) {
  const int nx = (rows + B - 2) / B + 1;
  return nx < L ? nx : L;
}

template <typename T, bool STAGED>
__global__ void __launch_bounds__(128)
    links_update_kernel(const cplx<T>* __restrict__ U, const cplx<T>* phi,
                        const cplx<T>* __restrict__ r, cplx<T>* out,
                        cplx<T>* scratch, int L, T diag, T omega, int rb,
                        int n_sweeps, int rows, int B, long long r_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nx_cap = band_xrows(rows, B, L);
  cplx<T>* const sux = reinterpret_cast<cplx<T>*>(smem_raw);  // nx_cap + 1
  cplx<T>* const suy = sux + (size_t)(nx_cap + 1) * L;        // nx_cap
  cplx<T>* const sr = suy + (size_t)nx_cap * L;               // 2 x rows
  const size_t LL = (size_t)L * L;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B * L - row0);
  const int x_lo = row0 / B;  // the band's first x row

  if constexpr (STAGED) {
    const int nx = (row0 + nrows - 1) / B - x_lo + 1;
    const int nux = (nx + 1) * L, nuy = nx * L;  // U_x, U_y; then r_0, r_1
    for (int k = threadIdx.x; k < nux + nuy + 2 * nrows * L;
         k += blockDim.x) {
      if (k < nux) {
        const int j = k / L, y = k - j * L;
        const int x = (x_lo - 1 + j + L) % L;
        cp_async(sux + k, U + (size_t)x * L + y);
      } else if (k < nux + nuy) {
        const int q = k - nux;
        cp_async(suy + q, U + LL + (size_t)x_lo * L + q);
      } else {
        const int q = k - nux - nuy;  // plane (r_0, r_1), row, y
        const int p = q / (nrows * L), rem = q - p * (nrows * L);
        const int j = rem / L, y = rem - j * L;
        const int g = row0 + j, x = g / B, b = g - x * B;
        cp_async(sr + (size_t)p * rows * L + rem,
                 r + b * (size_t)r_bstride + (size_t)p * LL +
                     (size_t)x * L + y);
      }
    }
    cp_async_wait();
    __syncthreads();
  }

  cg::grid_group grid = cg::this_grid();
  const bool red_black = rb != 0;
  const int passes = red_black ? 2 * n_sweeps : n_sweeps;
  for (int h = 0; h < passes; ++h) {
    const Pass<T> ps = pass_of(h, red_black, n_sweeps, phi, out, scratch);
    if (h > 0) grid.sync();
    const int per_row = ps.colour < 0 ? L : L / 2;
    if (red_black && h == 0) {  // the other colour, phi -> out
      for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
        const int j = t / per_row, g = row0 + j, x = g / B, b = g - x * B;
        const int y = 2 * (t - j * per_row) + ((x + 1) & 1);
        const size_t s = b * 2 * LL + (size_t)x * L + y;
        out[s] = ld_cg(phi + s);
        out[LL + s] = ld_cg(phi + LL + s);
      }
    }
    for (int t = threadIdx.x; t < nrows * per_row; t += blockDim.x) {
      const int j = t / per_row, g = row0 + j, x = g / B, b = g - x * B;
      const int idx = t - j * per_row;
      const int y = ps.colour < 0 ? idx : 2 * idx + ((x + ps.colour) & 1);
      const Nbrs n = neighbours(x, y, L);
      const int ym = (y == 0) ? L - 1 : y - 1;
      cplx<T> ux, uxm, uy, uym, r0, r1;
      if constexpr (STAGED) {
        const int i = x - x_lo;  // the x row in the band
        ux = sux[(size_t)(i + 1) * L + y];
        uxm = sux[(size_t)i * L + y];
        uy = suy[(size_t)i * L + y];
        uym = suy[(size_t)i * L + ym];
        r0 = sr[(size_t)j * L + y];
        r1 = sr[(size_t)(rows + j) * L + y];
      } else {
        const cplx<T>* rr = r + b * (size_t)r_bstride;
        ux = ld_nc(U + n.s);
        uxm = ld_nc(U + n.xm);
        uy = ld_nc(U + LL + n.s);
        uym = ld_nc(U + LL + n.ym);
        r0 = ld_nc(rr + n.s);
        r1 = ld_nc(rr + LL + n.s);
      }
      const cplx<T>* v = ps.src + b * 2 * LL;
      cplx<T>* dst = ps.dst + b * 2 * LL;
      cplx<T> h0, h1;
      tmg::wilson_hop_core(ux, uxm, uy, uym, ld_cg(v + n.xp),
                           ld_cg(v + LL + n.xp), ld_cg(v + n.xm),
                           ld_cg(v + LL + n.xm), ld_cg(v + n.yp),
                           ld_cg(v + LL + n.yp), ld_cg(v + n.ym),
                           ld_cg(v + LL + n.ym), h0, h1);
      const cplx<T> d0 = r0 - h0, d1 = r1 - h1;
      cplx<T> u0 = mk<T>(d0.re / diag, d0.im / diag);
      cplx<T> u1 = mk<T>(d1.re / diag, d1.im / diag);
      if (omega != T(1)) {
        const cplx<T> p0 = ld_cg(v + n.s), p1 = ld_cg(v + LL + n.s);
        u0 = p0 + scale(omega, u0 - p0);
        u1 = p1 + scale(omega, u1 - p1);
      }
      dst[n.s] = u0;
      dst[LL + n.s] = u1;
    }
  }
}

// ---- B3 / B4: the dense block-stencil smoother, one launch per smooth ----
//
// Replaces _rbgs_kernel (pallas_stencil.py:125; colours 0, 1 per sweep) and
// _jacobi_kernel (:86; rb == 0), which run all n_sweeps of a smooth in one
// call, D fetched from HBM once per smooth.
//
//   upd = -D0inv (sum_{mu != 0} D_mu phi(x + mu) - r);  phi <- upd
//   (omega == 1) or phi + omega (upd - phi)
//
// What bounds it: bytes, once per smooth: D's 4 n^2 hop blocks, D0inv's n^2,
// r, phi in and out, 5 n^2 + 3 n complex words a site (92 at n=4: 3.60 us
// at n=4 L=128 c64 against 3.35 TB/s). The first design (one thread per
// site, one launch per red/black half-sweep, phi cloned first: 9 launches
// for rbgs x4) re-read D, D0inv and r from L2 every launch and filled only
// 8-32 blocks of 256 threads at L=64 and the NTL copies. rbgs x4 in c64 at
// level 1 (n=4 L=128) / level 2 (L=64) / the 4 NTL copies (L=32): 0.2067 /
// 0.1622 / 0.2881 ms a call (48.9 / 42.8 / 43.3 us of device time) for the
// first design, 0.0779 / 0.0576 / 0.0962 ms (32.2 / 26.5 / 24.8 us) for
// this one, same H100 80GB HBM3 at 700 W, in turns
// (scripts/torch_smoother_ab.py; PERF.md).
//
// Design: one cooperative launch; the grid barrier between half-sweeps
// takes the place of the launch boundary. Block g owns `rows` consecutive
// (batch, x) rows for every sweep. STAGED: the block first copies, with
// cp.async, its rows of D's 4 n^2 hop planes, D0inv's n^2 planes and r's n
// planes (each a contiguous run of L words a row, the layout being
// site-minor) into shared memory, (5 n^2 + n) L words a row (86 KB at n=4
// L=128 c64), and reads them from there in every sweep. Else (a band past
// the shared memory: L=1024, or setup at n=2 L=256 in c128) it reads them
// from global memory each sweep, in the same launch. n threads per site,
// thread i computing row i of the block product: it loads phi_i of each
// neighbour once (through L2 only) and gets the other components by warp
// shuffles within its n-lane group, then shares its hop row the same way for
// the D0inv product. So a level-2 row (L=64, n=4) keeps 128 threads busy a
// half-sweep, four times the first design's. Blocks of 256 threads; at the
// flagship's level 1 one row a block, 128 blocks of 86 KB of shared memory
// (172 KB in c128). Registers (-Xptxas -v, staged / streamed): n=4 64 / 71
// in c64, 64 (8 bytes spilled) / 96 in c128; n=2 63 / 64 and 72 / 70; no
// other spills.
//
// In-place red/black as in links_update_kernel: a site of one colour reads
// only the other colour and itself; half-sweep 0 copies the other colour of
// the caller's phi into out.
template <typename T, int N, bool STAGED>
__global__ void __launch_bounds__(256)
    dense_update_kernel(const cplx<T>* __restrict__ D,
                        const cplx<T>* __restrict__ Dinv, const cplx<T>* phi,
                        const cplx<T>* __restrict__ r, cplx<T>* out,
                        cplx<T>* scratch, int B, int L, long long d_bstride,
                        long long dinv_bstride, long long r_bstride, int rb,
                        int n_sweeps, T omega, int rows) {
  constexpr int kHop = 4 * N * N;  // staged planes: hop blocks, D0inv, r
  constexpr int kPlanes = kHop + N * N + N;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const sm = reinterpret_cast<cplx<T>*>(smem_raw);
  const size_t LL = (size_t)L * L;
  const size_t band = (size_t)rows * L;  // plane stride in shared memory
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B * L - row0);

  if constexpr (STAGED) {
    const int per_plane = nrows * L;
    for (int k = threadIdx.x; k < kPlanes * per_plane; k += blockDim.x) {
      const int p = k / per_plane, rem = k - p * per_plane;
      const int j = rem / L, y = rem - j * L;
      const int g = row0 + j, b = g / L, x = g - b * L;
      const size_t s = (size_t)x * L + y;
      const cplx<T>* src;
      if (p < kHop) {
        src = D + b * (size_t)d_bstride + (size_t)(N * N + p) * LL + s;
      } else if (p < kHop + N * N) {
        src = Dinv + b * (size_t)dinv_bstride + (size_t)(p - kHop) * LL + s;
      } else {
        src = r + b * (size_t)r_bstride + (size_t)(p - kHop - N * N) * LL + s;
      }
      cp_async(sm + p * band + rem, src);
    }
    cp_async_wait();
    __syncthreads();
  }

  cg::grid_group grid = cg::this_grid();
  const bool red_black = rb != 0;
  const int passes = red_black ? 2 * n_sweeps : n_sweeps;
  const int lane_i = threadIdx.x % N;  // row i of the block product
  for (int h = 0; h < passes; ++h) {
    const Pass<T> ps = pass_of(h, red_black, n_sweeps, phi, out, scratch);
    if (h > 0) grid.sync();
    const int per_row = ps.colour < 0 ? L : L / 2;
    const int work = nrows * per_row * N;  // (site, i) pairs of the band
    if (red_black && h == 0) {  // the other colour, phi -> out
      for (int t = threadIdx.x; t < work; t += blockDim.x) {
        const int i = t % N, q = t / N;
        const int j = q / per_row, g = row0 + j, b = g / L, x = g - b * L;
        const int y = 2 * (q - j * per_row) + ((x + 1) & 1);
        const size_t k = b * (N * LL) + i * LL + (size_t)x * L + y;
        out[k] = ld_cg(phi + k);
      }
    }
    // Every thread of the block runs the same number of rounds, so that
    // whole warps take part in the shuffles; threads past the work compute
    // site 0's update and do not write it.
    for (int base = 0; base < work; base += blockDim.x) {
      const int t = base + threadIdx.x;
      const bool active = t < work;
      const int q = (active ? t : lane_i) / N;
      const int j = q / per_row, g = row0 + j, b = g / L, x = g - b * L;
      const int idx = q - j * per_row;
      const int y = ps.colour < 0 ? idx : 2 * idx + ((x + ps.colour) & 1);
      const Nbrs n = neighbours(x, y, L);
      const size_t nb[4] = {n.xp, n.xm, n.yp, n.ym};
      const size_t band_s = (size_t)j * L + y;  // the site in the band

      const cplx<T>* Dp;  // plane (d, i, 0) of the hop blocks at this site
      const cplx<T>* Dip;
      const cplx<T>* rp;
      size_t stride;
      if constexpr (STAGED) {
        Dp = sm + (size_t)(lane_i * N) * band + band_s;
        Dip = sm + (size_t)(kHop + lane_i * N) * band + band_s;
        rp = sm + (size_t)(kHop + N * N + lane_i) * band + band_s;
        stride = band;
      } else {
        Dp = D + b * (size_t)d_bstride + (size_t)(N * N + lane_i * N) * LL +
             n.s;
        Dip = Dinv + b * (size_t)dinv_bstride + (size_t)(lane_i * N) * LL +
              n.s;
        rp = r + b * (size_t)r_bstride + (size_t)lane_i * LL + n.s;
        stride = LL;
      }
      const cplx<T>* pb = ps.src + b * (N * LL);

      cplx<T> a = mk<T>(T(0), T(0));
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const cplx<T> mine = ld_cg(pb + lane_i * LL + nb[d]);
#pragma unroll
        for (int jj = 0; jj < N; ++jj) {
          const cplx<T> v = shfl(mine, jj, N);
          a = a + ld_ro<STAGED>(Dp + (size_t)(d * N * N + jj) * stride) * v;
        }
      }
      a = a - ld_ro<STAGED>(rp);
      cplx<T> acc = mk<T>(T(0), T(0));
#pragma unroll
      for (int jj = 0; jj < N; ++jj)
        acc = acc + ld_ro<STAGED>(Dip + (size_t)jj * stride) * shfl(a, jj, N);
      cplx<T> upd = mk<T>(-acc.re, -acc.im);
      const size_t k = b * (N * LL) + lane_i * LL + n.s;
      if (omega != T(1)) {
        const cplx<T> own = ld_cg(ps.src + k);
        upd = own + scale(omega, upd - own);
      }
      if (active) ps.dst[k] = upd;
    }
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
  site_of(t - b * LL, L, x, y);
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
constexpr int kLinksThreads = 128;  // links_update_kernel's block
constexpr int kDenseThreads = 256;  // dense_update_kernel's block

inline unsigned blocks_for(size_t work) {
  return (unsigned)((work + kThreads - 1) / kThreads);
}

// Blocks of `kernel` one SM holds with `smem` bytes of dynamic shared
// memory (which may pass the 48 KB default).
int occupancy(const void* kernel, int threads, long long smem, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                      (size_t)smem);
  cudaGetLastError();  // leave no error behind for a later launch to report
  return (int)e;
}

// A cooperative launch (every block resident at once, so that grid sync
// works). A launch the card refuses (too many blocks to be co-resident, too
// much shared memory) returns its error and leaves none behind.
int launch_cooperative(const void* kernel, unsigned grid, int threads,
                       long long smem, void* stream, void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(threads), args,
                                    (size_t)smem, (cudaStream_t)stream);
  cudaGetLastError();
  return (int)e;
}

template <typename T, bool APPLY>
int links_out(const void* U, const void* phi, const void* r, void* out,
              int B, int L, double m, long long r_bs, void* stream) {
  if (B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  const size_t LL = (size_t)L * L;
  links_out_kernel<T, APPLY><<<blocks_for((size_t)B * LL), kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
      (cplx<T>*)out, L, T(2.0 + m), B, r_bs);
  return (int)cudaGetLastError();
}

template <typename T>
const void* links_update_fn(int staged) {
  return staged ? (const void*)links_update_kernel<T, true>
                : (const void*)links_update_kernel<T, false>;
}

template <typename T>
int links_update(const void* U, const void* phi, const void* r, void* out,
                 void* scratch, int B, int L, double m, double omega, int rb,
                 int n_sweeps, long long r_bs, int rows, int staged,
                 long long smem, void* stream) {
  if (rows < 1 || n_sweeps < 1 || B < 1 || L < 2 || (rb && L % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (staged && smem < (long long)(2 * band_xrows(rows, B, L) + 1 +
                                   2 * rows) * L * sizeof(cplx<T>)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((B * L + rows - 1) / rows);
  const cplx<T>* Up = (const cplx<T>*)U;
  const cplx<T>* pp = (const cplx<T>*)phi;
  const cplx<T>* rp = (const cplx<T>*)r;
  cplx<T>* op = (cplx<T>*)out;
  cplx<T>* sp = (cplx<T>*)scratch;
  T diag = T(2.0 + m), om = T(omega);
  void* args[] = {&Up, &pp, &rp, &op,       &sp,   &L, &diag,
                  &om, &rb, &n_sweeps, &rows, &B, &r_bs};
  return launch_cooperative(links_update_fn<T>(staged), grid, kLinksThreads,
                            staged ? smem : 0, stream, args);
}

template <typename T, int N>
const void* dense_update_fn(int staged) {
  return staged ? (const void*)dense_update_kernel<T, N, true>
                : (const void*)dense_update_kernel<T, N, false>;
}

template <typename T>
const void* dense_update_fn(int n, int staged) {
  switch (n) {
    case 1:
      return dense_update_fn<T, 1>(staged);
    case 2:
      return dense_update_fn<T, 2>(staged);
    case 4:
      return dense_update_fn<T, 4>(staged);
    default:
      return nullptr;
  }
}

template <typename T>
int dense_update(const void* D, const void* Dinv, const void* phi,
                 const void* r, void* out, void* scratch, int B, int n, int L,
                 long long d_bs, long long dinv_bs, long long r_bs, int rb,
                 int n_sweeps, double omega, int rows, int staged,
                 long long smem, void* stream) {
  const void* fn = dense_update_fn<T>(n, staged);
  if (fn == nullptr || rows < 1 || n_sweeps < 1 || B < 1 || L < 2 ||
      (rb && L % 2)) {
    return (int)cudaErrorInvalidValue;
  }
  if (staged &&
      smem < (long long)(5 * n * n + n) * rows * L * sizeof(cplx<T>)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((B * L + rows - 1) / rows);
  const cplx<T>* Dp = (const cplx<T>*)D;
  const cplx<T>* Dip = (const cplx<T>*)Dinv;
  const cplx<T>* pp = (const cplx<T>*)phi;
  const cplx<T>* rp = (const cplx<T>*)r;
  cplx<T>* op = (cplx<T>*)out;
  cplx<T>* sp = (cplx<T>*)scratch;
  T om = T(omega);
  void* args[] = {&Dp, &Dip, &pp,      &rp,     &op, &sp,
                  &B,  &L,   &d_bs,    &dinv_bs, &r_bs, &rb,
                  &n_sweeps, &om, &rows};
  return launch_cooperative(fn, grid, kDenseThreads, staged ? smem : 0,
                            stream, args);
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

// Plain C interface, loaded with ctypes (ops/cuda_stencil.py). Each launch
// entry launches on the given stream, does not synchronise, allocates
// nothing and returns the error of its launch (0: launched). The two
// smoothers take their band (`rows` rows a block, operands `staged` in
// `smem` bytes of shared memory) from ops/cuda_stencil.plan_band, which
// sizes it with the *_occupancy entries.
extern "C" {

// The links entries take phi, out [B][2][L][L], U [2][L][L] shared by the
// batch, and r batched (r_bs = 2 L^2) or shared (0).
int tmg_links_residual_c64(const void* U, const void* phi, const void* r,
                           void* out, int B, int L, double m, long long r_bs,
                           void* stream) {
  return links_out<float, false>(U, phi, r, out, B, L, m, r_bs, stream);
}
int tmg_links_residual_c128(const void* U, const void* phi, const void* r,
                            void* out, int B, int L, double m,
                            long long r_bs, void* stream) {
  return links_out<double, false>(U, phi, r, out, B, L, m, r_bs, stream);
}

int tmg_links_apply_c64(const void* U, const void* v, void* out, int B,
                        int L, double m, void* stream) {
  return links_out<float, true>(U, v, nullptr, out, B, L, m, 0, stream);
}
int tmg_links_apply_c128(const void* U, const void* v, void* out, int B,
                         int L, double m, void* stream) {
  return links_out<double, true>(U, v, nullptr, out, B, L, m, 0, stream);
}

int tmg_links_update_c64(const void* U, const void* phi, const void* r,
                         void* out, void* scratch, int B, int L, double m,
                         double omega, int rb, int n_sweeps, long long r_bs,
                         int rows, int staged, long long smem, void* stream) {
  return links_update<float>(U, phi, r, out, scratch, B, L, m, omega, rb,
                             n_sweeps, r_bs, rows, staged, smem, stream);
}
int tmg_links_update_c128(const void* U, const void* phi, const void* r,
                          void* out, void* scratch, int B, int L, double m,
                          double omega, int rb, int n_sweeps, long long r_bs,
                          int rows, int staged, long long smem,
                          void* stream) {
  return links_update<double>(U, phi, r, out, scratch, B, L, m, omega, rb,
                              n_sweeps, r_bs, rows, staged, smem, stream);
}
int tmg_links_update_occupancy_c64(int staged, long long smem, int* blocks) {
  return occupancy(links_update_fn<float>(staged), kLinksThreads, smem,
                   blocks);
}
int tmg_links_update_occupancy_c128(int staged, long long smem, int* blocks) {
  return occupancy(links_update_fn<double>(staged), kLinksThreads, smem,
                   blocks);
}

int tmg_dense_update_c64(const void* D, const void* Dinv, const void* phi,
                         const void* r, void* out, void* scratch, int B,
                         int n, int L, long long d_bs, long long dinv_bs,
                         long long r_bs, int rb, int n_sweeps, double omega,
                         int rows, int staged, long long smem, void* stream) {
  return dense_update<float>(D, Dinv, phi, r, out, scratch, B, n, L, d_bs,
                             dinv_bs, r_bs, rb, n_sweeps, omega, rows, staged,
                             smem, stream);
}
int tmg_dense_update_c128(const void* D, const void* Dinv, const void* phi,
                          const void* r, void* out, void* scratch, int B,
                          int n, int L, long long d_bs, long long dinv_bs,
                          long long r_bs, int rb, int n_sweeps, double omega,
                          int rows, int staged, long long smem,
                          void* stream) {
  return dense_update<double>(D, Dinv, phi, r, out, scratch, B, n, L, d_bs,
                              dinv_bs, r_bs, rb, n_sweeps, omega, rows,
                              staged, smem, stream);
}
int tmg_dense_update_occupancy_c64(int n, int staged, long long smem,
                                   int* blocks) {
  const void* fn = dense_update_fn<float>(n, staged);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return occupancy(fn, kDenseThreads, smem, blocks);
}
int tmg_dense_update_occupancy_c128(int n, int staged, long long smem,
                                    int* blocks) {
  const void* fn = dense_update_fn<double>(n, staged);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return occupancy(fn, kDenseThreads, smem, blocks);
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
