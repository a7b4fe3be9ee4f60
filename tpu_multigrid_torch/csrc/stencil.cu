// Hand-written Hopper (sm_90a) kernels for the multigrid smoother path.
//
// Ports of the Pallas TPU kernels in tpu_multigrid/ops/pallas_stencil.py:
//   links_out_kernel<T, false, PAIRED>
//                                     <- _u_resid_vmem_kernel  (B2, :662)
//   links_resid_restrict_kernel<T, NC, PAIRED>
//                                     <- _u_resid_vmem_kernel  (B2, :662;
//                                        fused with the restriction of its
//                                        output)
//   links_resid_norm_kernel<T>
//                                     <- _u_resid_vmem_kernel  (B2, :662;
//                                        with the norms of the convergence
//                                        check)
//   links_out_kernel<T, true, PAIRED>
//                                     <- _u_apply_vmem_kernel  (B8, :656)
//   links_update_kernel<T, STAGED>    <- _u_smooth_vmem_kernel (B1, :669)
//   dense_update_kernel<T, N, STAGED, GROUPED>
//                                     <- _rbgs_kernel (B3, :125) and
//                                        _jacobi_kernel (B4, :86)
//   dense_apply_kernel<T, N, KG, RESID>
//                                     <- _apply_d_kernel       (B7a, :64;
//                                        RESID: r - D v)
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
// What bounds them on the H100: bytes. The links SpMV, residual and check
// (links_out_kernel, links_resid_norm_kernel), the dense SpMV and residual
// (dense_apply_kernel) and the fused residual-restriction give a thread a
// pair of sites (16-byte loads); see the notes at each. Levels whose sweep
// streams more than the L2 holds take the x-tiled kernels of
// stencil_tiled.cu instead (ops/cuda_stencil.u_mode, smoother_mode).
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
// takes the place of the launch boundary. The B entries come in groups of
// G that share one operator (entry b reads D and D0inv of copy b / G; G = 1
// a copy an entry, or one shared copy at stride 0; G = k for an ensemble's
// k near-null candidates a configuration, as the TPU kernels see them
// under the JAX package's vmap). The B L rows are ordered
// g = (c L + x) G + m for entry b = c G + m, so that the G entries of a
// group at one x are neighbours, as in links_update_kernel. Block g owns
// `rows` consecutive rows for every sweep. STAGED: the block first copies,
// with cp.async, D's 4 n^2 hop planes and D0inv's n^2 planes of each (c, x)
// row that its rows touch, once for the group, and r's n planes of each
// of its rows (each a contiguous run of L words a row, the layout being
// site-minor) into shared memory, (5 n^2 + n) L words a row at G = 1 (86
// KB at n=4 L=128 c64), and reads them from there in every sweep. Else (a
// band past the shared memory: L=1024, or setup at n=2 L=256 in c128) it
// reads them from global memory each sweep, in the same launch. An
// ensemble's level 0 (8 configurations of 2 candidates, n=2 L=128, G = 2:
// 2048 rows) takes 105.7 us cold a rbgs x4 call against a bound of 8.8 us
// with D read once a group, on an H100 80GB HBM3 at 700 W (chip_smoke.py;
// PERF.md), the same bits as the launch on D copied for each candidate. n
// threads per site, thread i computing row i of the block product: it loads
// phi_i of each neighbour once (through L2 only) and gets the other
// components by warp shuffles within its n-lane group, then shares its hop
// row the same way for the D0inv product. So a level-2 row (L=64, n=4) keeps
// 128 threads busy a half-sweep, four times the first design's. Blocks of
// 256 threads; at the flagship's level 1 one row a block, 128 blocks of 86
// KB of shared memory (172 KB in c128). Registers (-Xptxas -v, staged /
// streamed), G = 1: n=4 64 / 64 in c64, 64 (8 bytes spilled) / 96 in c128;
// n=2 62 / 64 and 72 / 70; G > 1: n=4 64 / 71 and 80 / 94, n=2 64 / 60 and
// 78 / 70; no other spills.
//
// In-place red/black as in links_update_kernel: a site of one colour reads
// only the other colour and itself; half-sweep 0 copies the other colour of
// the caller's phi into out.
// The (group, x) rows c L + x that a band of `rows` consecutive rows
// g = (c L + x) G + m touches, at most (rows at G = 1).
__host__ __device__ __forceinline__ int band_ops_rows(int rows, int G) {
  return (rows + G - 2) / G + 1;
}

// Row g of a dense smoother launch: (c L + x) G + m, entry b = c G + m.
struct DenseRow {
  int c, x, b;
};

__device__ __forceinline__ DenseRow dense_row(int g, int G, int L) {
  const int cx = g / G, c = cx / L;
  return DenseRow{c, cx - c * L, c * G + (g - cx * G)};
}

// GROUPED false: G is 1 at compile time, so that the ungrouped call pays
// no division by G.
template <typename T, int N, bool STAGED, bool GROUPED>
__global__ void __launch_bounds__(256)
    dense_update_kernel(const cplx<T>* __restrict__ D,
                        const cplx<T>* __restrict__ Dinv, const cplx<T>* phi,
                        const cplx<T>* __restrict__ r, cplx<T>* out,
                        cplx<T>* scratch, int B, int L, int G,
                        long long d_bstride, long long dinv_bstride,
                        long long r_bstride, int rb, int n_sweeps, T omega,
                        int rows) {
  constexpr int kHop = 4 * N * N;  // staged planes: hop blocks, D0inv; r
  constexpr int kOps = kHop + N * N;
  if constexpr (!GROUPED) G = 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const sm = reinterpret_cast<cplx<T>*>(smem_raw);
  const size_t LL = (size_t)L * L;
  // plane strides in shared memory: D's and D0inv's planes a (c, x) row,
  // then r's planes a row
  const size_t band_ops = (size_t)band_ops_rows(rows, G) * L;
  const size_t band = (size_t)rows * L;
  cplx<T>* const sr = sm + kOps * band_ops;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, B * L - row0);
  const int cx0 = row0 / G;  // the band's first (c, x) row

  if constexpr (STAGED) {
    const int per_ops = ((row0 + nrows - 1) / G - cx0 + 1) * L;
    const int per_r = nrows * L;
    for (int k = threadIdx.x; k < kOps * per_ops + N * per_r;
         k += blockDim.x) {
      if (k < kOps * per_ops) {
        const int p = k / per_ops, rem = k - p * per_ops;
        const int cx = cx0 + rem / L, y = rem % L;
        const int c = cx / L;
        const size_t s = (size_t)(cx - c * L) * L + y;
        const cplx<T>* src =
            p < kHop ? D + c * (size_t)d_bstride + (size_t)(N * N + p) * LL + s
                     : Dinv + c * (size_t)dinv_bstride +
                           (size_t)(p - kHop) * LL + s;
        cp_async(sm + p * band_ops + rem, src);
      } else {
        const int q = k - kOps * per_ops;
        const int p = q / per_r, rem = q - p * per_r;
        const int j = rem / L, y = rem - j * L;
        const DenseRow w = dense_row(row0 + j, G, L);
        cp_async(sr + p * band + rem,
                 r + w.b * (size_t)r_bstride + (size_t)p * LL +
                     (size_t)w.x * L + y);
      }
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
        const int j = q / per_row;
        const DenseRow w = dense_row(row0 + j, G, L);
        const int y = 2 * (q - j * per_row) + ((w.x + 1) & 1);
        const size_t k = w.b * (N * LL) + i * LL + (size_t)w.x * L + y;
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
      const int j = q / per_row, g = row0 + j;
      const DenseRow w = dense_row(g, G, L);
      const int x = w.x;
      const size_t b = w.b;
      const int idx = q - j * per_row;
      const int y = ps.colour < 0 ? idx : 2 * idx + ((x + ps.colour) & 1);
      const Nbrs n = neighbours(x, y, L);
      const size_t nb[4] = {n.xp, n.xm, n.yp, n.ym};

      const cplx<T>* Dp;  // plane (d, i, 0) of the hop blocks at this site
      const cplx<T>* Dip;
      const cplx<T>* rp;
      size_t stride;
      if constexpr (STAGED) {
        const size_t ops_s = (size_t)(g / G - cx0) * L + y;  // (c, x) row
        Dp = sm + (size_t)(lane_i * N) * band_ops + ops_s;
        Dip = sm + (size_t)(kHop + lane_i * N) * band_ops + ops_s;
        rp = sr + (size_t)lane_i * band + (size_t)j * L + y;
        stride = band_ops;
      } else {
        Dp = D + w.c * (size_t)d_bstride +
             (size_t)(N * N + lane_i * N) * LL + n.s;
        Dip = Dinv + w.c * (size_t)dinv_bstride +
              (size_t)(lane_i * N) * LL + n.s;
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

// ---- pairs of y-adjacent sites -------------------------------------------
//
// The links and dense SpMV and residuals, the check and the fused
// residual-restriction give a thread two y-adjacent sites, so that a row
// of an operand plane comes in 16-byte loads: one float4 in complex64 (the
// pair must start at an even word), one double2 a word in complex128.

// Words ya and yb of a row, read-only: one 16-byte load in complex64 when
// PAIRED (yb == ya + 1, ya even, the row 16-byte aligned), else one load a
// word.
template <typename T, bool PAIRED>
__device__ __forceinline__ void ld_pair(const cplx<T>* __restrict__ row,
                                        int ya, int yb, cplx<T> out[2]) {
  if constexpr (PAIRED && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + ya));
    out[0] = mk<T>(q.x, q.y);
    out[1] = mk<T>(q.z, q.w);
  } else {
    out[0] = ld_nc(row + ya);
    out[1] = ld_nc(row + yb);
  }
}

// Words s and s + 1 of a row, written: one 16-byte store in complex64.
template <typename T>
__device__ __forceinline__ void st_pair(cplx<T>* row, const cplx<T> v[2]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(row) = make_float4(v[0].re, v[0].im, v[1].re,
                                                  v[1].im);
  } else {
    row[0] = v[0];
    row[1] = v[1];
  }
}

// Periodic index of i in [-L, 2L).
__device__ __forceinline__ int wrap(int i, int L) {
  return i < 0 ? i + L : (i >= L ? i - L : i);
}

// ---- B8 and B2 redesigned: the links apply and residual, a pair a thread --
//
// Replace _u_apply_vmem_kernel (pallas_stencil.py:656; APPLY) and
// _u_resid_vmem_kernel (:662), where the cycle does not restrict the
// residual at once:
//
//   APPLY:  out = (2+m) v + hop(v)        else:  out = r - (2+m) v - hop(v)
//
// phi and out [B][2][L][L], r batched (r_bstride 2 L^2) or shared (0), U
// [2][L][L] shared by the batch.
//
// What bounds them: bytes, 6 complex words a site for the apply (U 2, v 2,
// out 2: 3.1 MB, 0.94 us at L=256 c64 against 3.35 TB/s) and 8 for the
// residual (r 2 more: 1.25 us). Below that, the card's floor: a cold copy
// of the same 3.1 MB takes 2.76 us on the device, a one-element zero_()
// 1.02 us (chip_smoke.py, H100 80GB HBM3, 700 W). The first design gave
// one thread a site and read every operand with an 8-byte load, the
// neighbours of v through L2: 2.00 / 3.60 us warm / cold on the device at
// L=256 c64 for the apply, 2.19 / 4.11 for the residual (chip_smoke.py,
// same card; PERF.md).
//
// Design: a thread owns a pair of y-adjacent sites (x, ya), (x, ya + 1), ya
// even. PAIRED (L even, every operand 16-byte aligned): in complex64 one
// 16-byte load reads a row's two words, so a pair's links come as U_x and
// U_y at the pair, U_x at x-1 as a pair and U_y at ya-1 as one word, r at
// the pair; out is one 16-byte store a row. Else (an odd L, an operand off
// a 16-byte line) a word a load, the same code; at an odd L the last pair
// of a row holds one site. Blocks of 32 pairs by 4 x rows (fewer on a small
// lattice), one batch entry a block: 256 blocks of 128 threads at L=256.
// The block stages v's two planes over its tile and a one-site periodic
// halo by cp.async, the links and r going straight to registers before it
// waits, so that every load is in flight at once.
//
// Same card, in turns (scripts/torch_smoother_ab.py --residuals-only),
// warm / cold us, the first design -> this one: the apply at L=256 2.04 /
// 3.54 -> 2.26 / 3.21, at L=1024 18.84 / 22.83 -> 17.89 / 21.11; the
// residual at L=256 2.20 / 4.13 -> 2.30 / 3.68, at L=512 4.41 / 9.27 ->
// 4.39 / 8.71. One entry a block reading v through L1 instead of staging
// it: 2.11 / 3.44, 18.73 / 21.60, 2.35 / 4.66, 4.18 / 8.85 at those
// shapes, slower cold at each. At a batch of 8, a thread holding its
// pair's links in registers for 4 entries (v through L1) read 5.30 / 12.70
// against 6.62 / 12.97 for one entry a thread: 2% cold, on a path (the
// batched unfused residual) that no solve of the smoke, bench.py or the
// CLI drives, so it was not kept. The 16-byte pair loads (PAIRED)
// against a word a load, in turns: the apply 2.27 / 3.23 against 2.39 /
// 3.41 at L=256, 17.85 / 20.75 against 18.53 / 22.09 at L=1024; the
// residual 2.31 / 3.68 against 2.39 / 3.73 at L=256, 4.46 / 8.71 against
// 4.92 / 8.76 at L=512, 7.27 / 12.29 against 7.93 / 12.75 at B=8.
// Registers (-Xptxas -v), complex64 PAIRED: 47 (apply), 54 (residual);
// complex128 68, 96; no spills but the complex128 word-a-load residual's
// 8 bytes.
template <typename T>
struct LinksAt {
  cplx<T> ux[2], uxm[2], uy[2], uym;
};

template <typename T>
struct SpinAt {
  cplx<T> c[2][2], xp[2][2], xm[2][2], ym[2], yp[2];  // [spin][site]
};

template <typename T, bool PAIRED>
__device__ __forceinline__ LinksAt<T> ld_links(const cplx<T>* __restrict__ U,
                                               size_t LL, int L, int x, int ya,
                                               int yb) {
  LinksAt<T> u;
  const size_t row = (size_t)x * L, rowm = (size_t)wrap(x - 1, L) * L;
  ld_pair<T, PAIRED>(U + row, ya, yb, u.ux);
  ld_pair<T, PAIRED>(U + rowm, ya, yb, u.uxm);
  ld_pair<T, PAIRED>(U + LL + row, ya, yb, u.uy);
  u.uym = ld_nc(U + LL + row + wrap(ya - 1, L));
  return u;
}

// v at the pair and its neighbours: the y neighbours inside the pair are
// the pair's own words; ym is left of ya, yp right of yb.
template <typename T, bool PAIRED>
__device__ __forceinline__ SpinAt<T> ld_spin(const cplx<T>* __restrict__ v,
                                             size_t LL, int L, int x, int ya,
                                             int yb) {
  SpinAt<T> o;
  const size_t row = (size_t)x * L;
  const size_t rowp = (size_t)wrap(x + 1, L) * L;
  const size_t rowm = (size_t)wrap(x - 1, L) * L;
  const int ym = wrap(ya - 1, L), yp = wrap(yb + 1, L);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const cplx<T>* p = v + s * LL;
    ld_pair<T, PAIRED>(p + row, ya, yb, o.c[s]);
    ld_pair<T, PAIRED>(p + rowp, ya, yb, o.xp[s]);
    ld_pair<T, PAIRED>(p + rowm, ya, yb, o.xm[s]);
    o.ym[s] = ld_nc(p + row + ym);
    o.yp[s] = ld_nc(p + row + yp);
  }
  return o;
}

// D_U v at the pair: d[spin][site] = diag v + hop(v). `two`: the pair has
// its second site (else, at an odd L, site 1 is the first again and its
// value is not used).
template <typename T>
__device__ __forceinline__ void links_apply_pair(const LinksAt<T>& u,
                                                 const SpinAt<T>& v, T diag,
                                                 bool two, cplx<T> d[2][2]) {
  cplx<T> h0, h1;
  tmg::wilson_hop_core(u.ux[0], u.uxm[0], u.uy[0], u.uym, v.xp[0][0],
                       v.xp[1][0], v.xm[0][0], v.xm[1][0],
                       two ? v.c[0][1] : v.yp[0], two ? v.c[1][1] : v.yp[1],
                       v.ym[0], v.ym[1], h0, h1);
  d[0][0] = scale(diag, v.c[0][0]) + h0;
  d[1][0] = scale(diag, v.c[1][0]) + h1;
  tmg::wilson_hop_core(u.ux[1], u.uxm[1], u.uy[1], u.uy[0], v.xp[0][1],
                       v.xp[1][1], v.xm[0][1], v.xm[1][1], v.yp[0], v.yp[1],
                       v.c[0][0], v.c[1][0], h0, h1);
  d[0][1] = scale(diag, v.c[0][1]) + h0;
  d[1][1] = scale(diag, v.c[1][1]) + h1;
}

// The pair of thread (tx, ty) of a block of bx x by threads over tile t of
// a lattice cut into tiles of bx pairs by by x rows, tiles_y of them along
// y: (x, ya, yb, two); false where the thread falls off the lattice.
__device__ __forceinline__ bool pair_of(int t, int tiles_y, int L, int& x,
                                        int& ya, int& yb, bool& two) {
  const int ty = t / tiles_y;
  ya = 2 * ((t - ty * tiles_y) * (int)blockDim.x + (int)threadIdx.x);
  x = ty * (int)blockDim.y + (int)threadIdx.y;
  two = ya + 1 < L;
  yb = two ? ya + 1 : ya;
  return ya < L && x < L;
}

// v's two planes over the block's tile (blockDim.x pairs by blockDim.y x
// rows from (x0, y0)) and a one-site periodic halo, (by + 2) x (2 bx + 2)
// words a plane, into shared memory by cp.async; the caller waits. (The
// tile's indices stay within [-1, 2L) for L >= 2, where wrap holds; at
// L = 1 every site is site 0.)
template <typename T>
__device__ __forceinline__ void stage_tile(const cplx<T>* __restrict__ v,
                                           size_t LL, int L, int x0, int y0,
                                           cplx<T>* sv) {
  const int cols = 2 * blockDim.x + 2, n = (blockDim.y + 2) * cols;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < n;
       i += blockDim.x * blockDim.y) {
    const int ii = i / cols, jj = i - ii * cols;
    const size_t g =
        L == 1 ? 0 : (size_t)wrap(x0 - 1 + ii, L) * L + wrap(y0 - 1 + jj, L);
    cp_async(sv + i, v + g);
    cp_async(sv + n + i, v + LL + g);
  }
}

// v at the pair (x, ya), (x, ya + 1) and its neighbours, from the tile.
template <typename T>
__device__ __forceinline__ SpinAt<T> spin_of_tile(const cplx<T>* sv, int x0,
                                                  int y0, int x, int ya,
                                                  bool two) {
  SpinAt<T> o;
  const int cols = 2 * blockDim.x + 2, n = (blockDim.y + 2) * cols;
  const cplx<T>* c0 = sv + (x - x0 + 1) * cols + (ya - y0 + 1);
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    const cplx<T>* c = c0 + s * n;
    o.c[s][0] = c[0];
    o.c[s][1] = two ? c[1] : c[0];
    o.xp[s][0] = c[cols];
    o.xp[s][1] = two ? c[cols + 1] : c[cols];
    o.xm[s][0] = c[-cols];
    o.xm[s][1] = two ? c[1 - cols] : c[-cols];
    o.ym[s] = c[-1];
    o.yp[s] = two ? c[2] : c[1];
  }
  return o;
}

// out at the pair of entry b: r - d (the residual) or d (APPLY), one
// 16-byte store a row where PAIRED.
template <typename T, bool APPLY, bool PAIRED>
__device__ __forceinline__ void store_pair(cplx<T>* out, size_t LL,
                                           cplx<T> d[2][2],
                                           const cplx<T> rr[2][2], bool two) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    if constexpr (!APPLY) {
      d[s][0] = rr[s][0] - d[s][0];
      d[s][1] = rr[s][1] - d[s][1];
    }
    cplx<T>* o = out + s * LL;
    if constexpr (PAIRED) {
      st_pair<T>(o, d[s]);
    } else {
      o[0] = d[s][0];
      if (two) o[1] = d[s][1];
    }
  }
}

template <typename T, bool APPLY, bool PAIRED>
__global__ void __launch_bounds__(128)
    links_out_kernel(const cplx<T>* __restrict__ U,
                     const cplx<T>* __restrict__ phi,
                     const cplx<T>* __restrict__ r, cplx<T>* __restrict__ out,
                     int L, T diag, long long r_bstride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const sv = reinterpret_cast<cplx<T>*>(smem_raw);
  int x, ya, yb;
  bool two;
  const bool active = pair_of(blockIdx.y * gridDim.x + blockIdx.x, gridDim.x,
                              L, x, ya, yb, two);
  const size_t LL = (size_t)L * L, row = (size_t)x * L, b = blockIdx.z;
  const int x0 = blockIdx.y * blockDim.y, y0 = blockIdx.x * 2 * blockDim.x;
  LinksAt<T> u;
  cplx<T> rr[2][2], d[2][2];
  if (active) u = ld_links<T, PAIRED>(U, LL, L, x, ya, yb);
  stage_tile(phi + b * 2 * LL, LL, L, x0, y0, sv);
  if (active && !APPLY) {
    const cplx<T>* rb = r + b * (size_t)r_bstride + row;
    ld_pair<T, PAIRED>(rb, ya, yb, rr[0]);
    ld_pair<T, PAIRED>(rb + LL, ya, yb, rr[1]);
  }
  cp_async_wait();
  __syncthreads();
  if (!active) return;
  links_apply_pair(u, spin_of_tile(sv, x0, y0, x, ya, two), diag, two, d);
  store_pair<T, APPLY, PAIRED>(out + b * 2 * LL + row + ya, LL, d, rr, two);
}

// ---- the level-0 convergence check in one launch ---------------------------
//
// Replaces, on the check's path, _u_resid_vmem_kernel (pallas_stencil.py:662)
// and the two norms around it (cycles.residual_norm_ratio0):
//
//   out[b] = ||r_b - D_U phi_b|| / ||r_b||   (the real type T)
//
// the residual computed in registers as links_out_kernel computes it and
// never written; r (the right-hand side) is read anyway, so ||r||^2 costs
// no byte more. What bounds it: bytes, U 2, phi 2, r 2 complex words a site
// (6: 0.94 us at L=256 c64). Each thread sums |res|^2 and |r|^2 of its
// sites in float64, a warp by shuffles, a block through shared memory, in
// a fixed order; the blocks' partial sums go to `partial` [B][gridDim.x][2].
// One cooperative launch: after a grid barrier, block (0, b % gridDim.y)
// adds entry b's partials in index order and writes out[b]. No atomics, so
// three calls on the same inputs give the same bits, and a solve's cycle
// count cannot flip with the order of a sum. The grid is sized to be
// resident (cooperative): gridDim.y entries at once, gridDim.x blocks
// striding over an entry's tiles of 32 pairs by 4 x rows; v through L1.
//
// The check as B2, then two norms in plain torch, took 18 device ops and
// 36.54 / 39.20 us of device time warm / cold at L=256 c64 (66.32 / 68.32
// at B=8); this one 1 launch, 5.02 / 6.86 us (11.70 / 16.42 at B=8), same
// H100 80GB HBM3 at 700 W, in turns (scripts/torch_smoother_ab.py
// --residuals-only). At L=2048 (the x-tiled level 0; bound 60.1 us) it
// reads 72.6 / 84.0 us against 451.2 / 458.4 for B5b, then the two norms,
// so every links-active level 0 takes it. Variants timed against it in
// turns: the reduction as a second, one-block launch instead of the grid
// barrier, 4.56 / 6.39 us unbatched against 5.04 / 6.84 here, but 15.07 /
// 19.32 at B=8 against 11.80 / 16.41, and one more launch on a check the
// host waits for; v staged by cp.async, 5.05 / 6.61 (13.96 / 16.11 at
// B=8); 16-byte loads of a pair (PAIRED, as links_out_kernel reads) 5.04 /
// 6.84, 72.6 / 83.3 at L=2048 and 11.81 / 16.31 at B=8 against a word a
// load's 4.85 / 6.73, 71.4 / 81.1 and 11.82 / 15.71: a word a load is
// kept, which also takes any L and alignment. Registers (-Xptxas -v): 63
// (complex64), 86 (complex128), no spills.
__device__ __forceinline__ void block_sum2(double& a, double& c,
                                           double* sred) {
#pragma unroll
  for (int w = 16; w > 0; w /= 2) {
    a += __shfl_xor_sync(0xffffffffu, a, w);
    c += __shfl_xor_sync(0xffffffffu, c, w);
  }
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nw = (blockDim.x * blockDim.y) / 32;
  __syncthreads();  // sred free (a previous sum has been read)
  if ((tid & 31) == 0) {
    sred[2 * (tid / 32)] = a;
    sred[2 * (tid / 32) + 1] = c;
  }
  __syncthreads();
  a = 0.0;
  c = 0.0;
  for (int w = 0; w < nw; ++w) {  // every thread, in the same order
    a += sred[2 * w];
    c += sred[2 * w + 1];
  }
}

template <typename T>
__device__ __forceinline__ double sq(cplx<T> z) {
  const double re = z.re, im = z.im;
  return re * re + im * im;
}

template <typename T>
__global__ void __launch_bounds__(128)
    links_resid_norm_kernel(const cplx<T>* __restrict__ U,
                            const cplx<T>* __restrict__ phi,
                            const cplx<T>* __restrict__ r,
                            double* __restrict__ partial, T* __restrict__ out,
                            int L, T diag, int B, long long r_bstride,
                            int tiles_y, int tiles) {
  __shared__ double sred[8];  // 4 warps x 2 sums
  const size_t LL = (size_t)L * L;
  for (int e = blockIdx.y; e < B; e += gridDim.y) {
    double s_res = 0.0, s_r = 0.0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int x, ya, yb;
      bool two;
      if (!pair_of(t, tiles_y, L, x, ya, yb, two)) continue;
      const size_t row = (size_t)x * L;
      const LinksAt<T> u = ld_links<T, false>(U, LL, L, x, ya, yb);
      const SpinAt<T> v = ld_spin<T, false>(phi + (size_t)e * 2 * LL, LL, L,
                                            x, ya, yb);
      const cplx<T>* rb = r + e * (size_t)r_bstride + row;
      cplx<T> rr[2][2];
      ld_pair<T, false>(rb, ya, yb, rr[0]);
      ld_pair<T, false>(rb + LL, ya, yb, rr[1]);
      cplx<T> d[2][2];
      links_apply_pair(u, v, diag, two, d);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        s_res += sq(rr[s][0] - d[s][0]);
        s_r += sq(rr[s][0]);
        if (two) {
          s_res += sq(rr[s][1] - d[s][1]);
          s_r += sq(rr[s][1]);
        }
      }
    }
    block_sum2(s_res, s_r, sred);
    if (threadIdx.x == 0 && threadIdx.y == 0) {
      double* p = partial + 2 * ((size_t)e * gridDim.x + blockIdx.x);
      p[0] = s_res;
      p[1] = s_r;
    }
  }
  cg::this_grid().sync();
  if (blockIdx.x != 0) return;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  for (int e = blockIdx.y; e < B; e += gridDim.y) {
    const double* p = partial + 2 * (size_t)e * gridDim.x;
    double s_res = 0.0, s_r = 0.0;
    for (int i = tid; i < (int)gridDim.x; i += nt) {
      s_res += __ldcg(p + 2 * i);
      s_r += __ldcg(p + 2 * i + 1);
    }
    block_sum2(s_res, s_r, sred);
    if (tid == 0) out[e] = T(sqrt(s_res) / sqrt(s_r));
  }
}

// ---- B2 redesigned: the level-0 residual fused with its restriction ------
//
// Replaces _u_resid_vmem_kernel (pallas_stencil.py:662) where the cycle
// restricts its output at once (ops/transfer.restrict):
//
//   rc[b][c][X][Y] = sum_{f, a, e} phi_null[c][f][x][y] res[b][f][x][y],
//   res = r - (2+m) phi - hop(phi),  x = X bx + a + ox,  y = Y by + e + oy
//
// (periodic; (ox, oy) = transfer.QUAD_OFFSETS[quad], no conjugate, as
// restrict). The fine residual never goes to memory.
//
// What bounds it: bytes, 15 complex words a fine site at nc = 4 and 2 x 2
// blocks (U 2, phi 2, r 2, phi_null 2 nc, out nc / (bx by)): 2.35 us at
// L=256 c64 against 3.35 TB/s. The unfused path (B2, then the einsum and
// copy of restrict) writes the residual and reads it back.
//
// Design: a block of 32 x TXc threads owns a tile of 32 / bx x TXc coarse
// sites (TXc from the host: the most rows, up to 4, that still give every
// SM a block; 4 at L=256, 256 blocks of 128 threads). It stages phi over its
// fine tile and a one-site periodic halo in shared memory by cp.async. A
// coarse site belongs to bx adjacent lanes, lane a taking its fine row a:
// it walks the row a pair of y-adjacent sites at a time, reads their links,
// r and phi_null straight into registers (16 bytes a load where the pair is
// aligned: the quadrants with oy = 0), the neighbours of phi from the
// staged tile, computes the two residuals in registers and adds them, times
// phi_null, into its nc sums; a warp shuffle adds the bx rows' sums. Each
// coarse site belongs to one warp, so there is no reduction across warps or
// blocks. The first two pairs' loads (all of a 2 x 2 block's) are issued
// before the block waits for the staging, so that they are in flight
// together, and each later pair's two pairs ahead of its arithmetic. The
// first version gave a thread a whole coarse site (16384 threads at
// L=256, the second pair's loads after the barrier): 7.34 us cold, 4.49 us
// warm at the flagship's level 0 (chip_smoke.py, H100 80GB HBM3, 700 W);
// loading the second pair before the barrier moved it to 7.22 / 4.52.
// The 16-byte pair loads (PAIRED) against a word a load, in turns on an
// H100 80GB HBM3 at 700 W (scripts/torch_smoother_ab.py --residuals-only):
// 17.4 / 22.9 us warm / cold against 20.3 / 27.4 at a batch of 8, 3.6 /
// 6.0 against 3.5 / 5.9 unbatched. Registers (-Xptxas -v): 168 / 174
// (paired / unpaired loads) at nc = 4 in complex64, no spills; 255 in
// complex128 at nc = 4, with 164 bytes spilled (fewer rows: no spills).
template <typename T, int NC>
struct RRPair {
  cplx<T> ux[2], uy[2], uxm[2], uym, r0[2], r1[2], pn[NC][2][2];
};

template <typename T, int NC, bool PAIRED>
__device__ __forceinline__ RRPair<T, NC> rr_load(
    const cplx<T>* __restrict__ U, const cplx<T>* __restrict__ r,
    const cplx<T>* __restrict__ pn, size_t LL, int L, int x, int ya, int yb) {
  RRPair<T, NC> o;
  const size_t row = (size_t)x * L;
  const size_t rowm = (size_t)wrap(x - 1, L) * L;
  ld_pair<T, PAIRED>(U + row, ya, yb, o.ux);
  ld_pair<T, PAIRED>(U + rowm, ya, yb, o.uxm);
  ld_pair<T, PAIRED>(U + LL + row, ya, yb, o.uy);
  o.uym = ld_nc(U + LL + row + wrap(ya - 1, L));
  ld_pair<T, PAIRED>(r + row, ya, yb, o.r0);
  ld_pair<T, PAIRED>(r + LL + row, ya, yb, o.r1);
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int f = 0; f < 2; ++f)
      ld_pair<T, PAIRED>(pn + (size_t)(2 * c + f) * LL + row, ya, yb,
                         o.pn[c][f]);
  return o;
}

template <typename T>
__device__ __forceinline__ cplx<T> shfl_xor(cplx<T> v, int mask) {
  return mk<T>(__shfl_xor_sync(0xffffffffu, v.re, mask),
               __shfl_xor_sync(0xffffffffu, v.im, mask));
}

template <typename T, int NC, bool PAIRED>
__global__ void __launch_bounds__(128)
    links_resid_restrict_kernel(const cplx<T>* __restrict__ U,
                                const cplx<T>* __restrict__ phi,
                                const cplx<T>* __restrict__ r,
                                const cplx<T>* __restrict__ pn,
                                cplx<T>* __restrict__ out, int L, T diag,
                                long long r_bstride, int bx, int by, int ox,
                                int oy) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cplx<T>* const sp = reinterpret_cast<cplx<T>*>(smem_raw);
  const int Lcx = L / bx, Lcy = L / by;
  const int tyc = 32 / bx;  // coarse columns of a block (a warp)
  const int X0 = blockIdx.y * blockDim.y, Y0 = blockIdx.x * tyc;
  const int tcx = min((int)blockDim.y, Lcx - X0), tcy = min(tyc, Lcy - Y0);
  const int x0 = X0 * bx + ox, y0 = Y0 * by + oy;  // the tile's fine origin
  const int rows = tcx * bx + 2, cols = tcy * by + 2;
  const int pitch = tyc * by + 2;
  const int plane = ((int)blockDim.y * bx + 2) * pitch;
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  const cplx<T>* const pb = phi + b * 2 * LL;
  r += b * (size_t)r_bstride;

  for (int ii = threadIdx.y; ii < rows; ii += blockDim.y) {
    const size_t row = (size_t)wrap(x0 - 1 + ii, L) * L;
    for (int jj = threadIdx.x; jj < cols; jj += 32) {
      const int y = wrap(y0 - 1 + jj, L);
      cp_async(sp + ii * pitch + jj, pb + row + y);
      cp_async(sp + plane + ii * pitch + jj, pb + LL + row + y);
    }
  }

  // lane = (coarse column, fine row a of the coarse site), a fastest
  const int a = threadIdx.x % bx, yl = threadIdx.x / bx;
  const bool active = yl < tcy && (int)threadIdx.y < tcx;
  const int steps = by / 2;
  const int i = threadIdx.y * bx + a;  // the fine row in the tile
  const int x = wrap(x0 + i, L);
  // fine sites (x, ya), (x, yb) of pair e, at column j of the tile
  auto at = [&](int e, int& j, int& ya, int& yb) {
    j = yl * by + 2 * e;
    ya = wrap(y0 + j, L);
    yb = ya + 1 == L ? 0 : ya + 1;
  };
  // two pairs' operands in flight: cur (pair e) and nxt (pair e + 1), the
  // first two issued before the block waits for the staging
  int j, ya, yb;
  RRPair<T, NC> cur, nxt;
  if (active) {
    at(0, j, ya, yb);
    cur = rr_load<T, NC, PAIRED>(U, r, pn, LL, L, x, ya, yb);
    if (steps > 1) {
      at(1, j, ya, yb);
      nxt = rr_load<T, NC, PAIRED>(U, r, pn, LL, L, x, ya, yb);
    }
  }
  cp_async_wait();
  __syncthreads();

  cplx<T> acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = mk<T>(T(0), T(0));
  for (int e = 0; active && e < steps; ++e) {
    const RRPair<T, NC> o = cur;
    cur = nxt;
    if (e + 2 < steps) {
      at(e + 2, j, ya, yb);
      nxt = rr_load<T, NC, PAIRED>(U, r, pn, LL, L, x, ya, yb);
    }
    at(e, j, ya, yb);
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const cplx<T>* c0 = sp + (i + 1) * pitch + (j + 1 + s);
      const cplx<T>* c1 = c0 + plane;
      cplx<T> h0, h1;
      tmg::wilson_hop_core(o.ux[s], o.uxm[s], o.uy[s], s ? o.uy[0] : o.uym,
                           c0[pitch], c1[pitch], c0[-pitch], c1[-pitch],
                           c0[1], c1[1], c0[-1], c1[-1], h0, h1);
      const cplx<T> e0 = (s ? o.r0[1] : o.r0[0]) - scale(diag, *c0) - h0;
      const cplx<T> e1 = (s ? o.r1[1] : o.r1[0]) - scale(diag, *c1) - h1;
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[c] = acc[c] + o.pn[c][0][s] * e0 + o.pn[c][1][s] * e1;
    }
  }
  // the bx fine rows of a coarse site are bx adjacent lanes: every lane
  // takes part in the shuffles, the idle ones with zero sums
#pragma unroll
  for (int c = 0; c < NC; ++c)
    for (int w = 1; w < bx; w *= 2) acc[c] = acc[c] + shfl_xor(acc[c], w);
  if (!active || a != 0) return;
  const size_t LLc = (size_t)Lcx * Lcy;
  cplx<T>* ob = out + b * NC * LLc + (size_t)(X0 + threadIdx.y) * Lcy + Y0 +
                yl;
#pragma unroll
  for (int c = 0; c < NC; ++c) ob[c * LLc] = acc[c];
}

// ---- B7a redesigned: the dense SpMV and residual on shared operands -------
//
// Replaces _apply_d_kernel (pallas_stencil.py:64):
//
//   APPLY:  out[b] = D[b / G] v[b]        RESID:  out[b] = r[b] - D[b / G] v[b]
//   (D v)(x) = sum_{mu = 0..4} D_mu(x) v(x + mu)
//
// over B batch entries in groups of G that share one D (G = B: D shared by
// the batch, as the NTL copies' min-res apply on the level's D or a batch of
// right-hand sides on one hierarchy; G = 1: a D an entry; G = 4, B = 4 E:
// the min-res apply of an ensemble, each configuration's D for its 4
// copies). v and r each batched or shared (stride 0).
//
// What bounds it: bytes, D's 5 n^2 words a site once a group, v and out (and
// r) n words a site an entry: the level-1 residual of the flagship (n=4,
// L=128) moves 92 words a site, 12.1 MB, 3.60 us at 3.35 TB/s; the min-res
// apply [4, 4, 64, 64] on a shared D 80 + 4 x 8 words a site, 1.10 us. The
// first design (one thread a (batch entry, site), all n rows) read a shared
// D once an entry and, at the coarse levels' sizes, filled few SMs.
//
// Design: N lanes own a pair of y-adjacent sites (L even) for a chunk of up
// to KG entries of one group; lane i computes row i of the block product for
// both sites and every entry of the chunk. It loads D's row i of all five
// directions at once (5 N 16-byte loads in complex64, in flight together)
// and keeps it in registers while it runs over the chunk, so a group of G
// entries reads D ceil(G / KG) times (KG = 4 where that leaves enough
// threads, else 1: dense_apply_g). The N lanes of a pair read the same
// words of v (one transaction a warp serves them all), the four neighbour
// rows from L1 / L2: the centre and the x neighbours as pairs, the y
// neighbours outside the pair one word each. Blocks of 128 threads, fewer
// where the grid would not give every SM one (L=64). A first version that
// loaded D one direction at a time (46 registers at n=4 c64) took 13.35 us
// cold at the level-1 residual and 13.23 us at the min-res apply (KG = 4,
// 8192 threads), against 7.61 us for the first design's apply at n=2 L=256
// (chip_smoke.py, H100 80GB HBM3, 700 W; PERF.md). Registers (-Xptxas -v,
// n=4): 80-84 at KG = 1 and 168-170 at KG = 4 in complex64, 142-176 in
// complex128; no spills. KG = 4 against KG = 1 on the same code, in turns
// on an H100 80GB HBM3 at 700 W (scripts/torch_smoother_ab.py
// --residuals-only), warm / cold us: the level-1 residual of 8 right-hand
// sides on one D 12.5 / 19.9 against 16.5 / 20.2; the min-res apply of 32
// copies on one D 9.8 / 13.5 against 15.9 / 18.4, on 8 D 11.3 / 19.8
// against 18.0 / 25.6. A version
// without the chunk loop (one entry a thread) took 72 registers at n=4
// c64, its D loads no longer all in flight: 3.2-3.8 us warm at the
// level-2 residual against 2.7.
template <typename T, int N, int KG, bool RESID>
__global__ void __launch_bounds__(128)
    dense_apply_kernel(const cplx<T>* __restrict__ D,
                       const cplx<T>* __restrict__ v,
                       const cplx<T>* __restrict__ r,
                       cplx<T>* __restrict__ out, int B, int L, int G,
                       long long d_bstride, long long v_bstride,
                       long long r_bstride) {
  const size_t LL = (size_t)L * L;
  const int i = threadIdx.x % N;
  const size_t pr = (size_t)blockIdx.x * (blockDim.x / N) + threadIdx.x / N;
  if (pr >= LL / 2) return;
  const int chunks = (G + KG - 1) / KG;
  const int q = blockIdx.y / chunks;  // the group
  const int b0 = q * G + (blockIdx.y - q * chunks) * KG;
  const int kg = min(KG, (q + 1) * G - b0);

  const size_t s0 = 2 * pr;  // sites s0, s0 + 1 in one row (L even)
  const int x = (int)(s0 / L), y = (int)(s0 - (size_t)x * L);
  const size_t xp = (size_t)wrap(x + 1, L) * L + y;
  const size_t xm = (size_t)wrap(x - 1, L) * L + y;
  const size_t yp = (size_t)x * L + wrap(y + 2, L);  // right of the pair
  const size_t ym = (size_t)x * L + wrap(y - 1, L);  // left of the pair
  const cplx<T>* Dq = D + q * (size_t)d_bstride + (size_t)i * N * LL;

  // D's row i of every direction at the two sites, all loads in flight
  // at once
  cplx<T> w[5][N][2];
#pragma unroll
  for (int d = 0; d < 5; ++d)
#pragma unroll
    for (int j = 0; j < N; ++j)
      ld_pair<T, true>(Dq + (size_t)(d * N * N + j) * LL, (int)s0,
                       (int)s0 + 1, w[d][j]);
#pragma unroll
  for (int k = 0; k < KG; ++k) {
    if (k >= kg) break;
    const size_t b = b0 + k;
    // v at the pair and its neighbours: u[d][j] for direction d, component
    // j; the y neighbours inside the pair are the pair's own words
    cplx<T> u[5][N][2];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const cplx<T>* vj = v + b * (size_t)v_bstride + (size_t)j * LL;
      ld_pair<T, true>(vj, (int)s0, (int)s0 + 1, u[0][j]);
      ld_pair<T, true>(vj, (int)xp, (int)xp + 1, u[1][j]);
      ld_pair<T, true>(vj, (int)xm, (int)xm + 1, u[2][j]);
      u[3][j][0] = u[0][j][1];
      u[3][j][1] = ld_nc(vj + yp);
      u[4][j][0] = ld_nc(vj + ym);
      u[4][j][1] = u[0][j][0];
    }
    cplx<T> rr[2];
    if constexpr (RESID)
      ld_pair<T, true>(r + b * (size_t)r_bstride + (size_t)i * LL, (int)s0,
                       (int)s0 + 1, rr);
    cplx<T> acc[2] = {mk<T>(T(0), T(0)), mk<T>(T(0), T(0))};
#pragma unroll
    for (int d = 0; d < 5; ++d)
#pragma unroll
      for (int j = 0; j < N; ++j) {
        acc[0] = acc[0] + w[d][j][0] * u[d][j][0];
        acc[1] = acc[1] + w[d][j][1] * u[d][j][1];
      }
    if constexpr (RESID) {
      acc[0] = rr[0] - acc[0];
      acc[1] = rr[1] - acc[1];
    }
    st_pair<T>(out + (b * N + i) * LL + s0, acc);
  }
}

constexpr int kLinksThreads = 128;  // links_update_kernel's block
constexpr int kDenseThreads = 256;  // dense_update_kernel's block

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
int launch_cooperative(const void* kernel, dim3 grid, dim3 threads,
                       long long smem, void* stream, void** args) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(kernel, grid, threads, args,
                                    (size_t)smem, (cudaStream_t)stream);
  cudaGetLastError();
  return (int)e;
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

template <typename T, int N, bool GROUPED>
const void* dense_update_fn(int staged) {
  return staged ? (const void*)dense_update_kernel<T, N, true, GROUPED>
                : (const void*)dense_update_kernel<T, N, false, GROUPED>;
}

template <typename T, int N>
const void* dense_update_fn(int staged, int grouped) {
  return grouped ? dense_update_fn<T, N, true>(staged)
                 : dense_update_fn<T, N, false>(staged);
}

template <typename T>
const void* dense_update_fn(int n, int staged, int grouped) {
  switch (n) {
    case 1:
      return dense_update_fn<T, 1>(staged, grouped);
    case 2:
      return dense_update_fn<T, 2>(staged, grouped);
    case 4:
      return dense_update_fn<T, 4>(staged, grouped);
    default:
      return nullptr;
  }
}

template <typename T>
int dense_update(const void* D, const void* Dinv, const void* phi,
                 const void* r, void* out, void* scratch, int B, int n, int L,
                 int G, long long d_bs, long long dinv_bs, long long r_bs,
                 int rb, int n_sweeps, double omega, int rows, int staged,
                 long long smem, void* stream) {
  const void* fn = dense_update_fn<T>(n, staged, G > 1);
  if (fn == nullptr || rows < 1 || n_sweeps < 1 || B < 1 || L < 2 ||
      (rb && L % 2) || G < 1 || B % G) {
    return (int)cudaErrorInvalidValue;
  }
  if (staged && smem < (long long)(5 * n * n * band_ops_rows(rows, G) +
                                   n * rows) * L * sizeof(cplx<T>)) {
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
  void* args[] = {&Dp,      &Dip,  &pp,   &rp, &op,       &sp,
                  &B,       &L,    &G,    &d_bs, &dinv_bs, &r_bs,
                  &rb,      &n_sweeps, &om, &rows};
  return launch_cooperative(fn, grid, kDenseThreads, staged ? smem : 0,
                            stream, args);
}

// The SMs of the current card, read once a process (the grid sizing of
// the SpMV and the fused residual-restriction runs on every launch), or a
// CUDA error as a negative number, which those launches return.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    return n;
  }();
  return sms;
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<size_t>(p) & 15) == 0;
}

// The blocks of the links apply, residual and norm: bx pairs along y (the
// least power of 2 that covers a row's (L + 1) / 2 pairs, at most 32) by
// `by` x rows, 128 threads (`full`, the norm's whole warps) or fewer where
// L has fewer rows; the lattice in tiles_x (along x) by tiles_y tiles.
struct LinksTiles {
  int bx, by, tiles_x, tiles_y;
};

inline LinksTiles links_tiles(int L, bool full) {
  const int px = (L + 1) / 2;
  int bx = 1;
  while (bx < px && bx < 32) bx *= 2;
  int by = 128 / bx;
  if (!full && by > L) by = L;
  return {bx, by, (L + by - 1) / by, (px + bx - 1) / bx};
}

// One batch entry a block (blockIdx.z), v's tile and halo in shared memory
// (at most 13 KB).
template <typename T, bool APPLY, bool PAIRED>
int links_out_n(const void* U, const void* phi, const void* r, void* out,
                int B, int L, double m, long long r_bs, void* stream) {
  const LinksTiles g = links_tiles(L, false);
  if (B > 65535 || g.tiles_x > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(cplx<T>) * (g.by + 2) * (2 * g.bx + 2);
  links_out_kernel<T, APPLY, PAIRED>
      <<<dim3((unsigned)g.tiles_y, (unsigned)g.tiles_x, (unsigned)B),
         dim3(g.bx, g.by), smem, (cudaStream_t)stream>>>(
          (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
          (cplx<T>*)out, L, T(2.0 + m), r_bs);
  return (int)cudaGetLastError();
}

// paired: L even and every operand 16-byte aligned (the wrapper decides;
// a paired call that is not is refused).
template <typename T, bool APPLY>
int links_out(const void* U, const void* phi, const void* r, void* out,
              int B, int L, double m, long long r_bs, int paired,
              void* stream) {
  if (B < 1 || L < 1 || (!APPLY && r == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!paired)
    return links_out_n<T, APPLY, false>(U, phi, r, out, B, L, m, r_bs,
                                        stream);
  if (L % 2 || !aligned16(U) || !aligned16(phi) || !aligned16(r) ||
      !aligned16(out))
    return (int)cudaErrorInvalidValue;
  return links_out_n<T, APPLY, true>(U, phi, r, out, B, L, m, r_bs, stream);
}

// The doubles of scratch the check needs: 2 B gridDim.x, at most 2 B
// tiles.
inline int links_norm_scratch(int B, int L, long long* n) {
  if (B < 1 || L < 1 || n == nullptr) return (int)cudaErrorInvalidValue;
  const LinksTiles g = links_tiles(L, true);
  *n = 2LL * B * g.tiles_x * g.tiles_y;
  return 0;
}

// The check: one cooperative launch, its grid as many blocks as the card
// holds resident (the kernel's occupancy, read once a process) up to one a
// tile; `partial` must hold 2 B gridDim.x doubles (links_norm_scratch).
template <typename T>
int links_norm(const void* U, const void* phi, const void* r, void* partial,
               void* out, int B, int L, double m, long long r_bs,
               long long partial_len, void* stream) {
  if (B < 1 || L < 1 || r == nullptr || partial == nullptr ||
      out == nullptr)
    return (int)cudaErrorInvalidValue;
  static const int occ = [] {
    int n = 0;
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, links_resid_norm_kernel<T>, 128, 0);
    if (e != cudaSuccess) {
      cudaGetLastError();
      return -(int)e;
    }
    return n;
  }();
  if (occ < 0) return -occ;
  if (occ == 0) return (int)cudaErrorLaunchOutOfResources;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const long long cap = (long long)occ * sms;
  const LinksTiles g = links_tiles(L, true);
  int tiles = g.tiles_x * g.tiles_y, tiles_y = g.tiles_y;
  const long long gy = B < cap ? B : cap;
  long long gx = cap / gy < tiles ? cap / gy : tiles;
  if (gx < 1) gx = 1;
  if (gy > 65535 || 2 * (long long)B * gx > partial_len)
    return (int)cudaErrorInvalidValue;
  const cplx<T>* Up = (const cplx<T>*)U;
  const cplx<T>* pp = (const cplx<T>*)phi;
  const cplx<T>* rp = (const cplx<T>*)r;
  double* part = (double*)partial;
  T* op = (T*)out;
  T diag = T(2.0 + m);
  void* args[] = {&Up, &pp, &rp, &part, &op, &L, &diag, &B, &r_bs, &tiles_y,
                  &tiles};
  return launch_cooperative((const void*)links_resid_norm_kernel<T>,
                            dim3((unsigned)gx, (unsigned)gy),
                            dim3(g.bx, g.by), 0, stream, args);
}

// The dense SpMV or residual of B entries in groups of G sharing one D
// (B % G == 0), L even, every operand 16-byte aligned; r is read when RESID.
template <typename T, int N, int KG, bool RESID>
int dense_apply_n(const void* D, const void* v, const void* r, void* out,
                  int B, int L, int G, long long d_bs, long long v_bs,
                  long long r_bs, void* stream) {
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const long long chunks = (long long)(B / G) * ((G + KG - 1) / KG);
  const size_t pairs = (size_t)L * L / 2;
  int threads = 128;
  while (threads > 32 &&
         (pairs + threads / N - 1) / (threads / N) * chunks < (size_t)sms)
    threads /= 2;
  const size_t blocks = (pairs + threads / N - 1) / (threads / N);
  if (chunks > 65535 || blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  dense_apply_kernel<T, N, KG, RESID>
      <<<dim3((unsigned)blocks, (unsigned)chunks), threads, 0,
         (cudaStream_t)stream>>>((const cplx<T>*)D, (const cplx<T>*)v,
                                 (const cplx<T>*)r, (cplx<T>*)out, B, L, G,
                                 d_bs, v_bs, r_bs);
  return (int)cudaGetLastError();
}

// Chunks of 4 entries a thread where that still leaves 2 blocks of 128
// threads an SM, else one entry a thread: the unbatched min-res apply (4
// entries of n=4 at L=64) then runs 32768 threads, not 8192, and reads D
// four times from L2 instead of once, after one read from HBM. In
// complex128 always one entry a thread (4 spill at n=4).
template <typename T, int N, bool RESID>
int dense_apply_g(const void* D, const void* v, const void* r, void* out,
                  int B, int L, int G, long long d_bs, long long v_bs,
                  long long r_bs, void* stream) {
  if constexpr (sizeof(T) == 4) {
    const int sms = sm_count();
    if (sms < 0) return -sms;
    const long long threads4 =
        (long long)(B / G) * ((G + 3) / 4) * ((long long)L * L / 2) * N;
    if (G > 1 && threads4 >= 2LL * 128 * sms)
      return dense_apply_n<T, N, 4, RESID>(D, v, r, out, B, L, G, d_bs, v_bs,
                                           r_bs, stream);
  }
  return dense_apply_n<T, N, 1, RESID>(D, v, r, out, B, L, G, d_bs, v_bs,
                                       r_bs, stream);
}

template <typename T, bool RESID>
int dense_apply(const void* D, const void* v, const void* r, void* out,
                int B, int n, int L, int G, long long d_bs, long long v_bs,
                long long r_bs, void* stream) {
  if (B < 1 || G < 1 || B % G || L < 2 || L % 2 || !aligned16(D) ||
      !aligned16(v) || !aligned16(r) || !aligned16(out) ||
      (RESID && r == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1:
      return dense_apply_g<T, 1, RESID>(D, v, r, out, B, L, G, d_bs, v_bs,
                                        r_bs, stream);
    case 2:
      return dense_apply_g<T, 2, RESID>(D, v, r, out, B, L, G, d_bs, v_bs,
                                        r_bs, stream);
    case 4:
      return dense_apply_g<T, 4, RESID>(D, v, r, out, B, L, G, d_bs, v_bs,
                                        r_bs, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The fused level-0 residual and restriction of B entries: nc in {1, 2, 4},
// bx, by in {2, 4} dividing L, (ox, oy) in {0, -1}^2; the coarse rows a
// block (TXc, up to 4) the most that still give every SM a block.
template <typename T, int NC, bool PAIRED>
int links_rr_n(const void* U, const void* phi, const void* r, const void* pn,
               void* out, int B, int L, double m, long long r_bs, int bx,
               int by, int ox, int oy, void* stream) {
  const int Lcx = L / bx, Lcy = L / by, tyc = 32 / bx;
  const long long ytiles = (Lcy + tyc - 1) / tyc;
  const int sms = sm_count();
  if (sms < 0) return -sms;
  int txc = 4;
  while (txc > 1 && ytiles * ((Lcx + txc - 1) / txc) * B < sms) txc /= 2;
  const size_t smem = sizeof(cplx<T>) * 2 * (size_t)(txc * bx + 2) *
                      (tyc * by + 2);
  const auto kernel = links_resid_restrict_kernel<T, NC, PAIRED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3((unsigned)ytiles, (unsigned)((Lcx + txc - 1) / txc),
                (unsigned)B),
           dim3(32, txc), smem, (cudaStream_t)stream>>>(
      (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
      (const cplx<T>*)pn, (cplx<T>*)out, L, T(2.0 + m), r_bs, bx, by, ox, oy);
  return (int)cudaGetLastError();
}

template <typename T, int NC>
int links_rr_p(const void* U, const void* phi, const void* r, const void* pn,
               void* out, int B, int L, double m, long long r_bs, int bx,
               int by, int ox, int oy, void* stream) {
  return oy == 0 ? links_rr_n<T, NC, true>(U, phi, r, pn, out, B, L, m, r_bs,
                                           bx, by, ox, oy, stream)
                 : links_rr_n<T, NC, false>(U, phi, r, pn, out, B, L, m,
                                            r_bs, bx, by, ox, oy, stream);
}

template <typename T>
int links_resid_restrict(const void* U, const void* phi, const void* r,
                         const void* pn, void* out, int B, int nc, int L,
                         double m, long long r_bs, int bx, int by, int ox,
                         int oy, void* stream) {
  if (B < 1 || B > 65535 || (bx != 2 && bx != 4) || (by != 2 && by != 4) ||
      L < 2 || L % bx || L % by || (ox != 0 && ox != -1) ||
      (oy != 0 && oy != -1) || !aligned16(U) || !aligned16(phi) ||
      !aligned16(r) || !aligned16(pn) || !aligned16(out))
    return (int)cudaErrorInvalidValue;
  switch (nc) {
    case 1:
      return links_rr_p<T, 1>(U, phi, r, pn, out, B, L, m, r_bs, bx, by, ox,
                              oy, stream);
    case 2:
      return links_rr_p<T, 2>(U, phi, r, pn, out, B, L, m, r_bs, bx, by, ox,
                              oy, stream);
    case 4:
      return links_rr_p<T, 4>(U, phi, r, pn, out, B, L, m, r_bs, bx, by, ox,
                              oy, stream);
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
// batch, and r batched (r_bs = 2 L^2) or shared (0); `paired` (the apply
// and the residual): L even and every operand 16-byte aligned (16-byte
// loads of a pair of sites), else a word a load. The norm reads a word a
// load at any L and alignment, writes out [B] in the real type and needs
// `partial`, the doubles of scratch that *_scratch gives (partial_len, the
// doubles it holds).
int tmg_links_residual_c64(const void* U, const void* phi, const void* r,
                           void* out, int B, int L, double m, long long r_bs,
                           int paired, void* stream) {
  return links_out<float, false>(U, phi, r, out, B, L, m, r_bs, paired,
                                 stream);
}
int tmg_links_residual_c128(const void* U, const void* phi, const void* r,
                            void* out, int B, int L, double m,
                            long long r_bs, int paired, void* stream) {
  return links_out<double, false>(U, phi, r, out, B, L, m, r_bs, paired,
                                  stream);
}

int tmg_links_apply_c64(const void* U, const void* v, void* out, int B,
                        int L, double m, int paired, void* stream) {
  return links_out<float, true>(U, v, nullptr, out, B, L, m, 0, paired,
                                stream);
}
int tmg_links_apply_c128(const void* U, const void* v, void* out, int B,
                         int L, double m, int paired, void* stream) {
  return links_out<double, true>(U, v, nullptr, out, B, L, m, 0, paired,
                                 stream);
}

int tmg_links_residual_norm_c64(const void* U, const void* phi, const void* r,
                                void* partial, void* out, int B, int L,
                                double m, long long r_bs,
                                long long partial_len, void* stream) {
  return links_norm<float>(U, phi, r, partial, out, B, L, m, r_bs,
                           partial_len, stream);
}
int tmg_links_residual_norm_c128(const void* U, const void* phi,
                                 const void* r, void* partial, void* out,
                                 int B, int L, double m, long long r_bs,
                                 long long partial_len, void* stream) {
  return links_norm<double>(U, phi, r, partial, out, B, L, m, r_bs,
                            partial_len, stream);
}

int tmg_links_residual_norm_scratch_c64(int B, int L, long long* n) {
  return links_norm_scratch(B, L, n);
}
int tmg_links_residual_norm_scratch_c128(int B, int L, long long* n) {
  return links_norm_scratch(B, L, n);
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

// B entries in groups of G sharing one D and D0inv (copy b / G, at d_bs
// and dinv_bs a copy; 0: shared), r batched (r_bs = n L^2) or shared (0).
int tmg_dense_update_c64(const void* D, const void* Dinv, const void* phi,
                         const void* r, void* out, void* scratch, int B,
                         int n, int L, int G, long long d_bs,
                         long long dinv_bs, long long r_bs, int rb,
                         int n_sweeps, double omega, int rows, int staged,
                         long long smem, void* stream) {
  return dense_update<float>(D, Dinv, phi, r, out, scratch, B, n, L, G, d_bs,
                             dinv_bs, r_bs, rb, n_sweeps, omega, rows, staged,
                             smem, stream);
}
int tmg_dense_update_c128(const void* D, const void* Dinv, const void* phi,
                          const void* r, void* out, void* scratch, int B,
                          int n, int L, int G, long long d_bs,
                          long long dinv_bs, long long r_bs, int rb,
                          int n_sweeps, double omega, int rows, int staged,
                          long long smem, void* stream) {
  return dense_update<double>(D, Dinv, phi, r, out, scratch, B, n, L, G,
                              d_bs, dinv_bs, r_bs, rb, n_sweeps, omega, rows,
                              staged, smem, stream);
}
// grouped: the kernel of G > 1 (the launches' kernel differs at G = 1).
int tmg_dense_update_occupancy_c64(int n, int grouped, int staged,
                                   long long smem, int* blocks) {
  const void* fn = dense_update_fn<float>(n, staged, grouped);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return occupancy(fn, kDenseThreads, smem, blocks);
}
int tmg_dense_update_occupancy_c128(int n, int grouped, int staged,
                                    long long smem, int* blocks) {
  const void* fn = dense_update_fn<double>(n, staged, grouped);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  return occupancy(fn, kDenseThreads, smem, blocks);
}

// The dense SpMV and residual: B entries in groups of G sharing one D (D's
// copy b / G, at d_bs a copy), v and r batched (v_bs, r_bs = n L^2) or
// shared (0); out [B][n][L][L]. L even, every pointer 16-byte aligned.
int tmg_dense_apply_c64(const void* D, const void* v, void* out, int B,
                        int n, int L, int G, long long d_bs, long long v_bs,
                        void* stream) {
  return dense_apply<float, false>(D, v, nullptr, out, B, n, L, G, d_bs,
                                   v_bs, 0, stream);
}
int tmg_dense_apply_c128(const void* D, const void* v, void* out, int B,
                         int n, int L, int G, long long d_bs, long long v_bs,
                         void* stream) {
  return dense_apply<double, false>(D, v, nullptr, out, B, n, L, G, d_bs,
                                    v_bs, 0, stream);
}
int tmg_dense_residual_c64(const void* D, const void* v, const void* r,
                           void* out, int B, int n, int L, int G,
                           long long d_bs, long long v_bs, long long r_bs,
                           void* stream) {
  return dense_apply<float, true>(D, v, r, out, B, n, L, G, d_bs, v_bs, r_bs,
                                  stream);
}
int tmg_dense_residual_c128(const void* D, const void* v, const void* r,
                            void* out, int B, int n, int L, int G,
                            long long d_bs, long long v_bs, long long r_bs,
                            void* stream) {
  return dense_apply<double, true>(D, v, r, out, B, n, L, G, d_bs, v_bs,
                                   r_bs, stream);
}

// The fused level-0 residual and restriction: U [2][L][L] and phi_null
// [nc][2][L][L] shared by the batch, phi [B][2][L][L], r batched (r_bs =
// 2 L^2) or shared (0); out [B][nc][L/bx][L/by]; (ox, oy) the quadrant's
// offsets (ops/transfer.QUAD_OFFSETS). Every pointer 16-byte aligned.
int tmg_links_residual_restrict_c64(const void* U, const void* phi,
                                    const void* r, const void* pn, void* out,
                                    int B, int nc, int L, double m,
                                    long long r_bs, int bx, int by, int ox,
                                    int oy, void* stream) {
  return links_resid_restrict<float>(U, phi, r, pn, out, B, nc, L, m, r_bs,
                                     bx, by, ox, oy, stream);
}
int tmg_links_residual_restrict_c128(const void* U, const void* phi,
                                     const void* r, const void* pn,
                                     void* out, int B, int nc, int L,
                                     double m, long long r_bs, int bx, int by,
                                     int ox, int oy, void* stream) {
  return links_resid_restrict<double>(U, phi, r, pn, out, B, nc, L, m, r_bs,
                                      bx, by, ox, oy, stream);
}

}  // extern "C"
