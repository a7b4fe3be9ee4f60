// Hand-written Hopper (sm_90a) x-tiled kernels for lattices past the L2.
//
// Ports of the x-tiled Pallas TPU kernels in tpu_multigrid/ops/pallas_stencil.py:
//   links_rb_tiled_kernel<T>       <- _u_update_tile_kernel (B5a, :711; one
//                                     whole red-black sweep a launch)
//   links_tiled_kernel<T, kUpdate> <- _u_update_tile_kernel (B5a, :711;
//                                     one Jacobi sweep a launch)
//   links_tiled_kernel<T, kResid>  <- _u_resid_tile_kernel  (B5b, :703)
//   links_tiled_kernel<T, kApply>  <- _u_apply_tile_kernel  (B5c, :695)
//   dense_rb_tiled_kernel<T, N, GROUPED>
//                                  <- _tiled_update_kernel  (B6, :358; one
//                                     whole red-black sweep a launch)
//   dense_tiled_kernel<T, N, GROUPED>
//                                  <- _tiled_update_kernel  (B6, :358; one
//                                     Jacobi sweep a launch)
//   dense_apply_tiled_kernel<T, N, RESID>
//                                  <- _tiled_apply_kernel   (B7b, :236;
//                                     RESID: r - D v)
// Layouts are stencil.cu's: U[2][L][L], phi/r/v/out[B][n][L][L],
// D[B][5][n][n][L][L], D0inv[B][n][n][L][L], site (x, y) at x*L + y. The
// dense kernels take n in {1, 2, 4} and a batch axis with a stride per
// operand (0: shared by the batch), the entries in groups of G that share
// one copy of D (and D0inv): entry b reads copy b / G; the links kernels a
// batch axis on phi, out and r (r's stride 0: shared), with U shared by the
// batch. The batch entry is blockIdx.z (entry_of for the dense smoothers).
//
// What bounds them on the H100: bytes. At L=2048 the level-0 links set is
// ~270 MB (c64) and level 1's dense D ~670 MB, far past the 50 MB L2, so
// what one launch reads is gone before the next: every word of U, r, phi, D
// and D0inv comes from HBM once per launch. The SpMVs move 5n^2 + 2n words a
// site (B7b: D, v in, out) and 6 (B5c: U, v in, out); their neighbour reads
// of v come from the staged tile, so each word of v crosses HBM once.
//
// Jacobi, residual and apply (links_tiled_kernel, dense_tiled_kernel,
// dense_apply_tiled_kernel): each block of 32 x 8 threads owns a TX x TY
// tile of sites (TX <= 16, TY <= 32). It stages that tile of phi, plus a
// one-site periodic halo in x and y, into shared memory with coalesced row
// loads, and computes every site of the tile from there. A thread owns two
// sites, (x, y) and (x + 8, y); the 32 threads of a warp cover 32
// consecutive y. U and r are read once per site straight into registers
// (U_x at x-1 and U_y at y-1 for the -x and -y hops, wrapped), issued before
// the barrier so that they are in flight together with the staging; D and
// D0inv are read in the update. A tile is clipped to the lattice, so tiles
// need not divide L and a lattice may be smaller than one tile. A first
// version that also staged U, with one load and one store per staged element
// (two integer divisions each), ran the links sweep at L=2048 1.6x slower
// than stencil.cu's global kernel; this one is as fast or faster (PERF.md).
//
// Red-black (links_rb_tiled_kernel, dense_rb_tiled_kernel): one launch is
// one whole sweep, red then black, in one pass over the operands; see the
// note above links_rb_tiled_kernel. dense_rb_tiled_kernel<..., 2> runs two
// whole sweeps in one pass (temporal blocking by a column march; the note
// above dense_rb_march), so a smooth call reads the dense operands once
// every two sweeps; the links sweep still makes one pass a sweep.
//
// Kept simple on purpose: no TMA and no persistent blocks.

#include "cplx.cuh"

namespace {

using tmg::cp_async;
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

// The red-black blocks: threadIdx.x a pair of sites (y, y + 1), threadIdx.y
// an x row; TX rows (rounded up to even, so that warps are whole) by 16
// pairs cover a tile of up to 16 x 32.
constexpr int kPairs = kMaxTY / 2;             // 16
constexpr int kRbThreads = kPairs * kMaxTX;    // 256
// Shared memory one block may ask for on the H100 (227 KB).
constexpr size_t kSmemBlockMax = 232448;

struct Tile {
  int x0, y0;  // origin of the tile on the lattice
  int tx, ty;  // its extent, clipped to the lattice
};

// The tile of this block; G > 1: grid.x runs over (y tile, member of a
// group), the G members of a group side by side (entry_of).
__device__ __forceinline__ Tile tile_of(int TX, int TY, int L, int G = 1) {
  Tile t;
  t.x0 = blockIdx.y * TX;
  t.y0 = (blockIdx.x / G) * TY;
  t.tx = min(TX, L - t.x0);
  t.ty = min(TY, L - t.y0);
  return t;
}

// Batch entry of a dense smoother block: group blockIdx.z, member
// blockIdx.x % G. The G blocks that read one tile of a group's D and D0inv
// are neighbours in the grid, so that they run together and all but the
// first can find the tile's operands in L2 (the TPU kernel, under the JAX
// package's vmap, reads them once per entry). An ensemble's level 0 at
// L=512 (2 configurations of 2 candidates, n=2, G = 2) takes 268.1 us cold
// a rbgs x4 call (4 launches) against a bound of 36.3 us with D read once a
// group, on an H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md).
__device__ __forceinline__ size_t entry_of(int G) {
  return (size_t)blockIdx.z * G + blockIdx.x % G;
}

// Periodic index of i in [-L, 2L).
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

// Stage P planes of src over the tile and a TWO-site periodic halo: site
// (x0 + i, y0 + j), i in [-2, tx + 1] and j in [-2, ty + 1], at
// sm[p * plane + (i + 2) * pitch + j + 2], with cp.async (every copy in
// flight at once; one commit group, which the caller waits for). Warp w of
// the block takes rows w, w + nwarps, ...; lane l columns l and l + 32
// (coalesced rows).
template <typename T, int P>
__device__ __forceinline__ void stage_phi2(cplx<T>* sm, int plane, int pitch,
                                           const cplx<T>* __restrict__ src,
                                           size_t LL, int L, const Tile& t) {
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31;
  const int nwarps = (int)(blockDim.x * blockDim.y) >> 5;
  for (int i = tid >> 5; i < t.tx + 4; i += nwarps) {
    const cplx<T>* row = src + (size_t)wrap(t.x0 - 2 + i, L) * L;
    for (int j = lane; j < t.ty + 4; j += 32) {
      const cplx<T>* g = row + wrap(t.y0 - 2 + j, L);
#pragma unroll
      for (int p = 0; p < P; ++p)
        cp_async(sm + p * plane + i * pitch + j, g + p * LL);
    }
  }
  tmg::cp_async_commit();
}

// ---- the update of one site, shared by the Jacobi and red-black kernels --

// The links operands of one site: U_x and U_y there, U_x at x-1 and U_y at
// y-1 (the -x and -y hops read the neighbour's link), and r's components.
template <typename T>
struct LinkSite {
  cplx<T> ux, uxm, uy, uym, r0, r1;
};

template <typename T>
__device__ __forceinline__ LinkSite<T> link_site(
    const cplx<T>* __restrict__ U, const cplx<T>* __restrict__ r, int L,
    size_t LL, int x, int y) {
  const size_t s = (size_t)x * L + y;
  LinkSite<T> o;
  o.ux = U[s];
  o.uxm = U[(size_t)wrap(x - 1, L) * L + y];
  o.uy = U[LL + s];
  o.uym = U[LL + (size_t)x * L + wrap(y - 1, L)];
  o.r0 = r[s];
  o.r1 = r[LL + s];
  return o;
}

// Links smoother update at the staged site c0 (component 1 at c0 + vpl,
// neighbours at +-vp along x and +-1 along y): (r - hop(phi)) / (2+m),
// relaxed by omega.
template <typename T>
__device__ __forceinline__ void links_relax(const LinkSite<T>& o,
                                            const cplx<T>* c0, int vp,
                                            int vpl, T diag, T omega,
                                            cplx<T> out[2]) {
  const cplx<T>* c1 = c0 + vpl;
  cplx<T> h[2];
  tmg::wilson_hop_core(o.ux, o.uxm, o.uy, o.uym, c0[vp], c1[vp], c0[-vp],
                       c1[-vp], c0[1], c1[1], c0[-1], c1[-1], h[0], h[1]);
  const cplx<T> v[2] = {*c0, *c1};
  const cplx<T> rv[2] = {o.r0, o.r1};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const cplx<T> d = rv[k] - h[k];
    cplx<T> upd = mk<T>(d.re / diag, d.im / diag);
    if (omega != T(1)) upd = v[k] + scale(omega, upd - v[k]);
    out[k] = upd;
  }
}

// Where the dense operands of one site are read: D's hop block (d, p, q),
// d = 0..3 for +x, -x, +y, -y, at hop[((d * N + p) * N + q) * stride];
// D0inv's (p, q) at dinv[(p * N + q) * stride]; r's q at r[q * stride].
// Global memory (stride L^2) or a thread's staged words (stride: threads).
template <typename T>
struct DenseSite {
  const cplx<T>* hop;
  const cplx<T>* dinv;
  const cplx<T>* r;
  size_t stride;
};

// Word w of a site's 5N^2 + N operands: D's hop blocks (w < 4N^2), then
// D0inv's, then r's.
template <typename T, int N>
__device__ __forceinline__ const cplx<T>* word(const DenseSite<T>& o, int w) {
  return w < 4 * N * N ? o.hop + w * o.stride
         : w < 5 * N * N ? o.dinv + (w - 4 * N * N) * o.stride
                         : o.r + (w - 5 * N * N) * o.stride;
}

// The dense operands of one site in registers, in word order.
template <typename T, int N>
struct DenseOps {
  cplx<T> v[5 * N * N + N];
};

template <typename T, int N>
__device__ __forceinline__ DenseOps<T, N> load_ops(const DenseSite<T>& o) {
  DenseOps<T, N> a;
#pragma unroll
  for (int w = 0; w < 5 * N * N + N; ++w) a.v[w] = *word<T, N>(o, w);
  return a;
}

// Dense smoother update at the staged site c (component p at c + p * vpl):
//   upd = -D0inv (sum_{mu != 0} D_mu phi(x + mu) - r), relaxed by omega.
template <typename T, int N>
__device__ __forceinline__ void dense_relax(const DenseOps<T, N>& o,
                                            const cplx<T>* c, int vp,
                                            int vpl, T omega, cplx<T> out[N]) {
  cplx<T> a[N];
#pragma unroll
  for (int p = 0; p < N; ++p) a[p] = mk<T>(T(0), T(0));
#pragma unroll
  for (int d = 0; d < 4; ++d) {  // +x, -x, +y, -y
    const int off = d == 0 ? vp : d == 1 ? -vp : d == 2 ? 1 : -1;
    cplx<T> v[N];
#pragma unroll
    for (int q = 0; q < N; ++q) v[q] = c[q * vpl + off];
#pragma unroll
    for (int p = 0; p < N; ++p)
#pragma unroll
      for (int q = 0; q < N; ++q)
        a[p] = a[p] + o.v[(d * N + p) * N + q] * v[q];
  }
#pragma unroll
  for (int q = 0; q < N; ++q) a[q] = a[q] - o.v[5 * N * N + q];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    cplx<T> acc = mk<T>(T(0), T(0));
#pragma unroll
    for (int q = 0; q < N; ++q) acc = acc + o.v[4 * N * N + p * N + q] * a[q];
    cplx<T> upd = mk<T>(-acc.re, -acc.im);
    const cplx<T> old = c[p * vpl];
    if (omega != T(1)) upd = old + scale(omega, upd - old);
    out[p] = upd;
  }
}

// The global operands of site s of one batch entry.
template <typename T, int N>
__device__ __forceinline__ DenseSite<T> dense_site(const cplx<T>* Db,
                                                   const cplx<T>* Dib,
                                                   const cplx<T>* rb,
                                                   size_t LL, size_t s) {
  return DenseSite<T>{Db + (size_t)N * N * LL + s, Dib + s, rb + s, LL};
}

// ---- Jacobi sweep, residual, apply ----------------------------------------

// What the links kernel writes at a site.
enum LinksMode { kUpdate, kResid, kApply };

// Links-only Wilson on one tile. kResid: out = r - (2+m) phi - hop(phi) at
// every site; kApply: out = (2+m) phi + hop(phi) at every site (r is not
// read); kUpdate: one Jacobi sweep of the smoother, (r - hop(phi)) / (2+m)
// relaxed by omega, into a separate out.
//
// A thread owns sites (x0 + threadIdx.y + 8u, y0 + threadIdx.x), u < 2. It
// loads their links (U_x at x and x-1, U_y at y and y-1) and r into
// registers before the barrier, so those loads are in flight with the
// staging of phi [2][TX+2][TY+2].
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
    links_tiled_kernel(const cplx<T>* __restrict__ U,
                       const cplx<T>* __restrict__ phi,
                       const cplx<T>* __restrict__ r,
                       cplx<T>* __restrict__ out, int L, T diag, T omega,
                       long long r_bstride, int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  phi += b * 2 * LL;
  out += b * 2 * LL;
  if constexpr (MODE != kApply) r += b * (size_t)r_bstride;
  const int vp = TY + 2;
  const int vpl = (TX + 2) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  const int j = threadIdx.x;
  const int y = t.y0 + j;

  bool act[kRows];
  LinkSite<T> o[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    act[u] = i < t.tx && j < t.ty;
    if (act[u]) {
      if constexpr (MODE == kApply) {
        const int x = t.x0 + i;
        const size_t s = (size_t)x * L + y;
        o[u].ux = U[s];
        o[u].uxm = U[(size_t)wrap(x - 1, L) * L + y];
        o[u].uy = U[LL + s];
        o[u].uym = U[LL + (size_t)x * L + wrap(y - 1, L)];
      } else {
        o[u] = link_site(U, r, L, LL, t.x0 + i, y);
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
    const size_t s = (size_t)(t.x0 + i) * L + y;
    cplx<T> w[2];
    if constexpr (MODE == kUpdate) {
      links_relax(o[u], c0, vp, vpl, diag, omega, w);
    } else {
      const cplx<T>* c1 = c0 + vpl;
      cplx<T> h[2];
      tmg::wilson_hop_core(o[u].ux, o[u].uxm, o[u].uy, o[u].uym, c0[vp],
                           c1[vp], c0[-vp], c1[-vp], c0[1], c1[1], c0[-1],
                           c1[-1], h[0], h[1]);
      const cplx<T> v[2] = {*c0, *c1};
      if constexpr (MODE == kResid) {
        w[0] = o[u].r0 - scale(diag, v[0]) - h[0];
        w[1] = o[u].r1 - scale(diag, v[1]) - h[1];
      } else {
        w[0] = scale(diag, v[0]) + h[0];
        w[1] = scale(diag, v[1]) + h[1];
      }
    }
    out[s] = w[0];
    out[LL + s] = w[1];
  }
}

// One Jacobi sweep of the dense 5-point block smoother on one tile of
// batch entry entry_of(G), into a separate out (dense_relax). Sites per
// thread as in links_tiled_kernel; phi [N][TX+2][TY+2] staged. D and D0inv
// (5 n^2 words a site) are read in the update itself, where their loads
// keep enough bytes in flight.
template <typename T, int N, bool GROUPED>
__global__ void __launch_bounds__(kThreads)
    dense_tiled_kernel(const cplx<T>* __restrict__ D,
                       const cplx<T>* __restrict__ Dinv,
                       const cplx<T>* __restrict__ phi,
                       const cplx<T>* __restrict__ r,
                       cplx<T>* __restrict__ out, int L, int G,
                       long long d_bstride, long long dinv_bstride,
                       long long r_bstride, T omega, int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (!GROUPED) G = 1;  // no division by G at G = 1
  const Tile t = tile_of(TX, TY, L, G);
  const size_t LL = (size_t)L * L;
  const size_t b = entry_of(G);
  const cplx<T>* Db = D + blockIdx.z * (size_t)d_bstride;
  const cplx<T>* Dib = Dinv + blockIdx.z * (size_t)dinv_bstride;
  const cplx<T>* rb = r + b * (size_t)r_bstride;
  cplx<T>* ob = out + b * (N * LL);
  const int vp = TY + 2;
  const int vpl = (TX + 2) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  stage_phi<T, N>(sv, vpl, vp, phi + b * (N * LL), LL, L, t);
  __syncthreads();

  const int j = threadIdx.x;
  const int y = t.y0 + j;
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int i = threadIdx.y + u * kThreadsX;
    if (i >= t.tx || j >= t.ty) continue;
    const size_t s = (size_t)(t.x0 + i) * L + y;
    cplx<T> w[N];
    dense_relax<T, N>(load_ops<T, N>(dense_site<T, N>(Db, Dib, rb, LL, s)),
                      sv + (i + 1) * vp + (j + 1), vp, vpl, omega, w);
#pragma unroll
    for (int p = 0; p < N; ++p) ob[p * LL + s] = w[p];
  }
}

// ---- the fused red-black sweep ---------------------------------------------
//
// links_rb_tiled_kernel replaces _u_update_tile_kernel (pallas_stencil.py
// :711) and dense_rb_tiled_kernel _tiled_update_kernel (:358) for
// red-black: the TPU kernels take one colour a call, a shape that suited
// VMEM; here one launch is one whole sweep, red ((x + y) even) then black.
// (The dense one also runs two sweeps a launch, by the column march below,
// where ops/cuda_stencil.rb_plan takes the call: the pass described here
// then runs only an odd count's last sweep. The links sweep has no such
// pass yet.)
//
// What bounds them: bytes. The operators do not fit on chip (n=4 at L=1024:
// D's hop planes, D0inv and r are ~0.7 GB c64, 13x the L2), so each launch
// streams them from HBM. A launch a half-sweep read every operand twice a
// sweep: the colours interleave along y, so every 32-byte sector holds
// sites of both. One pass a sweep reads each once.
//
// The ring and its overlap: a block owns a TX x TY tile (<= 16 x 32) and
// stages src phi over the tile and a two-site periodic halo,
// [P][TX+4][TY+4], in shared memory. Red phase: it updates the red sites of
// the tile AND of its one-site ring from the staged black sites (and the
// site's own old value, for omega != 1), writing the new reds in place in
// shared memory, which is safe because a red update reads only black sites
// and itself. Barrier. Black phase: it updates the tile's black sites from
// the new reds, then writes both colours of the tile (not the ring) to
// dst. A ring red is a neighbour tile's site: its owner computes it from
// the same inputs with the same arithmetic, so both agree bit for bit; its
// operands come from sectors that the neighbour tile reads too, and the
// tiles of a row of y tiles run next to each other in launch order
// (blockIdx.x), so L2 serves most of that overlap (~(TX + TY) / (TX TY) of
// the site reads, ~9% at 16 x 32). Colour is the global (x + y); with
// even L the wrapped and unwrapped parities agree, so a halo that wraps
// onto the tile's own sites (tiles that do not divide L, a tile past the
// lattice) computes the same values twice.
//
// Out of place, never in place: a ring red reads black sites two away from
// the tile, which a neighbouring block writes in the same launch. src is
// read-only for the whole launch and dst must not overlap it; the host
// function refuses an overlap (cudaErrorInvalidValue).
//
// A thread owns one pair of sites (x, y) and (x, y + 1), one of each
// colour; lanes 0-15 of a warp take 16 pairs of one row, 16-31 the next.
// Ring sites go to threads by their place in the ring. Every load of a
// block is in flight before its first barrier: phi by cp.async, the
// operands of the pair (and, in the links kernel, of the ring place) into
// registers or, for the dense black site, shared memory.
//
// Measured (H100 80GB HBM3, 700 W; PERF.md, scripts/torch_smoother_ab.py,
// rbgs x4 complex64, the first design's launch a half-sweep -> this): links
// L=2048 0.801 -> 0.432 ms; dense n=4 L=1024 2.231 -> 1.480 ms (12 x 32
// tiles, ~0.62 of the HBM peak for one pass a sweep), L=512 0.641 ->
// 0.459, L=256 0.217 -> 0.153, n=2 L=2048 k=2 4.972 -> 2.411. A first
// version of this pass, whose staging and red loads waited on each other
// (one load then one store a staged word), took 2.90 ms at n=4 L=1024;
// the black copies issued apart from the red loads (each sector then
// crossed L2 -> SM twice) 1.64 ms. Without __launch_bounds__(256, 1) the
// n=2 call took 3.24 ms (fewer of its operand loads in flight).
//
// -Xptxas -v (no spills; shared memory at the default tiles, rb_tile):
//   links_rb_tiled_kernel   c64  64 registers, c128 127; 2 (TX+4)(TY+4)
//                           words (11.3 KB c64 at 16 x 32)
//   dense_rb_tiled_kernel   c64  n=1 72, n=2 95, n=4 204 registers (G > 1:
//                           76, 95, 255); c128 n=1 80, n=2 150, n=4 254
//                           (81, 146, 252); n (TX+4)(TY+4)
//                           + (5n^2 + n) 16 TX words (n=4 c64 12 x 32:
//                           144 KB, one block an SM; c128 6 x 32: 148.5 KB)

// The tile sites of this thread: (x, y0 + jr) red and (x, y0 + jb) black,
// each present if it lies in the (clipped) tile.
struct RbPair {
  int i, x, jr, jb;
  bool red, black;
};

__device__ __forceinline__ RbPair rb_pair(const Tile& t) {
  RbPair q;
  q.i = threadIdx.y;
  q.x = t.x0 + q.i;
  const int j0 = 2 * threadIdx.x;
  const int k = (q.x + t.y0 + j0) & 1;  // 0: (x, y0 + j0) is red
  q.jr = j0 + k;
  q.jb = j0 + 1 - k;
  q.red = q.i < t.tx && q.jr < t.ty;
  q.black = q.i < t.tx && q.jb < t.ty;
  return q;
}

// Place k of the tile's one-site ring, 2 (tx + ty) + 4 places, in tile
// coordinates: the row above (i = -1) and below (i = tx), j in [-1, ty],
// then the columns left (j = -1) and right (j = ty), i in [0, tx).
__device__ __forceinline__ void ring_place(int k, const Tile& t, int& i,
                                           int& j) {
  const int w = t.ty + 2;
  if (k < 2 * w) {
    i = k < w ? -1 : t.tx;
    j = (k < w ? k : k - w) - 1;
  } else {
    k -= 2 * w;
    i = k < t.tx ? k : k - t.tx;
    j = k < t.tx ? -1 : t.ty;
  }
}

// One red-black sweep of the links smoother (see above). The links and r
// of the pair and of the thread's first ring place are loaded into
// registers before the barrier, in flight with the cp.async staging of phi
// [2][TX+4][TY+4].
template <typename T>
__global__ void __launch_bounds__(kRbThreads)
    links_rb_tiled_kernel(const cplx<T>* __restrict__ U,
                          const cplx<T>* __restrict__ src,
                          const cplx<T>* __restrict__ r,
                          cplx<T>* __restrict__ dst, int L, T diag, T omega,
                          long long r_bstride, int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  src += b * 2 * LL;
  dst += b * 2 * LL;
  r += b * (size_t)r_bstride;
  const int vp = TY + 4;
  const int vpl = (TX + 4) * vp;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  const RbPair q = rb_pair(t);
  stage_phi2<T, 2>(sv, vpl, vp, src, LL, L, t);
  LinkSite<T> red, black;
  if (q.red) red = link_site(U, r, L, LL, q.x, t.y0 + q.jr);
  if (q.black) black = link_site(U, r, L, LL, q.x, t.y0 + q.jb);
  // ring place k = tid + u * nth of this thread: its links and r are read
  // before the barrier too (the first; a block of few threads has more)
  const int nring = 2 * (t.tx + t.ty) + 4;
  int ri = 0, rj = 0;
  bool ring = false;
  LinkSite<T> ro;
  if (tid < nring) {
    ring_place(tid, t, ri, rj);
    ring = !((t.x0 + ri + t.y0 + rj) & 1);
    if (ring)
      ro = link_site(U, r, L, LL, wrap(t.x0 + ri, L), wrap(t.y0 + rj, L));
  }
  tmg::cp_async_wait_group<0>();
  __syncthreads();

  cplx<T> vr[2];
  if (q.red) {
    cplx<T>* c = sv + (q.i + 2) * vp + q.jr + 2;
    links_relax(red, c, vp, vpl, diag, omega, vr);
    c[0] = vr[0];
    c[vpl] = vr[1];
  }
  for (int k = tid; k < nring; k += nth) {
    if (k != tid) {
      ring_place(k, t, ri, rj);
      ring = !((t.x0 + ri + t.y0 + rj) & 1);
      if (ring)
        ro = link_site(U, r, L, LL, wrap(t.x0 + ri, L), wrap(t.y0 + rj, L));
    }
    if (!ring) continue;
    cplx<T>* c = sv + (ri + 2) * vp + rj + 2;
    cplx<T> v[2];
    links_relax(ro, c, vp, vpl, diag, omega, v);
    c[0] = v[0];
    c[vpl] = v[1];
  }
  __syncthreads();

  if (q.black) {
    cplx<T> v[2];
    links_relax(black, sv + (q.i + 2) * vp + q.jb + 2, vp, vpl, diag, omega,
                v);
    const size_t s = (size_t)q.x * L + t.y0 + q.jb;
    dst[s] = v[0];
    dst[LL + s] = v[1];
  }
  if (q.red) {
    const size_t s = (size_t)q.x * L + t.y0 + q.jr;
    dst[s] = vr[0];
    dst[LL + s] = vr[1];
  }
}

// ---- two red-black sweeps a pass: the column march -------------------------
//
// dense_rb_tiled_kernel<T, N, false, 2> runs two whole red-black sweeps of
// the dense smoother in one launch (temporal blocking). A sweep of the
// one-pass kernel streams a site's 5N^2 + N operand words from HBM (84 at
// n=4: D's 64 hop words, D0inv's 16, r's 4) to move 2N words of phi, and the
// operands are the same in every sweep: a pass that runs both sweeps on an
// operand row while it sits in shared memory reads them half as often.
//
// A block owns a strip of W lattice columns, y0 .. y0 + W - 1, over a
// segment of S x rows, xa .. xb - 1 (grid (strips, segments, batch)), and
// marches along x. Its window is the strip and kMarchHalo columns on either
// side, C = W + 8 columns (window column j is lattice column y0 - 4 + j,
// wrapped). At step t it runs four stages, each in place:
//   sweep 1, red sites   of row t      window columns 1 .. C - 2
//   sweep 1, black sites of row t - 2                 2 .. C - 3
//   sweep 2, red sites   of row t - 4                 3 .. C - 4
//   sweep 2, black sites of row t - 6                 4 .. C - 5 (the strip)
// A stage reads the other colour's sites in its row and the rows either
// side, and the site's own old value. Two rows apart, no stage of a step
// reads what another of the same step writes, so the four run together,
// with one barrier a step; and each reads values that the stage before it
// finished in an earlier step and that the stage after it has not yet
// overwritten. So every site takes, in order, the values that two launches
// of the one-pass kernel give it, bit for bit (dense_relax's arithmetic; the
// N components of a site are N lanes, march_relax). Each stage's columns
// are those whose inputs the window holds: the first sweep's reds reach 3
// columns past the strip and read phi 4 past it. The march starts 3 rows
// before the segment and its first sweep ends 3 after it: it reads the
// operands of S + 6 rows, in S + 9 steps, and writes row t - 7 at step t.
//
// Shared memory: the operand words of rows t - 6 .. t + P,
// [7 + P][5N^2 + N][pitch], and phi's rows t - 7 .. t + P + 1 in a ring of
// [16][N][pitch]; rows t + 1 .. t + P are in flight during step t (P =
// kMarchAhead), by cp.async, 16 bytes a copy. The pitch pads C so that the
// word planes of a site's N components fall on different bank halves
// (march_pitch). Out of place like the one-pass kernel; G = 1 and complex64
// only (ops/cuda_stencil.rb_plan chooses the pass from the call's shapes).
//
// Measured (H100 80GB HBM3, 700 W; rbgs x4 n=4 complex64, device time a
// call, the one-pass kernel -> this; scripts/torch_smoother_ab.py): L=1024
// 1361 -> 919 us, L=512 366 -> 248. At L=256, whose operands stay in the
// L2 from one sweep to the next, two one-pass sweeps take 38 us against 44
// for a pass, so rb_plan keeps the one-pass kernel there. A step takes
// ~1.4 us at 24 to 34 window columns, most of it a fixed cost: copies 2 or
// 3 rows ahead, TMA bulk copies of each word plane's row, segments started
// at rows skewed from strip to strip, and rows split by column parity (no
// bank conflicts, twice the copies) were as fast or slower. A first version
// whose copies recomputed their addresses (~240 instructions a 16-byte
// copy) took 4.2 us a step; one whose stages ran one after another on rows
// one apart, a barrier between, 2.9 us.
constexpr int kMarchHalo = 4;
constexpr int kMarchLag = 7;       // rows from a first-sweep red to its store
constexpr int kMarchAhead = 2;     // rows of copies in flight
constexpr int kMarchPhiRows = 16;
constexpr int kMarchOpsRows = kMarchLag + kMarchAhead;
// The most 16-byte copies one of a block's threads makes a step: a row's
// (5N^2 + N + N) C / 2 over kRbThreads threads.
constexpr int kMarchCopies = 12;

// The pitch, in complex words, of a march block's rows of C = W + 8 window
// columns: C padded so that N * pitch = 8 mod 16 (n > 1).
__host__ __device__ __forceinline__ int march_pitch(int N, int W) {
  int pitch = W + 2 * kMarchHalo;
  while (N > 1 && (N * pitch) % 16 != 8) pitch += 2;
  return pitch;
}

// Shared memory of a march block: operand rows and phi rows.
template <typename T, int N>
__host__ __device__ __forceinline__ size_t march_smem(int W) {
  return sizeof(cplx<T>) * march_pitch(N, W) *
         ((size_t)kMarchOpsRows * (5 * N * N + N) + kMarchPhiRows * N);
}

// Component p of dense_relax at one site: o its operand words (word w at
// o[w * ws]), c its phi in its row and xm / xp the same column in the rows
// x - 1 / x + 1 (component q at q * vpl). The site's N components are N
// consecutive lanes (p = lane % N), which exchange their sums
// sum_{mu != 0} D_mu phi(x + mu) - r before the D0inv product; every lane of
// the warp calls it (act: whether this lane has a site), in the order and
// with the operations of dense_relax.
template <typename T, int N>
__device__ __forceinline__ cplx<T> march_relax(const cplx<T>* o, int ws,
                                               const cplx<T>* xm,
                                               const cplx<T>* c,
                                               const cplx<T>* xp, int vpl,
                                               int p, bool act, T omega) {
  cplx<T> a = mk<T>(T(0), T(0));
  if (act) {
#pragma unroll
    for (int d = 0; d < 4; ++d) {  // +x, -x, +y, -y
      const cplx<T>* nb = d == 0 ? xp : d == 1 ? xm : d == 2 ? c + 1 : c - 1;
#pragma unroll
      for (int q = 0; q < N; ++q)
        a = a + o[((d * N + p) * N + q) * ws] * nb[q * vpl];
    }
    a = a - o[(5 * N * N + p) * ws];
  }
  cplx<T> s[N];
#pragma unroll
  for (int q = 0; q < N; ++q)
    s[q] = mk<T>(__shfl_sync(0xffffffffu, a.re, q, N),
                 __shfl_sync(0xffffffffu, a.im, q, N));
  if (!act) return a;
  cplx<T> acc = mk<T>(T(0), T(0));
#pragma unroll
  for (int q = 0; q < N; ++q)
    acc = acc + o[(4 * N * N + p * N + q) * ws] * s[q];
  cplx<T> upd = mk<T>(-acc.re, -acc.im);
  const cplx<T> old = c[p * vpl];
  if (omega != T(1)) upd = old + scale(omega, upd - old);
  return upd;
}

// Periodic index of any i.
__device__ __forceinline__ int wrap_any(int i, int L) {
  while (i < 0) i += L;
  while (i >= L) i -= L;
  return i;
}

// One march block (see above): two red-black sweeps of batch entry
// blockIdx.z, src -> dst, on the strip blockIdx.x (W columns) of the
// segment blockIdx.y (S rows).
template <typename T, int N>
__device__ __forceinline__ void dense_rb_march(
    unsigned char* smem, const cplx<T>* __restrict__ D,
    const cplx<T>* __restrict__ Dinv, const cplx<T>* __restrict__ src,
    const cplx<T>* __restrict__ r, cplx<T>* __restrict__ dst, int L,
    long long d_bstride, long long dinv_bstride, long long r_bstride,
    T omega, int S, int W) {
  constexpr int kW = 5 * N * N + N;
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  const cplx<T>* Db = D + b * (size_t)d_bstride;
  const cplx<T>* Dib = Dinv + b * (size_t)dinv_bstride;
  const cplx<T>* rb = r + b * (size_t)r_bstride;
  const cplx<T>* sb = src + b * (N * LL);
  cplx<T>* ob = dst + b * (N * LL);
  const int y0 = blockIdx.x * W;
  const int w = min(W, L - y0);          // this strip's columns
  const int C = w + 2 * kMarchHalo;      // its window's
  const int half = C / 2;
  const int pitch = march_pitch(N, W);
  const int xa = blockIdx.y * S;
  const int xb = min(xa + S, L);
  const int t0 = xa - 3;                 // the first step, and ops row
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  cplx<T>* so = sv + kMarchPhiRows * N * pitch;
  auto phi_row = [&](int t) {
    return sv + ((t - t0 + 1) & (kMarchPhiRows - 1)) * (N * pitch);
  };
  auto ops_row = [&](int t) {
    return so + ((t - t0) % kMarchOpsRows) * (kW * pitch);
  };

  // A step's copies are the operands' kW word planes and phi's N planes of
  // one row each, window columns 0 .. C - 1 in pairs: (kW + N) * half
  // copies of 16 bytes, the same every step but for the row. This thread's
  // (tid, tid + nth, ...; at most kMarchCopies): the source without the
  // row's offset, the place in its row of shared memory; operands first.
  const cplx<T>* from[kMarchCopies];
  int to[kMarchCopies];
  int nops = 0, ncopy = 0;
#pragma unroll
  for (int m = 0; m < kMarchCopies; ++m) {
    const int i = tid + m * nth;
    if (i < (kW + N) * half) {
      const int k = i / half;
      const int j = 2 * (i - k * half);
      const int y = wrap_any(y0 - kMarchHalo + j, L);
      from[m] = k < kW ? word<T, N>(dense_site<T, N>(Db, Dib, rb, LL, y), k)
                       : sb + (k - kW) * LL + y;
      to[m] = (k < kW ? k : k - kW) * pitch + j;
      nops += k < kW;
      ++ncopy;
    }
  }
  // Copies of phi's row t (phi) or of step t's group, the operands of row
  // t and phi's row t + 1 (none past the last row); one commit group.
  auto fetch = [&](int t, bool phi) {
    if (t < xb + 3) {
      const size_t xo = (size_t)wrap_any(t, L) * L;
      const size_t xp = (size_t)wrap_any(t + 1 - phi, L) * L;
      cplx<T>* ro = ops_row(t);
      cplx<T>* rp = phi_row(t + 1 - phi);
#pragma unroll
      for (int m = 0; m < kMarchCopies; ++m) {
        if (m < ncopy && (m >= nops || !phi)) {
          const bool ops = m < nops;
          tmg::cp_async16((ops ? ro : rp) + to[m], from[m] + (ops ? xo : xp));
        }
      }
    }
    tmg::cp_async_commit();
  };
  // Row t's finished strip, window columns 4 .. 4 + w - 1, to dst.
  auto store = [&](int t) {
    const cplx<T>* f = phi_row(t) + kMarchHalo;
    cplx<T>* o = ob + (size_t)wrap_any(t, L) * L + y0;
#pragma unroll
    for (int q = 0; q < N; ++q)
      for (int j = tid; j < w; j += nth) o[q * LL + j] = f[q * pitch + j];
  };

  fetch(t0 - 1, true);  // phi's rows t0 - 1 and t0
  fetch(t0, true);
  for (int g = 0; g < kMarchAhead; ++g) fetch(t0 + g, false);
  for (int t = t0; t < xb + 6; ++t) {
    // operands of row t, phi of row t + 1 (and the rows before them)
    tmg::cp_async_wait_group<kMarchAhead - 1>();
    __syncthreads();
    if (t - kMarchLag >= xa) store(t - kMarchLag);
    fetch(t + kMarchAhead, false);
    // The four stages of the step (row, first column, where its items
    // end), their sites' components one a lane.
    int row[4], lo[4], end[4];
    int items = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      row[k] = t - 2 * k;
      const bool on = k == 0 ? t < xb + 3
                             : row[k] >= xa - 3 + k && row[k] < xb + 3 - k;
      // the first column of colour k & 1: (x + y) & 1 = (row + y0 + j) & 1
      // (L and y0 - 4 are even)
      const int first = k + 1;
      lo[k] = first + ((k + row[k] + y0 + first) & 1);
      const int hi = C - 1 - k;
      items += on && hi > lo[k] ? (hi - lo[k] + 1) / 2 * N : 0;
      end[k] = items;
    }
    for (int base = 0; base < items; base += nth) {
      const int u = base + tid;
      const bool act = u < items;
      const int k = u < end[0] ? 0 : u < end[1] ? 1 : u < end[2] ? 2 : 3;
      const int v = u - (k == 0 ? 0 : k == 1 ? end[0] : k == 2 ? end[1]
                                                                : end[2]);
      const int rk = k == 0 ? row[0] : k == 1 ? row[1] : k == 2 ? row[2]
                                                                : row[3];
      const int j = (k == 0 ? lo[0] : k == 1 ? lo[1] : k == 2 ? lo[2]
                                                               : lo[3]) +
                    2 * (v / N);
      const int p = v % N;
      cplx<T>* c = phi_row(rk) + j;
      const cplx<T> upd =
          march_relax<T, N>(ops_row(rk) + j, pitch, phi_row(rk - 1) + j, c,
                            phi_row(rk + 1) + j, pitch, p, act, omega);
      if (act) c[p * pitch] = upd;
    }
  }
  __syncthreads();
  store(xb - 1);
}

// One red-black sweep of the dense 5-point block smoother on one tile of
// batch entry entry_of(G) (see above); SWEEPS = 2: two sweeps, by the
// column march (dense_rb_march; GROUPED false). Shared memory: src phi
// [N][TX+4][TY+4], then the black site's operands of every thread,
// [5N^2 + N][threads] (D's 4N^2 hop blocks, D0inv's N^2, r's N), copied
// with cp.async at the start, after phi's copies (two commit groups: the
// red phase waits for phi's only). The red site's operands come from the
// same 32-byte sectors (into registers before the barrier in complex64),
// so each sector crosses HBM once and the black phase reads its operands
// from shared memory; a ring red reads its own from global memory.
template <typename T, int N, bool GROUPED, int SWEEPS = 1>
__global__ void __launch_bounds__(kRbThreads, 1)
    dense_rb_tiled_kernel(const cplx<T>* __restrict__ D,
                          const cplx<T>* __restrict__ Dinv,
                          const cplx<T>* __restrict__ src,
                          const cplx<T>* __restrict__ r,
                          cplx<T>* __restrict__ dst, int L, int G,
                          long long d_bstride, long long dinv_bstride,
                          long long r_bstride, T omega, int TX, int TY) {
  constexpr int kW = 5 * N * N + N;
  extern __shared__ __align__(16) unsigned char smem[];
  if constexpr (SWEEPS == 2) {  // TX: rows a segment, TY: columns a strip
    static_assert(!GROUPED, "the march takes one copy of D an entry");
    dense_rb_march<T, N>(smem, D, Dinv, src, r, dst, L, d_bstride,
                         dinv_bstride, r_bstride, omega, TX, TY);
    return;
  }
  if constexpr (!GROUPED) G = 1;  // no division by G at G = 1
  const Tile t = tile_of(TX, TY, L, G);
  const size_t LL = (size_t)L * L;
  const size_t b = entry_of(G);
  const cplx<T>* Db = D + blockIdx.z * (size_t)d_bstride;
  const cplx<T>* Dib = Dinv + blockIdx.z * (size_t)dinv_bstride;
  const cplx<T>* rb = r + b * (size_t)r_bstride;
  cplx<T>* ob = dst + b * (N * LL);
  const int vp = TY + 4;
  const int vpl = (TX + 4) * vp;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nth = blockDim.x * blockDim.y;
  cplx<T>* sv = reinterpret_cast<cplx<T>*>(smem);
  cplx<T>* so = sv + N * vpl;
  const RbPair q = rb_pair(t);
  stage_phi2<T, N>(sv, vpl, vp, src + b * (N * LL), LL, L, t);
  // complex64: each word of the black site is copied right beside the
  // load of the red site's same word, which lies in the same 32-byte
  // sector (the pair is (y, y+1)), so that L1 serves the second request
  // and each sector crosses from L2 once; the red words stay in registers,
  // in flight with the copies. complex128 (whose 5n^2 + n words would not
  // fit the registers as well) reads the red words after the barrier.
  constexpr bool kEarly = sizeof(T) == 4;
  const DenseSite<T> rg = dense_site<T, N>(Db, Dib, rb, LL,
                                           (size_t)q.x * L + t.y0 + q.jr);
  const DenseSite<T> bg = dense_site<T, N>(Db, Dib, rb, LL,
                                           (size_t)q.x * L + t.y0 + q.jb);
  DenseOps<T, N> ro;
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    if (q.black) cp_async(so + w * nth + tid, word<T, N>(bg, w));
    if constexpr (kEarly) {
      if (q.red) ro.v[w] = *word<T, N>(rg, w);
    }
  }
  tmg::cp_async_commit();
  tmg::cp_async_wait_group<1>();  // phi is staged
  __syncthreads();

  cplx<T> vr[N];
  if (q.red) {
    if constexpr (!kEarly) ro = load_ops<T, N>(rg);
    cplx<T>* c = sv + (q.i + 2) * vp + q.jr + 2;
    dense_relax<T, N>(ro, c, vp, vpl, omega, vr);
#pragma unroll
    for (int p = 0; p < N; ++p) c[p * vpl] = vr[p];
  }
  for (int k = tid; k < 2 * (t.tx + t.ty) + 4; k += nth) {
    int i, j;
    ring_place(k, t, i, j);
    if ((t.x0 + i + t.y0 + j) & 1) continue;
    cplx<T>* c = sv + (i + 2) * vp + j + 2;
    const size_t s = (size_t)wrap(t.x0 + i, L) * L + wrap(t.y0 + j, L);
    cplx<T> v[N];
    dense_relax<T, N>(load_ops<T, N>(dense_site<T, N>(Db, Dib, rb, LL, s)),
                      c, vp, vpl, omega, v);
#pragma unroll
    for (int p = 0; p < N; ++p) c[p * vpl] = v[p];
  }
  tmg::cp_async_wait_group<0>();  // the black sites' operands are staged
  __syncthreads();

  if (q.black) {
    cplx<T> v[N];
    const DenseSite<T> o{so + tid, so + 4 * N * N * nth + tid,
                         so + 5 * N * N * nth + tid, (size_t)nth};
    dense_relax<T, N>(load_ops<T, N>(o), sv + (q.i + 2) * vp + q.jb + 2, vp,
                      vpl, omega, v);
    const size_t s = (size_t)q.x * L + t.y0 + q.jb;
#pragma unroll
    for (int p = 0; p < N; ++p) ob[p * LL + s] = v[p];
  }
  if (q.red) {
    const size_t s = (size_t)q.x * L + t.y0 + q.jr;
#pragma unroll
    for (int p = 0; p < N; ++p) ob[p * LL + s] = vr[p];
  }
}

// ---- SpMV ------------------------------------------------------------------

// Dense 5-point block SpMV on one tile of batch entry b = blockIdx.z (B7b):
//   APPLY: out[b] = D[b / G] v[b];  RESID: out[b] = r[b] - D[b / G] v[b]
// (D v)(x) = sum_{mu = 0..4} D_mu v(x + mu), the entries in groups of G that
// share one D (stencil.cu's dense_apply_kernel). Sites per thread as in
// links_tiled_kernel; v [N][TX+2][TY+2] staged with its periodic halo (every
// neighbour is read, not one colour's), D (and r) read once per site
// straight from global memory. v and r each shared by the batch (stride 0)
// or batched; out is batched and must not alias v.
template <typename T, int N, bool RESID>
__global__ void __launch_bounds__(kThreads)
    dense_apply_tiled_kernel(const cplx<T>* __restrict__ D,
                             const cplx<T>* __restrict__ v,
                             const cplx<T>* __restrict__ r,
                             cplx<T>* __restrict__ out, int L, int G,
                             long long d_bstride, long long v_bstride,
                             long long r_bstride, int TX, int TY) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile t = tile_of(TX, TY, L);
  const size_t LL = (size_t)L * L;
  const size_t b = blockIdx.z;
  const cplx<T>* Db = D + (b / G) * (size_t)d_bstride;
  const cplx<T>* rb = r + b * (size_t)r_bstride;
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
    for (int p = 0; p < N; ++p)
      ob[p * LL + s] = RESID ? rb[p * LL + s] - a[p] : a[p];
  }
}

// ---- host side -------------------------------------------------------------

// Grid over (y tiles, x tiles, batch), or cudaErrorInvalidValue for a tile
// or batch the kernels do not take; G > 1 (the dense smoothers): over
// (y tiles x G members, x tiles, B / G groups).
inline int grid_of(int L, int TX, int TY, int B, dim3& grid, int G = 1) {
  if (L < 1 || TX < 1 || TX > kMaxTX || TY < 1 || TY > kMaxTY || B < 1 ||
      G < 1 || B % G || B / G > 65535 || (L + TX - 1) / TX > 65535)
    return (int)cudaErrorInvalidValue;
  grid = dim3((unsigned)((L + TY - 1) / TY * G),
              (unsigned)((L + TX - 1) / TX), (unsigned)(B / G));
  return 0;
}

// A smoother sweep reads src while other blocks write out: the two byte
// ranges of `bytes` each must not overlap.
inline bool overlap(const void* a, const void* b, size_t bytes) {
  const char* x = static_cast<const char*>(a);
  const char* y = static_cast<const char*>(b);
  return x < y + bytes && y < x + bytes;
}

// Launch a kernel with `smem` bytes of dynamic shared memory, opting in
// above the 48 KB default; the error of the launch, or of the opt-in.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, dim3 block, size_t smem, void* stream,
           Args... args) {
  if (smem > kSmemBlockMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, block, smem, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// The red-black blocks: 16 pairs by TX rows rounded up to even.
inline dim3 rb_block(int TX) { return dim3(kPairs, TX + (TX & 1)); }

template <typename T, int MODE>
int links_tiled(const void* U, const void* phi, const void* r, void* out,
                int B, int L, double m, double omega, long long r_bs, int TX,
                int TY, void* stream) {
  const size_t smem = sizeof(cplx<T>) * 2 * (size_t)(TX + 2) * (TY + 2);
  dim3 grid;
  const int err = grid_of(L, TX, TY, B, grid);
  if (err) return err;
  return launch(links_tiled_kernel<T, MODE>, grid, dim3(kThreadsY, kThreadsX),
                smem, stream, (const cplx<T>*)U, (const cplx<T>*)phi,
                (const cplx<T>*)r, (cplx<T>*)out, L, T(2.0 + m), T(omega),
                r_bs, TX, TY);
}

// One smoother sweep of a batch: a whole red-black sweep (rb) or a Jacobi
// sweep, from phi into out, which must not overlap it.
template <typename T>
int links_update(const void* U, const void* phi, const void* r, void* out,
                 int B, int L, double m, double omega, int rb, long long r_bs,
                 int TX, int TY, void* stream) {
  if (B < 1 ||
      overlap(phi, out, sizeof(cplx<T>) * 2 * (size_t)B * L * L) ||
      (rb && L % 2))
    return (int)cudaErrorInvalidValue;
  if (!rb)
    return links_tiled<T, kUpdate>(U, phi, r, out, B, L, m, omega, r_bs, TX,
                                   TY, stream);
  dim3 grid;
  const int err = grid_of(L, TX, TY, B, grid);
  if (err) return err;
  const size_t smem = sizeof(cplx<T>) * 2 * (size_t)(TX + 4) * (TY + 4);
  return launch(links_rb_tiled_kernel<T>, grid, rb_block(TX), smem, stream,
                (const cplx<T>*)U, (const cplx<T>*)phi, (const cplx<T>*)r,
                (cplx<T>*)out, L, T(2.0 + m), T(omega), r_bs, TX, TY);
}

template <typename T, int N>
int dense_update_n(const void* D, const void* Dinv, const void* phi,
                   const void* r, void* out, int B, int L, int G,
                   long long d_bs, long long dinv_bs, long long r_bs, int rb,
                   double omega, int TX, int TY, void* stream) {
  if (overlap(phi, out, sizeof(cplx<T>) * (size_t)B * N * L * L) ||
      (rb && L % 2) || rb < 0 || rb > 2)
    return (int)cudaErrorInvalidValue;
  dim3 grid;
  const auto run = [&](auto kernel, dim3 block, size_t smem) {
    return launch(kernel, grid, block, smem, stream, (const cplx<T>*)D,
                  (const cplx<T>*)Dinv, (const cplx<T>*)phi,
                  (const cplx<T>*)r, (cplx<T>*)out, L, G, d_bs, dinv_bs,
                  r_bs, T(omega), TX, TY);
  };
  if (rb == 2) {  // two sweeps a pass: TX rows a segment, TY columns a strip
    if constexpr (sizeof(T) == 4) {
      const auto aligned = [](const void* p) {
        return reinterpret_cast<size_t>(p) % 16 == 0;
      };
      if (G != 1 || TX < 1 || TX > L || TY < 2 || TY > L || TY % 2 ||
          (5 * N * N + 2 * N) * (TY / 2 + kMarchHalo) >
              kMarchCopies * kRbThreads ||
          B > 65535 || !aligned(D) || !aligned(Dinv) || !aligned(phi) ||
          !aligned(r) || !aligned(out))
        return (int)cudaErrorInvalidValue;
      grid = dim3((unsigned)((L + TY - 1) / TY), (unsigned)((L + TX - 1) / TX),
                  (unsigned)B);
      const size_t smem = march_smem<T, N>(TY);
      return run(dense_rb_tiled_kernel<T, N, false, 2>,
                 dim3(kThreadsY, kThreadsX), smem);
    } else {
      return (int)cudaErrorInvalidValue;  // complex64 only
    }
  }
  const int err = grid_of(L, TX, TY, B, grid, G);
  if (err) return err;
  const dim3 block = rb_block(TX);
  const size_t jacobi = sizeof(cplx<T>) * N * (size_t)(TX + 2) * (TY + 2);
  const size_t red_black =
      sizeof(cplx<T>) * ((size_t)N * (TX + 4) * (TY + 4) +
                         (size_t)(5 * N * N + N) * block.x * block.y);
  const dim3 threads(kThreadsY, kThreadsX);
  if (G > 1)
    return rb ? run(dense_rb_tiled_kernel<T, N, true>, block, red_black)
              : run(dense_tiled_kernel<T, N, true>, threads, jacobi);
  return rb ? run(dense_rb_tiled_kernel<T, N, false>, block, red_black)
            : run(dense_tiled_kernel<T, N, false>, threads, jacobi);
}

template <typename T>
int dense_update(const void* D, const void* Dinv, const void* phi,
                 const void* r, void* out, int B, int n, int L, int G,
                 long long d_bs, long long dinv_bs, long long r_bs, int rb,
                 double omega, int TX, int TY, void* stream) {
  switch (n) {
    case 1:
      return dense_update_n<T, 1>(D, Dinv, phi, r, out, B, L, G, d_bs,
                                  dinv_bs, r_bs, rb, omega, TX, TY, stream);
    case 2:
      return dense_update_n<T, 2>(D, Dinv, phi, r, out, B, L, G, d_bs,
                                  dinv_bs, r_bs, rb, omega, TX, TY, stream);
    case 4:
      return dense_update_n<T, 4>(D, Dinv, phi, r, out, B, L, G, d_bs,
                                  dinv_bs, r_bs, rb, omega, TX, TY, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T, int N, bool RESID>
int dense_apply_tiled_n(const void* D, const void* v, const void* r,
                        void* out, int B, int L, int G, long long d_bs,
                        long long v_bs, long long r_bs, int TX, int TY,
                        void* stream) {
  const size_t smem = sizeof(cplx<T>) * N * (size_t)(TX + 2) * (TY + 2);
  dim3 grid;
  const int err = grid_of(L, TX, TY, B, grid);
  if (err) return err;
  return launch(dense_apply_tiled_kernel<T, N, RESID>, grid,
                dim3(kThreadsY, kThreadsX), smem, stream, (const cplx<T>*)D,
                (const cplx<T>*)v, (const cplx<T>*)r, (cplx<T>*)out, L, G,
                d_bs, v_bs, r_bs, TX, TY);
}

// The dense SpMV (RESID false) or residual of B entries in groups of G
// sharing one D (B % G == 0).
template <typename T, bool RESID>
int dense_apply_tiled(const void* D, const void* v, const void* r, void* out,
                      int B, int n, int L, int G, long long d_bs,
                      long long v_bs, long long r_bs, int TX, int TY,
                      void* stream) {
  if (G < 1 || B % G || (RESID && r == nullptr))
    return (int)cudaErrorInvalidValue;
  switch (n) {
    case 1:
      return dense_apply_tiled_n<T, 1, RESID>(D, v, r, out, B, L, G, d_bs,
                                              v_bs, r_bs, TX, TY, stream);
    case 2:
      return dense_apply_tiled_n<T, 2, RESID>(D, v, r, out, B, L, G, d_bs,
                                              v_bs, r_bs, TX, TY, stream);
    case 4:
      return dense_apply_tiled_n<T, 4, RESID>(D, v, r, out, B, L, G, d_bs,
                                              v_bs, r_bs, TX, TY, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C interface, loaded with ctypes (ops/cuda_stencil.py). Each entry
// launches on the given stream, does not synchronise, allocates nothing and
// returns the CUDA error of its launch (cudaErrorInvalidValue for a tile or
// a shared-memory size the kernel does not take, an odd lattice for a
// red-black sweep, or a smoother's out overlapping its phi).
extern "C" {

// The links entries: phi, out [B][2][L][L], U [2][L][L] shared by the
// batch, r batched (r_bs = 2 L^2) or shared (0).
int tmg_links_residual_tiled_c64(const void* U, const void* phi,
                                 const void* r, void* out, int B, int L,
                                 double m, long long r_bs, int TX, int TY,
                                 void* stream) {
  return links_tiled<float, kResid>(U, phi, r, out, B, L, m, 1.0, r_bs, TX,
                                    TY, stream);
}
int tmg_links_residual_tiled_c128(const void* U, const void* phi,
                                  const void* r, void* out, int B, int L,
                                  double m, long long r_bs, int TX, int TY,
                                  void* stream) {
  return links_tiled<double, kResid>(U, phi, r, out, B, L, m, 1.0, r_bs, TX,
                                     TY, stream);
}

// rb = 1: one whole red-black sweep; rb = 0: one Jacobi sweep.
int tmg_links_update_tiled_c64(const void* U, const void* phi, const void* r,
                               void* out, int B, int L, double m,
                               double omega, int rb, long long r_bs, int TX,
                               int TY, void* stream) {
  return links_update<float>(U, phi, r, out, B, L, m, omega, rb, r_bs, TX,
                             TY, stream);
}
int tmg_links_update_tiled_c128(const void* U, const void* phi, const void* r,
                                void* out, int B, int L, double m,
                                double omega, int rb, long long r_bs, int TX,
                                int TY, void* stream) {
  return links_update<double>(U, phi, r, out, B, L, m, omega, rb, r_bs, TX,
                              TY, stream);
}

// The dense smoother sweep: B entries in groups of G sharing one D and
// D0inv (copy b / G, at d_bs and dinv_bs a copy; 0: shared), r batched or
// shared. rb = 0: one Jacobi sweep, 1: one red-black sweep on TX x TY
// tiles; 2 (complex64, G = 1, every pointer 16-byte aligned): two red-black
// sweeps in one pass, the column march on strips of TY (even) columns and
// segments of TX rows.
int tmg_dense_update_tiled_c64(const void* D, const void* Dinv,
                               const void* phi, const void* r, void* out,
                               int B, int n, int L, int G, long long d_bs,
                               long long dinv_bs, long long r_bs, int rb,
                               double omega, int TX, int TY, void* stream) {
  return dense_update<float>(D, Dinv, phi, r, out, B, n, L, G, d_bs, dinv_bs,
                             r_bs, rb, omega, TX, TY, stream);
}
int tmg_dense_update_tiled_c128(const void* D, const void* Dinv,
                                const void* phi, const void* r, void* out,
                                int B, int n, int L, int G, long long d_bs,
                                long long dinv_bs, long long r_bs, int rb,
                                double omega, int TX, int TY, void* stream) {
  return dense_update<double>(D, Dinv, phi, r, out, B, n, L, G, d_bs,
                              dinv_bs, r_bs, rb, omega, TX, TY, stream);
}

int tmg_links_apply_tiled_c64(const void* U, const void* v, void* out, int B,
                              int L, double m, int TX, int TY, void* stream) {
  return links_tiled<float, kApply>(U, v, nullptr, out, B, L, m, 1.0, 0, TX,
                                    TY, stream);
}
int tmg_links_apply_tiled_c128(const void* U, const void* v, void* out,
                               int B, int L, double m, int TX, int TY,
                               void* stream) {
  return links_tiled<double, kApply>(U, v, nullptr, out, B, L, m, 1.0, 0, TX,
                                     TY, stream);
}

// The dense SpMV and residual: B entries in groups of G sharing one D (D's
// copy b / G, at d_bs a copy), v and r batched or shared (stride 0).
int tmg_dense_apply_tiled_c64(const void* D, const void* v, void* out, int B,
                              int n, int L, int G, long long d_bs,
                              long long v_bs, int TX, int TY, void* stream) {
  return dense_apply_tiled<float, false>(D, v, nullptr, out, B, n, L, G, d_bs,
                                         v_bs, 0, TX, TY, stream);
}
int tmg_dense_apply_tiled_c128(const void* D, const void* v, void* out,
                               int B, int n, int L, int G, long long d_bs,
                               long long v_bs, int TX, int TY, void* stream) {
  return dense_apply_tiled<double, false>(D, v, nullptr, out, B, n, L, G,
                                          d_bs, v_bs, 0, TX, TY, stream);
}
int tmg_dense_residual_tiled_c64(const void* D, const void* v, const void* r,
                                 void* out, int B, int n, int L, int G,
                                 long long d_bs, long long v_bs,
                                 long long r_bs, int TX, int TY,
                                 void* stream) {
  return dense_apply_tiled<float, true>(D, v, r, out, B, n, L, G, d_bs, v_bs,
                                        r_bs, TX, TY, stream);
}
int tmg_dense_residual_tiled_c128(const void* D, const void* v,
                                  const void* r, void* out, int B, int n,
                                  int L, int G, long long d_bs,
                                  long long v_bs, long long r_bs, int TX,
                                  int TY, void* stream) {
  return dense_apply_tiled<double, true>(D, v, r, out, B, n, L, G, d_bs, v_bs,
                                         r_bs, TX, TY, stream);
}

}  // extern "C"
