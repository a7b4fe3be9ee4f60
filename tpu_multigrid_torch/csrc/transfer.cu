// Hand-written Hopper (sm_90a) kernels of the cycle's transfers: the
// aggregation restriction P and prolongation P^dagger with the near-null
// rows phi_null, read where they lie.
//
//   transfer_restrict_kernel<T, PAIRED>
//       vc[e][c][X][Y] = sum_{f, a, b} phi[e][c][f][s] v[e][f][s]
//   transfer_prolong_kernel<T>
//       out[e][f][s] = base[e][f][s] + sum_c conj(phi[e][c][f][s]) vc[e][c][X][Y]
//
// with s = (bx X + a + ox, by Y + b + oy) mod L: the fine sites of coarse
// site (X, Y) in the blocking quadrant's frame, (ox, oy) its offset
// (transfer.QUAD_OFFSETS, each 0 or -1). They replace no TPU kernel: the
// JAX package leaves restrict and prolong to XLA (tpu_multigrid/ops/
// transfer.py, an einsum over a rolled, blocked phi_null). On the card the
// plain version (ops/transfer.restrict_plain, prolong_plain: an einsum
// over the rolled, permuted blocks) copied phi_null into the block frame
// and ran a batched gemv of Lc^2 4 x 8 products a call; here the quadrant
// is index arithmetic, nothing is copied, and no intermediate is written.
//
// Layouts are the JAX package's, row-major, each entry contiguous:
//   phi[nc][nf][Lx][Ly], v/out (restrict: v)[nf][Lx][Ly],
//   vc[nc][Lx/bx][Ly/by], base/out (prolong)[nf][Lx][Ly].
// Entry e = blockIdx.z of E NQ entries, e = o NQ + q: o an index of the
// outer batch axis (a field of a batch, a hierarchy of an ensemble) and q
// an NTL copy (NQ = 1 outside the NTL copies). Each operand is found at
// o * so + q * sq with strides (so, sq) of its own, 0 where it is shared
// (phi_null by a batch of fields; the fine residual by the copies). Copy q
// takes the offsets bit q of ox_mask and oy_mask give (-1 where set): the
// NTL copies, one a quadrant, in one launch each way. Outputs and base are
// contiguous [E][NQ][...].
//
// What bounds them on the H100: bytes. Restriction reads phi (nc nf words
// a fine site) and v (nf) once and writes nc / (bx by) words; prolongation
// reads phi, base (nf) and vc (nc / (bx by)) and writes nf. At level 0 of
// L=2048 (nc = 4, nf = 2, 2 x 2 blocks, c64) phi_null is 268 MB: a restrict
// moves 369 MB (110 us at 3.35 TB/s), a prolong with base 436 MB (130 us).
//
// Design. Restriction: one thread owns a coarse site and produces its nc
// rows (four at a time, in registers: nc > 4 rereads v from L1 once per
// four rows), summing over (f, a, b) in that order, four steps' loads in
// flight (the coarse levels' launches have few threads); a warp spans 32
// consecutive Y, so its reads of a (c, f, a) row are one run of 32 by
// fine sites. PAIRED (complex64, oy = 0, by and Ly even, 16-byte aligned
// operands): the words b, b + 1 of a row come in one 16-byte load, and a
// warp's load covers 512 contiguous bytes. Prolongation: one thread a fine
// site (a warp 32 consecutive y: every load and store coalesced), which
// reads its nc coarse words (shared by the by x bx threads of a block: L1
// hits) and forms each f in registers, conjugating phi there. Sums run in
// the fields' own type, as the einsum's.

#include "cplx.cuh"

namespace {

using tmg::conj_mul;
using tmg::cplx;
using tmg::mk;

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
__device__ __forceinline__ cplx<T> ld(const cplx<T>* p) {
  const auto v = __ldg(reinterpret_cast<const typename Vec2<T>::type*>(p));
  return mk<T>(v.x, v.y);
}

// Words y and y + 1 of a row: one 16-byte load where PAIRED (complex64,
// y even, the row 16-byte aligned), else two.
template <typename T, bool PAIRED>
__device__ __forceinline__ void ld2(const cplx<T>* p, cplx<T> out[2]) {
  if constexpr (PAIRED && sizeof(T) == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    out[0] = mk<T>(q.x, q.y);
    out[1] = mk<T>(q.z, q.w);
  } else {
    out[0] = ld(p);
    out[1] = ld(p + 1);
  }
}

// The lattice index i wrapped into [0, L): a quadrant offset reaches -1.
__device__ __forceinline__ int wrap_low(int i, int L) {
  return i < 0 ? i + L : i;
}

constexpr int kRows = 4;  // coarse rows a thread sums at a time

template <typename T, bool PAIRED>
__global__ void __launch_bounds__(128)
    transfer_restrict_kernel(const cplx<T>* __restrict__ phi,
                             const cplx<T>* __restrict__ v,
                             cplx<T>* __restrict__ out, int NQ, int nc,
                             int nf, int Lx, int Ly, int bx, int by,
                             int ox_mask, int oy_mask, long long phi_so,
                             long long phi_sq, long long v_so,
                             long long v_sq) {
  const int Lcx = Lx / bx, Lcy = Ly / by;
  const int Y = blockIdx.x * 32 + threadIdx.x;
  const int X = blockIdx.y * blockDim.y + threadIdx.y;
  if (X >= Lcx || Y >= Lcy) return;
  const int e = blockIdx.z, o = e / NQ, q = e % NQ;
  const int ox = -((ox_mask >> q) & 1), oy = -((oy_mask >> q) & 1);
  const size_t LL = (size_t)Lx * Ly, LLc = (size_t)Lcx * Lcy;
  phi += o * phi_so + q * phi_sq;
  v += o * v_so + q * v_sq;
  cplx<T>* const ob = out + (size_t)e * nc * LLc + (size_t)X * Lcy + Y;
  const int x0 = bx * X + ox, y0 = by * Y + oy;

  // one step a (f, a, pair of b) (PAIRED) or a (f, a, b), b fastest; the
  // steps unrolled by four, so that four steps' loads are in flight (at
  // the coarse levels a launch has too few threads to hide a load's
  // latency otherwise)
  const int per_row = PAIRED ? by / 2 : by, steps = nf * bx * per_row;
  for (int c0 = 0; c0 < nc; c0 += kRows) {
    cplx<T> acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc[k] = mk<T>(T(0), T(0));
#pragma unroll 4
    for (int t = 0; t < steps; ++t) {
      const int fa = t / per_row, b = (t - fa * per_row) * (PAIRED ? 2 : 1);
      const int f = fa / bx, a = fa - f * bx;
      const size_t row = (size_t)f * LL + (size_t)wrap_low(x0 + a, Lx) * Ly;
      if constexpr (PAIRED) {
        // oy = 0: the block's columns y0 .. y0 + by - 1, by even
        cplx<T> vv[2];
        ld2<T, true>(v + row + y0 + b, vv);
#pragma unroll
        for (int k = 0; k < kRows; ++k) {
          if (c0 + k < nc) {
            cplx<T> pp[2];
            ld2<T, true>(phi + (size_t)(c0 + k) * nf * LL + row + y0 + b, pp);
            acc[k] = acc[k] + pp[0] * vv[0] + pp[1] * vv[1];
          }
        }
      } else {
        const size_t s = row + wrap_low(y0 + b, Ly);
        const cplx<T> vv = ld(v + s);
#pragma unroll
        for (int k = 0; k < kRows; ++k)
          if (c0 + k < nc)
            acc[k] = acc[k] + ld(phi + (size_t)(c0 + k) * nf * LL + s) * vv;
      }
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (c0 + k < nc) ob[(size_t)(c0 + k) * LLc] = acc[k];
  }
}

template <typename T>
__global__ void __launch_bounds__(128)
    transfer_prolong_kernel(const cplx<T>* __restrict__ phi,
                            const cplx<T>* __restrict__ vc,
                            const cplx<T>* __restrict__ base,
                            cplx<T>* __restrict__ out, int NQ, int nc,
                            int nf, int Lx, int Ly, int bx, int by,
                            int ox_mask, int oy_mask, long long phi_so,
                            long long phi_sq, long long vc_so,
                            long long vc_sq) {
  const int y = blockIdx.x * 32 + threadIdx.x;
  const int x = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= Lx || y >= Ly) return;
  const int e = blockIdx.z, o = e / NQ, q = e % NQ;
  const int ox = -((ox_mask >> q) & 1), oy = -((oy_mask >> q) & 1);
  const int Lcx = Lx / bx, Lcy = Ly / by;
  const size_t LL = (size_t)Lx * Ly, LLc = (size_t)Lcx * Lcy;
  // the site's place in the quadrant's frame, x - ox (mod L), and its block
  const int i = x - ox == Lx ? 0 : x - ox, j = y - oy == Ly ? 0 : y - oy;
  const size_t s = (size_t)x * Ly + y;
  phi += o * phi_so + q * phi_sq;
  vc += o * vc_so + q * vc_sq + (size_t)(i / bx) * Lcy + j / by;
  const size_t eo = (size_t)e * nf * LL + s;

  for (int f0 = 0; f0 < nf; f0 += kRows) {
    cplx<T> acc[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      acc[k] = (base != nullptr && f0 + k < nf)
                   ? ld(base + eo + (size_t)(f0 + k) * LL)
                   : mk<T>(T(0), T(0));
#pragma unroll 4
    for (int c = 0; c < nc; ++c) {
      const cplx<T> w = ld(vc + (size_t)c * LLc);
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (f0 + k < nf)
          acc[k] = acc[k] +
                   conj_mul(ld(phi + ((size_t)c * nf + f0 + k) * LL + s), w);
    }
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if (f0 + k < nf) out[eo + (size_t)(f0 + k) * LL] = acc[k];
  }
}

inline bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<size_t>(p) & 15) == 0;
}

// Checks shared by both entries: E NQ entries in grid z, the blocks divide
// the lattice, and the masks name only the NQ copies.
inline bool dims_ok(int E, int NQ, int nc, int nf, int Lx, int Ly, int bx,
                    int by, int ox_mask, int oy_mask) {
  return E >= 1 && NQ >= 1 && NQ <= 30 && (long long)E * NQ <= 65535 &&
         nc >= 1 && nf >= 1 && bx >= 1 && by >= 1 && Lx >= bx && Ly >= by &&
         Lx % bx == 0 && Ly % by == 0 && (ox_mask >> NQ) == 0 &&
         (oy_mask >> NQ) == 0 && ox_mask >= 0 && oy_mask >= 0;
}

template <typename T>
int restrict_launch(const void* phi, const void* v, void* out, int E, int NQ,
                    int nc, int nf, int Lx, int Ly, int bx, int by,
                    int ox_mask, int oy_mask, long long phi_so,
                    long long phi_sq, long long v_so, long long v_sq,
                    int paired, void* stream) {
  if (!dims_ok(E, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask))
    return (int)cudaErrorInvalidValue;
  const int Lcx = Lx / bx, Lcy = Ly / by;
  const dim3 block(32, 4);
  const dim3 grid((unsigned)((Lcy + 31) / 32), (unsigned)((Lcx + 3) / 4),
                  (unsigned)(E * NQ));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const cplx<T>* p = (const cplx<T>*)phi;
  const cplx<T>* vv = (const cplx<T>*)v;
  cplx<T>* o = (cplx<T>*)out;
  if (paired) {
    // every row start and pair even: checked here as well as by the caller
    if (oy_mask || by % 2 || Ly % 2 || !aligned16(phi) || !aligned16(v) ||
        (phi_so | phi_sq | v_so | v_sq) & 1)
      return (int)cudaErrorInvalidValue;
    transfer_restrict_kernel<T, true><<<grid, block, 0,
                                        (cudaStream_t)stream>>>(
        p, vv, o, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask, phi_so,
        phi_sq, v_so, v_sq);
  } else {
    transfer_restrict_kernel<T, false><<<grid, block, 0,
                                         (cudaStream_t)stream>>>(
        p, vv, o, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask, phi_so,
        phi_sq, v_so, v_sq);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int prolong_launch(const void* phi, const void* vc, const void* base,
                   void* out, int E, int NQ, int nc, int nf, int Lx, int Ly,
                   int bx, int by, int ox_mask, int oy_mask, long long phi_so,
                   long long phi_sq, long long vc_so, long long vc_sq,
                   void* stream) {
  if (!dims_ok(E, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask))
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 4);
  const dim3 grid((unsigned)((Ly + 31) / 32), (unsigned)((Lx + 3) / 4),
                  (unsigned)(E * NQ));
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  transfer_prolong_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const cplx<T>*)phi, (const cplx<T>*)vc, (const cplx<T>*)base,
      (cplx<T>*)out, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask, phi_so,
      phi_sq, vc_so, vc_sq);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// restrict: phi [E][NQ] entries of [nc][nf][Lx][Ly] at o * phi_so + q *
// phi_sq, v entries of [nf][Lx][Ly] at o * v_so + q * v_sq, out [E][NQ][nc]
// [Lx / bx][Ly / by] contiguous; copy q's quadrant offsets -1 where bit q
// of ox_mask / oy_mask is set; `paired` (complex64 only: 16-byte loads of
// a pair of words) needs oy_mask 0, by and Ly even, 16-byte aligned phi and
// v and even strides.
int tmg_restrict_c64(const void* phi, const void* v, void* out, int E,
                     int NQ, int nc, int nf, int Lx, int Ly, int bx, int by,
                     int ox_mask, int oy_mask, long long phi_so,
                     long long phi_sq, long long v_so, long long v_sq,
                     int paired, void* stream) {
  return restrict_launch<float>(phi, v, out, E, NQ, nc, nf, Lx, Ly, bx, by,
                                ox_mask, oy_mask, phi_so, phi_sq, v_so, v_sq,
                                paired, stream);
}
int tmg_restrict_c128(const void* phi, const void* v, void* out, int E,
                      int NQ, int nc, int nf, int Lx, int Ly, int bx, int by,
                      int ox_mask, int oy_mask, long long phi_so,
                      long long phi_sq, long long v_so, long long v_sq,
                      int paired, void* stream) {
  return restrict_launch<double>(phi, v, out, E, NQ, nc, nf, Lx, Ly, bx, by,
                                 ox_mask, oy_mask, phi_so, phi_sq, v_so, v_sq,
                                 0, stream);
}

// prolong: phi as restrict's, vc entries of [nc][Lx / bx][Ly / by] at o *
// vc_so + q * vc_sq, base (nullptr: none) and out [E][NQ][nf][Lx][Ly]
// contiguous.
int tmg_prolong_c64(const void* phi, const void* vc, const void* base,
                    void* out, int E, int NQ, int nc, int nf, int Lx, int Ly,
                    int bx, int by, int ox_mask, int oy_mask,
                    long long phi_so, long long phi_sq, long long vc_so,
                    long long vc_sq, void* stream) {
  return prolong_launch<float>(phi, vc, base, out, E, NQ, nc, nf, Lx, Ly, bx,
                               by, ox_mask, oy_mask, phi_so, phi_sq, vc_so,
                               vc_sq, stream);
}
int tmg_prolong_c128(const void* phi, const void* vc, const void* base,
                     void* out, int E, int NQ, int nc, int nf, int Lx, int Ly,
                     int bx, int by, int ox_mask, int oy_mask,
                     long long phi_so, long long phi_sq, long long vc_so,
                     long long vc_sq, void* stream) {
  return prolong_launch<double>(phi, vc, base, out, E, NQ, nc, nf, Lx, Ly,
                                bx, by, ox_mask, oy_mask, phi_so, phi_sq,
                                vc_so, vc_sq, stream);
}

}  // extern "C"
