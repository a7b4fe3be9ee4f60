// Complex arithmetic and the links-only Wilson hop, shared by the port's
// kernels (stencil.cu, stencil_tiled.cu).
//
// Complex numbers are interleaved (re, im) pairs, i.e. torch's complex64 /
// complex128 storage; every kernel is a template on the real type.
#pragma once

#include <cuda_runtime.h>
#include <cstddef>

namespace tmg {

template <typename T>
struct alignas(2 * sizeof(T)) cplx {
  T re, im;
};

template <typename T>
__device__ __forceinline__ cplx<T> mk(T re, T im) {
  cplx<T> z;
  z.re = re;
  z.im = im;
  return z;
}
template <typename T>
__device__ __forceinline__ cplx<T> operator+(cplx<T> a, cplx<T> b) {
  return mk<T>(a.re + b.re, a.im + b.im);
}
template <typename T>
__device__ __forceinline__ cplx<T> operator-(cplx<T> a, cplx<T> b) {
  return mk<T>(a.re - b.re, a.im - b.im);
}
template <typename T>
__device__ __forceinline__ cplx<T> operator*(cplx<T> a, cplx<T> b) {
  return mk<T>(a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re);
}
template <typename T>
__device__ __forceinline__ cplx<T> scale(T s, cplx<T> a) {
  return mk<T>(s * a.re, s * a.im);
}
// conj(a) * b
template <typename T>
__device__ __forceinline__ cplx<T> conj_mul(cplx<T> a, cplx<T> b) {
  return mk<T>(a.re * b.re + a.im * b.im, a.re * b.im - a.im * b.re);
}
// i * a
template <typename T>
__device__ __forceinline__ cplx<T> times_i(cplx<T> a) {
  return mk<T>(-a.im, a.re);
}

// Spin-projected Wilson hop from the links (ops/gauge_stencil.wilson_hop_u),
// given the links ux(x), ux(x-1), uy(x), uy(y-1) and the neighbour spinors
// (v0, v1) at x+1, x-1, y+1, y-1:
//   ha = ux(x) (v0 - v1)(x+1)          hb = ux(x-1)^* (v0 + v1)(x-1)
//   hc = uy(x) (v0 + i v1)(y+1)        hd = uy(y-1)^* (v0 - i v1)(y-1)
//   h0 = 1/2 (ha + hb + hc + hd),      h1 = 1/2 (-ha + hb - i hc + i hd)
template <typename T>
__device__ __forceinline__ void wilson_hop_core(
    cplx<T> ux, cplx<T> uxm, cplx<T> uy, cplx<T> uym, cplx<T> v0xp,
    cplx<T> v1xp, cplx<T> v0xm, cplx<T> v1xm, cplx<T> v0yp, cplx<T> v1yp,
    cplx<T> v0ym, cplx<T> v1ym, cplx<T>& h0, cplx<T>& h1) {
  const cplx<T> ha = ux * (v0xp - v1xp);
  const cplx<T> hb = conj_mul(uxm, v0xm + v1xm);
  const cplx<T> hc = uy * (v0yp + times_i(v1yp));
  const cplx<T> hd = conj_mul(uym, v0ym - times_i(v1ym));
  h0 = scale(T(0.5), ha + hb + hc + hd);
  h1 = scale(T(0.5), (hb - ha) + times_i(hd - hc));
}

// One complex word, global -> shared, asynchronously (cp.async, 8 or 16
// bytes); cp_async_wait waits for all of this thread's copies.
template <typename T>
__device__ __forceinline__ void cp_async(cplx<T>* smem, const cplx<T>* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(gmem), "n"((int)sizeof(cplx<T>)));
}

// 16 bytes, global -> shared, asynchronously and past L1 (cp.async.cg); both
// addresses 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Close this thread's group of copies issued since the last commit;
// cp_async_wait_group<K> waits for all but its K most recent groups.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(K) : "memory");
}

}  // namespace tmg
