// f32-accurate matrix products on Hopper's tensor cores: 3xTF32 with
// mma.sync.m16n8k8, shared by the port's CUDA kernels (flash_attention,
// mlstm_chunk).
//
// A TF32 operand keeps 10 of f32's 23 mantissa bits, so one TF32 product
// misses the f32 tolerances the kernels are held to.  Each f32 operand x is
// split as big = tf32(x) (round to nearest) and small =
// tf32(x - big) (x - big is exact in f32), and a product is taken as
// small_a*big_b + big_a*small_b + big_a*big_b, the two cross terms first.
// What it drops, small_a*small_b, and the rounding of the small parts are
// ~2^-22 of the product.  The tensor cores' f32 accumulation does not round
// to nearest, and over a long reduction into one accumulator that shows (on
// the H100, flash attention's P.V over 2048 keys in one accumulator erred
// several times more than f32 FFMA), so the kernels take long sums in f32:
// mma3_rn keeps the cross terms in an accumulator of their own and adds each
// big*big product to the total in f32.  An operand that is
// exact in TF32 (a bfloat16 input, converted to f32) has small = 0, and its
// cross term is skipped: a bf16 x bf16 product is one mma, a bf16 x f32
// product two.
//
// Fragments of the m16n8k8 TF32 mma (PTX ISA, "Matrix Fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
//   B (8 x 8):  b0 (k = t, n = g), b1 (k = t + 4, n = g);
//   C (16 x 8): c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
// The loaders below relabel the reduction index of each 8-wide k step: mma
// slot t reads k = 2t and slot t + 4 reads k = 2t + 1.  A and B use the same
// relabelling, so the product is unchanged, and then
//   * a k-contiguous tile gives each thread its two k values as one 8-byte
//     load (A from a row-major tile, B from an n-major tile);
//   * an accumulator (columns 2t, 2t + 1 of an 8-column n tile) is already an
//     A fragment for a product over those 8 columns: a0 = c0, a1 = c2,
//     a2 = c1, a3 = c3 (flash attention's P.V keeps P in registers so).
// Shared-memory leading dimensions that keep the loads free of bank
// conflicts: a multiple of 8 floats that is 8 or 24 mod 32 for the 8-byte
// k-contiguous loads (rows g = 0..3 of a half warp land 8 banks apart), 4 or
// 20 mod 32 for the k-major loads (k = 2t rows land 8 banks apart).
//
// Only sm_80 and later have the TF32 mma; the kernels are built for sm_90a.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32x3 {

struct FragA {
  uint32_t big[4], small[4];
};

struct FragB {
  uint32_t big[2], small[2];
};

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero:
// the result of cvt.rna.tf32.f32 for every finite x, in two integer ops
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a TF32 value; an EXACT x (a bf16 input) is its own big
template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  if (EXACT) {
    big = __float_as_uint(x);
    small = 0u;
  } else {
    big = to_tf32(x);
    small = to_tf32(x - __uint_as_float(big));
  }
}

template <bool EXACT>
__device__ __forceinline__ void split_a(FragA& f, const float x[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split<EXACT>(x[i], f.big[i], f.small[i]);
}

template <bool EXACT>
__device__ __forceinline__ void split_b(FragB& f, const float x[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) split<EXACT>(x[i], f.big[i], f.small[i]);
}

// d += a * b, one TF32 m16n8k8 product with f32 accumulation (not volatile:
// the compiler interleaves the independent accumulators' products)
__device__ __forceinline__ void mma(float d[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b at f32 accuracy: the cross terms of the inexact operands, then
// big * big
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3(float d[4], const FragA& a, const FragB& b) {
  if (!A_EXACT) mma(d, a.small, b.big);
  if (!B_EXACT) mma(d, a.big, b.small);
  mma(d, a.big, b.big);
}

// d += a * b at f32 accuracy with sums rounded to nearest: the tensor cores
// add into their accumulator without rounding to nearest, which a long
// reduction into one accumulator shows (at f32 resolution).  So the cross
// terms go to their own accumulator `cross` (2^-11 of the product: its
// rounding costs nothing), and big * big is taken from zero and added to d
// in f32.  The caller adds `cross` to d when the reduction ends.
template <bool A_EXACT, bool B_EXACT>
__device__ __forceinline__ void mma3_rn(float d[4], float cross[4], const FragA& a,
                                        const FragB& b) {
  if (!A_EXACT) mma(cross, a.small, b.big);
  if (!B_EXACT) mma(cross, a.big, b.small);
  float z[4] = {0.f, 0.f, 0.f, 0.f};
  mma(z, a.big, b.big);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += z[i];
}

// ---- shared-memory elements as f32 (tiles hold the inputs' own type) ----

__device__ __forceinline__ float ld1(const float* p) { return *p; }
__device__ __forceinline__ float ld1(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// ---- fragment loaders (raw f32 values; the caller scales, then splits) ----
// p points at the tile's element (row 0, k 0) of this 16 x 8 (A) or 8 x 8 (B)
// piece; ld is the tile's leading dimension in elements.

// A, element (r, k) at p[r * ld + k]: k contiguous (two 8-byte loads)
template <typename T>
__device__ __forceinline__ void load_a_rows(float x[4], const T* p, int ld) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float2 lo = ld2(p + g * ld + 2 * t), hi = ld2(p + (g + 8) * ld + 2 * t);
  x[0] = lo.x;
  x[1] = hi.x;
  x[2] = lo.y;
  x[3] = hi.y;
}

// A, element (r, k) at p[k * ld + r]: r contiguous
template <typename T>
__device__ __forceinline__ void load_a_cols(float x[4], const T* p, int ld) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  x[0] = ld1(p + 2 * t * ld + g);
  x[1] = ld1(p + 2 * t * ld + g + 8);
  x[2] = ld1(p + (2 * t + 1) * ld + g);
  x[3] = ld1(p + (2 * t + 1) * ld + g + 8);
}

// B, element (k, n) at p[n * ld + k]: k contiguous (one 8-byte load)
template <typename T>
__device__ __forceinline__ void load_b_rows(float x[2], const T* p, int ld) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  const float2 v = ld2(p + g * ld + 2 * t);
  x[0] = v.x;
  x[1] = v.y;
}

// B, element (k, n) at p[k * ld + n]: n contiguous
template <typename T>
__device__ __forceinline__ void load_b_cols(float x[2], const T* p, int ld) {
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
  x[0] = ld1(p + 2 * t * ld + g);
  x[1] = ld1(p + (2 * t + 1) * ld + g);
}

// ---- cp.async: global -> shared copies of 4 elements, zero-filled when !ok ----

template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool ok);

template <>
__device__ __forceinline__ void cp_async4<float>(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

template <>
__device__ __forceinline__ void cp_async4<__nv_bfloat16>(__nv_bfloat16* dst,
                                                         const __nv_bfloat16* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace tf32x3
