// Shared helpers for the kernels (built with nvcc into one shared library
// per source, plain C interface, loaded through ctypes).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace rt {

// Same mask value as the TPU kernels: a large finite negative, so that
// exp(NEG_INF - m) is exactly 0 once any real score has set m.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// 16-byte asynchronous copy from device memory to shared memory (sm_80+),
// bypassing L1.  With valid == false it reads nothing and fills the 16
// bytes with zeros (src-size 0), so a ragged edge needs no branch around
// the copy; src must still be a mapped address.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- bf16 tensor-core helpers (mma.sync m16n8k16, sm_80+) --------------------
//
// Fragment layouts of m16n8k16 (g = lane / 4, t = lane % 4): the accumulator
// holds (row g, cols 2t, 2t+1) in c[0..1] and (row g+8, same cols) in c[2..3];
// A holds rows g / g+8 at cols 2t.. (a[0], a[1]) and 2t+8.. (a[2], a[3]); B
// holds k rows 2t.. (b0) and 2t+8.. (b1) of col g.  So the accumulator of
// one product, two n-blocks of 8 side by side, is the A fragment of the next.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// B fragment (b0, b1) of one n-block of 8 over k0..k0+15 from a tile stored
// n-major (row n holds its k values); lanes 16-31 give no address
__device__ __forceinline__ void ldmatrix_x2_b(unsigned& b0, unsigned& b1,
                                              const __nv_bfloat16* base, int ld, int k0,
                                              int n0, int lane) {
  const __nv_bfloat16* p = base + (n0 + (lane & 7)) * ld + k0 + ((lane >> 3) & 1) * 8;
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(smem_addr(p))
               : "memory");
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the two bf16 halves of a bf16x2 register as floats
__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// 2^x on the special-function unit (one instruction).  The kernels call it
// with x <= 0 or -inf only; results below 2^-126 flush to 0, a decay or
// weight that no sum of theirs can see next to its other terms.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log2 x on the special-function unit, for normal x
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16x2 register, lo in the low half (round to nearest even)
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// Address of this lane's row for an x4 ldmatrix of a 16x16 bf16 tile at
// (row0, col0) of a row-major array with row stride ld.  Without .trans it
// gives an A fragment of the tile (rows = m, cols = k); with .trans, read
// from a tile stored k-major (rows = k, cols = m), the A fragment of its
// transpose.
__device__ __forceinline__ const __nv_bfloat16* a_tile_row(const __nv_bfloat16* base, int ld,
                                                           int row0, int col0, int lane,
                                                           bool trans) {
  const int mi = lane >> 3, r = lane & 7;
  return trans ? base + (row0 + r + (mi >> 1) * 8) * ld + col0 + (mi & 1) * 8
               : base + (row0 + r + (mi & 1) * 8) * ld + col0 + (mi >> 1) * 8;
}

// Address of this lane's row for an x4 ldmatrix that gives the B fragments
// of two n-blocks of 8 (regs 0-1: cols n0..n0+7, regs 2-3: n0+8..n0+15) over
// k0..k0+15.  Stored n-major (row n holds its k values): no .trans.  Stored
// k-major (row k holds its n values): .trans.
__device__ __forceinline__ const __nv_bfloat16* b_tile_row(const __nv_bfloat16* base, int ld,
                                                           int k0, int n0, int lane,
                                                           bool k_major) {
  const int mi = lane >> 3, r = lane & 7;
  return k_major ? base + (k0 + r + (mi & 1) * 8) * ld + n0 + (mi >> 1) * 8
                 : base + (n0 + r + (mi >> 1) * 8) * ld + k0 + (mi & 1) * 8;
}

}  // namespace rt
