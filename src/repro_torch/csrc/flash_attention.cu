// Forward flash attention (causal or not, GQA, Dq may differ from Dv).
//
// Replaces: repro/kernels/flash_attention.py :: flash (_flash_kernel), the
// Pallas TPU kernel that runs prefill.  It computes the same function:
// online softmax in fp32, scale 1/sqrt(Dq) unless given, causal mask
// kpos <= qpos, masked scores NEG_INF = -1e30, l floored at 1e-30, output in
// q's dtype.
//
// What bounds it on an H100: at prefill lengths the work is O(S^2 * D) per
// head against O(S * D) bytes, so the bound is arithmetic.  This first
// version does the products with fp32 FMAs on the CUDA cores (67 TFLOP/s)
// and not on the tensor cores (989 TFLOP/s bf16), so it sits far above the
// bound; wgmma/TMA tiling is later work.
//
// Design.  The TPU kernel carries (m, l, acc) in VMEM across a sequential KV
// grid axis.  Blocks of a CUDA grid run in no order, so here one CTA owns one
// (batch, head, tile of BQ query rows) and loops over KV tiles itself; the
// running state lives in registers.  Each query row is split over TPR
// threads that own interleaved slices of Dq and Dv (thread c owns dims
// c, c+TPR, ...), so shared-memory reads of a K/V row hit TPR consecutive
// banks.  Partial dot products are summed across those lanes with an xor
// butterfly, which leaves bit-identical sums in every lane.  K/V tiles are
// staged in shared memory as fp32 and shared by the BQ rows of the CTA.  The
// causal loop stops at the tile's diagonal (the TPU kernel skips blocks
// above it with pl.when).  The ragged edge is masked: rows past Sq are not
// stored and keys past Skv are masked, where the TPU kernel asserts that
// Sq and Skv divide the block sizes.  The kv head of query head h is h / G
// for any group size G (qwen2-0.5b has G = 7).  No atomics: the result is
// the same on every run.
#include "common.cuh"

namespace {

constexpr int BQ = 32;               // query rows per CTA
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 128

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
                 int H, int Hkv, int causal, float scale) {
  static_assert(DQ % TPR == 0 && DV % TPR == 0, "head dims split over TPR lanes");
  constexpr int QP = DQ / TPR;
  constexpr int VP = DV / TPR;
  __shared__ float ks[BK][DQ];
  __shared__ float vs[BK][DV];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int qpos = q0 + row;
  const bool row_ok = qpos < Sq;

  float qr[QP];
  {
    const int64_t off = (((int64_t)b * Sq + (row_ok ? qpos : 0)) * H + h) * DQ;
#pragma unroll
    for (int i = 0; i < QP; ++i) qr[i] = row_ok ? rt::to_f32(q[off + part + i * TPR]) : 0.f;
  }
  float acc[VP];
#pragma unroll
  for (int i = 0; i < VP; ++i) acc[i] = 0.f;
  float m = rt::NEG_INF;
  float l = 0.f;

  // keys past the tile's last row are masked for every row of the tile
  const int kv_end = causal ? min(Skv, q0 + BQ) : Skv;
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int e = tid; e < BK * DQ; e += THREADS) {
      const int j = e / DQ, d = e % DQ, kp = k0 + j;
      ks[j][d] = kp < Skv ? rt::to_f32(k[(((int64_t)b * Skv + kp) * Hkv + hk) * DQ + d]) : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int j = e / DV, d = e % DV, kp = k0 + j;
      vs[j][d] = kp < Skv ? rt::to_f32(v[(((int64_t)b * Skv + kp) * Hkv + hk) * DV + d]) : 0.f;
    }
    __syncthreads();

    float s[BK];
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < QP; ++i) dot = fmaf(qr[i], ks[j][part + i * TPR], dot);
      s[j] = dot;
    }
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 1);
      s[j] += __shfl_xor_sync(0xffffffffu, s[j], 2);
    }

    float m_new = m;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const int kp = k0 + j;
      const bool visible = kp < Skv && (!causal || kp <= qpos);
      s[j] = visible ? s[j] * scale : rt::NEG_INF;
      m_new = fmaxf(m_new, s[j]);
    }
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int i = 0; i < VP; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
#pragma unroll
      for (int i = 0; i < VP; ++i) acc[i] = fmaf(s[j], vs[j][part + i * TPR], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
    const int64_t off = (((int64_t)b * Sq + qpos) * H + h) * DV;
#pragma unroll
    for (int i = 0; i < VP; ++i) o[off + part + i * TPR] = rt::from_f32<T>(acc[i] / denom);
  }
}

template <typename T, int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
           int Skv, int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DQ, DV><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Skv, H, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Dq, int Dv, const void* q, const void* k, const void* v, void* o,
             int B, int Sq, int Skv, int H, int Hkv, int causal, float scale,
             cudaStream_t st) {
#define RT_DIMS(DQ, DV)        \
  if (Dq == DQ && Dv == DV) \
    return launch<T, DQ, DV>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, st);
  RT_DIMS(32, 32) RT_DIMS(32, 64) RT_DIMS(32, 128)
  RT_DIMS(64, 32) RT_DIMS(64, 64) RT_DIMS(64, 128)
  RT_DIMS(128, 32) RT_DIMS(128, 64) RT_DIMS(128, 128)
  RT_DIMS(192, 128)
#undef RT_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Sq,H,Dq), k (B,Skv,Hkv,Dq), v (B,Skv,Hkv,Dv), o (B,Sq,H,Dv), all
// contiguous and of one dtype (is_bf16 ? bfloat16 : float32).  Returns a
// cudaError_t as int; 0 means the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int Hkv, int Dq, int Dv,
                                   int is_bf16, int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(Dq, Dv, q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, st);
  return dispatch<float>(Dq, Dv, q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, st);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
