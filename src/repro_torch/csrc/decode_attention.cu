// Flash decode: one query token per sequence against a KV cache.
//
// Replaces: repro/kernels/decode_attention.py :: flash_decode
// (_decode_kernel), the Pallas TPU kernel that runs every decode step.  It
// computes the same function: the G query heads of a kv head attend over
// cache positions [0, kv_len), with an fp32 online softmax (NEG_INF = -1e30,
// l floored at 1e-30) and the output in q's dtype.  kv_len is read from a
// device int32 (the cache's t + 1), so a generation loop never waits on the
// host.
//
// What bounds it on an H100: bytes.  Each cache byte up to kv_len is read
// once and used for 2*G flops (G = 7 for qwen2-0.5b), far below the ~295
// flops per byte at which the tensor cores would be the limit; the bound is
// the K/V bytes up to kv_len over 3.35 TB/s.
//
// Design.  One CTA per (batch, kv head) walks the cache in tiles of DBK
// positions up to kv_len; tiles past kv_len are never read (the TPU kernel
// skips them with pl.when).  The G query heads of the kv head share every
// K/V tile they read from shared memory, so the cache is read once for all
// G heads.  The running state (m, l, acc) lives in shared memory, one owner
// thread per element, and every reduction runs in a fixed order, with no
// atomics: the same inputs give the same bits on every run, which is what
// the serving snapshot/migrate path needs for a bit-identical continuation.
// This first version launches B * Hkv CTAs (8 at batch 4 on qwen2-0.5b),
// which leaves most of the 132 SMs idle; a split-KV pass with a fixed-order
// combine is later work.
#include "common.cuh"

namespace {

constexpr int DBK = 64;         // cache positions per tile
constexpr int THREADS = 128;    // four warps
constexpr int WARPS = THREADS / 32;

size_t smem_floats(int Dq, int Dv, int G) {
  return (size_t)G * Dq               // q rows of the group
         + (size_t)DBK * (Dq + 1)     // K tile, rows padded against bank conflicts
         + (size_t)DBK * Dv           // V tile
         + (size_t)G * DBK            // scores, then probabilities
         + (size_t)G * Dv             // acc
         + 3 * (size_t)G;             // m, l, alpha
}

template <typename T, int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                    T* __restrict__ o, int S, int H, int Hkv, float scale) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  float* qs = smem;
  float* ks = qs + G * DQ;
  float* vs = ks + DBK * (DQ + 1);
  float* ps = vs + DBK * DV;
  float* accs = ps + G * DBK;
  float* ms = accs + G * DV;
  float* ls = ms + G;
  float* alphas = ls + G;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int kv_len = max(0, min(*kv_len_ptr, S));
  const int64_t qo_base = ((int64_t)b * H + (int64_t)hk * G);  // first head of the group

  for (int e = tid; e < G * DQ; e += THREADS) qs[e] = rt::to_f32(q[qo_base * DQ + e]);
  for (int e = tid; e < G * DV; e += THREADS) accs[e] = 0.f;
  for (int g = tid; g < G; g += THREADS) {
    ms[g] = rt::NEG_INF;
    ls[g] = 0.f;
  }

  for (int k0 = 0; k0 < kv_len; k0 += DBK) {
    __syncthreads();  // previous tile and the initial state are settled
    for (int e = tid; e < DBK * DQ; e += THREADS) {
      const int j = e / DQ, d = e % DQ, kp = k0 + j;
      ks[j * (DQ + 1) + d] =
          kp < S ? rt::to_f32(k[(((int64_t)b * S + kp) * Hkv + hk) * DQ + d]) : 0.f;
    }
    for (int e = tid; e < DBK * DV; e += THREADS) {
      const int j = e / DV, d = e % DV, kp = k0 + j;
      vs[j * DV + d] = kp < S ? rt::to_f32(v[(((int64_t)b * S + kp) * Hkv + hk) * DV + d]) : 0.f;
    }
    __syncthreads();

    // scores of the G heads against the DBK positions of this tile
    for (int e = tid; e < G * DBK; e += THREADS) {
      const int g = e / DBK, j = e % DBK;
      const float* qg = qs + g * DQ;
      const float* kj = ks + j * (DQ + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < DQ; ++d) dot = fmaf(qg[d], kj[d], dot);
      ps[e] = (k0 + j < kv_len) ? dot * scale : rt::NEG_INF;
    }
    __syncthreads();

    // online-softmax statistics: one warp per head, butterfly reductions
    // (every lane ends with the same bits)
    for (int g = warp; g < G; g += WARPS) {
      float* pg = ps + g * DBK;
      float mx = ms[g];
      for (int j = lane; j < DBK; j += 32) mx = fmaxf(mx, pg[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float sum = 0.f;
      for (int j = lane; j < DBK; j += 32) {
        const float p = expf(pg[j] - mx);
        pg[j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(ms[g] - mx);
        alphas[g] = alpha;
        ls[g] = ls[g] * alpha + sum;
        ms[g] = mx;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ V, one owner thread per (head, dim)
    for (int e = tid; e < G * DV; e += THREADS) {
      const int g = e / DV, d = e % DV;
      const float* pg = ps + g * DBK;
      float a = accs[e] * alphas[g];
#pragma unroll 8
      for (int j = 0; j < DBK; ++j) a = fmaf(pg[j], vs[j * DV + d], a);
      accs[e] = a;
    }
  }
  __syncthreads();

  for (int e = tid; e < G * DV; e += THREADS) {
    const int g = e / DV;
    o[qo_base * DV + e] = rt::from_f32<T>(accs[e] / fmaxf(ls[g], 1e-30f));
  }
}

template <typename T, int DQ, int DV>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           int B, int S, int H, int Hkv, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats(DQ, DV, H / Hkv) * sizeof(float);
  auto kernel = flash_decode_kernel<T, DQ, DV>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(Hkv, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<T*>(o), S, H, Hkv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Dq, int Dv, const void* q, const void* k, const void* v,
             const void* kv_len, void* o, int B, int S, int H, int Hkv, float scale,
             cudaStream_t st) {
#define RT_DIMS(DQ, DV)        \
  if (Dq == DQ && Dv == DV) \
    return launch<T, DQ, DV>(q, k, v, kv_len, o, B, S, H, Hkv, scale, st);
  RT_DIMS(32, 32) RT_DIMS(32, 64) RT_DIMS(32, 128)
  RT_DIMS(64, 32) RT_DIMS(64, 64) RT_DIMS(64, 128)
  RT_DIMS(128, 32) RT_DIMS(128, 64) RT_DIMS(128, 128)
  RT_DIMS(192, 128)
#undef RT_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Largest dynamic shared memory the kernel asks for at (Dq, Dv, G); the
// wrapper refuses shapes above the card's 227 KB per block.
extern "C" long long decode_attention_smem_bytes(int Dq, int Dv, int G) {
  return static_cast<long long>(smem_floats(Dq, Dv, G) * sizeof(float));
}

// q (B,1,H,Dq), k (B,S,Hkv,Dq), v (B,S,Hkv,Dv), kv_len one device int32,
// o (B,1,H,Dv), all contiguous, q/k/v/o of one dtype (is_bf16 ? bfloat16 :
// float32).  Returns a cudaError_t as int; 0 means the launch was accepted.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, int B, int S, int H,
                                    int Hkv, int Dq, int Dv, int is_bf16, float scale,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(Dq, Dv, q, k, v, kv_len, o, B, S, H, Hkv, scale, st);
  return dispatch<float>(Dq, Dv, q, k, v, kv_len, o, B, S, H, Hkv, scale, st);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
