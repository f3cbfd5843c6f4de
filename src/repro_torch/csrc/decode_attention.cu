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
// the K/V bytes up to kv_len over 3.35 TB/s.  At the serving shapes that is
// well under a microsecond, below the latency of one launch, so what the
// design must buy is parallelism: enough CTAs reading at once.  What is left
// is a chain of dependent latencies (the cache copy, the tile's products,
// the partial's store, the combine's re-read), which PERF.md breaks down.
//
// Design: split-KV over the whole card, then a combine in a fixed order.
// * The grid is (num_splits, Hkv * G/GH, B).  The CTA of split s reads
//   positions [s*split, min((s+1)*split, kv_len)) of its (batch, kv head)
//   for GH query heads of the group, and writes a partial (m, l, acc[Dv])
//   per head to a workspace.  GH is the whole group where its fp32 q and
//   accumulators fit in shared memory (GQA: the cache is read once for all
//   G heads); MLA's absorbed decode (one kv head for G = 128 heads, Dq 576,
//   Dv 512) would need 557 KB for them, so there the wrapper tiles the
//   group, GH = 16 heads a CTA, and each tile reads the cache itself.  A
//   head's partial is the same whatever GH is: every sum it takes runs over
//   that head alone.  A CTA whose split starts at or past kv_len reads
//   nothing.  The wrapper picks split and num_splits from the cache's shape
//   alone (never kv_len, which stays on the device, and never the card's SM
//   count, so a cache restored on another card decodes to the same bits).
// * V may be a strided view (MLA's V is the first 512 columns of the
//   576-wide latent cache that is also K): the kernel takes V's batch,
//   position and head strides, each a whole number of 16-byte units.
// * Inside a CTA, tiles of DBK positions arrive by 16-byte cp.async copies
//   in the cache's dtype, K and V as two groups, so V is still in flight
//   while the scores are formed.  Products run on the CUDA cores in fp32
//   (byte-bound at the GQA shapes: tensor cores would not help; MLA's
//   absorbed shape, 16 heads by 576 a tile, is not, and takes eight warps a
//   CTA where GQA takes four).  K rows are padded by 16
//   bytes, which keeps the 16-byte reads of the score loop free of bank
//   conflicts.  Each (head, position) score and each (head, dim) sum has
//   one owner thread, and the softmax statistics take a warp butterfly, so
//   the order of every sum is fixed.
// * A second launch on the same stream combines, one CTA per (batch, query
//   head): over the active splits i = 0, 1, ... in that order, m* = max
//   m_i, l = sum l_i e^(m_i - m*), acc = sum acc_i e^(m_i - m*), out = acc /
//   max(l, 1e-30).  Stream order is the only synchronisation: no atomics,
//   no counters, no state kept between calls, and every run gives the same
//   bits, which the serving snapshot/migrate path needs for a bit-identical
//   continuation.  kv_len = 0 leaves no active split and writes zeros.  The
//   workspace is the caller's, one per call.
// * Where the caller asks for it, the combine also writes each (batch,
//   query head)'s log-sum-exp of the scaled scores, m* + log(l), as fp32
//   (-inf with no active split): the quantity that merges the outputs of
//   attention over disjoint blocks of one sequence, as when a cache is split
//   over ranks by position.  The Pallas kernel keeps the same m and l in
//   scratch (m_ref, l_ref).  One thread of the CTA writes it; no extra
//   launch.
#include "common.cuh"

namespace {

constexpr int DBK = 64;         // cache positions per tile; a split is a multiple
constexpr int THREADS = 128;    // four warps, at the GQA shapes
// MLA's absorbed shape fills a streaming multiprocessor's shared memory with
// one CTA: eight warps there, to keep more than one warp a scheduler in flight
// (every score, statistic and sum keeps its one owner, so the bits are the
// same at either count)
constexpr int THREADS_WIDE = 256;
// splits per (batch, kv head) at most: the combine's loops run this far (the
// wrapper's MAX_SPLITS, kernels/decode_attention.py, which a test holds equal)
constexpr int MAX_SPLITS = 32;

size_t smem_bytes(int Dq, int Dv, int G, int elt) {
  return (size_t)G * Dq * sizeof(float)            // q rows of the group, fp32
         + (size_t)DBK * (Dq * elt + 16)           // K tile
         + (size_t)DBK * (Dv * elt + 16)           // V tile
         + (size_t)G * Dv * sizeof(float)          // acc
         + (size_t)G * DBK * sizeof(float)         // scores, then probabilities
         + 3 * (size_t)G * sizeof(float);          // m, l, alpha
}

// two consecutive T from shared memory as fp32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// 16 bytes of T from shared memory as fp32
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

template <typename T, int DQ, int DV, int NT>
__global__ void __launch_bounds__(NT)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ kv_len_ptr,
                          float* __restrict__ part, int S, int H, int Hkv, int GH,
                          int64_t v_sb, int64_t v_ss, int64_t v_sh, int split,
                          float scale) {
  constexpr int VEC = 16 / sizeof(T);              // elements per 16-byte copy
  constexpr int KR = DQ + VEC, VR = DV + VEC;      // smem rows: 16 bytes of padding
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int G = GH;                                // heads of this CTA
  const int Gall = H / Hkv, tiles = Gall / GH;     // heads of the group, tiles of it
  float* qs = reinterpret_cast<float*>(smem_raw);
  T* ks = reinterpret_cast<T*>(qs + G * DQ);
  T* vs = ks + DBK * KR;
  float* accs = reinterpret_cast<float*>(vs + DBK * VR);
  float* ps = accs + G * DV;
  float* ms = ps + G * DBK;
  float* ls = ms + G;
  float* alphas = ls + G;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int ns = gridDim.x, s = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / tiles, g0 = blockIdx.y % tiles * GH;   // first head of the tile
  const int kv_len = max(0, min(*kv_len_ptr, S));
  const int start = s * split, end = min(start + split, kv_len);
  if (start >= end) return;   // past kv_len: nothing to read, no partial
  const int64_t qo_base = (int64_t)b * H + (int64_t)hk * Gall + g0;
  const int64_t k_stride = (int64_t)Hkv * DQ, v_stride = v_ss;
  const T* kb = k + (int64_t)b * S * k_stride + (int64_t)hk * DQ;
  const T* vb = v + (int64_t)b * v_sb + (int64_t)hk * v_sh;
  // this (batch, kv head)'s partials, (m, l) of [split][head] then acc of
  // [split][head][DV], offset to the tile's first head
  float* part_ml = part + (size_t)(b * Hkv + hk) * ns * Gall * (DV + 2);
  float* part_acc = part_ml + (size_t)ns * Gall * 2 + (size_t)g0 * DV;
  part_ml += (size_t)g0 * 2;

  // a fixed number of 16-byte copies per thread (compile-time trip counts)
  static_assert((DBK * DQ / VEC) % NT == 0 && (DBK * DV / VEC) % NT == 0,
                "tiles split evenly over the threads");
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int i = 0; i < DBK * (DQ / VEC) / NT; ++i) {
      const int c = tid + i * NT, r = c / (DQ / VEC), ch = c % (DQ / VEC), kp = k0 + r;
      rt::cp_async16(ks + r * KR + ch * VEC, kb + (kp < end ? kp : 0) * k_stride + ch * VEC,
                     kp < end);
    }
    rt::cp_async_commit();
#pragma unroll
    for (int i = 0; i < DBK * (DV / VEC) / NT; ++i) {
      const int c = tid + i * NT, r = c / (DV / VEC), ch = c % (DV / VEC), kp = k0 + r;
      rt::cp_async16(vs + r * VR + ch * VEC, vb + (kp < end ? kp : 0) * v_stride + ch * VEC,
                     kp < end);
    }
    rt::cp_async_commit();
  };

  load_tile(start);
  for (int e = tid; e < G * DQ; e += NT) qs[e] = rt::to_f32(q[qo_base * DQ + e]);
  for (int e = tid; e < G * DV; e += NT) accs[e] = 0.f;
  for (int g = tid; g < G; g += NT) {
    ms[g] = rt::NEG_INF;
    ls[g] = 0.f;
  }
  for (int k0 = start; k0 < end; k0 += DBK) {
    if (k0 != start) {
      __syncthreads();   // every thread is done with the previous tile
      load_tile(k0);
    }
    rt::cp_async_wait<1>();   // K has landed; V may still be in flight
    __syncthreads();

    // scores of the G heads against the DBK positions of this tile
    for (int e = tid; e < G * DBK; e += NT) {
      const int g = e / DBK, j = e % DBK;
      const float* qg = qs + g * DQ;
      const T* kj = ks + j * KR;
      float d4[4] = {0.f, 0.f, 0.f, 0.f};   // four short chains, summed in a fixed order
#pragma unroll
      for (int c = 0; c < DQ; c += VEC) {
        float kf[VEC], qf[VEC];
        load16(kj + c, kf);
#pragma unroll
        for (int i = 0; i < VEC; i += 4) load16(qg + c + i, qf + i);
#pragma unroll
        for (int i = 0; i < VEC; ++i) d4[i % 4] = fmaf(qf[i], kf[i], d4[i % 4]);
      }
      const float dot = (d4[0] + d4[1]) + (d4[2] + d4[3]);
      ps[e] = (k0 + j < end) ? dot * scale : rt::NEG_INF;
    }
    __syncthreads();

    // online-softmax statistics: one warp per head, butterfly reductions
    // (every lane ends with the same bits)
    for (int g = warp; g < G; g += NT / 32) {
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
    rt::cp_async_wait<0>();
    __syncthreads();

    // acc = acc * alpha + p @ V, one owner thread per (head, pair of dims)
    for (int e = tid; e < G * (DV / 2); e += NT) {
      const int g = e / (DV / 2), d = 2 * (e % (DV / 2));
      const float* pg = ps + g * DBK;
      float a0[4] = {0.f, 0.f, 0.f, 0.f}, a1[4] = {0.f, 0.f, 0.f, 0.f};   // chains by j % 4
#pragma unroll 16
      for (int j = 0; j < DBK; ++j) {
        const float2 vv = load2(vs + j * VR + d);
        a0[j % 4] = fmaf(pg[j], vv.x, a0[j % 4]);
        a1[j % 4] = fmaf(pg[j], vv.y, a1[j % 4]);
      }
      accs[g * DV + d] = fmaf(accs[g * DV + d], alphas[g], (a0[0] + a0[1]) + (a0[2] + a0[3]));
      accs[g * DV + d + 1] =
          fmaf(accs[g * DV + d + 1], alphas[g], (a1[0] + a1[1]) + (a1[2] + a1[3]));
    }
  }
  __syncthreads();
  for (int e = tid; e < G * DV; e += NT) part_acc[(size_t)s * Gall * DV + e] = accs[e];
  for (int g = tid; g < G; g += NT) {
    part_ml[((size_t)s * Gall + g) * 2] = ms[g];
    part_ml[((size_t)s * Gall + g) * 2 + 1] = ls[g];
  }
}

// One CTA per (batch, query head), one thread per output dim: the active
// splits' partials combined in split order.  Every load is issued before
// the first is used (the loops run to MAX_SPLITS, predicated), so the
// partials cost one trip to L2; each thread forms m*, the weights and l
// itself, in the same order, so no thread waits on another.  Runs after the
// split kernel on the same stream.
template <typename T, int DV>
__global__ void __launch_bounds__(DV)
flash_decode_combine_kernel(const int* __restrict__ kv_len_ptr,
                            const float* __restrict__ part, T* __restrict__ o,
                            float* __restrict__ lse, int S, int H, int Hkv, int split,
                            int ns) {
  const int G = H / Hkv;
  const int d = threadIdx.x, h = blockIdx.x, b = blockIdx.y, hk = h / G, g = h % G;
  const int kv_len = max(0, min(*kv_len_ptr, S));
  const int n_active = (kv_len + split - 1) / split;
  const float* part_ml = part + (size_t)(b * Hkv + hk) * ns * G * (DV + 2);
  const float2* ml = reinterpret_cast<const float2*>(part_ml) + g;        // split i: ml[i*G]
  const float* acc = part_ml + (size_t)ns * G * 2 + (size_t)g * DV + d;    // acc[i*G*DV]

  float2 mli[MAX_SPLITS];
  float acci[MAX_SPLITS];
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) {
    mli[i] = i < n_active ? ml[(size_t)i * G] : make_float2(rt::NEG_INF, 0.f);
    acci[i] = i < n_active ? acc[(size_t)i * G * DV] : 0.f;
  }
  float m_star = rt::NEG_INF;
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) m_star = fmaxf(m_star, mli[i].x);
  float l = 0.f, a = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_SPLITS; ++i) {
    if (i < n_active) {
      const float w = expf(mli[i].x - m_star);
      l = fmaf(mli[i].y, w, l);
      a = fmaf(acci[i], w, a);
    }
  }
  o[((int64_t)b * H + h) * DV + d] = rt::from_f32<T>(a / fmaxf(l, 1e-30f));
  // an active split holds a position below kv_len, whose term in l is >= 1
  if (lse != nullptr && d == 0)
    lse[(int64_t)b * H + h] = n_active ? m_star + logf(l) : -__int_as_float(0x7f800000);
}

template <typename T, int DQ, int DV>
int launch(const void* q, const void* k, const void* v, const void* kv_len, void* o,
           void* lse, void* part, int B, int S, int H, int Hkv, int GH,
           const long long* v_strides,
           int split, int num_splits, float scale, cudaStream_t stream) {
  const int G = H / Hkv;
  if (GH <= 0 || G % GH != 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(DQ, DV, GH, sizeof(T));
  constexpr int NT = DQ >= 512 ? THREADS_WIDE : THREADS;
  auto split_kernel = flash_decode_split_kernel<T, DQ, DV, NT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  split_kernel<<<dim3(num_splits, Hkv * (G / GH), B), NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(kv_len), static_cast<float*>(part), S, H, Hkv, GH,
      v_strides[0], v_strides[1], v_strides[2], split, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_decode_combine_kernel<T, DV><<<dim3(H, B), DV, 0, stream>>>(
      static_cast<const int*>(kv_len), static_cast<const float*>(part), static_cast<T*>(o),
      static_cast<float*>(lse), S, H, Hkv, split, num_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int Dq, int Dv, const void* q, const void* k, const void* v,
             const void* kv_len, void* o, void* lse, void* part, int B, int S, int H,
             int Hkv, int GH, const long long* v_strides, int split, int num_splits,
             float scale, cudaStream_t st) {
#define RT_DIMS(DQ, DV)                                                                 \
  if (Dq == DQ && Dv == DV)                                                             \
    return launch<T, DQ, DV>(q, k, v, kv_len, o, lse, part, B, S, H, Hkv, GH,          \
                             v_strides, split, num_splits, scale, st);
  RT_DIMS(32, 32) RT_DIMS(32, 64) RT_DIMS(32, 128)
  RT_DIMS(64, 32) RT_DIMS(64, 64) RT_DIMS(64, 128)
  RT_DIMS(128, 32) RT_DIMS(128, 64) RT_DIMS(128, 128)
  RT_DIMS(192, 128)
  RT_DIMS(48, 32)     // reduced MLA: absorbed decode (latent 32 + rope 16, v 32)
  RT_DIMS(576, 512)   // MLA's absorbed decode: latent 512 + rope 64, v the latent
#undef RT_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory the split kernel asks for at (Dq, Dv) with G heads
// a CTA and elements of elt bytes; the wrapper picks the largest G that
// divides the group and fits the card's 227 KB per block, and refuses a
// shape where none does.
extern "C" long long decode_attention_smem_bytes(int Dq, int Dv, int G, int elt) {
  return static_cast<long long>(smem_bytes(Dq, Dv, G, elt));
}

// q (B,1,H,Dq), k (B,S,Hkv,Dq), kv_len one device int32, o (B,1,H,Dv), all
// contiguous and 16-byte aligned; lse null, or B*H floats that receive each
// (batch, query head)'s log-sum-exp of the scaled scores; v (B,S,Hkv,Dv) with its last dimension
// contiguous and v_sb, v_ss, v_sh its batch, position and head strides in
// elements, each a multiple of 16 bytes; q/k/v/o of one dtype (is_bf16 ?
// bfloat16 : float32).  GH: query heads a CTA, a divisor of H/Hkv.  part:
// B*Hkv*num_splits*(H/Hkv)*(Dv+2) floats of workspace, not read before the
// split kernel writes it.  split: cache positions per CTA, a multiple of 64,
// with num_splits * split >= S and num_splits <= MAX_SPLITS.  Two launches
// on the stream: the split kernel, then the combine.  Returns a cudaError_t
// as int; 0 means both were accepted.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* kv_len, void* o, void* lse, void* part,
                                    int B, int S, int H, int Hkv, int Dq, int Dv,
                                    int is_bf16, int GH,
                                    long long v_sb, long long v_ss, long long v_sh,
                                    int split, int num_splits, float scale, void* stream) {
  if (split <= 0 || split % DBK != 0 || num_splits <= 0 || num_splits > MAX_SPLITS ||
      (long long)split * num_splits < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long v_strides[3] = {v_sb, v_ss, v_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(Dq, Dv, q, k, v, kv_len, o, lse, part, B, S, H, Hkv,
                                   GH, v_strides, split, num_splits, scale, st);
  return dispatch<float>(Dq, Dv, q, k, v, kv_len, o, lse, part, B, S, H, Hkv, GH,
                         v_strides, split, num_splits, scale, st);
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
