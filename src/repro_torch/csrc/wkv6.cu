// RWKV6 WKV: the data-dependent-decay recurrence over a whole sequence,
// with the fp32 (D, D) state of each (batch, head) kept in registers.
//
// Replaces: repro/kernels/_rwkv6_pallas.py :: wkv6_pallas (_wkv_kernel), the
// Pallas TPU kernel behind ops.wkv6 that runs in every rwkv6 layer's
// prefill.  Same contract as ref.wkv6: r, k, v, w (B,S,H,D) in the compute
// dtype, u (H,D) fp32, an optional fp32 initial state (B,H,D,D) mapping the
// k dim to the v dim; y (B,S,H,D) in r's dtype and the fp32 final state out.
//     y_t = r_t . (state + u * k_t v_t^T);   state = diag(w_t) state + k_t v_t^T
//
// Form.  The TPU kernel works a chunk of 128 tokens at a time through
// r * exp(cw_prev) and k * exp(-cw), with cw the cumulative log-decay.  At
// rwkv6's own decay initialisation a channel's cw passes -88 inside a chunk,
// exp(-cw) overflows fp32 while exp(cw_prev) underflows to 0, and 0 * inf is
// NaN (ROADMAP.md section 3).  This kernel runs the recurrence itself, token
// by token, which multiplies by w_t <= 1 and cannot overflow.  w is clamped
// at 1e-30 as the TPU kernel does before its log (_rwkv6_pallas.py:34).
//
// What bounds it on an H100: bytes.  The recurrence does about 4 D^2 flops
// per token and head against 10 D bytes moved (bf16 r/k/v/w in, y out), about
// 26 flops per byte at D = 64, far under the ~295 of the tensor cores.  The
// token loop is sequential, so this first version is bound by its latency,
// not by either rate (PERF.md has its times).
//
// Design.  One CTA owns one (batch, head), 256 threads.  Thread (g, v) owns
// column v of the state for the D/G rows k of its group g (G = 256 / D), in
// registers, for the whole sequence.  A tile of TT tokens of r, k, v, w is
// staged in shared memory; each thread then walks the tile's tokens with no
// barrier, since the state update of its own elements needs only the tile:
//     part_g,v = sum_{k in g} r_k s_kv;    s_kv = s_kv w_k + k_k v_v
// The G partial sums of each output meet in shared memory after the tile,
// together with the bonus term (sum_k r_k u_k k_k) v_v, in a fixed order:
// no atomics, so the same inputs give the same bits on every run, which the
// serving snapshot/migrate path relies on.  Any S >= 1: the last tile is
// masked by its length, never padded in memory.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TT = 32;          // tokens per tile

size_t smem_floats(int D) {
  return 4 * (size_t)TT * D     // r, k, v, w tiles
         + (size_t)TT * THREADS // partial outputs, G x D per token
         + TT;                  // bonus term per token
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
wkv6_kernel(const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ w, const float* __restrict__ u,
            const float* __restrict__ init_state, T* __restrict__ y,
            float* __restrict__ state_out, int S, int H) {
  constexpr int G = THREADS / D;   // k groups
  constexpr int KPT = D / G;       // state rows a thread owns
  extern __shared__ float smem[];
  float* rs = smem;                // TT x D
  float* ks = rs + TT * D;
  float* vs = ks + TT * D;
  float* ws = vs + TT * D;
  float* part = ws + TT * D;       // TT x G x D
  float* bonus = part + TT * THREADS;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int vi = tid % D;
  const int g = tid / D;
  const int k0 = g * KPT;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int64_t st_base = ((int64_t)b * H + h) * D * D;
  const float* uh = u + (int64_t)h * D;

  float s[KPT];
#pragma unroll
  for (int q = 0; q < KPT; ++q)
    s[q] = init_state ? init_state[st_base + (int64_t)(k0 + q) * D + vi] : 0.f;

  for (int t0 = 0; t0 < S; t0 += TT) {
    const int L = min(TT, S - t0);
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < L * D; e += THREADS) {
      const int i = e / D, d = e % D;
      const int64_t gi = (((int64_t)b * S + t0 + i) * H + h) * D + d;
      rs[e] = rt::to_f32(r[gi]);
      ks[e] = rt::to_f32(k[gi]);
      vs[e] = rt::to_f32(v[gi]);
      ws[e] = fmaxf(rt::to_f32(w[gi]), 1e-30f);
    }
    __syncthreads();

    // bonus_i = sum_k r_ik u_k k_ik: one warp per token, butterfly sum
    for (int i = warp; i < L; i += THREADS / 32) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaf(rs[i * D + d] * uh[d], ks[i * D + d], a);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) bonus[i] = a;
    }
    // the recurrence on this thread's rows of column vi, token by token
    for (int i = 0; i < L; ++i) {
      const float* ri = rs + i * D + k0;
      const float* ki = ks + i * D + k0;
      const float* wi = ws + i * D + k0;
      const float vv = vs[i * D + vi];
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < KPT; ++q) {
        acc = fmaf(ri[q], s[q], acc);
        s[q] = fmaf(s[q], wi[q], ki[q] * vv);
      }
      part[(i * G + g) * D + vi] = acc;
    }
    __syncthreads();

    for (int e = tid; e < L * D; e += THREADS) {
      const int i = e / D, d = e % D;
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < G; ++q) acc += part[(i * G + q) * D + d];
      acc = fmaf(bonus[i], vs[e], acc);
      y[(((int64_t)b * S + t0 + i) * H + h) * D + d] = rt::from_f32<T>(acc);
    }
  }
#pragma unroll
  for (int q = 0; q < KPT; ++q) state_out[st_base + (int64_t)(k0 + q) * D + vi] = s[q];
}

template <typename T, int D>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* init_state, void* y, void* state_out, int B, int S, int H,
           cudaStream_t stream) {
  const size_t bytes = smem_floats(D) * sizeof(float);
  auto kernel = wkv6_kernel<T, D>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const float*>(u),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(state_out), S, H);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(int D, const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* init_state, void* y, void* state_out, int B, int S, int H,
             cudaStream_t st) {
#define RT_DIM(DD) \
  if (D == DD) return launch<T, DD>(r, k, v, w, u, init_state, y, state_out, B, S, H, st);
  RT_DIM(16) RT_DIM(32) RT_DIM(64) RT_DIM(128)
#undef RT_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// r, k, v, w, y (B,S,H,D) of one dtype (is_bf16 ? bfloat16 : float32); u (H,D),
// init_state (B,H,D,D) or null, and state_out (B,H,D,D) float32; all
// contiguous; D one of 16, 32, 64, 128.  Returns a cudaError_t as int; 0
// means the launch was accepted.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* init_state, void* y, void* state_out,
                        int B, int S, int H, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(D, r, k, v, w, u, init_state, y, state_out, B, S, H, st);
  return dispatch<float>(D, r, k, v, w, u, init_state, y, state_out, B, S, H, st);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
