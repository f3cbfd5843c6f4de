// Mamba2 SSD scan: the selective state-space recurrence over a whole
// sequence, with the fp32 (P, N) state of each (batch, head) kept on chip.
//
// Replaces: repro/kernels/_ssd_pallas.py :: ssd_pallas (_ssd_kernel), the
// Pallas TPU kernel behind ops.ssd that runs in every mamba2 layer's
// prefill.  Same contract as ref.ssd: x (B,S,H,P), dt (B,S,H) and the
// single-group B/C (B,S,N) in the compute dtype, A_log and D (H,) fp32,
// an optional fp32 initial state (B,H,P,N); y (B,S,H,P) in x's dtype and
// the fp32 final state out.
//
// What bounds it on an H100: at zamba2's shape (P = N = 64, chunk 64) the
// chunked form does about 95 flops per byte it must move, under the ~295 at
// which bf16 tensor cores would be the limit, so the bound is the bytes;
// this first version does its products on the fp32 CUDA cores from shared
// memory, so it is far from that bound (PERF.md has its times).
//
// Design.  The TPU kernel walks a sequential grid axis over chunks and
// carries the state in VMEM scratch.  Here one CTA owns one (batch, head)
// and walks the chunks itself, in order, with the state in shared memory
// for the whole sequence.  Within a chunk of Q tokens (the TPU kernel's
// math, _ssd_pallas.py:36-59):
//   cA   = inclusive cumsum of dt*A                 (one warp scan)
//   s_ij = (C_i . B_j) exp(cA_i - cA_j) dt_j        for j <= i only
//   y_i  = sum_j s_ij x_j + exp(cA_i) C_i . state^T + D x_i
//   state = state exp(cA_last) + sum_j exp(cA_last - cA_j) dt_j x_j B_j^T
// The upper triangle (j > i) is never formed: there cA_i - cA_j > 0 and the
// exponent overflows, which is how the reference's XLA chunked form
// (ssd_scan.py:24-25, exp times a 0/1 mask) turns into NaN.  Every exponent
// the kernel takes is <= 0.  The chunk is the kernel's own constant, any
// S >= 1 works, and the ragged last chunk is masked by its length, never
// padded in memory.  Each output has one owner thread and every sum runs
// in a fixed order, with no atomics: the same inputs give the same bits on
// every run, which the serving snapshot/migrate path relies on.
#include "common.cuh"

namespace {

constexpr int Q = 64;          // tokens per chunk (the warp scan takes two a lane)
constexpr int THREADS = 256;

size_t smem_floats(int P, int N) {
  const size_t NP = (size_t)N + 1;   // rows padded against bank conflicts
  return (size_t)Q * P               // x chunk
         + 2 * (size_t)Q * NP        // B and C chunks
         + (size_t)Q * (Q + 1)       // scores
         + (size_t)P * NP            // state
         + 4 * (size_t)Q;            // dt, cA, exp(cA), exp(cA_last - cA) dt
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A_log, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ Dskip,
                const float* __restrict__ init_state, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N) {
  extern __shared__ float smem[];
  const int NP = N + 1;
  float* xs = smem;                  // Q x P
  float* bs = xs + Q * P;            // Q x NP
  float* cs = bs + Q * NP;           // Q x NP
  float* sc = cs + Q * NP;           // Q x (Q + 1)
  float* st = sc + Q * (Q + 1);      // P x NP
  float* dts = st + P * NP;          // Q
  float* cA = dts + Q;               // Q
  float* eA = cA + Q;                // Q
  float* wj = eA + Q;                // Q

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const float A = -expf(A_log[h]);
  const float Dh = Dskip[h];
  const int64_t st_base = ((int64_t)b * H + h) * P * N;

  for (int e = tid; e < P * N; e += THREADS)
    st[(e / N) * NP + e % N] = init_state ? init_state[st_base + e] : 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    const int L = min(Q, S - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int e = tid; e < L * P; e += THREADS) {
      const int i = e / P, p = e % P;
      xs[e] = rt::to_f32(x[(((int64_t)b * S + t0 + i) * H + h) * P + p]);
    }
    for (int e = tid; e < L * N; e += THREADS) {
      const int i = e / N, n = e % N;
      const int64_t g = ((int64_t)b * S + t0) * N + e;
      bs[i * NP + n] = rt::to_f32(Bm[g]);
      cs[i * NP + n] = rt::to_f32(Cm[g]);
    }
    for (int i = tid; i < L; i += THREADS)
      dts[i] = rt::to_f32(dt[((int64_t)b * S + t0 + i) * H + h]);
    __syncthreads();

    // inclusive cumsum of dt*A: one warp, two tokens a lane
    if (warp == 0) {
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float a0 = i0 < L ? dts[i0] * A : 0.f;
      const float a1 = i1 < L ? dts[i1] * A : 0.f;
      float s = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, s, off);
        if (lane >= off) s += o;
      }
      const float before = s - (a0 + a1);
      if (i0 < L) cA[i0] = before + a0;
      if (i1 < L) cA[i1] = (before + a0) + a1;
    }
    __syncthreads();
    const float c_last = cA[L - 1];
    for (int i = tid; i < L; i += THREADS) {
      eA[i] = expf(cA[i]);
      wj[i] = expf(c_last - cA[i]) * dts[i];
    }
    // scores of the lower triangle only: every exponent is <= 0
    for (int e = tid; e < L * Q; e += THREADS) {
      const int i = e / Q, j = e % Q;
      if (j > i) continue;
      const float* ci = cs + i * NP;
      const float* bj = bs + j * NP;
      float dot = 0.f;
      for (int n = 0; n < N; ++n) dot = fmaf(ci[n], bj[n], dot);
      sc[i * (Q + 1) + j] = dot * expf(cA[i] - cA[j]) * dts[j];
    }
    __syncthreads();

    // y_i = sum_{j <= i} s_ij x_j + exp(cA_i) C_i . state^T + D x_i
    for (int e = tid; e < L * P; e += THREADS) {
      const int i = e / P, p = e % P;
      const float* si = sc + i * (Q + 1);
      float acc = 0.f;
      for (int j = 0; j <= i; ++j) acc = fmaf(si[j], xs[j * P + p], acc);
      const float* ci = cs + i * NP;
      const float* sp = st + p * NP;
      float cst = 0.f;
      for (int n = 0; n < N; ++n) cst = fmaf(ci[n], sp[n], cst);
      acc = fmaf(eA[i], cst, acc);
      acc = fmaf(xs[e], Dh, acc);
      y[(((int64_t)b * S + t0 + i) * H + h) * P + p] = rt::from_f32<T>(acc);
    }
    __syncthreads();  // every reader of the incoming state is done

    // state = state exp(cA_last) + sum_j exp(cA_last - cA_j) dt_j x_j B_j^T
    const float e_last = expf(c_last);
    for (int e = tid; e < P * N; e += THREADS) {
      const int p = e / N, n = e % N;
      float acc = 0.f;
      for (int j = 0; j < L; ++j) acc = fmaf(wj[j] * xs[j * P + p], bs[j * NP + n], acc);
      st[p * NP + n] = fmaf(st[p * NP + n], e_last, acc);
    }
  }
  __syncthreads();
  for (int e = tid; e < P * N; e += THREADS) state_out[st_base + e] = st[(e / N) * NP + e % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm, const void* Cm,
           const void* D, const void* init_state, void* y, void* state_out, int B, int S,
           int H, int P, int N, cudaStream_t stream) {
  const size_t bytes = smem_floats(P, N) * sizeof(float);
  auto kernel = ssd_scan_kernel<T>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), static_cast<const float*>(A_log),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init_state), static_cast<T*>(y),
      static_cast<float*>(state_out), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Dynamic shared memory the kernel asks for at (P, N); the wrapper refuses
// shapes above the card's 227 KB per block.
extern "C" long long ssd_scan_smem_bytes(int P, int N) {
  return static_cast<long long>(smem_floats(P, N) * sizeof(float));
}

// x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,N), y (B,S,H,P) of one dtype (is_bf16 ?
// bfloat16 : float32); A_log, D (H,), init_state (B,H,P,N) or null, and
// state_out (B,H,P,N) float32; all contiguous.  Returns a cudaError_t as
// int; 0 means the launch was accepted.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                            const void* Cm, const void* D, const void* init_state, void* y,
                            void* state_out, int B, int S, int H, int P, int N, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A_log, Bm, Cm, D, init_state, y, state_out, B, S, H,
                                 P, N, st);
  return launch<float>(x, dt, A_log, Bm, Cm, D, init_state, y, state_out, B, S, H, P, N, st);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
