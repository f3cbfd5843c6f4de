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
// which bf16 tensor cores would be the limit, so the bound is the bytes.
// What holds a kernel back is the chain of dependent steps a chunk takes
// (copies, scan, products, epilogue) against the few warps an SM holds;
// PERF.md has the measurements.
//
// The math, per chunk of Q tokens (the TPU kernel's, _ssd_pallas.py:36-59):
//   cA   = inclusive cumsum of dt*A, from the chunk start
//   s_ij = (C_i . B_j) exp(cA_i - cA_j) dt_j        for j <= i only
//   y_i  = sum_j s_ij x_j + exp(cA_i) C_i . state^T + D x_i
//   state = state exp(cA_last) + sum_j exp(cA_last - cA_j) dt_j x_j B_j^T
// Every exponent is <= 0 (dt >= 0, A < 0): cA falls along the chunk, the
// scores are exponentiated only where j <= i (the exponent is selected
// before exp, -inf above the diagonal; never a mask after it), and cA starts
// at 0 in each chunk.  The upper triangle is where the reference's XLA
// chunked form (ssd_scan.py:24-25, exp times a 0/1 mask) overflows into NaN
// at zamba2's own initialisation.  The TPU kernel walks a sequential grid
// axis and carries the state in VMEM; here a CTA walks the chunks itself.
// Any S >= 1 (the ragged last chunk is zero-filled and masked), no atomics,
// one owner per output and a fixed order for every sum: the same inputs give
// the same bits on every run, which the serving snapshot/migrate path
// relies on.  The dtype picks the kernel:
//
// * bfloat16 (every launch of the serving path): ssd_tc_kernel.  Grid
//   (P / PS, H, B): the recurrence is independent per column p of the state
//   (y[:, p] needs only state[p, :] and x[:, p]), so a CTA owns PS = 64
//   columns (16 and 32 measured slower at zamba2's shape, PERF.md) and
//   recomputes the head's C B^T.
//   Four warps own 16 token rows each; a fifth warp copies the next chunk's
//   x slice, B and C (16-byte cp.async, two stages) and dt while they
//   compute.  Every product is mma.sync.m16n8k16 bf16 with fp32
//   accumulation: G = C B^T; S = G exp(cA_i - cA_j) dt_j formed on the
//   accumulator fragments and rounded to bf16 in registers as the A operand
//   of S x (one mma's accumulator layout is the next one's A layout);
//   C state^T; and the state update (w x)^T B, whose A operand is x^T from
//   ldmatrix.trans with each column scaled by w_j and rounded to bf16 in
//   registers.  The fp32 state lives in the update product's accumulator
//   fragments for the whole sequence; each chunk it is rounded to bf16 into
//   one of two shared-memory buffers as the B operand of the next chunk's
//   C state^T (double-buffered, so the update need not wait for the reads).
//   Each warp scans cA itself, so a chunk takes one barrier.  P and N are
//   zero-padded to the tile in shared memory (N up to 128); rows must start
//   on 16-byte boundaries, so the wrapper pads P and N in memory to
//   multiples of 8 and copies a view off a 16-byte boundary.
// * float32: ssd_scan_kernel, fp32 FMAs on the CUDA cores, one CTA of 256
//   threads per (batch, head) with the state in shared memory.  This keeps
//   float32 exact (no bf16 or TF32 rounding), which the float32 reference
//   checks of the port (5e-5 of the sequential oracle) rely on.
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


// ---- bfloat16: tensor cores ------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using rt::a_tile_row;
using rt::b_tile_row;
using rt::ex2;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma;
using rt::pack_bf16;

constexpr int Q = 64;          // tokens per chunk: 4 warps x 16 rows
constexpr int PS = 64;         // columns of P per CTA
constexpr int MMA_WARPS = 4;
constexpr int THREADS = (MMA_WARPS + 1) * 32;   // and one warp that issues the copies
constexpr int PAD = 8;         // bf16 elements (16 bytes) of row padding
constexpr float LOG2E = 1.4426950408889634f;

template <int NT>
struct Smem {
  static constexpr int XLD = PS + PAD, NLD = NT + PAD;
  static constexpr size_t bf16s = 2 * (size_t)Q * XLD       // x slice, two stages
                                  + 4 * (size_t)Q * NLD     // B and C, two stages
                                  + 2 * (size_t)PS * NLD;   // the state as an operand, two
  static constexpr size_t floats = 2 * Q + MMA_WARPS * 3 * Q;   // dt (two stages); per
                                                                // warp cA, e^cA, w
  static constexpr size_t bytes = bf16s * sizeof(bf16) + floats * sizeof(float);
};

template <int NT>
__global__ void __launch_bounds__(THREADS)
ssd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
              const float* __restrict__ A_log, const bf16* __restrict__ Bm,
              const bf16* __restrict__ Cm, const float* __restrict__ Dskip,
              const float* __restrict__ init_state, bf16* __restrict__ y,
              float* __restrict__ state_out, int S, int H, int P, int N) {
  using SM = Smem<NT>;
  constexpr int XLD = SM::XLD, NLD = SM::NLD;
  constexpr int MT = PS / 16, NPAIR = NT / 16;              // state tiles: 16 p x 16 n
  constexpr int UPW = (MT * NPAIR + MMA_WARPS - 1) / MMA_WARPS;   // state tiles a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // 2 x Q x XLD
  bf16* bs = xs + 2 * Q * XLD;                     // 2 x Q x NLD
  bf16* cs = bs + 2 * Q * NLD;                     // 2 x Q x NLD
  bf16* sop = cs + 2 * Q * NLD;                    // 2 x PS x NLD, [p][n]
  float* dts = reinterpret_cast<float*>(sop + 2 * PS * NLD);   // 2 x Q

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int p0 = blockIdx.x * PS, h = blockIdx.y, b = blockIdx.z;
  const bool loader = warp == MMA_WARPS;
  float* cA = dts + 2 * Q + (loader ? 0 : warp) * 3 * Q;   // this warp's cA, e^cA, w
  float* eA = cA + Q;
  float* wj = eA + Q;
  const float A = -expf(A_log[h]);
  const float Dh = Dskip[h];
  const int n_chunks = (S + Q - 1) / Q;

  // The loader warp copies chunk c's x slice, B and C into stage c & 1
  // (16-byte cp.async; rows past S and columns past P or N land as zeros)
  // and dt into dts, then waits for its copies; the other warps compute
  // meanwhile.
  auto load = [&](int c) {
    const int t0 = c * Q, stg = c & 1;
    bf16* xt = xs + stg * Q * XLD;
    bf16* bt = bs + stg * Q * NLD;
    bf16* ct = cs + stg * Q * NLD;
#pragma unroll 4
    for (int e = lane; e < Q * (PS / 8); e += 32) {
      const int r = e / (PS / 8), ch = e % (PS / 8);
      const bool ok = t0 + r < S && p0 + ch * 8 < P;
      const bf16* src = ok ? x + (((int64_t)b * S + t0 + r) * H + h) * P + p0 + ch * 8 : x;
      rt::cp_async16(xt + r * XLD + ch * 8, src, ok);
    }
#pragma unroll 4
    for (int e = lane; e < Q * (NT / 8); e += 32) {
      const int r = e / (NT / 8), ch = e % (NT / 8);
      const bool ok = t0 + r < S && ch * 8 < N;
      const int64_t off = ok ? ((int64_t)b * S + t0 + r) * N + ch * 8 : 0;
      rt::cp_async16(bt + r * NLD + ch * 8, Bm + off, ok);
      rt::cp_async16(ct + r * NLD + ch * 8, Cm + off, ok);
    }
    rt::cp_async_commit();
#pragma unroll
    for (int i = lane; i < Q; i += 32)
      dts[stg * Q + i] =
          t0 + i < S ? __bfloat162float(dt[((int64_t)b * S + t0 + i) * H + h]) : 0.f;
    rt::cp_async_wait<0>();
  };

  // the fp32 state: this warp's tiles (u -> 16 p rows x 16 n cols, as two
  // 8-col accumulator blocks), in registers for the whole sequence
  float st[UPW][2][4];
  const int64_t st_base = ((int64_t)b * H + h) * P * N;
  auto has_unit = [&](int u) { return !loader && warp + MMA_WARPS * u < MT * NPAIR; };
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = warp + MMA_WARPS * u, mt = unit / NPAIR, np = unit % NPAIR;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + g + (e >> 1) * 8, n = np * 16 + hb * 8 + 2 * tq + (e & 1);
        st[u][hb][e] = (has_unit(u) && init_state && p0 + p < P && n < N)
                           ? init_state[st_base + (int64_t)(p0 + p) * N + n] : 0.f;
      }
  }
  // the state rounded to bf16 as the B operand of C state^T ([p][n])
  auto store_op = [&](bf16* op) {
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + MMA_WARPS * u, mt = unit / NPAIR, np = unit % NPAIR;
      if (!has_unit(u)) continue;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = mt * 16 + g + r * 8, n = np * 16 + hb * 8 + 2 * tq;
          *reinterpret_cast<unsigned*>(op + p * NLD + n) =
              pack_bf16(st[u][hb][2 * r], st[u][hb][2 * r + 1]);
        }
    }
  };
  store_op(sop);
  if (loader) load(0);

  // One barrier a chunk.  Each warp keeps its own copy of cA, e^cA and w;
  // the state operand is double-buffered (chunk c reads stage c & 1 and
  // writes the other), so a warp may update the state while another still
  // reads the incoming one.
  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q, L = min(Q, S - t0), stg = c & 1;
    const bf16* xt = xs + stg * Q * XLD;
    const bf16* bt = bs + stg * Q * NLD;
    const bf16* ct = cs + stg * Q * NLD;
    const bf16* op_in = sop + stg * PS * NLD;
    bf16* op_out = sop + (stg ^ 1) * PS * NLD;
    const float* dtc = dts + stg * Q;
    __syncthreads();                     // chunk c has landed; chunk c-1 is done with
    if (loader) {                        // ... the other stage: copy chunk c+1 into it
      if (c + 1 < n_chunks) load(c + 1);
      continue;
    }

    // cA = inclusive cumsum of dt A (two tokens a lane), relative to the
    // chunk start; tokens past L have dt = 0, so cA there stays at cA_last
    {
      const int i0 = 2 * lane, i1 = i0 + 1;
      const float a0 = dtc[i0] * A, a1 = dtc[i1] * A;
      float sum = a0 + a1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, sum, off);
        if (lane >= off) sum += o;
      }
      const float c0 = (sum - (a0 + a1)) + a0, c1 = c0 + a1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cA[i0] = c0;
      cA[i1] = c1;
      eA[i0] = ex2(c0 * LOG2E);
      eA[i1] = ex2(c1 * LOG2E);
      wj[i0] = ex2((last - c0) * LOG2E) * dtc[i0];
      wj[i1] = ex2((last - c1) * LOG2E) * dtc[i1];
    }
    __syncwarp();

    // C fragments of this warp's 16 rows (A operand of C B^T and C state^T)
    unsigned cf[NT / 16][4];
#pragma unroll
    for (int kn = 0; kn < NT / 16; ++kn)
      ldmatrix_x4(cf[kn], a_tile_row(ct, NLD, warp * 16, kn * 16, lane, false));
    // G = C B^T: 16 rows x 64 tokens, 8 accumulator blocks of 8 tokens
    float s[Q / 8][4];
#pragma unroll
    for (int i = 0; i < Q / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NT / 16; ++kn)
#pragma unroll
      for (int jb = 0; jb < Q / 16; ++jb) {
        unsigned bb[4];
        ldmatrix_x4(bb, b_tile_row(bt, NLD, kn * 16, jb * 16, lane, false));
        mma(s[2 * jb], cf[kn], bb[0], bb[1]);
        mma(s[2 * jb + 1], cf[kn], bb[2], bb[3]);
      }
    // y starts as C state^T (the incoming state), scaled by e^cA_i below
    float ya[PS / 8][4];
#pragma unroll
    for (int i = 0; i < PS / 8; ++i) ya[i][0] = ya[i][1] = ya[i][2] = ya[i][3] = 0.f;
#pragma unroll
    for (int kn = 0; kn < NT / 16; ++kn)
#pragma unroll
      for (int pb = 0; pb < PS / 16; ++pb) {
        unsigned bo[4];
        ldmatrix_x4(bo, b_tile_row(op_in, NLD, kn * 16, pb * 16, lane, false));
        mma(ya[2 * pb], cf[kn], bo[0], bo[1]);
        mma(ya[2 * pb + 1], cf[kn], bo[2], bo[3]);
      }

    // S_ij = G_ij exp(cA_i - cA_j) dt_j.  The exponent is selected before
    // exp: cA_i - cA_j (<= 0) where j <= i, -inf above the diagonal (exp
    // gives 0), so no exponent is ever positive.  Rounded to bf16 in
    // registers as the A operand of S x.
    const int i_lo = warp * 16 + g;
    const float cai[2] = {cA[i_lo], cA[i_lo + 8]};
    const float eai[2] = {eA[i_lo], eA[i_lo + 8]};
    unsigned pf[Q / 16][4];
#pragma unroll
    for (int jb = 0; jb < Q / 8; ++jb) {
      const int j0 = jb * 8 + 2 * tq;
      const float2 caj = *reinterpret_cast<const float2*>(cA + j0);
      const float2 dtj = *reinterpret_cast<const float2*>(dtc + j0);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i_lo + (e >> 1) * 8, j = j0 + (e & 1);
        const float d = (e & 1) ? caj.y : caj.x;
        const float ex = ex2((j <= i ? cai[e >> 1] - d : -INFINITY) * LOG2E);
        v[e] = s[jb][e] * ex * ((e & 1) ? dtj.y : dtj.x);
      }
      pf[jb >> 1][(jb & 1) * 2] = pack_bf16(v[0], v[1]);
      pf[jb >> 1][(jb & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
    // y = e^cA_i (C state^T) + S x + D x, this CTA's PS columns
#pragma unroll
    for (int i = 0; i < PS / 8; ++i) {
      ya[i][0] *= eai[0];
      ya[i][1] *= eai[0];
      ya[i][2] *= eai[1];
      ya[i][3] *= eai[1];
    }
#pragma unroll
    for (int kk = 0; kk < Q / 16; ++kk)
#pragma unroll
      for (int pb = 0; pb < PS / 16; ++pb) {
        unsigned bx[4];
        ldmatrix_x4_trans(bx, b_tile_row(xt, XLD, kk * 16, pb * 16, lane, true));
        mma(ya[2 * pb], pf[kk], bx[0], bx[1]);
        mma(ya[2 * pb + 1], pf[kk], bx[2], bx[3]);
      }
    unsigned xq[2][PS / 8];             // x at this thread's outputs, read before any store
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int pb = 0; pb < PS / 8; ++pb)
        xq[r][pb] = *reinterpret_cast<const unsigned*>(xt + (i_lo + r * 8) * XLD + pb * 8 + 2 * tq);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i_lo + r * 8;
      if (i >= L) continue;
      bf16* yrow = y + (((int64_t)b * S + t0 + i) * H + h) * P + p0;
#pragma unroll
      for (int pb = 0; pb < PS / 8; ++pb) {
        const int p = pb * 8 + 2 * tq;
        const float v0 = fmaf(rt::bf16_lo(xq[r][pb]), Dh, ya[pb][2 * r]);
        const float v1 = fmaf(rt::bf16_hi(xq[r][pb]), Dh, ya[pb][2 * r + 1]);
        if (p0 + p < P) *reinterpret_cast<unsigned*>(yrow + p) = pack_bf16(v0, v1);
      }
    }

    // state = state e^cA_last + (w x)^T B, with (w x)_jp = exp(cA_last -
    // cA_j) dt_j x_jp rounded to bf16 in the A fragments (x^T from ldmatrix
    // .trans, each k column j scaled by w_j)
    const float e_last = eA[Q - 1];
#pragma unroll
    for (int u = 0; u < UPW; ++u) {
      const int unit = warp + MMA_WARPS * u, mt = unit / NPAIR, np = unit % NPAIR;
      if (!has_unit(u)) continue;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[u][hb][e] *= e_last;
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        unsigned a[4], bb[4];
        ldmatrix_x4_trans(a, a_tile_row(xt, XLD, kk * 16, mt * 16, lane, true));
        ldmatrix_x4_trans(bb, b_tile_row(bt, NLD, kk * 16, np * 16, lane, true));
        const int j0 = kk * 16 + 2 * tq;
        const float2 w01 = *reinterpret_cast<const float2*>(wj + j0);
        const float2 w89 = *reinterpret_cast<const float2*>(wj + j0 + 8);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 wp = q < 2 ? w01 : w89;
          a[q] = pack_bf16(wp.x * rt::bf16_lo(a[q]), wp.y * rt::bf16_hi(a[q]));
        }
        mma(st[u][0], a, bb[0], bb[1]);
        mma(st[u][1], a, bb[2], bb[3]);
      }
    }
    store_op(op_out);                    // read by the next chunk, after its barrier
  }

#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int unit = warp + MMA_WARPS * u, mt = unit / NPAIR, np = unit % NPAIR;
    if (!has_unit(u)) continue;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = mt * 16 + g + (e >> 1) * 8, n = np * 16 + hb * 8 + 2 * tq + (e & 1);
        if (p0 + p < P && n < N) state_out[st_base + (int64_t)(p0 + p) * N + n] = st[u][hb][e];
      }
  }
}

template <int NT>
int launch(const void* x, const void* dt, const void* A_log, const void* Bm, const void* Cm,
           const void* D, const void* init_state, void* y, void* state_out, int B, int S,
           int H, int P, int N, cudaStream_t stream) {
  const size_t bytes = Smem<NT>::bytes;
  auto kernel = ssd_tc_kernel<NT>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((P + PS - 1) / PS, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const float*>(A_log), static_cast<const bf16*>(Bm),
      static_cast<const bf16*>(Cm), static_cast<const float*>(D),
      static_cast<const float*>(init_state), static_cast<bf16*>(y),
      static_cast<float*>(state_out), S, H, P, N);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const void* x, const void* dt, const void* A_log, const void* Bm, const void* Cm,
             const void* D, const void* init_state, void* y, void* state_out, int B, int S,
             int H, int P, int N, cudaStream_t st) {
  if (P % 8 || N % 8) return static_cast<int>(cudaErrorInvalidValue);
#define RT_TILE(NT_) \
  if (N <= NT_)      \
    return launch<NT_>(x, dt, A_log, Bm, Cm, D, init_state, y, state_out, B, S, H, P, N, st);
  RT_TILE(16) RT_TILE(32) RT_TILE(64) RT_TILE(128)
#undef RT_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// Dynamic shared memory the float32 kernel asks for at (P, N); the wrapper
// refuses shapes above the card's 227 KB per block.
extern "C" long long ssd_scan_smem_bytes(int P, int N) {
  return static_cast<long long>(smem_floats(P, N) * sizeof(float));
}

// x (B,S,H,P), dt (B,S,H), Bm/Cm (B,S,N), y (B,S,H,P) of one dtype (is_bf16 ?
// bfloat16 on the tensor cores : float32 on the CUDA cores); A_log, D (H,),
// init_state (B,H,P,N) or null, and state_out (B,H,P,N) float32; all
// contiguous.  bfloat16 only: P and N multiples of 8, N <= 128, and x, Bm
// and Cm starting on 16-byte boundaries, so that every row does.  Returns a
// cudaError_t as int; 0 means the launch was accepted.
extern "C" int ssd_scan_fwd(const void* x, const void* dt, const void* A_log, const void* Bm,
                            const void* Cm, const void* D, const void* init_state, void* y,
                            void* state_out, int B, int S, int H, int P, int N, int is_bf16,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return tc::dispatch(x, dt, A_log, Bm, Cm, D, init_state, y, state_out, B, S, H, P, N, st);
  return launch<float>(x, dt, A_log, Bm, Cm, D, init_state, y, state_out, B, S, H, P, N, st);
}

extern "C" const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
