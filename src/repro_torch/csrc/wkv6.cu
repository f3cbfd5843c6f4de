// RWKV6 WKV: the data-dependent-decay recurrence over a whole sequence,
// with the fp32 (D, D) state of each (batch, head) kept on chip.
//
// Replaces: repro/kernels/_rwkv6_pallas.py :: wkv6_pallas (_wkv_kernel), the
// Pallas TPU kernel behind ops.wkv6 that runs in every rwkv6 layer's
// prefill.  Same contract as ref.wkv6: r, k, v, w (B,S,H,D) in the compute
// dtype, u (H,D) fp32, an optional fp32 initial state (B,H,D,D) mapping the
// k dim to the v dim; y (B,S,H,D) in r's dtype and the fp32 final state out.
//     y_t = r_t . (state + u * k_t v_t^T);   state = diag(w_t) state + k_t v_t^T
//
// Why no exponent here can overflow.  The TPU kernel works a chunk of 128
// tokens through r * exp(cw_prev) and k * exp(-cw), with cw the cumulative
// log-decay.  At rwkv6's own decay initialisation a channel's cw passes -88
// inside a chunk, exp(-cw) overflows fp32 while exp(cw_prev) underflows to
// 0, and 0 * inf is NaN (ROADMAP.md section 3).  Both kernels here only ever
// multiply by decays of the form prod w_t or 2^(cw_a - cw_b) with cw_a <=
// cw_b: w is clamped below at 1e-30 as the TPU kernel clamps it before its
// log (_rwkv6_pallas.py:34), so for any w in [1e-30, 1] every such factor
// is in [0, 1].  A factor that underflows to 0 is a decay below 2^-126,
// which no sum here can see.
//
// What bounds it on an H100: bytes.  The recurrence does about 4 D^2 flops
// per token and head against 10 D bytes moved (bf16 r/k/v/w in, y out),
// about 26 flops per byte at D = 64, far under the ~295 of the tensor cores.
// What holds a kernel back is the chain of dependent steps a chunk takes
// against the few warps an SM holds (PERF.md has the measurements).  No
// atomics and a fixed order for every sum: the same inputs give the same
// bits on every run, which the serving snapshot/migrate path relies on.
// The dtype picks the kernel:
//
// * bfloat16 (every launch of the serving path): wkv6_tc_kernel, a chunked
//   form on the tensor cores.  Grid (D / VS, H, B): the state's v columns
//   are independent, so a CTA owns VS = min(64, D) of them (16 and 32
//   measured slower at rwkv6's shape, PERF.md).  Eight warps compute; a ninth copies the next chunk's r, k, w
//   and v slice (16-byte cp.async, two stages).  A chunk is 32 tokens in
//   four sub-blocks of 8.  Per channel, cw_t = sum_{s<=t} log2 w_s from the
//   chunk start (a sum of terms <= 0, so it never increases along t), and
//   then, every exponent <= 0:
//     r_dec_i = r_i 2^cw_{i-1},  k_carry_j = k_j 2^(cw_last - cw_j),
//     total = 2^cw_last,
//     A_ij  = sum_k r_ik k_jk prod_{j<t<i} w_tk   (j < i, same sub-block;
//             fp32 on the CUDA cores as a running product, each factor <= 1)
//     A_jj  = sum_k r_jk u_k k_jk                 (the bonus)
//     A_ij  = r~_i . k~_j for j in an earlier sub-block J with last token m,
//             r~_i = r_i 2^(cw_{i-1} - cw_m), k~_j = k_j 2^(cw_m - cw_j):
//             the reference point m lies between the two tokens, so both
//             factors are <= 1 (mma over the channels, in registers)
//     y     = A v + r_dec State
//     State = diag(total) State + k_carry^T v
//   The products are mma.sync.m16n8k16 bf16 with fp32 accumulation; r_dec,
//   k_carry, r~, k~ and A are rounded to bf16 as operands.  The fp32 state
//   lives in the update product's accumulator fragments for the whole
//   sequence; each chunk it is rounded to bf16 into one of two shared-memory
//   buffers as the B operand of the next chunk's r_dec State.
// * float32: wkv6_kernel, the recurrence token by token on the CUDA cores
//   (s = s w + k v, one multiply by w_t <= 1 a step), one CTA per (batch,
//   head), each thread holding D/G rows of one column of the state in
//   registers, tiles of 32 tokens staged in shared memory.  This keeps
//   float32 exact (no bf16 or TF32 rounding), which the float32 reference
//   checks of the port (1e-4 of the sequential oracle) rely on.
//
// Any S >= 1: the last chunk or tile is masked by its length, never padded
// in memory.
#include <type_traits>

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


// ---- bfloat16: tensor cores ------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
using rt::a_tile_row;
using rt::b_tile_row;
using rt::bf16_hi;
using rt::bf16_lo;
using rt::ex2;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::lg2;
using rt::mma;
using rt::pack_bf16;

constexpr int SB = 8;          // tokens a sub-block
constexpr int NB = 4;          // sub-blocks a chunk
constexpr int Q = NB * SB;     // tokens a chunk
constexpr int COMPUTE = 256;   // threads that compute
constexpr int WARPS = COMPUTE / 32;
constexpr int THREADS = COMPUTE + 32;   // and one warp that issues the copies
constexpr int KG = COMPUTE / Q;                             // channel groups, diagonal scores
constexpr int PAD = 8;         // bf16 elements (16 bytes) of row padding
constexpr int ALD = Q + PAD;
constexpr float W_MIN = 1e-30f;
// rows of the decayed operands: k~ (sub-blocks 0 .. NB-2), r~J (the rows
// past sub-block J, for each J < NB-1)
constexpr int KT_ROWS = (NB - 1) * SB, RT_ROWS = (NB - 1) * NB / 2 * SB;

template <int D, int VS>
struct Smem {
  static constexpr int DLD = D + PAD, VLD = VS + PAD, CLD = D + 4;
  static constexpr size_t bf16s = 2 * 3 * (size_t)Q * DLD     // r, k, w, two stages
                                  + 2 * (size_t)Q * VLD       // v slice, two stages
                                  + 3 * (size_t)Q * DLD       // r_dec, k_carry, k~
                                  + (NB - 1) * (size_t)Q * DLD   // r~J
                                  + (size_t)Q * ALD           // A's diagonal sub-blocks
                                  + 2 * (size_t)D * VLD;      // the state operand, two
  static constexpr size_t floats = (size_t)Q * CLD            // cw
                                   + (size_t)NB * SB * SB * KG + D;   // partials, total
  static constexpr size_t bytes = bf16s * sizeof(bf16) + floats * sizeof(float);
};

// n consecutive bf16 (16-byte aligned when n >= 8) as floats
template <int n>
__device__ __forceinline__ void load_f32(float (&out)[n], const bf16* p) {
  if constexpr (n % 8 == 0) {
#pragma unroll
    for (int q = 0; q < n / 8; ++q) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[q];
      const bf16* hv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e) out[q * 8 + e] = __bfloat162float(hv[e]);
    }
  } else {
#pragma unroll
    for (int e = 0; e < n; ++e) out[e] = __bfloat162float(p[e]);
  }
}

template <int D, int VS>
__global__ void __launch_bounds__(THREADS)
wkv6_tc_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ init_state,
               bf16* __restrict__ y, float* __restrict__ state_out, int S, int H) {
  using SM = Smem<D, VS>;
  constexpr int DLD = SM::DLD, VLD = SM::VLD, CLD = SM::CLD;
  constexpr int CPK = D / KG;                                // channels a thread scores
  constexpr int MT = D / 16, NPAIR = VS / 16;                // state tiles: 16 k x 16 v
  constexpr int UPW = (MT * NPAIR + WARPS - 1) / WARPS;
  static_assert(D % KG == 0 && KG % 4 == 0 && 2 * D <= COMPUTE, "channel split");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* rs = reinterpret_cast<bf16*>(smem_raw);   // 2 x Q x DLD
  bf16* ks = rs + 2 * Q * DLD;
  bf16* ws = ks + 2 * Q * DLD;
  bf16* vs = ws + 2 * Q * DLD;                     // 2 x Q x VLD
  bf16* rdec = vs + 2 * Q * VLD;                   // Q x DLD
  bf16* kcar = rdec + Q * DLD;                     // Q x DLD
  bf16* ktil = kcar + Q * DLD;                     // Q x DLD (rows of sub-blocks 0 .. NB-2)
  bf16* rtil = ktil + Q * DLD;                     // (NB-1) x Q x DLD (rows past sub-block J)
  bf16* As = rtil + (NB - 1) * Q * DLD;            // Q x ALD
  bf16* sop = As + Q * ALD;                        // 2 x D x VLD, [k][v]
  float* cw = reinterpret_cast<float*>(sop + 2 * D * VLD);   // Q x CLD
  float* part = cw + Q * CLD;                      // NB x SB x SB x KG
  float* total = part + NB * SB * SB * KG;         // D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int v0 = blockIdx.x * VS, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + Q - 1) / Q;
  const int64_t row_stride = (int64_t)H * D;
  const int64_t base = (int64_t)b * S * row_stride + (int64_t)h * D;
  const bool loader = warp == WARPS;

  // The loader warp copies chunk c's r, k, w rows and v slice into stage
  // c & 1 (rows past S land as zeros); the other warps compute meanwhile.
  auto load = [&](int c) {
    const int t0 = c * Q, stg = c & 1;
#pragma unroll 4
    for (int e = lane; e < Q * (D / 8); e += 32) {
      const int row = e / (D / 8), ch = e % (D / 8);
      const bool ok = t0 + row < S;
      const int64_t off = ok ? base + (t0 + row) * row_stride + ch * 8 : 0;
      const int so = (stg * Q + row) * DLD + ch * 8;
      rt::cp_async16(rs + so, r + off, ok);
      rt::cp_async16(ks + so, k + off, ok);
      rt::cp_async16(ws + so, w + off, ok);
    }
#pragma unroll 4
    for (int e = lane; e < Q * (VS / 8); e += 32) {
      const int row = e / (VS / 8), ch = e % (VS / 8);
      const bool ok = t0 + row < S;
      const int64_t off = ok ? base + (t0 + row) * row_stride + v0 + ch * 8 : 0;
      rt::cp_async16(vs + (stg * Q + row) * VLD + ch * 8, v + off, ok);
    }
    rt::cp_async_commit();
  };
  if (loader) {
    load(0);
    rt::cp_async_wait<0>();
  }

  // A outside its diagonal sub-blocks is never written: zeros
  for (int e = tid; e < Q * ALD; e += THREADS) As[e] = __float2bfloat16(0.f);
  auto has_unit = [&](int uu) { return !loader && warp + WARPS * uu < MT * NPAIR; };

  // the fp32 state: this warp's tiles (16 k rows x 16 v cols as two 8-col
  // accumulator blocks), in registers for the whole sequence
  float st[UPW][2][4];
  const int64_t st_base = ((int64_t)b * H + h) * D * D;
#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {
    const int unit = warp + WARPS * uu, mt = unit / NPAIR, np = unit % NPAIR;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = mt * 16 + g + (e >> 1) * 8, vc = np * 16 + hb * 8 + 2 * tq + (e & 1);
        st[uu][hb][e] = (has_unit(uu) && init_state)
                            ? init_state[st_base + (int64_t)kr * D + v0 + vc] : 0.f;
      }
  }
  // the state rounded to bf16 as the B operand of r_dec State ([k][v])
  auto store_op = [&](bf16* op) {
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      const int unit = warp + WARPS * uu, mt = unit / NPAIR, np = unit % NPAIR;
      if (!has_unit(uu)) continue;
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr)
          *reinterpret_cast<unsigned*>(op + (mt * 16 + g + rr * 8) * VLD + np * 16 + hb * 8 +
                                       2 * tq) =
              pack_bf16(st[uu][hb][2 * rr], st[uu][hb][2 * rr + 1]);
    }
  };
  store_op(sop);

  // this thread's (sub-block, token j, channel group) of the diagonal
  // sub-blocks' scores, and its share of the bonus u
  const int blk = tid / (SB * KG) % NB, jl = tid / KG % SB, kg = tid % KG;
  const int jj = blk * SB + jl, c0 = kg * CPK;
  float uk[CPK];
#pragma unroll
  for (int e = 0; e < CPK; ++e) uk[e] = u[(int64_t)h * D + c0 + e];

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * Q, L = min(Q, S - t0), stg = c & 1;
    const bf16* rt_ = rs + stg * Q * DLD;
    const bf16* kt = ks + stg * Q * DLD;
    const bf16* wt = ws + stg * Q * DLD;
    const bf16* vt = vs + stg * Q * VLD;
    const bf16* op_in = sop + stg * D * VLD;
    bf16* op_out = sop + (stg ^ 1) * D * VLD;
    __syncthreads();                     // chunk c has landed; chunk c-1 is done with
    if (loader) {                        // ... the other stage: copy chunk c+1 into it,
      if (c + 1 < n_chunks) load(c + 1); // meet the chunk's two other barriers, and
      __syncthreads();                   // wait for the copies before the next chunk's
      __syncthreads();
      rt::cp_async_wait<0>();
      continue;
    }

    // cw_t = sum_{s<=t} log2 w_s per channel (w clamped at 1e-30; 0 past the
    // sequence's end), from the chunk start: sums of terms <= 0, so cw never
    // increases along t, in exact or in rounded arithmetic (a sum of more
    // non-positive terms, each rounding monotone).
    // Four threads a channel pair, eight tokens each (lanes 4p .. 4p+3 of a
    // warp): a running sum over the thread's tokens, then the segments'
    // totals added in order across the four lanes.
    if (tid < 2 * D) {
      const int kc = 2 * (tid / 4), seg = tid % 4;
      unsigned wq[Q / 4];
#pragma unroll
      for (int t = 0; t < Q / 4; ++t)
        wq[t] = *reinterpret_cast<const unsigned*>(wt + (seg * (Q / 4) + t) * DLD + kc);
      float s0[Q / 4], s1[Q / 4];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int t = 0; t < Q / 4; ++t) {
        const bool in = seg * (Q / 4) + t < L;
        a0 += in ? lg2(fmaxf(bf16_lo(wq[t]), W_MIN)) : 0.f;
        a1 += in ? lg2(fmaxf(bf16_hi(wq[t]), W_MIN)) : 0.f;
        s0[t] = a0;
        s1[t] = a1;
      }
      // exclusive prefix of the segment totals, in segment order
      float o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float t0_ = __shfl_sync(0xffffffffu, a0, (lane & ~3) + q);
        const float t1_ = __shfl_sync(0xffffffffu, a1, (lane & ~3) + q);
        if (q < seg) {
          o0 += t0_;
          o1 += t1_;
        }
      }
#pragma unroll
      for (int t = 0; t < Q / 4; ++t)
        *reinterpret_cast<float2*>(cw + (seg * (Q / 4) + t) * CLD + kc) =
            make_float2(o0 + s0[t], o1 + s1[t]);
    }
    // Diagonal sub-blocks, on the CUDA cores: token j against the later
    // tokens i of its sub-block over this thread's channels, A_ij = sum_k
    // r_ik k_jk prod_{j<t<i} w_tk (a running product, each factor <= 1), and
    // the bonus A_jj = sum_k r_jk u_k k_jk.  The partial sums are stored
    // after the loop, so its loads need not wait on the stores.
    {
      float kj[CPK], dec[CPK], ri[CPK], wi[CPK], pa[SB];
      load_f32(kj, kt + jj * DLD + c0);
      load_f32(ri, rt_ + jj * DLD + c0);
      float bonus = 0.f;
#pragma unroll
      for (int e = 0; e < CPK; ++e) {
        bonus = fmaf(ri[e] * uk[e], kj[e], bonus);
        dec[e] = 1.f;
      }
#pragma unroll
      for (int il = 1; il < SB; ++il) {
        const bool later = il > jl;
        load_f32(ri, rt_ + (blk * SB + il) * DLD + c0);
        load_f32(wi, wt + (blk * SB + il) * DLD + c0);
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int e = 0; e < CPK; e += 2) {
          a0 = fmaf(ri[e] * kj[e], dec[e], a0);
          if (later) dec[e] *= fmaxf(wi[e], W_MIN);
          if (e + 1 < CPK) {
            a1 = fmaf(ri[e + 1] * kj[e + 1], dec[e + 1], a1);
            if (later) dec[e + 1] *= fmaxf(wi[e + 1], W_MIN);
          }
        }
        pa[il] = a0 + a1;
      }
      float* pb = part + blk * SB * SB * KG + kg;
      pb[(jl * SB + jl) * KG] = bonus;
#pragma unroll
      for (int il = 1; il < SB; ++il)
        if (il > jl) pb[(il * SB + jl) * KG] = pa[il];
    }
    __syncthreads();                     // cw, partials

    // The decayed operands, each element on its own, as 2^(a - b) with
    // cw_a <= cw_b, so every exponent is <= 0 and no factor exceeds 1:
    //   r_dec_i = r_i 2^cw_{i-1}                 (cw_{-1} = 0)
    //   k_carry_j = k_j 2^(cw_last - cw_j)
    //   k~_j = k_j 2^(cw_m - cw_j)               (j in sub-block J, m its last token)
    //   r~J_i = r_i 2^(cw_{i-1} - cw_m)          (i past sub-block J)
    // so r~J_i . k~_j = sum_k r_ik k_jk 2^(cw_{i-1,k} - cw_{j,k}) is the score
    // of token i against token j of an earlier sub-block, with the reference
    // point m between them.  Two channels an element; each kind's inputs are
    // all read before its first store, so the loads need not wait on the
    // stores.
    auto decay = [&](auto rows, auto&& map) {
      // rows() rows of D/2 channel pairs; map(row) -> (src, dst, a, bref)
      constexpr int n = decltype(rows)::value * (D / 2);
      constexpr int IT = (n + COMPUTE - 1) / COMPUTE;
      unsigned xq[IT];
      float2 ca[IT], cb[IT];
      bf16* dst[IT];
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const int e = min(it * COMPUTE + tid, n - 1), row = e / (D / 2), kc = 2 * (e % (D / 2));
        const bf16* src;
        int a, bref;                    // exponent cw_a - cw_bref; -1 reads as 0
        map(row, src, dst[it], a, bref);
        dst[it] += kc;
        xq[it] = *reinterpret_cast<const unsigned*>(src + kc);
        ca[it] = *reinterpret_cast<const float2*>(cw + max(a, 0) * CLD + kc);
        cb[it] = *reinterpret_cast<const float2*>(cw + max(bref, 0) * CLD + kc);
        if (a < 0) ca[it] = make_float2(0.f, 0.f);
        if (bref < 0) cb[it] = make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int it = 0; it < IT; ++it) {
        const unsigned out = pack_bf16(bf16_lo(xq[it]) * ex2(fminf(ca[it].x - cb[it].x, 0.f)),
                                       bf16_hi(xq[it]) * ex2(fminf(ca[it].y - cb[it].y, 0.f)));
        if (it * COMPUTE + tid < n) *reinterpret_cast<unsigned*>(dst[it]) = out;
      }
    };
    using QR = std::integral_constant<int, Q>;
    using KR = std::integral_constant<int, KT_ROWS>;
    using RR = std::integral_constant<int, RT_ROWS>;
    decay(QR(), [&](int i, const bf16*& src, bf16*& dst, int& a, int& bref) {   // r_dec
      src = rt_ + i * DLD; dst = rdec + i * DLD; a = i - 1; bref = -1;
    });
    decay(QR(), [&](int j, const bf16*& src, bf16*& dst, int& a, int& bref) {   // k_carry
      src = kt + j * DLD; dst = kcar + j * DLD; a = Q - 1; bref = j;
    });
    decay(KR(), [&](int j, const bf16*& src, bf16*& dst, int& a, int& bref) {   // k~
      src = kt + j * DLD; dst = ktil + j * DLD; a = (j / SB + 1) * SB - 1; bref = j;
    });
    decay(RR(), [&](int rr, const bf16*& src, bf16*& dst, int& a, int& bref) {   // r~J
      // rows past sub-block J, J = 0, 1, ...: Q - SB, Q - 2 SB, ... of them
      int J = 0;
#pragma unroll
      for (int q = 1; q < NB - 1; ++q) J += rr >= q * Q - SB * q * (q + 1) / 2;
      const int i = rr - (J * Q - SB * J * (J + 1) / 2) + SB * (J + 1);
      src = rt_ + i * DLD; dst = rtil + (J * Q + i) * DLD; a = i - 1; bref = SB * (J + 1) - 1;
    });
    for (int kc = tid; kc < D; kc += COMPUTE) total[kc] = ex2(cw[(Q - 1) * CLD + kc]);
    // A's diagonal sub-blocks: the partials summed over the channel groups
    // in order, bf16
    for (int e = tid; e < NB * SB * SB; e += COMPUTE) {
      const int bb = e / (SB * SB), il = e / SB % SB, jl2 = e % SB;
      float sum = 0.f;
      if (jl2 <= il) {
        const float4* pp =
            reinterpret_cast<const float4*>(part + ((bb * SB + il) * SB + jl2) * KG);
#pragma unroll
        for (int q = 0; q < KG / 4; ++q) {
          const float4 f = pp[q];
          sum += f.x;
          sum += f.y;
          sum += f.z;
          sum += f.w;
        }
      }
      As[(bb * SB + il) * ALD + bb * SB + jl2] = __float2bfloat16(sum);
    }
    __syncthreads();                     // r_dec, k_carry, k~, r~, total, A's diagonal

    // y = A v + r_dec State, one (16 rows, 16 columns) job a warp.  A's
    // diagonal sub-blocks come from shared memory; below them, the block of
    // rows against sub-block J's 8 columns is r~J k~^T (mma over the
    // channels), rounded to bf16 in registers where it lands in the A
    // fragment (the accumulator layout of two 8-column blocks is the A
    // layout of one 16-column step).
    for (int job = warp; job < (Q / 16) * NPAIR; job += WARPS) {
      const int mt = job / NPAIR, np = job % NPAIR;
      float off[NB - 1][4];             // rows mt*16.., columns of sub-block J
#pragma unroll
      for (int J = 0; J < NB - 1; ++J) off[J][0] = off[J][1] = off[J][2] = off[J][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
        for (int J = 0; J < NB - 1; ++J) {
          if (SB * J >= mt * 16 + 16 - SB) continue;   // no row of the tile is past J
          unsigned a[4], b0, b1;
          ldmatrix_x4(a, a_tile_row(rtil + J * Q * DLD, DLD, mt * 16, kk * 16, lane, false));
          rt::ldmatrix_x2_b(b0, b1, ktil, DLD, kk * 16, SB * J, lane);
          mma(off[J], a, b0, b1);
        }
      float acc[2][4] = {};
      unsigned a[4], bb[4];
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        ldmatrix_x4(a, a_tile_row(As, ALD, mt * 16, kk * 16, lane, false));
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int rb = 2 * mt + (q & 1), cb = 2 * kk + (q >> 1);   // sub-blocks
          if (cb < rb) {
            const float* o = off[cb];
            a[q] = pack_bf16(o[2 * (q & 1)], o[2 * (q & 1) + 1]);
          }
        }
        ldmatrix_x4_trans(bb, b_tile_row(vt, VLD, kk * 16, np * 16, lane, true));
        mma(acc[0], a, bb[0], bb[1]);
        mma(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        ldmatrix_x4(a, a_tile_row(rdec, DLD, mt * 16, kk * 16, lane, false));
        ldmatrix_x4_trans(bb, b_tile_row(op_in, VLD, kk * 16, np * 16, lane, true));
        mma(acc[0], a, bb[0], bb[1]);
        mma(acc[1], a, bb[2], bb[3]);
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int i = mt * 16 + g + rr * 8;
        if (i >= L) continue;
        bf16* yrow = y + base + (t0 + i) * row_stride + v0 + np * 16 + 2 * tq;
#pragma unroll
        for (int hb = 0; hb < 2; ++hb)
          *reinterpret_cast<unsigned*>(yrow + hb * 8) =
              pack_bf16(acc[hb][2 * rr], acc[hb][2 * rr + 1]);
      }
    }

    // State = diag(total) State + k_carry^T v
#pragma unroll
    for (int uu = 0; uu < UPW; ++uu) {
      const int unit = warp + WARPS * uu, mt = unit / NPAIR, np = unit % NPAIR;
      if (!has_unit(uu)) continue;
      const float t_lo = total[mt * 16 + g], t_hi = total[mt * 16 + g + 8];
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        st[uu][hb][0] *= t_lo;
        st[uu][hb][1] *= t_lo;
        st[uu][hb][2] *= t_hi;
        st[uu][hb][3] *= t_hi;
      }
#pragma unroll
      for (int kk = 0; kk < Q / 16; ++kk) {
        unsigned a[4], bb[4];
        ldmatrix_x4_trans(a, a_tile_row(kcar, DLD, kk * 16, mt * 16, lane, true));
        ldmatrix_x4_trans(bb, b_tile_row(vt, VLD, kk * 16, np * 16, lane, true));
        mma(st[uu][0], a, bb[0], bb[1]);
        mma(st[uu][1], a, bb[2], bb[3]);
      }
    }
    store_op(op_out);                    // read by the next chunk, after its first barrier
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int uu = 0; uu < UPW; ++uu) {
    const int unit = warp + WARPS * uu, mt = unit / NPAIR, np = unit % NPAIR;
    if (!has_unit(uu)) continue;
#pragma unroll
    for (int hb = 0; hb < 2; ++hb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kr = mt * 16 + g + (e >> 1) * 8, vc = np * 16 + hb * 8 + 2 * tq + (e & 1);
        state_out[st_base + (int64_t)kr * D + v0 + vc] = st[uu][hb][e];
      }
  }
}

template <int D, int VS>
int launch(const void* r, const void* k, const void* v, const void* w, const void* u,
           const void* init_state, void* y, void* state_out, int B, int S, int H,
           cudaStream_t stream) {
  const size_t bytes = Smem<D, VS>::bytes;
  auto kernel = wkv6_tc_kernel<D, VS>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(D / VS, H, B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(w), static_cast<const float*>(u),
      static_cast<const float*>(init_state), static_cast<bf16*>(y),
      static_cast<float*>(state_out), S, H);
  return static_cast<int>(cudaGetLastError());
}

// VS = min(64, D) state columns a CTA
int dispatch(int D, const void* r, const void* k, const void* v, const void* w,
             const void* u, const void* init_state, void* y, void* state_out, int B, int S,
             int H, cudaStream_t st) {
#define RT_TILE(DD, VV) \
  if (D == DD) return launch<DD, VV>(r, k, v, w, u, init_state, y, state_out, B, S, H, st);
  RT_TILE(16, 16) RT_TILE(32, 32) RT_TILE(64, 64) RT_TILE(128, 64)
#undef RT_TILE
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace tc

}  // namespace

// r, k, v, w, y (B,S,H,D) of one dtype (is_bf16 ? bfloat16 on the tensor
// cores : float32 on the CUDA cores); u (H,D), init_state (B,H,D,D) or
// null, and state_out (B,H,D,D) float32; all contiguous; D one of 16, 32,
// 64, 128.  bfloat16 only: every tensor 16-byte aligned.  Returns a
// cudaError_t as int; 0 means the launch was accepted.
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const void* u, const void* init_state, void* y, void* state_out,
                        int B, int S, int H, int D, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return tc::dispatch(D, r, k, v, w, u, init_state, y, state_out, B, S, H, st);
  return dispatch<float>(D, r, k, v, w, u, init_state, y, state_out, B, S, H, st);
}

extern "C" const char* wkv6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
