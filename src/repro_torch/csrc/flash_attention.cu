// Forward flash attention (causal or not, GQA, Dq may differ from Dv).
//
// Replaces: repro/kernels/flash_attention.py :: flash (_flash_kernel), the
// Pallas TPU kernel that runs prefill.  It computes the same function:
// online softmax in fp32, scale 1/sqrt(Dq) unless given, causal mask
// kpos <= qpos, masked scores NEG_INF = -1e30, l floored at 1e-30, output in
// q's dtype.
//
// What bounds it on an H100: at the main paths' shapes (S 128-512, D 64)
// the whole call is a few GFLOP against a few MB, so even at the bf16
// tensor-core peak it would take microseconds; what holds a kernel back
// there is latency (each warp's chain of copy wait, barrier, products and
// softmax per tile, the causal tail) and the issue rate of its inner loop,
// not the card's peaks (PERF.md has the measurements).
//
// Design.  The TPU kernel carries (m, l, acc) in VMEM across a sequential KV
// grid axis.  Blocks of a CUDA grid run in no order, so here one CTA owns one
// (batch, head, tile of query rows) and loops over KV tiles itself, with the
// running state in registers.  The dtype picks one of two kernels:
//
// * bfloat16 (every launch of the serving and training paths):
//   flash_fwd_bf16_kernel.  A CTA of 4 warps owns 64 query rows, 16 per
//   warp.  Both products run on the tensor cores as
//   mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32: S = Q K^T with Q's
//   fragments loaded once (ldmatrix) and K's with ldmatrix, then O += P V
//   with V's fragments from ldmatrix.trans.  The online softmax works on the
//   S accumulator fragments: a thread holds two rows, whose max takes two
//   xor shuffles inside the quad that owns the row; P is rounded to bf16 in
//   registers and fed straight back as the A operand of P V (the
//   accumulator layout of one mma is the A layout of the next), and l sums
//   the unrounded fp32 P.  Scores are kept in the log2 domain (scale *
//   log2 e folded in, ex2 on the special-function unit), which changes no
//   result beyond rounding.
//   K/V tiles of 64 keys stay bf16 in shared memory, double-buffered: tile
//   j+1's 16-byte cp.async copies are in flight while tile j's products
//   run.  Rows are padded by 16 bytes, an odd number of 16-byte units,
//   which makes every ldmatrix and cp.async free of bank conflicts.  Keys
//   past Skv and query rows past Sq are copied as zeros (src-size 0) and
//   masked; only the diagonal tile and the ragged last tile mask, and the
//   causal loop stops at the diagonal.  The grid is ordered by causal work,
//   the latest query tiles of all heads first, so the longest rows start
//   first and the SMs' loads even out.
// * float32: flash_fwd_kernel, fp32 FMAs on the CUDA cores.  Each query row
//   is split over TPR threads that own interleaved slices of Dq and Dv; the
//   partial dot products are summed with an xor butterfly (bit-identical in
//   every lane); K/V tiles are staged in shared memory.  This keeps float32
//   exact (no TF32 or bf16 rounding), which the float32 reference checks of
//   the port rely on.
//
// Both: the ragged edge is masked (the TPU kernel asserts that Sq and Skv
// divide its block sizes); the kv head of query head h is h / G for any
// group size G (qwen2-0.5b has G = 7); tile sizes are constants, never
// taken from the card, and there are no atomics, so every run gives the
// same bits.  wgmma with TMA and a producer warp, as cuDNN's Hopper kernel
// has, is the next step (ROADMAP.md).
#include "common.cuh"

namespace {

// ---- float32: CUDA cores -----------------------------------------------------

constexpr int BQ = 32;               // query rows per CTA
constexpr int BK = 32;               // keys per shared-memory tile
constexpr int TPR = 4;               // threads per query row
constexpr int THREADS = BQ * TPR;    // 128

template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int Sq, int Skv,
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
    for (int i = 0; i < QP; ++i) qr[i] = row_ok ? q[off + part + i * TPR] : 0.f;
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
      ks[j][d] = kp < Skv ? k[(((int64_t)b * Skv + kp) * Hkv + hk) * DQ + d] : 0.f;
    }
    for (int e = tid; e < BK * DV; e += THREADS) {
      const int j = e / DV, d = e % DV, kp = k0 + j;
      vs[j][d] = kp < Skv ? v[(((int64_t)b * Skv + kp) * Hkv + hk) * DV + d] : 0.f;
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
    for (int i = 0; i < VP; ++i) o[off + part + i * TPR] = acc[i] / denom;
  }
}

template <int DQ, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B, int Sq,
               int Skv, int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<DQ, DV><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Skv, H, Hkv, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- bfloat16: tensor cores ----------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;               // query rows per CTA, 16 per warp
constexpr int BN = 64;               // keys per tile
constexpr int THREADS = 128;
constexpr int STAGES = 2;            // K/V tiles in shared memory (copies in flight: STAGES-1)
constexpr int PAD = 8;               // bf16 elements (16 bytes) of row padding
constexpr float LOG2E = 1.4426950408889634f;

size_t smem_bytes(int Dq, int Dv) {
  // Q tile, STAGES K tiles, STAGES V tiles
  return sizeof(bf16) * ((size_t)BM * (Dq + PAD) + STAGES * (size_t)BN * (Dq + PAD) +
                         STAGES * (size_t)BN * (Dv + PAD));
}

using rt::ex2;
using rt::ldmatrix_x4;
using rt::ldmatrix_x4_trans;
using rt::mma;
using rt::pack_bf16;

// Fragment layouts: common.cuh.
template <int DQ, int DV>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, int Sq, int Skv,
                      int H, int Hkv, int causal, float scale_log2) {
  static_assert(DQ % 16 == 0 && DV % 16 == 0, "head dims are multiples of 16");
  constexpr int QS = DQ + PAD, KS = DQ + PAD, VS = DV + PAD;   // smem row strides
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);   // BM x QS
  bf16* ks = qs + BM * QS;                         // STAGES x BN x KS
  bf16* vs = ks + STAGES * BN * KS;                // STAGES x BN x VS

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // The grid is one axis of (query tile, head, batch) work items ordered by
  // causal work, heaviest first: every (head, batch)'s latest query tile,
  // then every second latest, ...  Blocks are handed to the SMs in index
  // order, so the long causal rows start first and each SM gets a mix.
  const int nq = (Sq + BM - 1) / BM, items = gridDim.x / nq;   // items = H * B
  const int idx = blockIdx.x;
  const int q0 = (nq - 1 - idx / items) * BM;
  const int h = idx % items % H, b = idx % items / H;
  const int hk = h / (H / Hkv);
  const int64_t q_stride = (int64_t)H * DQ, k_stride = (int64_t)Hkv * DQ,
                v_stride = (int64_t)Hkv * DV;
  const bf16* qb = q + (int64_t)b * Sq * q_stride + (int64_t)h * DQ;
  const bf16* kb = k + (int64_t)b * Skv * k_stride + (int64_t)hk * DQ;
  const bf16* vb = v + (int64_t)b * Skv * v_stride + (int64_t)hk * DV;

  // Copies of 16 bytes, a fixed number per thread (the trip counts are
  // compile-time, so the loops unroll without remainder code); rows past the
  // end read nothing and land as zeros.
  static_assert((BM * DQ / 8) % THREADS == 0 && (BN * DQ / 8) % THREADS == 0 &&
                (BN * DV / 8) % THREADS == 0, "tiles split evenly over the threads");
#pragma unroll
  for (int i = 0; i < BM * (DQ / 8) / THREADS; ++i) {
    const int c = tid + i * THREADS, r = c / (DQ / 8), ch = c % (DQ / 8), qp = q0 + r;
    rt::cp_async16(qs + r * QS + ch * 8, qb + (qp < Sq ? qp : 0) * q_stride + ch * 8, qp < Sq);
  }
  auto load_kv = [&](int stage, int k0) {
    bf16* kt = ks + stage * BN * KS;
    bf16* vt = vs + stage * BN * VS;
#pragma unroll
    for (int i = 0; i < BN * (DQ / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (DQ / 8), ch = c % (DQ / 8), kp = k0 + r;
      rt::cp_async16(kt + r * KS + ch * 8, kb + (kp < Skv ? kp : 0) * k_stride + ch * 8,
                     kp < Skv);
    }
#pragma unroll
    for (int i = 0; i < BN * (DV / 8) / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c / (DV / 8), ch = c % (DV / 8), kp = k0 + r;
      rt::cp_async16(vt + r * VS + ch * 8, vb + (kp < Skv ? kp : 0) * v_stride + ch * 8,
                     kp < Skv);
    }
  };

  // keys past the CTA's last query row are masked for every row of it
  const int kv_end = causal ? min(Skv, q0 + BM) : Skv;
  const int n_tiles = (kv_end + BN - 1) / BN;
  // group s < STAGES-1 holds tile s (group 0 also Q); a group may be empty,
  // which keeps "group j holds tile j" true at the ragged end
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) load_kv(st, st * BN);
    rt::cp_async_commit();
  }

  unsigned qf[DQ / 16][4];
  float acc[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m[2] = {rt::NEG_INF, rt::NEG_INF};   // rows g and g+8 of the warp, log2 domain
  float l[2] = {0.f, 0.f};                   // this thread's share of each row's sum
  const int row0 = q0 + warp * 16 + (lane >> 2);
  const int col = 2 * (lane & 3);

  for (int j = 0; j < n_tiles; ++j) {
    rt::cp_async_wait<STAGES - 2>();       // group j (tile j) has landed
    __syncthreads();                       // ... for every thread; tile j-1's stage is free
    const int nxt = j + STAGES - 1;
    if (nxt < n_tiles) load_kv(nxt % STAGES, nxt * BN);
    rt::cp_async_commit();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const int mi = lane >> 3;
        ldmatrix_x4(qf[kk], qs + (warp * 16 + (lane & 7) + (mi & 1) * 8) * QS + kk * 16 +
                                (mi >> 1) * 8);
      }
    }
    const int k0 = j * BN;
    const bf16* kt = ks + (j % STAGES) * BN * KS;
    const bf16* vt = vs + (j % STAGES) * BN * VS;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 accumulator blocks of 8 keys
    float s[BN / 8][4];
#pragma unroll
    for (int i = 0; i < BN / 8; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQ / 16; ++kk) {
#pragma unroll
      for (int nb = 0; nb < BN / 16; ++nb) {
        const int mi = lane >> 3;
        unsigned bk[4];
        ldmatrix_x4(bk, kt + (nb * 16 + (lane & 7) + (mi >> 1) * 8) * KS + kk * 16 +
                            (mi & 1) * 8);
        mma(s[2 * nb], qf[kk], bk[0], bk[1]);
        mma(s[2 * nb + 1], qf[kk], bk[2], bk[3]);
      }
    }

    // online softmax on the fragments; only the diagonal and ragged tiles mask
    const bool masked = k0 + BN > Skv || (causal && k0 + BN - 1 > q0 + warp * 16);
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale_log2;
        if (masked) {
          const int kp = k0 + nb * 8 + col + (e & 1);
          const int qp = row0 + (e >> 1) * 8;
          if (kp >= Skv || (causal && kp > qp)) x = rt::NEG_INF;
        }
        s[nb][e] = x;
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // the row's max over this thread's 16 scores as a tree (max is exact,
      // so the order changes no bit), then over the quad
      float t[BN / 8];
#pragma unroll
      for (int nb = 0; nb < BN / 8; ++nb) t[nb] = fmaxf(s[nb][2 * r], s[nb][2 * r + 1]);
#pragma unroll
      for (int w = BN / 16; w > 0; w /= 2)
#pragma unroll
        for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
      float mx = fmaxf(m[r], t[0]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      alpha[r] = ex2(m[r] - mx);
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    unsigned pf[BN / 16][4];   // P as the A operand of P V, 16 keys per k-step
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const float p0 = ex2(s[nb][0] - m[0]), p1 = ex2(s[nb][1] - m[0]);
      const float p2 = ex2(s[nb][2] - m[1]), p3 = ex2(s[nb][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[nb >> 1][(nb & 1) * 2] = pack_bf16(p0, p1);
      pf[nb >> 1][(nb & 1) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
      for (int db = 0; db < DV / 16; ++db) {
        const int mi = lane >> 3;
        unsigned bv[4];
        ldmatrix_x4_trans(bv, vt + (kk * 16 + (lane & 7) + (mi & 1) * 8) * VS + db * 16 +
                                  (mi >> 1) * 8);
        mma(acc[2 * db], pf[kk], bv[0], bv[1]);
        mma(acc[2 * db + 1], pf[kk], bv[2], bv[3]);
      }
    }
  }
  rt::cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int qp = row0 + r * 8;
    if (qp >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* orow = o + (((int64_t)b * Sq + qp) * H + h) * DV + col;
#pragma unroll
    for (int i = 0; i < DV / 8; ++i) {
      *reinterpret_cast<unsigned*>(orow + i * 8) =
          pack_bf16(acc[i][2 * r] / denom, acc[i][2 * r + 1] / denom);
    }
  }
}

template <int DQ, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Sq, int Skv,
           int H, int Hkv, int causal, float scale, cudaStream_t stream) {
  const size_t bytes = smem_bytes(DQ, DV);
  auto kernel = flash_fwd_bf16_kernel<DQ, DV>;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (Sq + BM - 1) / BM * H * B;
  kernel<<<blocks, THREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), Sq, Skv, H, Hkv, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

int dispatch(int is_bf16, int Dq, int Dv, const void* q, const void* k, const void* v,
             void* o, int B, int Sq, int Skv, int H, int Hkv, int causal, float scale,
             cudaStream_t st) {
#define RT_DIMS(DQ, DV)                                                          \
  if (Dq == DQ && Dv == DV)                                                      \
    return is_bf16 ? tc::launch<DQ, DV>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, st) \
                   : launch_f32<DQ, DV>(q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale, st);
  RT_DIMS(32, 32) RT_DIMS(32, 64) RT_DIMS(32, 128)
  RT_DIMS(64, 32) RT_DIMS(64, 64) RT_DIMS(64, 128)
  RT_DIMS(128, 32) RT_DIMS(128, 64) RT_DIMS(128, 128)
  RT_DIMS(192, 128)
  RT_DIMS(48, 32)     // reduced MLA prefill: nope 32 + rope 16, v 32
#undef RT_DIMS
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q (B,Sq,H,Dq), k (B,Skv,Hkv,Dq), v (B,Skv,Hkv,Dv), o (B,Sq,H,Dv), all
// contiguous, 16-byte aligned and of one dtype (is_bf16 ? bfloat16 on the
// tensor cores : float32 on the CUDA cores).  Returns a cudaError_t as int;
// 0 means the launch was accepted.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int B, int Sq, int Skv, int H, int Hkv, int Dq, int Dv,
                                   int is_bf16, int causal, float scale, void* stream) {
  return dispatch(is_bf16, Dq, Dv, q, k, v, o, B, Sq, Skv, H, Hkv, causal, scale,
                  static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
