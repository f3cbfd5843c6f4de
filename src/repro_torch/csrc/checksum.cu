// Chunk fingerprints and the checkpoint checksum over a uint32 word stream.
//
// Replaces: repro/kernels/checksum.py :: chunk_fingerprints_pallas
// (_chunk_fp_kernel, _chunk_fp_call) and checksum_pallas (_checksum_kernel),
// the Pallas TPU kernels of the delta plane.  Both mix each word w at index i
// as (w ^ i*16777619) * (i|1) in wrapping uint32 arithmetic and reduce the
// mixed words to XOR + SUM (mod 2^32).  chunk_fingerprints uses the index
// inside each fixed-size chunk and writes one value per chunk; checksum uses
// the index in the whole stream and writes one value.  Words past n_words
// (the zero padding of the reference's tail chunk or block) are read as zero
// without being stored anywhere: the padding never exists in device memory.
//
// What bounds them on an H100: bytes.  Each word is read once and costs six
// integer operations, far below what the SMs can issue per byte of HBM, so
// the bound is the stream's bytes over 3.35 TB/s (the 5.93 GB qwen2-0.5b
// train state: ~1.77 ms).
//
// Design.  The TPU kernels walk a sequential grid and fold the XOR with a
// reshape-halving tree in VMEM; CUDA blocks run in parallel in no order.
//  * chunk_fingerprints, chunks of 1024 words or more (the checkpoint's
//    1 MiB chunks are 262,144 words): one CTA per chunk.  Each thread reads
//    16-byte vectors, neighbouring threads on neighbouring addresses, UNROLL
//    loads in flight before it mixes them, and keeps XOR and SUM in
//    registers; the CTA reduces them by warp shuffles and then across warps
//    in shared memory, and one thread stores the chunk's value.  No atomics,
//    one store per chunk.  Smaller chunks: one thread per chunk, grid-stride.
//  * checksum: a grid-stride loop over 16-byte vectors, the same in-CTA
//    reduction, then one atomicXor and one atomicAdd per CTA into two uint32
//    accumulators.  XOR and wrapping addition commute on integers, so the
//    result does not depend on the order the CTAs finish in.  The final
//    x + s is taken by the last CTA to finish (a ticket counter after a
//    memory fence) rather than by a second kernel: one launch per call, and
//    the accumulators need only one memset on the same stream before it.
//    The checksum is not on the training path (only its tests and the
//    reference's benchmarks call it), so it gets no more tuning than that.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr uint32_t PRIME = 16777619u;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int UNROLL = 4;
constexpr long long CTA_PER_CHUNK_MIN_WORDS = 1024;
constexpr int CHECKSUM_MAX_CTAS = 132 * 8;

__device__ __forceinline__ void mix_in(uint32_t w, uint32_t i, uint32_t& x, uint32_t& s) {
  const uint32_t m = (w ^ (i * PRIME)) * (i | 1u);
  x ^= m;
  s += m;
}

__device__ __forceinline__ void mix_vec(const uint4& w, uint32_t i, uint32_t& x, uint32_t& s) {
  mix_in(w.x, i, x, s);
  mix_in(w.y, i + 1u, x, s);
  mix_in(w.z, i + 2u, x, s);
  mix_in(w.w, i + 3u, x, s);
}

// XOR and SUM of the CTA's threads, valid in thread 0 on return.
__device__ __forceinline__ void reduce_cta(uint32_t& x, uint32_t& s, uint32_t* sx,
                                           uint32_t* ss) {
  for (int off = 16; off > 0; off >>= 1) {
    x ^= __shfl_xor_sync(0xffffffffu, x, off);
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sx[warp] = x;
    ss[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    x = lane < WARPS ? sx[lane] : 0u;
    s = lane < WARPS ? ss[lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      x ^= __shfl_xor_sync(0xffffffffu, x, off);
      s += __shfl_xor_sync(0xffffffffu, s, off);
    }
  }
}

// One CTA per chunk of cw words; words at or past n read as zero.  ``vec``:
// the stream is 16-byte aligned and cw a multiple of 4, so every chunk
// starts on a 16-byte boundary.
__global__ void __launch_bounds__(THREADS)
chunk_fp_cta_kernel(const uint32_t* __restrict__ words, long long n, long long cw,
                    bool vec, uint32_t* __restrict__ out) {
  __shared__ uint32_t sx[WARPS], ss[WARPS];
  const long long base = static_cast<long long>(blockIdx.x) * cw;
  const long long avail = n - base;                  // words of this chunk in the stream
  uint32_t x = 0u, s = 0u;
  long long done = 0;                                // words [0, done) mixed by the vector loop
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(words + base);
    const long long full = (avail < cw ? avail : cw) / 4;   // whole vectors inside n
    for (long long v0 = threadIdx.x; v0 < full; v0 += THREADS * UNROLL) {
      uint4 w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + static_cast<long long>(u) * THREADS;
        w[u] = v < full ? __ldg(p + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long v = v0 + static_cast<long long>(u) * THREADS;
        if (v < full) mix_vec(w[u], static_cast<uint32_t>(4 * v), x, s);
      }
    }
    done = 4 * full;
  }
  for (long long j = done + threadIdx.x; j < cw; j += THREADS) {
    const uint32_t w = j < avail ? __ldg(words + base + j) : 0u;
    mix_in(w, static_cast<uint32_t>(j), x, s);
  }
  reduce_cta(x, s, sx, ss);
  if (threadIdx.x == 0) out[blockIdx.x] = x + s;
}

// One thread per chunk, for chunks of fewer than CTA_PER_CHUNK_MIN_WORDS words.
__global__ void __launch_bounds__(THREADS)
chunk_fp_thread_kernel(const uint32_t* __restrict__ words, long long n, long long cw,
                       long long nchunks, uint32_t* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  for (long long c = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
       c < nchunks; c += stride) {
    const long long base = c * cw;
    uint32_t x = 0u, s = 0u;
    for (long long j = 0; j < cw; ++j) {
      const uint32_t w = base + j < n ? __ldg(words + base + j) : 0u;
      mix_in(w, static_cast<uint32_t>(j), x, s);
    }
    out[c] = x + s;
  }
}

// acc[0] XOR, acc[1] SUM, acc[2] finished-CTA ticket, acc[3] the digest.
// Words in [n, n_padded) read as zero.
__global__ void __launch_bounds__(THREADS)
checksum_kernel(const uint32_t* __restrict__ words, long long n, long long n_padded,
                bool vec, uint32_t* acc) {
  __shared__ uint32_t sx[WARPS], ss[WARPS];
  __shared__ bool last;
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long tid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  uint32_t x = 0u, s = 0u;
  long long done = 0;
  if (vec) {
    const uint4* p = reinterpret_cast<const uint4*>(words);
    const long long full = n / 4;
    for (long long v = tid; v < full; v += stride)
      mix_vec(__ldg(p + v), static_cast<uint32_t>(4 * v), x, s);
    done = 4 * full;
  }
  for (long long j = done + tid; j < n_padded; j += stride) {
    const uint32_t w = j < n ? __ldg(words + j) : 0u;
    mix_in(w, static_cast<uint32_t>(j), x, s);
  }
  reduce_cta(x, s, sx, ss);
  if (threadIdx.x == 0) {
    atomicXor(acc, x);
    atomicAdd(acc + 1, s);
    __threadfence();   // this CTA's partials are visible before its ticket is
    last = atomicAdd(acc + 2, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    // every other CTA fenced before taking its ticket: read both sums atomically
    acc[3] = atomicXor(acc, 0u) + atomicAdd(acc + 1, 0u);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// words: n_words uint32 (any alignment); out: ceil(n_words / chunk_words)
// uint32; chunk_words > 0.  Returns a cudaError_t as int; 0 means the launch
// was accepted.
extern "C" int chunk_fingerprints_u32(const void* words, long long n_words,
                                      long long chunk_words, void* out, void* stream) {
  if (n_words <= 0 || chunk_words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* o = static_cast<uint32_t*>(out);
  const long long nchunks = (n_words + chunk_words - 1) / chunk_words;
  if (chunk_words >= CTA_PER_CHUNK_MIN_WORDS) {
    if (nchunks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = aligned16(words) && chunk_words % 4 == 0;
    chunk_fp_cta_kernel<<<static_cast<unsigned>(nchunks), THREADS, 0, st>>>(
        w, n_words, chunk_words, vec, o);
  } else {
    long long ctas = (nchunks + THREADS - 1) / THREADS;
    if (ctas > 65535) ctas = 65535;
    chunk_fp_thread_kernel<<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(
        w, n_words, chunk_words, nchunks, o);
  }
  return static_cast<int>(cudaGetLastError());
}

// words: n_words uint32 (any alignment), read as zero-padded to n_padded
// >= n_words; acc: 4 uint32 of scratch, the digest lands in acc[3].
extern "C" int checksum_u32(const void* words, long long n_words, long long n_padded,
                            void* acc, void* stream) {
  if (n_words <= 0 || n_padded < n_words) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(acc, 0, 4 * sizeof(uint32_t), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long ctas = (n_padded + 4LL * THREADS - 1) / (4LL * THREADS);
  if (ctas > CHECKSUM_MAX_CTAS) ctas = CHECKSUM_MAX_CTAS;
  checksum_kernel<<<static_cast<unsigned>(ctas), THREADS, 0, st>>>(
      static_cast<const uint32_t*>(words), n_words, n_padded, aligned16(words),
      static_cast<uint32_t*>(acc));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* checksum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
