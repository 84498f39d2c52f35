// Streaming ADC scan with a running per-query top-L, for NVIDIA Hopper
// (sm_90a): stage 1 of the two-stage search.
//
//   score[q, n] = ((part(q,0,code[n,0]) + part(q,1,code[n,1])) + ...)
//                 + bias[n] (+ qbias[q, n])
//
//   part(q, m, c) = lut[q,m,c]                  f32 tables
//                 = f32(lut[q,m,c])             f16 tables
//                 = f32(lut[q,m,c]) * scale[q,m]   i8 tables, (Q, M) scale
//
// codes (N, M) u8, luts (Q, M, K), bias (N,) f32, optional qbias (Q, N)
// f32 -> the L smallest (score, n) pairs of each query as (Q, L) f32 +
// (Q, L) int32, sorted by (score asc, n asc): bit-identical to a stable
// sort of the full (Q, N) score matrix, which is never built. Each part
// is converted (and scaled) before it joins the chain, as in
// ref.adc_scan_batch_q_ref.
//
// Replaces: src/repro/kernels/topl_scan.py::adc_scan_topl_pallas
// (pl.pallas_call at :157, body _adc_scan_topl_kernel at :47, its f16 and
// i8 faces at :66-80, in-kernel fold
// src/repro/kernels/merge.py::merge_block_topl at :122).
//
// What bounds it on this card: operations. The work is Q * N * M table
// reads and f32 adds against N * M + 4 N bytes of database that every
// query tile re-reads from L2; the byte term is ~100x below the add term
// at Q = 1000. In this kernel the real cost is the Q * N * M
// shared-memory gathers of LUT entries (random codes give bank conflicts)
// plus the top-L bookkeeping. f16 and i8 tables halve and quarter the
// LUT bytes a block holds, so more blocks fit on an SM.
//
// Design. The TPU kernel runs its N axis in order and carries the
// (block_q, L) heap from one grid step to the next in a resident output
// block. CUDA blocks run in parallel and carry nothing, so the scan is
// split in two launches of this source:
//
//   1. topl_scan_kernel<T, BQ>: grid (Q / BQ, S). A block takes BQ
//      queries (8, 4, 2 or 1; warp w owns query w) and one of S slices of
//      N. It keeps the BQ tables in shared memory (at BQ = 8, M = 8,
//      K = 256: 64 KB in f32, 32 KB in f16, 16 KB in i8, above the 48 KB
//      static limit for f32, so the launcher raises the dynamic limit),
//      and per query a sorted heap of LP = next_pow2(L) pairs plus a
//      candidate buffer of CAP pairs. The caller picks the largest BQ
//      whose shared memory fits (topl_scan.py::block_q); that is what
//      lets L reach ~16K at M = 8 and M reach 32 at K = 256. Each of the
//      32 * BQ threads scores one row per tile for all BQ queries, with
//      the chain in __fadd_rn (and the i8 scale in __fmul_rn): no
//      reassociation, no contraction, so scores equal the oracle's bit
//      for bit. A candidate that is not lexicographically below the
//      query's current L-th pair cannot enter its top L and is dropped;
//      the rest are appended to the buffer (one shared atomic per warp
//      and query). When a buffer could overflow on the next tile, the
//      warp that owns the query sorts it (bitonic network) and merges it
//      into the heap: min(heap[i], buf[LP-1-i]) is a bitonic sequence
//      holding the LP smallest pairs, and log2(LP) half-cleaner stages
//      sort it. The slice's first L pairs go to (Q, S, L) partials.
//   2. topl_merge_kernel: one block per query folds its S partial lists
//      into one heap of LP pairs (8 * LP bytes of shared memory, any LP
//      the scan takes) and writes the (Q, L) result.
//
// All compares are the total order (score asc, gid asc) on floats, so
// -0.0 == +0.0 ties break by gid, as the reference's _lex_le does. Pad
// entries are (+inf, INT32_MAX) and sort after every real pair, including
// real rows whose score is +inf (a filtered point keeps its real gid, in
// ascending gid order, as the oracle gives it). Rows at or past N are
// never scored.

#include <cstdint>
#include <climits>
#include <type_traits>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int MERGE_THREADS = 256;
constexpr int IMAX = INT_MAX;

__host__ __device__ constexpr size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

// Shared memory of one scan block: the BQ tables (and, for i8, their
// (BQ, M) scales), each region 16-byte aligned, then the heaps, the
// candidate buffers and their counts. topl_scan.py::smem_bytes mirrors it.
__host__ __device__ constexpr size_t scan_smem_bytes(int bq, int M, int K,
                                                     int LP, int lut_bytes) {
  return align16((size_t)lut_bytes * bq * M * K) +
         (lut_bytes == 1 ? align16(sizeof(float) * (size_t)bq * M) : 0) +
         (sizeof(float) + sizeof(int)) * (size_t)bq * (LP + 64 * bq) +
         sizeof(int) * (size_t)bq;
}

__device__ __forceinline__ bool lex_less(float s1, int g1, float s2, int g2) {
  return s1 < s2 || (s1 == s2 && g1 < g2);
}

__device__ __forceinline__ void swap_pair(float* s, int* g, int i, int p) {
  const float t = s[i];
  s[i] = s[p];
  s[p] = t;
  const int u = g[i];
  g[i] = g[p];
  g[p] = u;
}

// Bitonic sort of n (a power of two) pairs, ascending, by one warp.
__device__ void warp_sort(float* s, int* g, int n, int lane) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = lane; i < n; i += 32) {
        const int p = i ^ j;
        if (p > i) {
          const bool up = (i & k) == 0;
          const bool out_of_order = up ? lex_less(s[p], g[p], s[i], g[i])
                                       : lex_less(s[i], g[i], s[p], g[p]);
          if (out_of_order) swap_pair(s, g, i, p);
        }
      }
      __syncwarp();
    }
  }
}

// heap (LP sorted pairs) <- the LP smallest of heap and the first nb
// pairs of the sorted run b, by one warp.
__device__ void warp_merge(float* hs, int* hg, const float* bs, const int* bg,
                           int nb, int LP, int lane) {
  for (int i = lane; i < LP; i += 32) {
    const int j = LP - 1 - i;
    if (j < nb && lex_less(bs[j], bg[j], hs[i], hg[i])) {
      hs[i] = bs[j];
      hg[i] = bg[j];
    }
  }
  __syncwarp();
  for (int j = LP >> 1; j > 0; j >>= 1) {
    for (int i = lane; i < LP; i += 32) {
      const int p = i ^ j;
      if (p > i && lex_less(hs[p], hg[p], hs[i], hg[i])) swap_pair(hs, hg, i, p);
    }
    __syncwarp();
  }
}

// Sort query q's candidate buffer (CAP pairs per query) and fold it into
// q's heap (one warp).
template <int CAP>
__device__ void flush(float* heap_s, int* heap_g, float* buf_s, int* buf_g,
                      int* cnt, int q, int LP, int lane) {
  float* bs = buf_s + q * CAP;
  int* bg = buf_g + q * CAP;
  const int n = cnt[q];
  int p2 = 32;
  while (p2 < n) p2 <<= 1;
  for (int i = n + lane; i < p2; i += 32) {
    bs[i] = CUDART_INF_F;
    bg[i] = IMAX;
  }
  __syncwarp();
  warp_sort(bs, bg, p2, lane);
  warp_merge(heap_s + q * LP, heap_g + q * LP, bs, bg, n, LP, lane);
  if (lane == 0) cnt[q] = 0;
  __syncwarp();
}

// One table entry as the f32 part that joins the chain.
template <typename T>
__device__ __forceinline__ float lut_part(const T* lut_s, const float* scale_s,
                                          int qm, int K, int code) {
  if constexpr (std::is_same_v<T, float>) {
    return lut_s[qm * K + code];
  } else if constexpr (std::is_same_v<T, __half>) {
    return __half2float(lut_s[qm * K + code]);
  } else {
    return __fmul_rn((float)lut_s[qm * K + code], scale_s[qm]);
  }
}

template <typename T, int BQ>
__global__ void __launch_bounds__(32 * BQ)
topl_scan_kernel(const uint8_t* __restrict__ codes, const T* __restrict__ luts,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias,
                 const float* __restrict__ qbias, long long ldq,
                 float* __restrict__ part_s, int* __restrict__ part_g,
                 int N, int Q, int M, int K, int L, int LP, int slice) {
  constexpr int THREADS = 32 * BQ;   // one row per thread per tile
  constexpr int TILE = THREADS;      // rows per tile
  constexpr int CAP = 2 * TILE;      // candidate buffer per query (pow2)
  constexpr bool SCALED = std::is_same_v<T, int8_t>;
  extern __shared__ __align__(16) unsigned char smem[];
  T* lut_s = reinterpret_cast<T*>(smem);                  // BQ * M * K
  unsigned char* p = smem + align16(sizeof(T) * BQ * M * K);
  float* scale_s = reinterpret_cast<float*>(p);           // BQ * M (i8)
  if constexpr (SCALED) p += align16(sizeof(float) * BQ * M);
  float* heap_s = reinterpret_cast<float*>(p);            // BQ * LP
  int* heap_g = reinterpret_cast<int*>(heap_s + BQ * LP);
  float* buf_s = reinterpret_cast<float*>(heap_g + BQ * LP);  // BQ * CAP
  int* buf_g = reinterpret_cast<int*>(buf_s + BQ * CAP);
  int* cnt = buf_g + BQ * CAP;                            // BQ

  const int q0 = blockIdx.x * BQ;
  const int S = gridDim.y;
  const long long lo = (long long)blockIdx.y * slice;
  const long long hi = min((long long)N, lo + slice);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const T* lsrc = luts + (size_t)q0 * M * K;
  for (int i = tid; i < BQ * M * K; i += THREADS) lut_s[i] = lsrc[i];
  if constexpr (SCALED) {
    for (int i = tid; i < BQ * M; i += THREADS)
      scale_s[i] = scale[(size_t)q0 * M + i];
  }
  for (int i = tid; i < BQ * LP; i += THREADS) {
    heap_s[i] = CUDART_INF_F;
    heap_g[i] = IMAX;
  }
  if (tid < BQ) cnt[tid] = 0;
  __syncthreads();

  for (long long t0 = lo; t0 < hi; t0 += TILE) {
    const long long row = t0 + tid;
    const bool valid = row < hi;
    float acc[BQ];
#pragma unroll
    for (int q = 0; q < BQ; ++q) acc[q] = 0.f;
    if (valid) {
      const uint8_t* c = codes + row * M;
      int code = c[0];
#pragma unroll
      for (int q = 0; q < BQ; ++q)
        acc[q] = lut_part(lut_s, scale_s, q * M, K, code);
      for (int m = 1; m < M; ++m) {
        code = c[m];
#pragma unroll
        for (int q = 0; q < BQ; ++q)
          acc[q] = __fadd_rn(acc[q], lut_part(lut_s, scale_s, q * M + m, K,
                                              code));
      }
      const float b = bias[row];
#pragma unroll
      for (int q = 0; q < BQ; ++q) acc[q] = __fadd_rn(acc[q], b);
      if (qbias != nullptr) {
#pragma unroll
        for (int q = 0; q < BQ; ++q)
          if (q0 + q < Q)
            acc[q] = __fadd_rn(acc[q], qbias[(long long)(q0 + q) * ldq + row]);
      }
    }
#pragma unroll
    for (int q = 0; q < BQ; ++q) {
      const bool take = valid && lex_less(acc[q], (int)row,
                                          heap_s[q * LP + L - 1],
                                          heap_g[q * LP + L - 1]);
      const unsigned mask = __ballot_sync(0xffffffffu, take);
      if (mask != 0u) {
        const int leader = __ffs(mask) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&cnt[q], __popc(mask));
        base = __shfl_sync(0xffffffffu, base, leader);
        if (take) {
          const int pos = base + __popc(mask & ((1u << lane) - 1u));
          buf_s[q * CAP + pos] = acc[q];
          buf_g[q * CAP + pos] = (int)row;
        }
      }
    }
    __syncthreads();
    if (cnt[warp] > CAP - TILE)
      flush<CAP>(heap_s, heap_g, buf_s, buf_g, cnt, warp, LP, lane);
    __syncthreads();
  }
  if (cnt[warp] > 0)
    flush<CAP>(heap_s, heap_g, buf_s, buf_g, cnt, warp, LP, lane);
  __syncwarp();

  const size_t off = ((size_t)(q0 + warp) * S + blockIdx.y) * L;
  for (int i = lane; i < L; i += 32) {
    part_s[off + i] = heap_s[warp * LP + i];
    part_g[off + i] = heap_g[warp * LP + i];
  }
}

__global__ void __launch_bounds__(MERGE_THREADS)
topl_merge_kernel(const float* __restrict__ part_s,
                  const int* __restrict__ part_g, float* __restrict__ out_s,
                  int* __restrict__ out_g, int S, int L, int LP) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* hs = reinterpret_cast<float*>(smem);
  int* hg = reinterpret_cast<int*>(hs + LP);
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const float* ps = part_s + (size_t)q * S * L;
  const int* pg = part_g + (size_t)q * S * L;

  for (int i = tid; i < LP; i += MERGE_THREADS) {
    hs[i] = i < L ? ps[i] : CUDART_INF_F;
    hg[i] = i < L ? pg[i] : IMAX;
  }
  for (int s = 1; s < S; ++s) {
    __syncthreads();
    const float* bs = ps + (size_t)s * L;
    const int* bg = pg + (size_t)s * L;
    for (int i = tid; i < LP; i += MERGE_THREADS) {
      const int j = LP - 1 - i;
      if (j < L && lex_less(bs[j], bg[j], hs[i], hg[i])) {
        hs[i] = bs[j];
        hg[i] = bg[j];
      }
    }
    __syncthreads();
    for (int j = LP >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < LP; i += MERGE_THREADS) {
        const int p = i ^ j;
        if (p > i && lex_less(hs[p], hg[p], hs[i], hg[i])) swap_pair(hs, hg, i, p);
      }
      __syncthreads();
    }
  }
  __syncthreads();
  for (int i = tid; i < L; i += MERGE_THREADS) {
    out_s[(size_t)q * L + i] = hs[i];
    out_g[(size_t)q * L + i] = hg[i];
  }
}

template <typename T, int BQ>
cudaError_t launch_scan(const uint8_t* codes, const void* luts,
                        const float* scale, const float* bias,
                        const float* qbias, long long ldq, float* part_s,
                        int* part_g, int N, int Q, int Qpad, int M, int K,
                        int L, int LP, int S, cudaStream_t st) {
  constexpr int TILE = 32 * BQ;
  const int slice = ((N + S - 1) / S + TILE - 1) / TILE * TILE;
  const size_t smem = scan_smem_bytes(BQ, M, K, LP, (int)sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(
      topl_scan_kernel<T, BQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  topl_scan_kernel<T, BQ><<<dim3(Qpad / BQ, S), 32 * BQ, smem, st>>>(
      codes, static_cast<const T*>(luts), scale, bias, qbias, ldq, part_s,
      part_g, N, Q, M, K, L, LP, slice);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_scan_bq(int bq, const uint8_t* codes, const void* luts,
                           const float* scale, const float* bias,
                           const float* qbias, long long ldq, float* part_s,
                           int* part_g, int N, int Q, int Qpad, int M, int K,
                           int L, int LP, int S, cudaStream_t st) {
  switch (bq) {
    case 8: return launch_scan<T, 8>(codes, luts, scale, bias, qbias, ldq,
                                     part_s, part_g, N, Q, Qpad, M, K, L, LP,
                                     S, st);
    case 4: return launch_scan<T, 4>(codes, luts, scale, bias, qbias, ldq,
                                     part_s, part_g, N, Q, Qpad, M, K, L, LP,
                                     S, st);
    case 2: return launch_scan<T, 2>(codes, luts, scale, bias, qbias, ldq,
                                     part_s, part_g, N, Q, Qpad, M, K, L, LP,
                                     S, st);
    case 1: return launch_scan<T, 1>(codes, luts, scale, bias, qbias, ldq,
                                     part_s, part_g, N, Q, Qpad, M, K, L, LP,
                                     S, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// lut_bytes: 4 (f32 tables), 2 (f16) or 1 (i8, with a scale).
extern "C" size_t adc_scan_topl_smem_bytes(int bq, int M, int K, int LP,
                                           int lut_bytes) {
  return scan_smem_bytes(bq, M, K, LP, lut_bytes);
}

// codes (N, M); luts (Qpad, M, K) of lut_bytes-wide entries (4: f32,
// 2: f16, 1: i8) with Qpad % bq == 0, bq in {8, 4, 2, 1}; scale (Qpad, M)
// for i8 tables, else NULL; bias (N,); qbias NULL or rows of stride ldq
// for the first Q queries; partials (Qpad, S, L) scratch; out (Q, L).
// L <= LP, LP a power of two >= 32.
extern "C" int adc_scan_topl_launch(const uint8_t* codes, const void* luts,
                                    const float* scale, int lut_bytes,
                                    int bq, const float* bias,
                                    const float* qbias, long long ldq,
                                    float* part_s, int* part_g, float* out_s,
                                    int* out_g, int N, int Q, int Qpad, int M,
                                    int K, int L, int LP, int S,
                                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  switch (lut_bytes) {
    case 4:
      err = launch_scan_bq<float>(bq, codes, luts, scale, bias, qbias, ldq,
                                  part_s, part_g, N, Q, Qpad, M, K, L, LP, S,
                                  st);
      break;
    case 2:
      err = launch_scan_bq<__half>(bq, codes, luts, scale, bias, qbias, ldq,
                                   part_s, part_g, N, Q, Qpad, M, K, L, LP, S,
                                   st);
      break;
    case 1:
      err = launch_scan_bq<int8_t>(bq, codes, luts, scale, bias, qbias, ldq,
                                   part_s, part_g, N, Q, Qpad, M, K, L, LP, S,
                                   st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const size_t msmem = 2 * sizeof(float) * (size_t)LP;
  err = cudaFuncSetAttribute(topl_merge_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)msmem);
  if (err != cudaSuccess) return (int)err;
  topl_merge_kernel<<<Q, MERGE_THREADS, msmem, st>>>(part_s, part_g, out_s,
                                                     out_g, S, L, LP);
  return (int)cudaGetLastError();
}

extern "C" const char* adc_scan_topl_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
