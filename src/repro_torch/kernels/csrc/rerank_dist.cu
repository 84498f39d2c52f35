// Fused stage 2 of the table quantizers for NVIDIA Hopper (sm_90a):
// gather, decode and distance in one pass.
//
//   d1[q, l] = sum_d (chain_m table[m, code[q, l, m], d] - queries[q, d])^2
//
// cand codes (Q, L, M) uint8, queries (Q, D) f32, table (M, K, D) f32 ->
// d1 (Q, L) f32. The chain over m runs left to right, as
// ref.decode_with_table does, so the reconstruction is bit-identical to it.
//
// Replaces: src/repro/kernels/rerank_dist.py::rerank_gather_dist_pallas
// (pl.pallas_call at :99, body _rerank_gather_dist_kernel at :47).
//
// What bounds it on this card: the work itself is small. At Q=1000,
// L=500, M=8, K=256, D=96 it needs Q*L*(M+1)*D = 4.32e8 f32 instructions
// ((M-1)*D chain adds, D subtractions and D FMAs that square and
// accumulate; 12.9 us at 33.5e12/s) and ~7 MB of traffic (2 us at
// 3.35 TB/s), so operations set the bound. What costs is reading the table: every
// (q, l) pair reads M rows of D floats, Q*L*M*D = 3.8e8 words in all.
//
// Design: the TPU kernel keeps the whole (M, K, D) table in VMEM and
// gathers rows with a one-hot matrix product. Here the table (786 KB at
// the main path's shapes, and dense for OPQ, whose rotation is folded
// in) is larger than the 227 KB of shared memory a block may hold, but
// it stays in the 50 MB L2, so rows are read through the read-only
// cache (__ldg). A block owns one query and TILE_L of its candidates and
// stages the query in shared memory. Each warp takes one candidate at a
// time: lane j handles d = j, j + 32, ..., so each table row is read as
// whole 128-byte lines, and the M code bytes are read by all lanes at
// once (a broadcast). The ragged edges of Q and L are masked here:
// nothing outside (Q, L) is read or written, and nothing is padded.
//
// Precision: __fadd_rn, __fsub_rn and __fmul_rn keep nvcc from
// contracting the chain or (recon - q)^2 into FMAs. The sum over D is a
// fixed order (each lane's d in ascending order, then a butterfly over
// the lanes), which PyTorch's reduction is not bound to share, so d1 is
// held to the plain version within rounding on real tables and bit for
// bit on integer-valued ones. A code >= K would index past the table:
// the kernel reads a clamped row and writes NaN for that candidate.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE_L = 64;    // candidates per block (rerank_dist.TILE_L)

__global__ void __launch_bounds__(THREADS)
rerank_gather_dist_kernel(const uint8_t* __restrict__ codes,
                          const float* __restrict__ queries,
                          const float* __restrict__ table,
                          float* __restrict__ out, int L, int M, int K,
                          int D) {
  extern __shared__ float qs[];                 // D: this block's query
  const int q = blockIdx.x;
  const int l0 = blockIdx.y * TILE_L;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int d = threadIdx.x; d < D; d += THREADS)
    qs[d] = queries[(size_t)q * D + d];
  __syncthreads();

  const int l_end = min(L, l0 + TILE_L);
  for (int l = l0 + warp; l < l_end; l += WARPS) {
    const uint8_t* c = codes + ((size_t)q * L + l) * M;
    bool in_range = true;
    float part = 0.f;
    for (int d = lane; d < D; d += 32) {
      int code = c[0];
      in_range &= code < K;
      float acc = __ldg(table + (size_t)min(code, K - 1) * D + d);
      for (int m = 1; m < M; ++m) {
        code = c[m];
        in_range &= code < K;
        acc = __fadd_rn(
            acc, __ldg(table + ((size_t)m * K + min(code, K - 1)) * D + d));
      }
      const float diff = __fsub_rn(acc, qs[d]);
      part = __fadd_rn(part, __fmul_rn(diff, diff));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    if (lane == 0) out[(size_t)q * L + l] = in_range ? part : CUDART_NAN_F;
  }
}

}  // namespace

// codes (Q, L, M), queries (Q, D), table (M, K, D), out (Q, L), all
// contiguous. Q >= 1, 1 <= L <= 65535 * TILE_L, D * 4 <= 48 KB.
extern "C" int rerank_gather_dist_launch(const uint8_t* codes,
                                         const float* queries,
                                         const float* table, float* out,
                                         int Q, int L, int M, int K, int D,
                                         void* stream) {
  const dim3 grid(Q, (L + TILE_L - 1) / TILE_L);
  rerank_gather_dist_kernel<<<grid, THREADS, sizeof(float) * D,
                              (cudaStream_t)stream>>>(codes, queries, table,
                                                      out, L, M, K, D);
  return (int)cudaGetLastError();
}

extern "C" const char* rerank_gather_dist_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
