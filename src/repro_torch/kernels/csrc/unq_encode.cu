// UNQ codeword assignment (paper Eq. 4) for NVIDIA Hopper (sm_90a).
//
//   codes[b, m] = argmax_k <heads[b, m, :], codebooks[m, k, :]>
//
// heads (B, M, d_c) f32, codebooks (M, K, d_c) f32 -> codes (B, M) int32,
// the first maximum winning (jnp.argmax / torch.argmax).
//
// Replaces: src/repro/kernels/unq_encode.py::unq_encode_pallas
// (pl.pallas_call at :49, body _unq_encode_kernel at :21).
//
// What bounds it on this card: arithmetic. The contraction is
// 2 * B * M * K * d_c fp32 flops against (B * M * d_c + M * K * d_c) * 4
// bytes read, ~100 flops per byte at d_c = 256, far above the H100's
// 67 TFLOP/s / 3.35 TB/s = 20 flop/byte ridge. TF32 tensor cores are
// excluded on purpose: their 10-bit mantissa flips argmax codes.
//
// Design: the Pallas kernel keeps all M codebooks resident in VMEM
// (2 MB at DEEP_8B). Shared memory holds 227 KB, and one book alone
// (K * d_c * 4 = 256 KB) does not fit, so a block owns a tile of TB head
// rows for ONE codebook m and streams that book through shared memory in
// TK-codeword tiles, each contracted over d_c in TD-deep slabs (a plain
// register-blocked SGEMM: 256 threads, 4 x 4 outputs per thread). After
// each codeword tile the block folds the tile's scores into a running
// (max, argmax) per row. Within a tile, ties go to the smaller k; across
// tiles, which ascend in k, the running best is replaced only on a
// strictly greater score. Together that is the first-max rule. The
// (B, K) score matrix never leaves registers.
//
// Precision: every dot product is a sequential chain of fmaf over
// d = 0 .. d_c - 1, in full fp32. The order differs from XLA's and
// cuBLAS's, so a code can differ from theirs only where the top two
// scores of a row are within rounding of each other.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int TB = 64;        // head rows per block
constexpr int TK = 64;        // codewords per streamed tile
constexpr int TD = 16;        // contraction slab
constexpr int THREADS = 256;  // 16 x 16 threads, 4 rows x 4 codewords each

__global__ void __launch_bounds__(THREADS)
unq_encode_kernel(const float* __restrict__ heads,
                  const float* __restrict__ books,
                  int32_t* __restrict__ out, int B, int M, int K, int D) {
  __shared__ float hs[TD][TB];   // heads slab, transposed (d, row)
  __shared__ float cs[TD][TK];   // codeword slab, transposed (d, k)

  const int m = blockIdx.y;
  const int b0 = blockIdx.x * TB;
  const int tid = threadIdx.x;
  const int ty = tid >> 4;       // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid & 15;       // codewords tx*4 .. tx*4+3 of the tile
  const int lr = tid >> 2;       // loader: row / codeword within the tile
  const int ld = (tid & 3) * 4;  // loader: first of 4 depths in the slab

  const float* hrow = heads + ((size_t)(b0 + lr) * M + m) * D;
  const bool hvalid = b0 + lr < B;
  const float* book = books + (size_t)m * K * D;

  float best_v[4];
  int best_k[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_v[i] = -CUDART_INF_F;
    best_k[i] = 0;
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const bool cvalid = k0 + lr < K;
    const float* crow = book + (size_t)(k0 + lr) * D;
    for (int d0 = 0; d0 < D; d0 += TD) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int d = d0 + ld + j;
        hs[ld + j][lr] = (hvalid && d < D) ? hrow[d] : 0.f;
        cs[ld + j][lr] = (cvalid && d < D) ? crow[d] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int dd = 0; dd < TD; ++dd) {
        float a[4], c[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = hs[dd][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) c[j] = cs[dd][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this codeword tile into the running (max, argmax) of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = -CUDART_INF_F;
      int kk = INT_MAX;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + tx * 4 + j;
        if (k < K && (acc[i][j] > v || kk == INT_MAX)) {
          v = acc[i][j];
          kk = k;
        }
      }
      // the 16 threads of one row group are 16 consecutive lanes
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int ok = __shfl_xor_sync(0xffffffffu, kk, off);
        if (ov > v || (ov == v && ok < kk)) {
          v = ov;
          kk = ok;
        }
      }
      if (kk != INT_MAX && (v > best_v[i] || k0 == 0)) {
        best_v[i] = v;
        best_k[i] = kk;
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = b0 + ty * 4 + i;
      if (b < B) out[(size_t)b * M + m] = best_k[i];
    }
  }
}

}  // namespace

extern "C" int unq_encode_launch(const float* heads, const float* books,
                                 int32_t* out, int B, int M, int K, int D,
                                 void* stream) {
  const dim3 grid((B + TB - 1) / TB, M);
  unq_encode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      heads, books, out, B, M, K, D);
  return (int)cudaGetLastError();
}

extern "C" const char* unq_encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
