// Materialized ADC scans for NVIDIA Hopper (sm_90a): the full score
// vector of one query, or the full (Q, N) score matrix of a batch.
//
//   adc_scan:        codes (N, M) u8, lut (M, K) f32      -> (N,) f32
//   adc_scan_batch:  codes (N, M) u8, luts (Q, M, K) f32  -> (Q, N) f32
//
//   score[q, n] = (lut[q,0,code[n,0]] + lut[q,1,code[n,1]]) + ...
//
// left to right over m in __fadd_rn (no reassociation, no contraction),
// so every score equals ref.adc_scan_ref / ref.adc_scan_batch_ref bit
// for bit.
//
// Replaces: src/repro/kernels/adc_scan.py::adc_scan_pallas (pl.pallas_call
// at :63) and adc_scan_batch_pallas (pl.pallas_call at :121). The TPU
// kernels turn the gather into one-hot products on the MXU; here the
// table entries are gathered from shared memory directly.
//
// What bounds it on this card: bytes. adc_scan_batch writes 4 * Q * N
// bytes (4 GB at Q = 1000, N = 1M: ~1.2 ms at 3.35 TB/s) against Q * N * M
// shared-memory gathers; adc_scan moves ~12 MB at N = 1M, so a single
// launch of it is bound by launch latency.
//
// Design. A block keeps BQ queries' tables in shared memory (BQ = 8 at
// M = 8, K = 256: 64 KB; the wrapper picks the largest BQ in 8, 4, 2, 1
// that fits) and walks a grid-stride range of rows. Each thread reads one
// code row (M bytes) once for the whole query tile and writes that row's
// BQ scores; neighbouring threads write neighbouring columns of each
// output row. The grid holds about four blocks per SM in all, so the
// tables are loaded a few hundred times, not once per 256 rows. The
// ragged N and Q edges are masked here: nothing is padded or copied.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

template <int BQ>
__global__ void __launch_bounds__(THREADS)
adc_scan_kernel(const uint8_t* __restrict__ codes,
                const float* __restrict__ luts, float* __restrict__ out,
                int N, int Q, int M, int K) {
  extern __shared__ __align__(16) float lut_s[];      // BQ * M * K
  const int q0 = blockIdx.y * BQ;
  const int nq = min(BQ, Q - q0);
  const float* lsrc = luts + (size_t)q0 * M * K;
  for (int i = threadIdx.x; i < nq * M * K; i += THREADS) lut_s[i] = lsrc[i];
  __syncthreads();

  const long long stride = (long long)gridDim.x * THREADS;
  for (long long row = (long long)blockIdx.x * THREADS + threadIdx.x;
       row < N; row += stride) {
    const uint8_t* c = codes + row * M;
    float acc[BQ];
    int code = c[0];
#pragma unroll
    for (int q = 0; q < BQ; ++q)
      if (q < nq) acc[q] = lut_s[(q * M) * K + code];
    for (int m = 1; m < M; ++m) {
      code = c[m];
#pragma unroll
      for (int q = 0; q < BQ; ++q)
        if (q < nq) acc[q] = __fadd_rn(acc[q], lut_s[(q * M + m) * K + code]);
    }
#pragma unroll
    for (int q = 0; q < BQ; ++q)
      if (q < nq) out[(size_t)(q0 + q) * N + row] = acc[q];
  }
}

template <int BQ>
cudaError_t launch(const uint8_t* codes, const float* luts, float* out, int N,
                   int Q, int M, int K, cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int q_tiles = (Q + BQ - 1) / BQ;
  const long long row_blocks = ((long long)N + THREADS - 1) / THREADS;
  const long long want = (4LL * sms + q_tiles - 1) / q_tiles;
  const int gx = (int)(row_blocks < want ? row_blocks : want);
  const size_t smem = sizeof(float) * (size_t)BQ * M * K;
  err = cudaFuncSetAttribute(adc_scan_kernel<BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  adc_scan_kernel<BQ><<<dim3(gx, q_tiles), THREADS, smem, st>>>(
      codes, luts, out, N, Q, M, K);
  return cudaGetLastError();
}

}  // namespace

// codes (N, M), lut (M, K), out (N,): one table, one query per block.
// N >= 1, 4 * M * K <= 232,448.
extern "C" int adc_scan_launch(const uint8_t* codes, const float* lut,
                               float* out, int N, int M, int K,
                               void* stream) {
  return (int)launch<1>(codes, lut, out, N, 1, M, K, (cudaStream_t)stream);
}

// codes (N, M), luts (Q, M, K), out (Q, N); bq in {8, 4, 2, 1} with
// 4 * bq * M * K <= 232,448. N, Q >= 1.
extern "C" int adc_scan_batch_launch(const uint8_t* codes, const float* luts,
                                     float* out, int N, int Q, int M, int K,
                                     int bq, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (bq) {
    case 8: return (int)launch<8>(codes, luts, out, N, Q, M, K, st);
    case 4: return (int)launch<4>(codes, luts, out, N, Q, M, K, st);
    case 2: return (int)launch<2>(codes, luts, out, N, Q, M, K, st);
    case 1: return (int)launch<1>(codes, luts, out, N, Q, M, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* adc_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

extern "C" const char* adc_scan_batch_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
