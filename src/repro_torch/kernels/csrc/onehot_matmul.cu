// onehot_matmul: join-as-matmul, out = onehot(idx) @ table, for Hopper.
//
// Replaces the TPU kernel onehot_matmul_pallas
// (src/repro/kernels/onehot_matmul/kernel.py:47).
//
//   out[i, c] = sum_r [idx[i] == r] * T[r, c]          (fp32, T fp32 or bf16)
//
// The TPU builds (block_n x block_r) one-hot tiles because its matrix unit
// wants a matmul; on Hopper the same function is a gather, one row of T per
// output row.  What the matmul adds on top of a gather is its IEEE behaviour
// at non-finite entries: 0*Inf and 0*NaN are NaN, so a non-finite T[r, c]
// poisons column c of every row except the one whose own entry it is.  The
// kernel keeps that exactly:
//   (a) onehot_nonfinite_kernel counts nf[c], the non-finite entries of each
//       column (one pass over T);
//   (b) onehot_gather_kernel gives one thread a (row, 4-column group),
//       own = in_range && !isfinite(T[idx, c]), and
//   (c) out = (nf[c] - own > 0) ? NaN : (in_range ? T[idx, c] : 0).
// bf16 entries convert with __bfloat162float, which is exact, so the fp32
// sum of one exact term and zeros is the term itself.  Offsets are 64-bit
// (n*d may exceed 2^31).  Rows whose width is a multiple of 4 on aligned
// buffers use one 16-byte (fp32) or 8-byte (bf16) load and a 16-byte store.
//
// Bound: bytes.  Per row it reads 4 bytes of idx and writes d*4 bytes; T is
// read once by (a) and, being small next to n, is served from L2 to (b).
// There are no operations to speak of (one compare per output element).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define OHM_THREADS 256
#define OHM_COUNT_BLOCKS 1024

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Four consecutive entries as one load: float4 for fp32, uint2 for bf16.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };

template <typename T>
__global__ void __launch_bounds__(OHM_THREADS)
onehot_nonfinite_kernel(const T* __restrict__ table, long long total, int d,
                        int* __restrict__ nf) {
  const long long stride = (long long)gridDim.x * OHM_THREADS;
  for (long long e = (long long)blockIdx.x * OHM_THREADS + threadIdx.x;
       e < total; e += stride) {
    if (!isfinite(to_f32(table[e]))) atomicAdd(&nf[e % d], 1);
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(OHM_THREADS)
onehot_gather_kernel(const int32_t* __restrict__ idx,
                     const T* __restrict__ table,
                     const int* __restrict__ nf, long long n, int r, int d,
                     int groups, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * OHM_THREADS + threadIdx.x;
  if (e >= n * (long long)groups) return;
  const long long i = e / groups;
  const int c0 = (int)(e - i * groups) * 4;
  const int k = idx[i];
  const bool in_range = k >= 0 && k < r;
  const T* row = table + (long long)k * d + c0;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  if (kVec) {
    if (in_range) {
      const typename Vec4<T>::type raw =
          *reinterpret_cast<const typename Vec4<T>::type*>(row);
      const T* p = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = to_f32(p[j]);
    }
  } else if (in_range) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < d) v[j] = to_f32(row[j]);
  }
  const float nan = __int_as_float(0x7fc00000);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c0 + j < d) {
      const int own = (in_range && !isfinite(v[j])) ? 1 : 0;
      if (nf[c0 + j] - own > 0) v[j] = nan;
    }
  }
  float* o = out + i * d + c0;
  if (kVec) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j < d) o[j] = v[j];
  }
}

template <typename T>
static int launch(const int32_t* idx, long long n, const T* table, int r,
                  int d, int* nf, float* out, cudaStream_t s) {
  cudaError_t err = cudaMemsetAsync(nf, 0, sizeof(int) * (size_t)d, s);
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)r * d;
  if (cells > 0) {
    long long blocks = (cells + OHM_THREADS - 1) / OHM_THREADS;
    if (blocks > OHM_COUNT_BLOCKS) blocks = OHM_COUNT_BLOCKS;
    onehot_nonfinite_kernel<T><<<(unsigned)blocks, OHM_THREADS, 0, s>>>(
        table, cells, d, nf);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int groups = (d + 3) / 4;
  const long long total = n * (long long)groups;
  const long long blocks = (total + OHM_THREADS - 1) / OHM_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 &&
                   (uintptr_t)table % (4 * sizeof(T)) == 0 &&
                   (uintptr_t)out % 16 == 0;
  if (vec) {
    onehot_gather_kernel<T, true><<<(unsigned)blocks, OHM_THREADS, 0, s>>>(
        idx, table, nf, n, r, d, groups, out);
  } else {
    onehot_gather_kernel<T, false><<<(unsigned)blocks, OHM_THREADS, 0, s>>>(
        idx, table, nf, n, r, d, groups, out);
  }
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the first CUDA error (0 on success).
// idx: (n,) int32; table: (r, d) float32, or bfloat16 when table_bf16;
// nonfinite: (d,) int32 scratch; out: (n, d) float32.  All contiguous.
extern "C" int onehot_matmul_launch(const void* idx, long long n,
                                    const void* table, int r, int d,
                                    int table_bf16, void* nonfinite,
                                    void* out, void* stream) {
  if (n < 0 || r < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16)
    return launch<__nv_bfloat16>((const int32_t*)idx, n,
                                 (const __nv_bfloat16*)table, r, d,
                                 (int*)nonfinite, (float*)out, s);
  return launch<float>((const int32_t*)idx, n, (const float*)table, r, d,
                       (int*)nonfinite, (float*)out, s);
}
