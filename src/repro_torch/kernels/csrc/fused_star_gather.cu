// fused_star_gather: the online phase of the fused star pipeline, for Hopper.
//
// Replaces the TPU kernel fused_star_gather_pallas
// (src/repro/kernels/fused_star_gather/kernel.py:53).
//
//   out[i, c] = sum_{j=0..J-1} P_j[clip(ptr_j[i], 0, r_j-1), c] * found_j[i]
//   out[i, c] = (out[i, c] == h[c])            when h is given
//
// Design: one thread per output element (i, c), the flattened index running
// over blockIdx.x/threadIdx.x, so a narrow head (l = 3..8) still fills every
// lane and consecutive threads write consecutive output words.  The J
// partial pointers and row counts travel by value in a small struct (J <= 8).
// The sum runs in the fixed order j = 0..J-1 and MULTIPLIES each gathered
// value by the liveness instead of selecting it, so NaN * 0 stays NaN exactly
// as predict_fused does; __fmul_rn/__fadd_rn keep nvcc from contracting the
// two into an FMA.  Out-of-range pointers clip into [0, r_j) as the reference
// wrapper does (fused_star_gather/ops.py:47-49).  No 128-lane padding of l:
// that is a TPU layout rule and would multiply the bytes written.
//
// Bound: bytes.  Per row it reads J*(4+1) bytes of pointers and liveness and
// J*l*4 gathered bytes (the partials are small enough to stay in L2), and
// writes l*4 bytes; there is one add per gathered value.  Coalesced reads of
// whole partial rows (one warp per row for wide l, vector loads) are a later
// PR's work.
#include <cuda_runtime.h>
#include <stdint.h>

#define FSG_MAX_ARMS 8
#define FSG_THREADS 256

struct Partials {
  const float* p[FSG_MAX_ARMS];
  int rows[FSG_MAX_ARMS];
};

template <bool kCompare>
__global__ void __launch_bounds__(FSG_THREADS)
fused_star_gather_kernel(const int32_t* __restrict__ ptrs,
                         const uint8_t* __restrict__ found, Partials parts,
                         int J, long long n, int l,
                         const float* __restrict__ h,
                         float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * FSG_THREADS + threadIdx.x;
  if (e >= n * (long long)l) return;
  const long long i = e / l;
  const int c = (int)(e - i * l);
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < FSG_MAX_ARMS; ++j) {
    if (j < J) {
      const int r = parts.rows[j];
      int ptr = ptrs[(long long)j * n + i];
      ptr = ptr < 0 ? 0 : (ptr >= r ? r - 1 : ptr);
      const float live = found[(long long)j * n + i] ? 1.f : 0.f;
      const float term = __fmul_rn(parts.p[j][(long long)ptr * l + c], live);
      acc = (j == 0) ? term : __fadd_rn(acc, term);
    }
  }
  if (kCompare) acc = (acc == h[c]) ? 1.f : 0.f;
  out[e] = acc;
}

// The message for a CUDA error code a launch entry point returned.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// ptrs: (J, n) int32; found: (J, n) bool; tables[j]: (rows[j], l) float32;
// h: (l,) float32 or null; out: (n, l) float32.  All contiguous.
extern "C" int fused_star_gather_launch(const void* ptrs, const void* found,
                                        int J, long long n,
                                        const void* const* tables,
                                        const int* rows, int l,
                                        const void* h, void* out,
                                        void* stream) {
  if (J < 1 || J > FSG_MAX_ARMS || l < 1 || n < 0)
    return (int)cudaErrorInvalidValue;
  Partials parts;
  for (int j = 0; j < FSG_MAX_ARMS; ++j) {
    parts.p[j] = j < J ? (const float*)tables[j] : nullptr;
    parts.rows[j] = j < J ? rows[j] : 1;
  }
  const long long total = n * (long long)l;
  if (total == 0) return (int)cudaSuccess;
  const long long blocks = (total + FSG_THREADS - 1) / FSG_THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (h != nullptr) {
    fused_star_gather_kernel<true><<<(unsigned)blocks, FSG_THREADS, 0, s>>>(
        (const int32_t*)ptrs, (const uint8_t*)found, parts, J, n, l,
        (const float*)h, (float*)out);
  } else {
    fused_star_gather_kernel<false><<<(unsigned)blocks, FSG_THREADS, 0, s>>>(
        (const int32_t*)ptrs, (const uint8_t*)found, parts, J, n, l,
        nullptr, (float*)out);
  }
  return (int)cudaGetLastError();
}
