// fused_star_gather: the online phase of the fused star pipeline, for Hopper.
//
// Replaces the TPU kernel fused_star_gather_pallas
// (src/repro/kernels/fused_star_gather/kernel.py:53).
//
//   out[i, c] = sum_{j=0..J-1} P_j[clip(ptr_j[i], 0, r_j-1), c] * found_j[i]
//   out[i, c] = (out[i, c] == h[c])            when h is given
//
// Bound: bytes.  Per row it reads J*(4+1) bytes of pointers and liveness and
// writes l*4 bytes; the J*l gathered words come from partials small enough
// to stay in L2, and there is one add per gathered value.  At the SF 10 main
// path (n = 60M, J = 3, l = 4) that is 1.87 GB against 0.72 G adds.
//
// Design: rows, not elements, are the unit of work.  Each row gets a group
// of G lanes, G = ceil(l/VEC) rounded up to a power of two and capped at a
// warp (VEC = 4 floats when l % 4 == 0 and every partial, h and out are
// 16-byte aligned, else 1); a group walks its row in steps of G*VEC columns,
// so l = 2048 loops 16 times over a warp.  A narrow head (l <= 4) is one
// thread per row and a warp covers 32 rows.  So:
//  * each row's J pointers and liveness bytes load once per row, not once
//    per column (the lanes of a group read the same words: one broadcast);
//  * the partial rows gather and the output stores as float4 where aligned;
//    the scalar branch of the same kernel takes the rest (l = 1, 3, 5, 129,
//    or a partial that is a view at an unaligned offset);
//  * a grid-stride loop over rows with 32-bit index arithmetic, and 64-bit
//    offsets only where n*l, J*n or r_j*l leave the int range; no division;
//  * a one-thread row takes two rows per step, so their pointer loads and
//    gathers are in flight together, and the registers hold 4 arms unless
//    J > 4 (on an H100, more rows per step slowed the wide rows and room
//    for 8 arms slowed every shape).
// The earlier design (one thread per output element) did a 64-bit division
// per element and loaded the J pointers l times per row.
//
// Bit for bit: the sum runs in the fixed order j = 0..J-1 and MULTIPLIES
// each gathered value by the liveness instead of selecting it, so NaN * 0
// stays NaN exactly as predict_fused does; __fmul_rn/__fadd_rn keep nvcc
// from contracting the two into an FMA, and the build takes no fast math.
// Out-of-range pointers clip into [0, r_j) as the reference wrapper does
// (fused_star_gather/ops.py:47-49).  No 128-lane padding of l: that is a
// TPU layout rule and would multiply the bytes written.
#include <cuda_runtime.h>
#include <stdint.h>

#define FSG_MAX_ARMS 8
#define FSG_THREADS 256
#define FSG_BLOCKS_PER_SM 8     // 2048 resident threads / FSG_THREADS

struct Partials {
  const float* p[FSG_MAX_ARMS];
  int rows[FSG_MAX_ARMS];
};

template <int VEC> struct Lanes;
template <> struct Lanes<1> {
  typedef float T;
  static __device__ __forceinline__ T mul(T a, float s) {
    return __fmul_rn(a, s);
  }
  static __device__ __forceinline__ T add(T a, T b) { return __fadd_rn(a, b); }
  static __device__ __forceinline__ T eq(T a, T h) {
    return a == h ? 1.f : 0.f;
  }
};
template <> struct Lanes<4> {
  typedef float4 T;
  static __device__ __forceinline__ T mul(T a, float s) {
    return make_float4(__fmul_rn(a.x, s), __fmul_rn(a.y, s),
                       __fmul_rn(a.z, s), __fmul_rn(a.w, s));
  }
  static __device__ __forceinline__ T add(T a, T b) {
    return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                       __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
  }
  static __device__ __forceinline__ T eq(T a, T h) {
    return make_float4(a.x == h.x ? 1.f : 0.f, a.y == h.y ? 1.f : 0.f,
                       a.z == h.z ? 1.f : 0.f, a.w == h.w ? 1.f : 0.f);
  }
};

// VEC: floats per access; Idx: int, or long long where offsets need it;
// MAXJ: arms the registers hold (J <= MAXJ); ROWS: rows a group works on at
// once, so their pointer loads and gathers are in flight together.
template <int VEC, typename Idx, bool kCompare, int MAXJ, int ROWS>
__global__ void __launch_bounds__(FSG_THREADS)
fused_star_gather_kernel(const int32_t* __restrict__ ptrs,
                         const uint8_t* __restrict__ found, Partials parts,
                         int J, Idx n, Idx units, int glog,
                         const float* __restrict__ h,
                         float* __restrict__ out) {
  typedef Lanes<VEC> L;
  typedef typename L::T V;
  const int G = 1 << glog;                 // lanes per row
  const int sub = threadIdx.x & (G - 1);
  const Idx rows_per_block = FSG_THREADS >> glog;
  const Idx stride = (Idx)gridDim.x * rows_per_block;
  const V* hv = (const V*)h;
  for (Idx i0 = (Idx)blockIdx.x * rows_per_block + (threadIdx.x >> glog);
       i0 < n; i0 += ROWS * stride) {
    // Row r of this step is i0 + r * stride: each load instruction stays
    // coalesced over the groups of a warp.
    Idx base[ROWS][MAXJ];
    float live[ROWS][MAXJ];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const Idx i = i0 + r * stride;
#pragma unroll
      for (int j = 0; j < MAXJ; ++j) {
        base[r][j] = 0;
        live[r][j] = 0.f;
        if (j < J && i < n) {
          const int rows = parts.rows[j];
          int ptr = __ldg(ptrs + (Idx)j * n + i);
          ptr = ptr < 0 ? 0 : (ptr >= rows ? rows - 1 : ptr);
          base[r][j] = (Idx)ptr * units;
          live[r][j] = __ldg(found + (Idx)j * n + i) ? 1.f : 0.f;
        }
      }
    }
    for (Idx u = sub; u < units; u += G) {
      V acc[ROWS];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        acc[r] = L::mul(__ldg((const V*)parts.p[0] + base[r][0] + u),
                        live[r][0]);
#pragma unroll
        for (int j = 1; j < MAXJ; ++j) {
          if (j < J)
            acc[r] = L::add(acc[r], L::mul(__ldg((const V*)parts.p[j] +
                                                 base[r][j] + u),
                                           live[r][j]));
        }
      }
      const V hu = kCompare ? __ldg(hv + u) : V();
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const Idx i = i0 + r * stride;
        if (i < n) __stcs((V*)out + i * units + u,
                          kCompare ? L::eq(acc[r], hu) : acc[r]);
      }
    }
  }
}

// The message for a CUDA error code a launch entry point returned.
extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

template <int VEC, typename Idx, bool kCompare, int MAXJ, int ROWS>
static void fsg_kernel_launch(unsigned blocks, cudaStream_t s,
                              const int32_t* ptrs, const uint8_t* found,
                              const Partials& parts, int J, long long n,
                              long long units, int glog, const float* h,
                              float* out) {
  fused_star_gather_kernel<VEC, Idx, kCompare, MAXJ, ROWS>
      <<<blocks, FSG_THREADS, 0, s>>>(ptrs, found, parts, J, (Idx)n,
                                      (Idx)units, glog, h, out);
}

template <int VEC, typename Idx>
static int fsg_launch(const int32_t* ptrs, const uint8_t* found,
                      const Partials& parts, int J, long long n, int l,
                      const float* h, float* out, cudaStream_t s) {
  const long long units = l / VEC;
  int glog = 0;
  while ((1LL << glog) < units && glog < 5) ++glog;
  const long long rows_per_block = FSG_THREADS >> glog;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n + rows_per_block - 1) / rows_per_block;
  const long long resident = (long long)sms * FSG_BLOCKS_PER_SM;
  if (blocks > resident) blocks = resident;
  const unsigned b = (unsigned)blocks;
  // Registers for at most 4 arms (the registry's plans have 3) where that
  // suffices; one thread per row: two rows at once; a group of lanes per
  // row: one (measured on an H100: two or four rows at once slowed l = 128
  // by 30%, and eight arms' registers slowed every shape).
  if (h != nullptr) {
    if (glog == 0)
      J <= 4 ? fsg_kernel_launch<VEC, Idx, true, 4, 2>(
                   b, s, ptrs, found, parts, J, n, units, glog, h, out)
             : fsg_kernel_launch<VEC, Idx, true, 8, 2>(
                   b, s, ptrs, found, parts, J, n, units, glog, h, out);
    else
      J <= 4 ? fsg_kernel_launch<VEC, Idx, true, 4, 1>(
                   b, s, ptrs, found, parts, J, n, units, glog, h, out)
             : fsg_kernel_launch<VEC, Idx, true, 8, 1>(
                   b, s, ptrs, found, parts, J, n, units, glog, h, out);
  } else {
    if (glog == 0)
      J <= 4 ? fsg_kernel_launch<VEC, Idx, false, 4, 2>(
                   b, s, ptrs, found, parts, J, n, units, glog, nullptr, out)
             : fsg_kernel_launch<VEC, Idx, false, 8, 2>(
                   b, s, ptrs, found, parts, J, n, units, glog, nullptr, out);
    else
      J <= 4 ? fsg_kernel_launch<VEC, Idx, false, 4, 1>(
                   b, s, ptrs, found, parts, J, n, units, glog, nullptr, out)
             : fsg_kernel_launch<VEC, Idx, false, 8, 1>(
                   b, s, ptrs, found, parts, J, n, units, glog, nullptr, out);
  }
  return (int)cudaGetLastError();
}

static bool aligned16(const void* p) {
  return ((uintptr_t)p & 15) == 0;
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
  if (n == 0) return (int)cudaSuccess;
  Partials parts;
  bool vec = l % 4 == 0 && aligned16(out) && (h == nullptr || aligned16(h));
  long long max_rows = 1;
  for (int j = 0; j < FSG_MAX_ARMS; ++j) {
    parts.p[j] = j < J ? (const float*)tables[j] : nullptr;
    parts.rows[j] = j < J ? rows[j] : 1;
    if (j < J) {
      if (rows[j] < 1) return (int)cudaErrorInvalidValue;
      vec = vec && aligned16(tables[j]);
      if (rows[j] > max_rows) max_rows = rows[j];
    }
  }
  // int offsets hold while every index (and a step of two strides past
  // the last row) stays below 2^31.
  const long long lim = 0x7fffffffLL;
  const bool narrow = n * l < lim && (long long)J * n < lim &&
                      max_rows * l < lim && 3 * n + 2 * FSG_THREADS < lim;
  const int32_t* p = (const int32_t*)ptrs;
  const uint8_t* f = (const uint8_t*)found;
  const float* hf = (const float*)h;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return narrow ? fsg_launch<4, int>(p, f, parts, J, n, l, hf, o, s)
                  : fsg_launch<4, long long>(p, f, parts, J, n, l, hf, o, s);
  return narrow ? fsg_launch<1, int>(p, f, parts, J, n, l, hf, o, s)
                : fsg_launch<1, long long>(p, f, parts, J, n, l, hf, o, s);
}
