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
// poisons column c of every row except the one whose own entry it is, and
// every out-of-range row.  With nf[c] the non-finite entries of column c:
//   out[i, c] = (nf[c] - own > 0) ? NaN : (in_range ? T[idx, c] : 0),
//   own = in_range && !isfinite(T[idx, c]).
// bf16 entries convert with __bfloat162float, which is exact, so the fp32
// sum of one exact term and zeros is the term itself.
//
// Bound: bytes.  The table is read once, idx once and the output written
// once; there is one compare per entry and one select per output element.
//
// Design: two kernels, no memset, launched back to back on one stream.
//  (a) ohm_count_kernel: one block per row slab (at most OHM_MAX_SLABS of
//      them).  A slab is a contiguous range of T, walked flat with 16-byte
//      loads (4 fp32 or 8 bf16 entries; scalar head and tail to the 16-byte
//      boundary), testing the exponent bits: no column index is needed to
//      know that a slab is all finite.  The block ORs its bits
//      (__syncthreads_or) and writes its own flag.  Only a flagged slab
//      walks itself again by (row, column) from the 2-D position, counts its
//      non-finite entries per column in shared memory and writes its own row
//      of per-slab counts.  Each slot is written by one block each call, and
//      only the flagged rows of counts are ever read: nothing is zeroed.
//  (b) ohm_gather_kernel works by rows: a group of G lanes (up to a warp,
//      G = ceil(d/VEC) rounded up to a power of two) owns a row, loads its
//      index once, gathers VEC = 4 entries at a time (float4, or 4 bf16 as 8
//      bytes) where d % 4 == 0 and the buffers are aligned, and stores with a
//      streaming hint; a one-lane row (d == VEC) takes several rows at once.
//      The grid covers the rows about once, a block's rows contiguous, so
//      the block scheduler balances them over the SMs: a grid of resident
//      blocks striding over the rows measured slower at d = 4.
//      Each warp ballots the slab flags into a bit per slab.  All finite
//      (the common case): a plain gather with no NaN logic at all.  Any flag
//      set: a lane sums the flagged slabs' counts of its own columns into
//      registers, U*G units at a time, and the rule above applies.  The
//      kernel uses no shared memory and no block barrier: on an H100, a tile
//      of counts in shared memory measured slower at d = 4 (it takes L1
//      from the table's rows), and so did a max-L1 carveout hint.
//  (c) (b) is a programmatic dependent launch of (a): (a) lets it start at
//      once (griddepcontrol.launch_dependents), and (b) loads its first
//      rows' indices before griddepcontrol.wait, which returns when (a) has
//      completed and its writes are visible.  This needs no memset between
//      the two launches.
// Index math is 32-bit (unsigned) unless n*d or r*d reach 2^31; there is no
// division or modulo per element.  The launch geometry (slabs, lanes, vector
// width, rows per step, blocks, 64-bit offsets) comes from the wrapper,
// onehot_matmul/ops.py::launch_geometry, and is checked here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define OHM_THREADS 256
#define OHM_MAX_SLABS 256     // slab flags a gather block reads, one a thread
#define OHM_NF_COLS 512       // columns a flagged slab counts at a time
#define OHM_UNROLL 4          // 16-byte loads in flight per count thread
#define OHM_COL_UNROLL 16     // rows in flight per thread of a column walk

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Non-finite (NaN or +-Inf) from the bits: the exponent all ones.
template <typename T> struct Bits;
template <> struct Bits<float> {
  static __device__ __forceinline__ bool any_nonfinite(uint4 w) {
    const uint32_t e = 0x7f800000u;
    return (w.x & e) == e || (w.y & e) == e || (w.z & e) == e ||
           (w.w & e) == e;
  }
};
template <> struct Bits<__nv_bfloat16> {
  static __device__ __forceinline__ bool pair(uint32_t w) {
    return (w & 0x7f80u) == 0x7f80u || (w & 0x7f800000u) == 0x7f800000u;
  }
  static __device__ __forceinline__ bool any_nonfinite(uint4 w) {
    return pair(w.x) || pair(w.y) || pair(w.z) || pair(w.w);
  }
};

// VEC consecutive entries of T as fp32: one load each.
template <typename T, int VEC> struct Gather;
template <typename T> struct Gather<T, 1> {
  typedef float V;
  static __device__ __forceinline__ V zero() { return 0.f; }
  template <typename Idx>
  static __device__ __forceinline__ V load(const T* t, Idx unit) {
    return to_f32(__ldg(t + unit));
  }
  static __device__ __forceinline__ float& at(V& v, int) { return v; }
  template <typename Idx>
  static __device__ __forceinline__ void store(float* o, Idx unit, V v) {
    __stcs(o + unit, v);
  }
};
template <typename T> struct Gather4 {
  typedef float4 V;
  static __device__ __forceinline__ V zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ float& at(V& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
  template <typename Idx>
  static __device__ __forceinline__ void store(float* o, Idx unit, V v) {
    __stcs(reinterpret_cast<float4*>(o) + unit, v);
  }
};
template <> struct Gather<float, 4> : Gather4<float> {
  template <typename Idx>
  static __device__ __forceinline__ V load(const float* t, Idx unit) {
    return __ldg(reinterpret_cast<const float4*>(t) + unit);
  }
};
template <> struct Gather<__nv_bfloat16, 4> : Gather4<__nv_bfloat16> {
  template <typename Idx>
  static __device__ __forceinline__ V load(const __nv_bfloat16* t,
                                           Idx unit) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(t) + unit);
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
    return make_float4(__bfloat162float(h[0]), __bfloat162float(h[1]),
                       __bfloat162float(h[2]), __bfloat162float(h[3]));
  }
};

__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

template <typename T, typename Idx>
__global__ void __launch_bounds__(OHM_THREADS)
ohm_count_kernel(const T* __restrict__ table, Idx r, int d, Idx slab_rows,
                 int clog, int* __restrict__ flags,
                 int* __restrict__ counts) {
  // The gather may be scheduled now: its griddepcontrol.wait returns only
  // when this grid has completed and its writes are visible.
  pdl_launch_dependents();
  const int s = blockIdx.x;
  const Idx row0 = (Idx)s * slab_rows;
  const Idx row1 = row0 + slab_rows < r ? row0 + slab_rows : r;
  const T* p = table + row0 * (Idx)d;
  const Idx len = (row1 - row0) * (Idx)d;
  constexpr int EPV = 16 / sizeof(T);
  Idx head = (Idx)(((16u - ((unsigned)(uintptr_t)p & 15u)) & 15u) /
                   sizeof(T));
  if (head > len) head = len;
  const Idx nv = (len - head) / EPV;
  const Idx tail0 = head + nv * EPV;
  const Idx t = threadIdx.x;
  bool bad = false;
  if (t < head) bad = !isfinite(to_f32(p[t]));
  if (tail0 + t < len) bad = bad || !isfinite(to_f32(p[tail0 + t]));
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  for (Idx j = t; j < nv; j += OHM_UNROLL * OHM_THREADS) {
    uint4 w[OHM_UNROLL];
#pragma unroll
    for (int q = 0; q < OHM_UNROLL; ++q) {
      const Idx jj = j + q * OHM_THREADS;
      w[q] = jj < nv ? __ldg(v + jj) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < OHM_UNROLL; ++q)
      bad = bad || Bits<T>::any_nonfinite(w[q]);
  }
  const int flagged = __syncthreads_or(bad);
  if (threadIdx.x == 0) flags[s] = flagged;
  if (!flagged) return;
  // A flagged slab: per-column counts, a tile of columns at a time, lanes
  // laid out (TY rows) x (TX columns) so a column is the 2-D position.
  __shared__ int cnt[OHM_NF_COLS];
  const int TX = 1 << clog, TY = OHM_THREADS >> clog;
  const int tx = threadIdx.x & (TX - 1), ty = threadIdx.x >> clog;
  for (int c0 = 0; c0 < d; c0 += OHM_NF_COLS) {
    const int cols = min(OHM_NF_COLS, d - c0);
    for (int c = threadIdx.x; c < cols; c += OHM_THREADS) cnt[c] = 0;
    __syncthreads();
    for (int c = tx; c < cols; c += TX) {
      const T* col = table + c0 + c;
      int found = 0;
      for (Idx row = row0 + ty; row < row1; row += OHM_COL_UNROLL * TY) {
        float x[OHM_COL_UNROLL];
#pragma unroll
        for (int q = 0; q < OHM_COL_UNROLL; ++q) {
          const Idx rr = row + q * TY;
          x[q] = rr < row1 ? to_f32(col[rr * (Idx)d]) : 0.f;
        }
#pragma unroll
        for (int q = 0; q < OHM_COL_UNROLL; ++q)
          found += isfinite(x[q]) ? 0 : 1;
      }
      if (found) atomicAdd(&cnt[c], found);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < cols; c += OHM_THREADS)
      counts[(Idx)s * d + c0 + c] = cnt[c];
    __syncthreads();
  }
}

// k[q] = idx of row i0 + q*stride when it is a row (< n) and idx is in
// [0, r); else -1 (a row of zeros, or no row at all).
template <int ROWS, typename Idx>
__device__ __forceinline__ void load_ids(const int32_t* __restrict__ idx,
                                         Idx i0, Idx stride, Idx n, int r,
                                         int (&k)[ROWS]) {
#pragma unroll
  for (int q = 0; q < ROWS; ++q) {
    const Idx i = i0 + q * stride;
    const int v = i < n ? __ldg(idx + i) : -1;
    k[q] = v >= 0 && v < r ? v : -1;
  }
}

// One step of a row group: rows i0 + q*stride (q < ROWS) with ids k, and
// units u_lo + sub + j*G (+ U*G per pass) below u_hi of each row, U units a
// lane in flight.  kRule applies the matmul's NaN rule with nf[j][e], the
// non-finite count of unit u_lo + sub + j*G's column e (one pass: u_hi -
// u_lo <= U*G).
template <typename T, int VEC, int ROWS, int U, bool kRule, typename Idx>
__device__ __forceinline__ void gather_step(
    const T* __restrict__ table, const int (&k)[ROWS], Idx i0, Idx stride,
    Idx n, Idx units, Idx u_lo, Idx u_hi, int sub, int G,
    const int (&nf)[U][VEC], float* __restrict__ out) {
  typedef Gather<T, VEC> Ga;
  typedef typename Ga::V V;
  for (Idx u0 = u_lo + sub; u0 < u_hi; u0 += U * G) {
    V v[ROWS][U];
#pragma unroll
    for (int q = 0; q < ROWS; ++q)
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const Idx u = u0 + j * G;
        v[q][j] = k[q] >= 0 && u < u_hi
                      ? Ga::load(table, (Idx)k[q] * units + u)
                      : Ga::zero();
      }
#pragma unroll
    for (int q = 0; q < ROWS; ++q) {
      const Idx i = i0 + q * stride;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const Idx u = u0 + j * G;
        if (i >= n || u >= u_hi) continue;
        if (kRule) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            float& x = Ga::at(v[q][j], e);
            const int own = (k[q] >= 0 && !isfinite(x)) ? 1 : 0;
            if (nf[j][e] - own > 0) x = __int_as_float(0x7fc00000);
          }
        }
        Ga::store(out, i * units + u, v[q][j]);
      }
    }
  }
}

// VEC: entries per access; Idx: unsigned, or unsigned long long where
// offsets need it; ROWS: rows a group works on at once; U: units (VEC
// entries) a lane has in flight per row.  No shared memory: L1 keeps its
// room for the table's rows.
template <typename T, int VEC, typename Idx, int ROWS, int U>
__global__ void __launch_bounds__(OHM_THREADS)
ohm_gather_kernel(const int32_t* __restrict__ idx,
                  const T* __restrict__ table, const int* flags,
                  const int* counts, Idx n, int r, int d, int slabs,
                  int glog, float* __restrict__ out) {
  const int G = 1 << glog;                        // lanes per row
  const int sub = threadIdx.x & (G - 1);
  const Idx rows_per_block = OHM_THREADS >> glog;
  // A block's rows of one step are contiguous: first + q*stride, q < ROWS.
  const Idx stride = rows_per_block;
  const Idx step = ROWS * (Idx)gridDim.x * rows_per_block;
  const Idx units = (Idx)(d / VEC);
  const Idx first =
      (Idx)blockIdx.x * rows_per_block * ROWS + (threadIdx.x >> glog);

  // Before the count grid has completed: the first rows' indices.
  int k[ROWS];
  load_ids<ROWS>(idx, first, stride, n, r, k);
  pdl_wait();
  // Every warp reads the slab flags into a bit per slab.
  unsigned flagged[OHM_MAX_SLABS / 32];
  bool any = false;
#pragma unroll
  for (int w = 0; w < OHM_MAX_SLABS / 32; ++w) {
    const int s = w * 32 + (threadIdx.x & 31);
    flagged[w] = __ballot_sync(0xffffffffu, s < slabs && flags[s] != 0);
    any = any || flagged[w] != 0;
  }
  if (!any) {
    // Every slab is finite: a plain gather.
    const int none[U][VEC] = {};
    for (Idx i0 = first; i0 < n; i0 += step) {
      if (i0 != first) load_ids<ROWS>(idx, i0, stride, n, r, k);
      gather_step<T, VEC, ROWS, U, false>(table, k, i0, stride, n, units,
                                          (Idx)0, units, sub, G, none, out);
    }
    return;
  }

  // Some slab holds a NaN or Inf: the matmul's rule, U*G units at a time,
  // each lane's column counts in registers, summed over the flagged slabs.
  const Idx tile = (Idx)U * G;
  for (Idx t0 = 0; t0 < units; t0 += tile) {
    int nf[U][VEC] = {};
#pragma unroll
    for (int w = 0; w < OHM_MAX_SLABS / 32; ++w)
      for (unsigned b = flagged[w]; b != 0; b &= b - 1) {
        const int* row = counts + (Idx)(w * 32 + __ffs(b) - 1) * d;
#pragma unroll
        for (int j = 0; j < U; ++j) {
          const Idx u = t0 + sub + j * G;
          if (u < units)
#pragma unroll
            for (int e = 0; e < VEC; ++e) nf[j][e] += row[u * VEC + e];
        }
      }
    const Idx t1 = t0 + tile < units ? t0 + tile : units;
    for (Idx i0 = first; i0 < n; i0 += step) {
      load_ids<ROWS>(idx, i0, stride, n, r, k);
      gather_step<T, VEC, ROWS, U, true>(table, k, i0, stride, n, units, t0,
                                         t1, sub, G, nf, out);
    }
  }
}

template <typename T, int VEC, typename Idx, int ROWS, int U>
static cudaError_t ohm_gather_launch(const cudaLaunchConfig_t& cfg,
                                     const int32_t* idx, const T* table,
                                     const int* flags, const int* counts,
                                     long long n, int r, int d, int slabs,
                                     int glog, float* out) {
  return cudaLaunchKernelEx(&cfg, ohm_gather_kernel<T, VEC, Idx, ROWS, U>,
                            idx, table, flags, counts, (Idx)n, r, d, slabs,
                            glog, out);
}

// ops.py::Geometry, field for field.
struct OhmGeometry {
  int slabs, slab_rows, count_lanes_log, gather_vec, row_lanes_log,
      rows_per_step, gather_blocks, wide;
};

template <typename T, typename Idx>
static int ohm_launch(const int32_t* idx, long long n, const T* table, int r,
                      int d, int* flags, int* counts, float* out,
                      cudaStream_t s, const OhmGeometry& g) {
  const int slabs = g.slabs, glog = g.row_lanes_log, rows = g.rows_per_step;
  if (slabs > 0) {
    ohm_count_kernel<T, Idx><<<(unsigned)slabs, OHM_THREADS, 0, s>>>(
        table, (Idx)r, d, (Idx)g.slab_rows, g.count_lanes_log, flags,
        counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)g.gather_blocks);
  cfg.blockDim = dim3(OHM_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = &attr;
  cfg.numAttrs = slabs > 0 ? 1 : 0;
  cudaError_t err;
  // A one-lane row (rows_per_step 2) has one unit; a wider row, U = 4.
  if (g.gather_vec == 4) {
    err = rows == 1 ? ohm_gather_launch<T, 4, Idx, 1, 4>(
                          cfg, idx, table, flags, counts, n, r, d, slabs,
                          glog, out)
                    : ohm_gather_launch<T, 4, Idx, 2, 1>(
                          cfg, idx, table, flags, counts, n, r, d, slabs,
                          glog, out);
  } else {
    err = rows == 1 ? ohm_gather_launch<T, 1, Idx, 1, 4>(
                          cfg, idx, table, flags, counts, n, r, d, slabs,
                          glog, out)
                    : ohm_gather_launch<T, 1, Idx, 2, 1>(
                          cfg, idx, table, flags, counts, n, r, d, slabs,
                          glog, out);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// Launches on `stream`; returns the first CUDA error (0 on success).
// idx: (n,) int32; table: (r, d) float32, or bfloat16 when table_bf16;
// scratch: slabs * (d + 1) int32 (slab flags, then per-slab column counts);
// out: (n, d) float32.  All contiguous.  geometry: ops.py::launch_geometry's,
// checked here.
extern "C" int onehot_matmul_launch(const void* idx, long long n,
                                    const void* table, int r, int d,
                                    int table_bf16, void* scratch, void* out,
                                    void* stream,
                                    const OhmGeometry* geometry) {
  const long long lim = 1LL << 31;
  if (n < 0 || r < 0 || d < 1 || d > 0x7fffffff - OHM_NF_COLS)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const OhmGeometry g = *geometry;
  const long long elem = table_bf16 ? 2 : 4;
  const bool slabs_ok =
      r == 0 ? g.slabs == 0
             : g.slabs >= 1 && g.slabs <= OHM_MAX_SLABS && g.slab_rows >= 1 &&
                   (long long)(g.slabs - 1) * g.slab_rows < r &&
                   (long long)g.slabs * g.slab_rows >= r;
  const bool vec_ok =
      g.gather_vec == 1 ||
      (g.gather_vec == 4 && d % 4 == 0 &&
       (uintptr_t)table % (4 * elem) == 0 && (uintptr_t)out % 16 == 0);
  const bool lanes_ok = g.count_lanes_log >= 0 && g.count_lanes_log <= 8 &&
                        g.row_lanes_log >= 0 && g.row_lanes_log <= 5 &&
                        (g.rows_per_step == 1 || g.rows_per_step == 2) &&
                        g.gather_blocks >= 1;
  if (!slabs_ok || !vec_ok || !lanes_ok) return (int)cudaErrorInvalidValue;
  // 32-bit offsets hold while every offset, and a row index one step past
  // the last row (below n + step), stays in the range of unsigned.
  const long long step = (long long)g.rows_per_step * g.gather_blocks *
                         (OHM_THREADS >> g.row_lanes_log);
  if (!g.wide && !(n * d < lim && (long long)r * d < lim &&
                   n + step <= 2 * lim - 1))
    return (int)cudaErrorInvalidValue;
  int* flags = (int*)scratch;
  int* counts = flags + g.slabs;
  const int32_t* ix = (const int32_t*)idx;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (table_bf16) {
    const __nv_bfloat16* t = (const __nv_bfloat16*)table;
    return g.wide ? ohm_launch<__nv_bfloat16, unsigned long long>(
                        ix, n, t, r, d, flags, counts, o, s, g)
                  : ohm_launch<__nv_bfloat16, unsigned>(
                        ix, n, t, r, d, flags, counts, o, s, g);
  }
  const float* t = (const float*)table;
  return g.wide ? ohm_launch<float, unsigned long long>(ix, n, t, r, d, flags,
                                                        counts, o, s, g)
                : ohm_launch<float, unsigned>(ix, n, t, r, d, flags, counts,
                                              o, s, g);
}
