// tree_predict: Hummingbird GEMM decision-tree inference, for Hopper.
//
// Replaces the TPU kernel tree_predict_pallas
// (src/repro/kernels/tree_predict/kernel.py:34).
//
//   out[i, leaf] = ( sum_node (x[i]·F[:, node] > v[node]) * H[node, leaf]
//                    == hsum[leaf] )
//
// The (n, p) predicate matrix never reaches device memory.
//
// Design: a block takes a tile of G groups of RPT rows (G from k and p, so
// the tile fits the shared-memory target) and stages it in shared memory
// with the RPT rows of a group interleaved, so 16-byte loads give one
// feature of 4 rows.  Work is handed out over flat item indices, so every
// lane has work even when p and l are small (the registry's trees have
// p=7, l=8):
//  1. Predicates, once per (row, node): item = (group, node); the thread
//     reads F[kk, node] once per kk and applies it to its RPT rows.  x·F is
//     an fp32 dot over k, as kernel.py:25-26 computes it (not a column
//     gather): a NaN or Inf anywhere in a row makes NaN terms and the
//     predicate false, as in the reference.  With F's one-hot columns every
//     product is exact, so the fused multiply-add gives the reference's dot
//     bit for bit.  Each predicate goes to shared memory as the high half of
//     fp32 0.0/1.0 (one 16-bit word), RPT*2 bytes per (group, node).
//  2. Scores, per (row, leaf): item = (group, leaf); the thread reads
//     H[node, leaf] once per node (coalesced over leaves) and accumulates
//     its RPT rows' scores in fp32 registers.  pred·H with pred in {0, 1} is
//     exact and the scores are sums of small integers, so the compare with
//     hsum is exact; NaN in H still propagates as in the reference's matmul.
// F, v, H and hsum are read through the read-only data cache rather than
// staged.  Each F or H load serves RPT rows, so the rows per thread set
// the cache traffic: 16 rows ran 1.6-2.3x faster than 4 on an H100 at the
// registry's and the paper's tree shapes (scripts/torch_tree_predict_times.py),
// and 4 remains for trees whose 16-row group does not fit a block.
// The build does not use fast math, so NaN compares stay false.
//
// Bound: per row it reads k*4 bytes and writes l*4 bytes; the work the
// function needs is 2*n*p*l score operations plus one gather per
// (row, node) and a finiteness test per feature.  Tensor-core wgmma on
// preds·H (exact in bf16 with fp32 accumulation), staging F and H tiles in
// shared memory and TMA staging of the x tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define TP_THREADS 256
#define TP_MAX_GROUPS 64               // groups of RPT rows per block
#define TP_SMEM_TARGET (48 * 1024)     // per block, so several blocks fit an SM
#define TP_MAX_SMEM 232448             // Hopper's largest block allocation

// Shared-memory bytes of one group: x (rpt*k floats) + predicates.
static long long tp_group_bytes(int k, int p, int rpt) {
  return 4LL * rpt * k + 2LL * rpt * p;
}

// Rows per thread: 16, or 4 for the widest trees (p in the thousands),
// where a 16-row group would not fit one block.
static int tp_rows_per_thread(int k, int p) {
  return tp_group_bytes(k, p, 16) <= TP_MAX_SMEM ? 16 : 4;
}

static int tp_groups(int k, int p, int rpt) {
  long long g = TP_SMEM_TARGET / tp_group_bytes(k, p, rpt);
  if (g < 1) g = 1;
  if (g > TP_MAX_GROUPS) g = TP_MAX_GROUPS;
  return (int)g;
}

template <int RPT>
__global__ void __launch_bounds__(TP_THREADS)
tree_predict_kernel(const float* __restrict__ x, const float* __restrict__ F,
                    const float* __restrict__ v, const float* __restrict__ H,
                    const float* __restrict__ hsum, float* __restrict__ out,
                    long long n, int k, int p, int l, int G) {
  static_assert(RPT % 4 == 0, "rows per thread come in float4s");
  constexpr int V = RPT / 4;          // float4s of x per (group, feature)
  constexpr int W = RPT / 4;          // uint2s of predicates per (group, node)
  extern __shared__ float4 smem4[];
  float4* xs = smem4;                               // [G][k][V]
  uint2* preds = (uint2*)(xs + (size_t)G * k * V);  // [G][p][W]
  const int R = RPT * G;
  const long long row0 = (long long)blockIdx.x * R;
  const long long left = n - row0;
  const int nrows = left < R ? (int)left : R;

  // Stage the tile: a coalesced read of nrows*k contiguous floats.
  float* xsf = (float*)xs;
  const float* xt = x + row0 * k;
  for (int idx = threadIdx.x; idx < R * k; idx += TP_THREADS) {
    const int r = idx / k;
    const int kk = idx - r * k;
    xsf[((r / RPT) * k + kk) * RPT + (r % RPT)] = r < nrows ? xt[idx] : 0.f;
  }
  __syncthreads();

  // 1. predicates, once per (row, node)
  for (int item = threadIdx.x; item < G * p; item += TP_THREADS) {
    const int g = item / p;
    const int node = item - g * p;
    const float4* xg = xs + (size_t)g * k * V;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < k; ++kk) {
      const float f = __ldg(F + (long long)kk * p + node);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float4 xv = xg[kk * V + j];
        acc[4 * j] = fmaf(xv.x, f, acc[4 * j]);
        acc[4 * j + 1] = fmaf(xv.y, f, acc[4 * j + 1]);
        acc[4 * j + 2] = fmaf(xv.z, f, acc[4 * j + 2]);
        acc[4 * j + 3] = fmaf(xv.w, f, acc[4 * j + 3]);
      }
    }
    const float t = __ldg(v + node);
    // 0x3f80 is the high half of 1.0f.
#pragma unroll
    for (int j = 0; j < W; ++j)
      preds[(size_t)item * W + j] = make_uint2(
          (acc[4 * j] > t ? 0x3f80u : 0u) |
              (acc[4 * j + 1] > t ? 0x3f800000u : 0u),
          (acc[4 * j + 2] > t ? 0x3f80u : 0u) |
              (acc[4 * j + 3] > t ? 0x3f800000u : 0u));
  }
  __syncthreads();

  // 2. scores per (row, leaf), then the compare
  for (int item = threadIdx.x; item < G * l; item += TP_THREADS) {
    const int g = item / l;
    const int leaf = item - g * l;
    const uint2* pg = preds + (size_t)g * p * W;
    float s[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) s[i] = 0.f;
#pragma unroll 2
    for (int node = 0; node < p; ++node) {
      const float hv = __ldg(H + (long long)node * l + leaf);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint2 w = pg[node * W + j];
        s[4 * j] = fmaf(__uint_as_float(w.x << 16), hv, s[4 * j]);
        s[4 * j + 1] = fmaf(__uint_as_float(w.x & 0xffff0000u), hv,
                            s[4 * j + 1]);
        s[4 * j + 2] = fmaf(__uint_as_float(w.y << 16), hv, s[4 * j + 2]);
        s[4 * j + 3] = fmaf(__uint_as_float(w.y & 0xffff0000u), hv,
                            s[4 * j + 3]);
      }
    }
    const float hs = __ldg(hsum + leaf);
    const int r = RPT * g;
    float* o = out + (row0 + r) * l + leaf;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (r + i < nrows) o[(long long)i * l] = s[i] == hs ? 1.f : 0.f;
  }
}

template <int RPT>
static int tp_launch(const float* x, const float* F, const float* v,
                     const float* H, const float* hsum, float* out,
                     long long n, int k, int p, int l, cudaStream_t stream) {
  const int G = tp_groups(k, p, RPT);
  const long long smem = G * tp_group_bytes(k, p, RPT);
  cudaError_t err = cudaFuncSetAttribute(
      tree_predict_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)RPT * G;
  const long long blocks = (n + rows - 1) / rows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tree_predict_kernel<RPT><<<(unsigned)blocks, TP_THREADS, (size_t)smem,
                             stream>>>(x, F, v, H, hsum, out, n, k, p, l, G);
  return (int)cudaGetLastError();
}

// Dynamic shared memory one block takes for (k, p).
extern "C" long long tree_predict_smem_bytes(int k, int p) {
  const int rpt = tp_rows_per_thread(k, p);
  return tp_groups(k, p, rpt) * tp_group_bytes(k, p, rpt);
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// x: (n, k); F: (k, p); v: (p,); H: (p, l); hsum: (l,); out: (n, l);
// all float32 and contiguous.
extern "C" int tree_predict_launch(const void* x, const void* F,
                                   const void* v, const void* H,
                                   const void* hsum, void* out, long long n,
                                   int k, int p, int l, void* stream) {
  if (n < 0 || k < 0 || p < 0 || l < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const float *xf = (const float*)x, *Ff = (const float*)F,
              *vf = (const float*)v, *Hf = (const float*)H,
              *hf = (const float*)hsum;
  cudaStream_t s = (cudaStream_t)stream;
  if (tp_rows_per_thread(k, p) == 16)
    return tp_launch<16>(xf, Ff, vf, Hf, hf, (float*)out, n, k, p, l, s);
  return tp_launch<4>(xf, Ff, vf, Hf, hf, (float*)out, n, k, p, l, s);
}
