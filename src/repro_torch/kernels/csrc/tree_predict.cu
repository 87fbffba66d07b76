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
// Bound: bytes at the registry's and the paper's shapes.  Per row it reads
// k*4 bytes and writes l*4; the function needs 2*n*p*l score operations
// (here on tensor cores: 989 TFLOP/s in bf16) plus one gather per
// (row, node) and a finiteness test per feature (fp32 units).  The earlier
// design computed every predicate as a full fp32 dot over k (n*p*k FMAs)
// and the scores on CUDA cores (n*p*l FMAs), reading H once per
// (node, leaf) per item: 15.7 ms at setting 1 against a 1.47 ms bound.
//
// Design, exact against tree_predict_ref by construction:
//  0. A prep pass (tree_predict_prep, launched by the same entry point)
//     finds for each node whether F's column is exactly one-hot (one entry
//     equal to 1, every other equal to 0) and its feature feat[node] (-1
//     if not).  It writes H as bf16 in mma.sync's B-fragment order into the
//     caller's scratch and raises flags[0] if any entry of H is not -1, 0
//     or 1 (NaN, Inf, 0.5, ...); flags[1] counts the columns that are not
//     one-hot.  Nothing returns to the host.
//  1. Persistent blocks walk tiles of rows.  A tile of x is copied into
//     shared memory with cp.async (16-byte units; the next tile loads
//     behind the current one where two fit), and each row's non-finite
//     features are counted once: nf(row).
//  2. Predicates by gather.  For a one-hot column the reference's fp32 dot
//     x[row]·F[:, node] equals x[row, feat] unless a NaN or Inf elsewhere
//     in the row makes a 0*NaN or 0*Inf term, so
//       pred = (nf(row) - !isfinite(x[row, feat]) == 0) && x[row, feat] > v.
//     A column that is not one-hot keeps the fp32 dot over k (fmaf in
//     feature order, as the earlier design did).  Each lane writes one
//     (16-row, 16-node) A fragment of the predicates as bf16 straight into
//     shared memory.
//  3. Scores on tensor cores.  Predicates in {0, 1} and H in {-1, 0, 1}
//     are exact in bf16, and their products and sums are integers of
//     magnitude <= p < 2^24, exact in the fp32 accumulator: mma.sync
//     m16n8k16 bf16 -> fp32 gives the fp32 scores bit for bit.  When
//     flags[0] is set the same kernel takes its fp32 branch instead: the
//     same fragments accumulated with fmaf over the nodes in order (NaN and
//     Inf in H propagate as in the reference's matmul).
//  4. The epilogue compares with hsum and writes fp32 0/1; padded nodes
//     and leaves are zero and never written.
// Two kernels share those steps.  tree_predict_narrow_kernel takes the
// registry's trees (l <= 16, p <= 128) where its 128-row tile of x fits
// (k up to about 440): H and the node tests stay in shared memory, and
// each warp carries its own m-tiles of a tile through steps 1-4 with no
// block barrier between them, so one warp's stores overlap another's
// predicates.  tree_predict_kernel takes the rest: a work item
// is one group of up to 128 leaves of one row tile (so a wide tree fills
// every SM even for a few rows), its warps split the item's output tile,
// and nodes go in chunks of 128.  H's fragments are staged once per block
// when the whole of H is one chunk and one group, else per chunk, the next
// chunk's cp.async running behind the current one's mma -- the depth-13
// edge tree (p = 8191, l = 8192) streams its 128 MB of bf16 H that way.
// Rows of x with k % 32 == 0 are swizzled in shared memory, so the
// gathers of eight rows reach eight banks.
// The build does not use fast math, so NaN compares stay false.
#include <cuda_runtime.h>
#include <stdint.h>

#define TP_THREADS 256
#define TP_WARPS 8
#define TP_KC 8                  // k-steps of 16 nodes per chunk
#define TP_NTW 2                 // n-tiles of 8 leaves per warp
#define TP_MAX_SMEM 232448       // Hopper's largest block allocation
#define TP_NARROW_TILE_BYTES 16384   // x per tile of a narrow tree
#define TP_NARROW_MIN_BLOCKS 4       // per SM: at most 64 registers
#define TP_BF16_ONE 0x3f80u
#define TP_BF16_MINUS_ONE 0xbf80u

struct TpShape {
  int k, p, l;
  int swz;       // x rows swizzled in shared memory (k % 32 == 0)
  int msub;      // m-tiles per warp in a tile of the narrow kernel
  int bm;        // rows per tile (a multiple of 16)
  int wm, wn;    // warps over m-tiles and over n-tiles (wm * wn <= 8)
  int kcc;       // k-steps per chunk: min(TP_KC, kc_total)
  int kc_total;  // ceil(p / 16)
  int nt_total;  // ceil(l / 8)
  int nbt;       // n-tiles per leaf group: wn * TP_NTW
  int vec;       // x is 16-byte aligned: the tile copies in 16-byte units
  int h_once;    // H fits one chunk and one group: staged once per block
  int nbuf;      // x tiles in shared memory: 2 prefetches the next tile
  int narrow;    // l <= 16, p <= 128 and a 128-row tile fits:
                 // tree_predict_narrow_kernel, whose warps each own msub
                 // m-tiles of a tile from end to end
};

static __host__ __device__ int tp_ceil(long long a, long long b) {
  return (int)((a + b - 1) / b);
}

static long long tp_smem(const TpShape& s) {
  return 4LL * s.bm * s.k * s.nbuf + 4LL * s.bm + 32LL * s.bm * s.kcc +
         32LL * (8 * s.nbt) * s.kcc * (s.h_once ? 1 : 2) +
         (s.narrow ? 1024LL * s.kcc : 0);
}

// The narrow kernel's tile: 8 warps of msub m-tiles each, x about
// TP_NARROW_TILE_BYTES; 0 if none fits.
static int tp_plan_narrow(TpShape* s) {
  s->narrow = 1;
  s->wm = TP_WARPS;
  s->wn = 1;
  s->nbt = s->nt_total;
  for (int nbuf = 2; nbuf >= 1; --nbuf) {
    const long long limit = nbuf == 2 ? TP_MAX_SMEM / 2 - 1024 : TP_MAX_SMEM;
    s->nbuf = nbuf;
    for (int msub = 16; msub >= 1; msub /= 2) {
      s->msub = msub;
      s->bm = msub * 16 * TP_WARPS;
      if (msub > 1 && 4LL * s->bm * s->k > TP_NARROW_TILE_BYTES) continue;
      if (tp_smem(*s) <= limit) return 1;
    }
  }
  return 0;
}

// Picks the tile for (k, p, l); returns the m-tiles per warp of the general
// kernel (4, 2 or 1; 1 for the narrow kernel), or 0 if no tile fits.
static int tp_plan(int k, int p, int l, bool vec, TpShape* s) {
  s->k = k; s->p = p; s->l = l;
  s->vec = vec ? 1 : 0;
  // The x tile: where k % 32 == 0 (so eight rows would share a bank) its
  // rows of 16-byte units are swizzled, unit q of row r at q ^ (r % 8);
  // otherwise it is the contiguous block of x it copies.
  s->swz = vec && k % 32 == 0;
  s->kc_total = tp_ceil(p, 16);
  s->kcc = s->kc_total < TP_KC ? s->kc_total : TP_KC;
  s->nt_total = tp_ceil(l, 8);
  int wn = 1;
  while (wn < TP_WARPS && wn * TP_NTW < s->nt_total) wn *= 2;
  s->wn = wn;
  s->nbt = wn * TP_NTW;
  s->h_once = (s->kc_total <= TP_KC && s->nt_total <= s->nbt) ? 1 : 0;
  s->narrow = 0;
  // A narrow tree whose 128-row tile does not fit (k above about 440) takes
  // the general kernel, whose tile may be 16 rows.
  if (l <= 16 && s->kc_total <= TP_KC) {
    TpShape t = *s;
    if (tp_plan_narrow(&t)) {
      *s = t;
      return 1;
    }
  }
  // Wide trees reuse each H fragment over 4 m-tiles; narrow ones (one or
  // two n-tiles) need no reuse and take fewer registers, so more blocks.
  const int first = s->nt_total >= 8 ? 4 : (s->nt_total >= 4 ? 2 : 1);
  // Two x buffers where they fit beside two blocks per SM, else one.
  for (int mtw = first; mtw >= 1; mtw /= 2) {
    for (int wm = TP_WARPS / wn; wm >= 1; wm /= 2) {
      for (int nbuf = 2; nbuf >= 1; --nbuf) {
        const long long limit = nbuf == 2 ? TP_MAX_SMEM / 2 - 1024
                                          : TP_MAX_SMEM;
        s->wm = wm;
        s->bm = wm * mtw * 16;
        s->msub = 1;
        s->nbuf = nbuf;
        if (tp_smem(*s) > limit) continue;
        return mtw;
      }
    }
  }
  return 0;
}

// ------------------------------------------------------------------ prep
// Blocks [0, ceil(p/32)) scan F, 32 nodes a block, each of the 8 warps
// every 8th feature; the rest write H's fragments.
__global__ void __launch_bounds__(TP_THREADS)
tree_predict_prep(const float* __restrict__ F, const float* __restrict__ H,
                  int k, int p, int l, int kc_total, int nt_total,
                  int* __restrict__ feat, uint2* __restrict__ hb,
                  int* __restrict__ flags) {
  const int f_blocks = tp_ceil(p, 32);
  if ((int)blockIdx.x < f_blocks) {
    __shared__ int ones_s[TP_WARPS][32], others_s[TP_WARPS][32],
        at_s[TP_WARPS][32];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int node = blockIdx.x * 32 + lane;
    int ones = 0, others = 0, at = -1;
    if (node < p) {
#pragma unroll 4
      for (int kk = w; kk < k; kk += TP_WARPS) {
        const float f = __ldg(F + (long long)kk * p + node);
        if (f == 1.f) {
          ++ones;
          at = kk;
        } else if (!(f == 0.f)) {
          ++others;
        }
      }
    }
    ones_s[w][lane] = ones;
    others_s[w][lane] = others;
    at_s[w][lane] = at;
    __syncthreads();
    if (w == 0 && node < p) {
      for (int i = 1; i < TP_WARPS; ++i) {
        ones += ones_s[i][lane];
        others += others_s[i][lane];
        at = max(at, at_s[i][lane]);
      }
      const bool onehot = ones == 1 && others == 0;
      feat[node] = onehot ? at : -1;
      if (!onehot) atomicAdd(flags + 1, 1);
    }
    return;
  }
  // H in B-fragment order: hb[(nt * kc_total + kc) * 32 + lane] holds
  // H[kc*16 + 2t + {0, 1}][nt*8 + g] and H[kc*16 + 2t + 8 + {0, 1}][...],
  // g = lane / 4, t = lane % 4; zero outside (p, l).
  const long long u =
      (long long)(blockIdx.x - f_blocks) * TP_THREADS + threadIdx.x;
  const long long units = (long long)nt_total * kc_total * 32;
  if (u < units) {
    const long long per_nt = (long long)kc_total * 32;
    const int nt = (int)(u / per_nt);
    const int rem = (int)(u - nt * per_nt);
    const int kc = rem >> 5, lane = rem & 31;
    const int col = nt * 8 + (lane >> 2);
    const int row0 = kc * 16 + 2 * (lane & 3);
    uint32_t bits[4];
    bool bad = false;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = row0 + (e & 1) + 8 * (e >> 1);
      const float hv = (row < p && col < l)
                           ? __ldg(H + (long long)row * l + col) : 0.f;
      bad = bad || !(hv == 0.f || hv == 1.f || hv == -1.f);
      bits[e] = hv == 1.f ? TP_BF16_ONE
                          : (hv == -1.f ? TP_BF16_MINUS_ONE : 0u);
    }
    if (bad) flags[0] = 1;
    hb[u] = make_uint2(bits[0] | (bits[1] << 16), bits[2] | (bits[3] << 16));
  }
}

// ------------------------------------------------------------------ main
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_bf16(float* c, const uint4& a,
                                         const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// x[r, kk] from the staged tile.
__device__ __forceinline__ float tp_x(const float* xs, const TpShape& s,
                                      int r, int kk) {
  const int c = s.swz ? ((((kk >> 2) ^ (r & 7)) << 2) | (kk & 3)) : kk;
  return xs[r * s.k + c];
}

// Issue the cp.async copy of `nrows` rows of x from row0 into the tile xs:
// one contiguous block (16-byte units, then a 4-byte tail) unless the rows
// are swizzled.  A tile starts at a multiple of 16 rows, so at a 16-byte
// boundary of an aligned x.
__device__ __forceinline__ void tp_load_tile(float* xs,
                                             const float* __restrict__ x,
                                             const TpShape& s,
                                             long long row0, int nrows) {
  const int tid = threadIdx.x;
  const float* xt = x + row0 * s.k;
  if (s.swz) {
    const int k4 = s.k / 4;
    const int dr = TP_THREADS / k4, dq = TP_THREADS % k4;
    int r = tid / k4, q = tid % k4;
    for (; r < nrows; r += dr, q += dq) {
      if (q >= k4) { q -= k4; ++r; if (r >= nrows) break; }
      cp_async16(xs + r * s.k + 4 * (q ^ (r & 7)),
                 xt + (long long)r * s.k + 4 * q);
    }
    return;
  }
  const int total = nrows * s.k;
  const int units = s.vec ? total / 4 : 0;
  for (int u = tid; u < units; u += TP_THREADS)
    cp_async16(xs + 4 * u, xt + 4 * u);
  for (int e = 4 * units + tid; e < total; e += TP_THREADS)
    cp_async4(xs + e, xt + e);
}

// Whether the `len` floats at xs (16-byte aligned) that this thread visits,
// from `first` in steps of `step` float4s, hold a NaN or ±Inf.
__device__ __forceinline__ bool tp_any_nonfinite(const float* xs, int len,
                                                 int first, int step) {
  bool bad = false;
  for (int e = 4 * first; e + 3 < len; e += 4 * step) {
    const float4 q = *(const float4*)(xs + e);
    bad |= !(isfinite(q.x) && isfinite(q.y) && isfinite(q.z) &&
             isfinite(q.w));
  }
  for (int e = (len & ~3) + first; e < len; e += step)
    bad |= !isfinite(xs[e]);
  return bad;
}

// nf(r): the NaN and ±Inf features of row r (any unit order).  The first
// form is one thread's, the second a whole warp's.
__device__ __forceinline__ int tp_row_nonfinite(const float* xs,
                                                const TpShape& s, int r) {
  int cnt = 0;
  for (int c = 0; c < s.k; ++c) cnt += isfinite(xs[r * s.k + c]) ? 0 : 1;
  return cnt;
}

__device__ __forceinline__ int tp_row_nonfinite_warp(const float* xs,
                                                     const TpShape& s, int r,
                                                     int lane) {
  int cnt = 0;
  for (int c = lane; c < s.k; c += 32)
    cnt += isfinite(xs[r * s.k + c]) ? 0 : 1;
  return __reduce_add_sync(0xffffffffu, cnt);
}

// The fp32 dot x[r]·F[:, node] of a column of F that is not one-hot (as
// the earlier design computed every predicate: fmaf in feature order).
__device__ __noinline__ float tp_dot(const float* xs,
                                     const float* __restrict__ F,
                                     const TpShape& s, int r, int node) {
  float a = 0.f;
  for (int kk = 0; kk < s.k; ++kk)
    a = fmaf(tp_x(xs, s, r, kk), __ldg(F + (long long)kk * s.p + node), a);
  return a;
}

// A one-hot column's predicate: the reference's dot is x[r, feat], unless a
// NaN or Inf elsewhere in the row (nf counts the row's) makes a 0*NaN or
// 0*Inf term, and then NaN and false.  As bf16 1.0 or 0.0.
__device__ __forceinline__ uint32_t tp_hit(float xv, int nf, float t) {
  return (nf - (isfinite(xv) ? 0 : 1) == 0 && xv > t) ? TP_BF16_ONE : 0u;
}

// A lane's four nodes of a k-step starting at node kbase: node kbase + 2t,
// +1, +8, +9 (t = lane % 4).  col: the node's feature as a column of the
// staged tile (the swizzle depends on the row only through r % 8 = lane/4,
// the same for both rows of the lane's fragment); th: its threshold, or
// +Inf (never true) for a padding node or a column of F that is not
// one-hot (those are patched by tp_patch_dots).
__device__ __forceinline__ void tp_lane_nodes(const int* __restrict__ feat,
                                              const float* __restrict__ v,
                                              const TpShape& s, int kbase,
                                              int lane, int col[4],
                                              float th[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int node = kbase + 2 * (lane & 3) + (e & 1) + 8 * (e >> 1);
    const int f = node < s.p ? __ldg(feat + node) : -2;
    const int ff = f >= 0 ? f : 0;
    col[e] = s.swz ? ((((ff >> 2) ^ (lane >> 2)) << 2) | (ff & 3)) : ff;
    th[e] = f >= 0 ? __ldg(v + node) : __int_as_float(0x7f800000);
  }
}

// A lane's A fragment of one (16-row, 16-node) block: .x, .y rows r0 and
// r0 + 8 (x0, x1) at nodes 2t and 2t + 1, .z, .w the same rows at 2t + 8,
// 2t + 9.  `clean`: no NaN or Inf in these rows, so the dot is x[r, feat];
// otherwise n0, n1 are the rows' nf.  lo, hi: the lane's first and second
// node pairs lie below p.
__device__ __forceinline__ uint4 tp_fragment(const float* x0, const float* x1,
                                             const int col[4],
                                             const float th[4], bool clean,
                                             int n0, int n1, bool lo,
                                             bool hi) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (clean) {
    if (lo) {
      w.x = (x0[col[0]] > th[0] ? TP_BF16_ONE : 0u) |
            (x0[col[1]] > th[1] ? TP_BF16_ONE << 16 : 0u);
      w.y = (x1[col[0]] > th[0] ? TP_BF16_ONE : 0u) |
            (x1[col[1]] > th[1] ? TP_BF16_ONE << 16 : 0u);
    }
    if (hi) {
      w.z = (x0[col[2]] > th[2] ? TP_BF16_ONE : 0u) |
            (x0[col[3]] > th[3] ? TP_BF16_ONE << 16 : 0u);
      w.w = (x1[col[2]] > th[2] ? TP_BF16_ONE : 0u) |
            (x1[col[3]] > th[3] ? TP_BF16_ONE << 16 : 0u);
    }
  } else {
    if (lo) {
      w.x = tp_hit(x0[col[0]], n0, th[0]) | tp_hit(x0[col[1]], n0, th[1]) << 16;
      w.y = tp_hit(x1[col[0]], n1, th[0]) | tp_hit(x1[col[1]], n1, th[1]) << 16;
    }
    if (hi) {
      w.z = tp_hit(x0[col[2]], n0, th[2]) | tp_hit(x0[col[3]], n0, th[3]) << 16;
      w.w = tp_hit(x1[col[2]], n1, th[2]) | tp_hit(x1[col[3]], n1, th[3]) << 16;
    }
  }
  return w;
}

// Replace, in a lane's fragment, the predicates of nodes whose column of F
// is not one-hot with the fp32 dot's.
__device__ __forceinline__ void tp_patch_dots(uint4* w, const float* xs,
                                              const float* __restrict__ F,
                                              const int* __restrict__ feat,
                                              const float* __restrict__ v,
                                              const TpShape& s, int r0,
                                              int kbase, int lane) {
  uint32_t* wr = (uint32_t*)w;
  for (int e = 0; e < 4; ++e) {
    const int node = kbase + 2 * (lane & 3) + (e & 1) + 8 * (e >> 1);
    if (node >= s.p || __ldg(feat + node) != -1) continue;
    const float t = __ldg(v + node);
    for (int h = 0; h < 2; ++h) {
      const uint32_t bit =
          tp_dot(xs, F, s, r0 + 8 * h, node) > t ? TP_BF16_ONE : 0u;
      const int reg = h + 2 * (e >> 1), sh = 16 * (e & 1);
      wr[reg] = (wr[reg] & ~(0xffffu << sh)) | (bit << sh);
    }
  }
}

// Predicate (row r16 of m-tile mt, node c16 of k-step kc) as 0.0/1.0, read
// back from the A fragments in shared memory.
__device__ __forceinline__ float tp_pred_at(const uint4* as, int kcn, int mt,
                                            int kc, int r16, int c16) {
  const int lane = (r16 & 7) * 4 + ((c16 & 7) >> 1);
  const int reg = (r16 >> 3) + 2 * (c16 >> 3);
  const unsigned short* w =
      (const unsigned short*)(as + (mt * kcn + kc) * 32 + lane);
  return w[reg * 2 + (c16 & 1)] ? 1.f : 0.f;
}

// The fp32 score branch (H not in {-1, 0, 1}): one lane's accumulator
// fragment of m-tile mt and the n-tile at column col = nt*8 + 2t, over the
// 16 nodes of k-step kc (nodes kbase..), fmaf in node order.
__device__ __forceinline__ void tp_scores_fp32(float acc[4], const uint4* as,
                                               int kcn, int mt, int kc,
                                               const float* __restrict__ H,
                                               const TpShape& s, int kbase,
                                               int col, int g) {
  if (col >= s.l) return;
  for (int c16 = 0; c16 < 16 && kbase + c16 < s.p; ++c16) {
    const float* hrow = H + (long long)(kbase + c16) * s.l + col;
    const float h0 = __ldg(hrow);
    const float h1 = col + 1 < s.l ? __ldg(hrow + 1) : 0.f;
    const float p0 = tp_pred_at(as, kcn, mt, kc, g, c16);
    const float p1 = tp_pred_at(as, kcn, mt, kc, g + 8, c16);
    acc[0] = fmaf(p0, h0, acc[0]);
    acc[1] = fmaf(p0, h1, acc[1]);
    acc[2] = fmaf(p1, h0, acc[2]);
    acc[3] = fmaf(p1, h1, acc[3]);
  }
}

// Compare a lane's accumulator fragment (rows rb + g and rb + g + 8 of the
// tile, columns col, col + 1) with hsum and store fp32 0/1.  Where
// l % 4 == 0 the lanes of a pair swap halves so each stores 16 bytes: an
// even t row rb + g's columns col..col+3, an odd t row rb + g + 8's
// col-2..col+1.  All lanes of the warp call it together.
__device__ __forceinline__ void tp_store(float* __restrict__ out,
                                         const TpShape& s, long long row0,
                                         int nrows, int rb, int col,
                                         const float acc[4], float hs0,
                                         float hs1, int g, int t) {
  float o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    o[e] = acc[e] == ((e & 1) ? hs1 : hs0) ? 1.f : 0.f;
  if (s.l % 4 == 0) {
    const bool odd = t & 1;
    const float a0 = __shfl_xor_sync(0xffffffffu, odd ? o[0] : o[2], 1);
    const float a1 = __shfl_xor_sync(0xffffffffu, odd ? o[1] : o[3], 1);
    const int r = rb + g + (odd ? 8 : 0);
    const int c = odd ? col - 2 : col;
    const float4 q = odd ? make_float4(a0, a1, o[2], o[3])
                         : make_float4(o[0], o[1], a0, a1);
    if (r < nrows && c < s.l)
      __stcs((float4*)(out + (row0 + r) * s.l + c), q);
    return;
  }
  if (col >= s.l) return;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = rb + g + 8 * half;
    if (r >= nrows) continue;
    float* op = out + (row0 + r) * s.l + col;
    if ((s.l & 1) == 0) {
      __stcs((float2*)op, make_float2(o[2 * half], o[2 * half + 1]));
    } else {
      __stcs(op, o[2 * half]);
      if (col + 1 < s.l) __stcs(op + 1, o[2 * half + 1]);
    }
  }
}

// Registers: held to fit two blocks per SM (three with one m-tile per
// warp), which hides more of each block's barriers.
template <int MTW>
__global__ void __launch_bounds__(TP_THREADS, MTW == 1 ? 3 : 2)
tree_predict_kernel(const float* __restrict__ x, const float* __restrict__ F,
                    const float* __restrict__ v, const float* __restrict__ H,
                    const float* __restrict__ hsum,
                    const int* __restrict__ feat,
                    const uint2* __restrict__ hb,
                    const int* __restrict__ flags, float* __restrict__ out,
                    long long n, TpShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xbuf = (float*)smem;                        // [nbuf][bm][k]
  int* nf = (int*)(xbuf + s.nbuf * s.bm * s.k);     // [bm]
  uint4* as = (uint4*)(nf + s.bm);                   // [bm/16][kcn][32]
  // H's fragments for one (group, chunk): [nbt][kcn][32]; two buffers
  // unless H is staged once, so the next chunk's copy runs behind the mma.
  uint2* hs = (uint2*)(as + (s.bm / 16) * s.kcc * 32);
  const int hsz = s.nbt * s.kcc * 32;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm_i = warp / s.wn, wn_i = warp % s.wn;
  const bool mma_warp = warp < s.wm * s.wn;
  const bool exact = flags[0] == 0;          // scores on tensor cores
  const bool dot_nodes = flags[1] > 0;       // columns of F not one-hot
  const int n_groups = tp_ceil(s.nt_total, s.nbt);
  const int n_chunks = tp_ceil(s.kc_total, TP_KC);
  const long long ntiles = (n + s.bm - 1) / s.bm;
  // A work item is one leaf group of one tile, so a wide tree spreads over
  // every SM even for a few rows.
  const long long nitems = ntiles * n_groups;

  // Copy H's chunk `ch` of leaf group `grp` as [nbt][kcn][32] fragments
  // into `dst` (cp.async; the caller commits and waits).
  auto stage_h = [&](int grp, int ch, uint2* dst) {
    const int kcn = min(TP_KC, s.kc_total - ch * TP_KC);
    const int units = s.nbt * kcn * 16;      // uint4 = two lanes' fragments
    for (int u = tid; u < units; u += TP_THREADS) {
      const int q = u & 15, rest = u >> 4;
      const int kc = rest % kcn, ntl = rest / kcn;
      const int nt = grp * s.nbt + ntl;
      if (nt >= s.nt_total) continue;
      const uint4* src = (const uint4*)(hb +
          ((long long)nt * s.kc_total + ch * TP_KC + kc) * 32) + q;
      cp_async16((uint4*)(dst + (ntl * kcn + kc) * 32) + q, src);
    }
  };
  auto rows_of = [&](long long item) {
    const long long row0 = item / n_groups * s.bm;
    return (int)((n - row0) < s.bm ? (n - row0) : s.bm);
  };

  // the first item's (group, chunk); with H_once all of H
  stage_h((int)(blockIdx.x % n_groups), 0, hs);
  int buf = 0, hbuf = 0;
  if (s.k > 0 && (long long)blockIdx.x < nitems)
    tp_load_tile(xbuf, x, s, blockIdx.x / n_groups * s.bm,
                 rows_of(blockIdx.x));
  cp_async_commit();

  for (long long item = blockIdx.x; item < nitems; item += gridDim.x) {
    const int grp = (int)(item % n_groups);
    const long long row0 = item / n_groups * s.bm;
    const int nrows = rows_of(item);
    const long long next = item + gridDim.x;
    const float* xs = xbuf + buf * s.bm * s.k;

    // 1. the x tile (the next one starts loading behind it), then nf(row)
    // where the tile holds a NaN or Inf (rows past the end keep stale
    // counts and are never written).
    if (s.nbuf == 2) {
      if (s.k > 0 && next < nitems)
        tp_load_tile(xbuf + (buf ^ 1) * s.bm * s.k, x, s,
                     next / n_groups * s.bm, rows_of(next));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool clean =
        !__syncthreads_or(tp_any_nonfinite(xs, nrows * s.k, tid, TP_THREADS));
    if (!clean) {
      if (s.k <= 32) {
        for (int r = tid; r < nrows; r += TP_THREADS)
          nf[r] = tp_row_nonfinite(xs, s, r);
      } else {
        for (int r = warp; r < nrows; r += TP_WARPS) {
          const int cnt = tp_row_nonfinite_warp(xs, s, r, lane);
          if (lane == 0) nf[r] = cnt;
        }
      }
      __syncthreads();
    }

    float acc[MTW][TP_NTW][4];
#pragma unroll
    for (int i = 0; i < MTW; ++i)
#pragma unroll
      for (int j = 0; j < TP_NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int kcn = min(TP_KC, s.kc_total - ch * TP_KC);
      if (ch > 0) __syncthreads();   // the last chunk's mma is done

      // 2. predicates of this chunk, every row of the tile, as A fragments.
      // Each thread keeps one (k-step, lane) pair, so its four nodes' tests
      // load once, and walks the m-tiles.
      const int pairs = kcn * 32;
      const int per = TP_THREADS / pairs;    // threads per pair, >= 1
      if (tid < per * pairs) {
        const int pair = tid % pairs;
        const int ln = pair & 31, kc = pair >> 5;
        const int kbase = (ch * TP_KC + kc) * 16;
        int col[4];
        float th[4];
        tp_lane_nodes(feat, v, s, kbase, ln, col, th);
        const bool lo = kbase + 2 * (ln & 3) < s.p;
        const bool hi = kbase + 2 * (ln & 3) + 8 < s.p;
        for (int mt = tid / pairs; mt < s.bm / 16; mt += per) {
          const int r0 = mt * 16 + (ln >> 2);
          const float* x0 = xs + r0 * s.k;
          uint4 w = tp_fragment(x0, x0 + 8 * s.k, col, th, clean,
                                clean ? 0 : nf[r0], clean ? 0 : nf[r0 + 8],
                                lo, hi);
          if (dot_nodes) tp_patch_dots(&w, xs, F, feat, v, s, r0, kbase, ln);
          as[(mt * kcn + kc) * 32 + ln] = w;
        }
      }
      if (!s.h_once) {
        // The next chunk, of this item or the next one, loads into the
        // other buffer while this one's mma runs.
        if (ch + 1 < n_chunks)
          stage_h(grp, ch + 1, hs + (hbuf ^ 1) * hsz);
        else if (next < nitems)
          stage_h((int)(next % n_groups), 0, hs + (hbuf ^ 1) * hsz);
        cp_async_commit();
        cp_async_wait<1>();
      }
      __syncthreads();
      const uint2* hcur = hs + hbuf * hsz;
      if (!s.h_once) hbuf ^= 1;
      if (!mma_warp) continue;

      // 3. scores: this warp's MTW m-tiles by TP_NTW n-tiles
      for (int kc = 0; kc < kcn; ++kc) {
        if (exact) {
          uint4 a[MTW];
#pragma unroll
          for (int i = 0; i < MTW; ++i)
            a[i] = as[((wm_i * MTW + i) * kcn + kc) * 32 + lane];
#pragma unroll
          for (int j = 0; j < TP_NTW; ++j) {
            const int ntl = wn_i * TP_NTW + j;
            if (grp * s.nbt + ntl >= s.nt_total) continue;
            const uint2 b = hcur[(ntl * kcn + kc) * 32 + lane];
#pragma unroll
            for (int i = 0; i < MTW; ++i) mma_bf16(acc[i][j], a[i], b);
          }
        } else {
#pragma unroll
          for (int j = 0; j < TP_NTW; ++j)
#pragma unroll
            for (int i = 0; i < MTW; ++i)
              tp_scores_fp32(acc[i][j], as, kcn, wm_i * MTW + i, kc, H, s,
                             (ch * TP_KC + kc) * 16,
                             (grp * s.nbt + wn_i * TP_NTW + j) * 8 + 2 * t,
                             g);
        }
      }
    }

    // 4. compare and store this group's leaves
    if (mma_warp) {
#pragma unroll
      for (int j = 0; j < TP_NTW; ++j) {
        const int nt = grp * s.nbt + wn_i * TP_NTW + j;
        if (nt >= s.nt_total) continue;
        const int col = nt * 8 + 2 * t;
        const float hs0 = col < s.l ? __ldg(hsum + col) : 0.f;
        const float hs1 = col + 1 < s.l ? __ldg(hsum + col + 1) : 0.f;
#pragma unroll
        for (int i = 0; i < MTW; ++i)
          tp_store(out, s, row0, nrows, (wm_i * MTW + i) * 16, col,
                   acc[i][j], hs0, hs1, g, t);
      }
    }
    __syncthreads();
    if (s.nbuf == 2) {
      buf ^= 1;
    } else if (s.k > 0 && next < nitems) {
      tp_load_tile(xbuf, x, s, next / n_groups * s.bm, rows_of(next));
      cp_async_commit();
    }
  }
}

// Trees with l <= 16 and p <= 128 (the registry's): H and the node tests
// sit in shared memory for the whole kernel, and each warp takes its own
// msub m-tiles of a tile through the non-finite check, the predicates, the
// mma and the stores with no barrier in between, so one warp's stores
// overlap another's predicates.  Two barriers per tile guard the x buffers.
__global__ void __launch_bounds__(TP_THREADS, TP_NARROW_MIN_BLOCKS)
tree_predict_narrow_kernel(const float* __restrict__ x,
                           const float* __restrict__ F,
                           const float* __restrict__ v,
                           const float* __restrict__ H,
                           const float* __restrict__ hsum,
                           const int* __restrict__ feat,
                           const uint2* __restrict__ hb,
                           const int* __restrict__ flags,
                           float* __restrict__ out, long long n, TpShape s) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xbuf = (float*)smem;                        // [nbuf][bm][k]
  int* nf = (int*)(xbuf + s.nbuf * s.bm * s.k);     // [bm]
  uint4* as = (uint4*)(nf + s.bm);                   // [bm/16][kcs][32]
  uint2* hs = (uint2*)(as + (s.bm / 16) * s.kcc * 32);  // [nts][kcs][32]
  // Per (k-step, lane): tp_lane_nodes' columns and thresholds.
  int4* ncol = (int4*)(hs + s.nt_total * s.kcc * 32);  // [kcs][32]
  float4* nth = (float4*)(ncol + s.kcc * 32);          // [kcs][32]

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kcs = s.kcc, nts = s.nt_total;
  const bool exact = flags[0] == 0;
  const bool dot_nodes = flags[1] > 0;
  const long long ntiles = (n + s.bm - 1) / s.bm;

  for (int u = tid; u < nts * kcs * 16; u += TP_THREADS)
    ((uint4*)hs)[u] = __ldg((const uint4*)hb + u);
  for (int i = tid; i < kcs * 32; i += TP_THREADS) {
    int c[4];
    float th[4];
    tp_lane_nodes(feat, v, s, (i >> 5) * 16, i & 31, c, th);
    ncol[i] = make_int4(c[0], c[1], c[2], c[3]);
    nth[i] = make_float4(th[0], th[1], th[2], th[3]);
  }
  float hs0[2], hs1[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = j * 8 + 2 * t;
    hs0[j] = col < s.l ? __ldg(hsum + col) : 0.f;
    hs1[j] = col + 1 < s.l ? __ldg(hsum + col + 1) : 0.f;
  }
  auto rows_of = [&](long long tile) {
    const long long row0 = tile * s.bm;
    return (int)((n - row0) < s.bm ? (n - row0) : s.bm);
  };

  int buf = 0;
  if (s.k > 0 && (long long)blockIdx.x < ntiles)
    tp_load_tile(xbuf, x, s, blockIdx.x * s.bm, rows_of(blockIdx.x));
  cp_async_commit();
  const int wrows = s.msub * 16;           // rows of this warp in a tile
  const int rw = warp * wrows;

  for (long long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long long row0 = tile * s.bm;
    const int nrows = rows_of(tile);
    const long long next = tile + gridDim.x;
    const float* xs = xbuf + buf * s.bm * s.k;
    if (s.nbuf == 2) {
      if (s.k > 0 && next < ntiles)
        tp_load_tile(xbuf + (buf ^ 1) * s.bm * s.k, x, s, next * s.bm,
                     rows_of(next));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Is any feature of this warp's rows (one contiguous, 16-byte aligned
    // run of the tile) NaN or ±Inf?  Only then count nf.
    const int wlen = max(0, min(wrows, nrows - rw)) * s.k;
    const bool clean =
        !__any_sync(0xffffffffu,
                    tp_any_nonfinite(xs + rw * s.k, wlen, lane, 32));
    if (!clean) {
      if (s.k <= 32) {
        for (int r = rw + lane; r < rw + wrows; r += 32)
          nf[r] = tp_row_nonfinite(xs, s, r);
      } else {
        for (int r = rw; r < rw + wrows; ++r) {
          const int cnt = tp_row_nonfinite_warp(xs, s, r, lane);
          if (lane == 0) nf[r] = cnt;
        }
      }
      __syncwarp();
    }

    // predicates of this warp's m-tiles as A fragments
    for (int kc = 0; kc < kcs; ++kc) {
      const int kbase = kc * 16;
      const int4 cv = ncol[kc * 32 + lane];
      const float4 tv = nth[kc * 32 + lane];
      const int col[4] = {cv.x, cv.y, cv.z, cv.w};
      const float th[4] = {tv.x, tv.y, tv.z, tv.w};
      const bool lo = kbase + 2 * t < s.p, hi = kbase + 2 * t + 8 < s.p;
      for (int m = 0; m < s.msub; ++m) {
        const int mt = warp * s.msub + m;
        const int r0 = mt * 16 + g;
        const float* x0 = xs + r0 * s.k;
        uint4 w = tp_fragment(x0, x0 + 8 * s.k, col, th, clean,
                              clean ? 0 : nf[r0], clean ? 0 : nf[r0 + 8],
                              lo, hi);
        if (dot_nodes) tp_patch_dots(&w, xs, F, feat, v, s, r0, kbase, lane);
        as[(mt * kcs + kc) * 32 + lane] = w;
      }
    }
    __syncwarp();

    // scores and stores, one m-tile at a time
    for (int m = 0; m < s.msub; ++m) {
      const int mt = warp * s.msub + m;
      float acc[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      for (int kc = 0; kc < kcs; ++kc) {
        if (exact) {
          const uint4 a = as[(mt * kcs + kc) * 32 + lane];
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (j < nts) mma_bf16(acc[j], a, hs[(j * kcs + kc) * 32 + lane]);
        } else {
#pragma unroll
          for (int j = 0; j < 2; ++j)
            tp_scores_fp32(acc[j], as, kcs, mt, kc, H, s, kc * 16,
                           j * 8 + 2 * t, g);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (j < nts)
          tp_store(out, s, row0, nrows, mt * 16, j * 8 + 2 * t, acc[j],
                   hs0[j], hs1[j], g, t);
    }
    __syncthreads();
    if (s.nbuf == 2) {
      buf ^= 1;
    } else if (s.k > 0 && next < ntiles) {
      tp_load_tile(xbuf, x, s, next * s.bm, rows_of(next));
      cp_async_commit();
    }
  }
}

// Blocks of `kernel` with `smem` bytes that fit the current device at once.
// The kernel's shared-memory limit is set to the most a block may take, so
// no launch, from any thread, finds it lower than it needs.
static cudaError_t tp_resident_blocks(const void* kernel, long long smem,
                                      long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TP_MAX_SMEM);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      TP_THREADS, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = (long long)sms * per_sm;
  return cudaSuccess;
}

template <typename Kernel>
static int tp_launch_main(Kernel kernel, const float* x, const float* F,
                          const float* v, const float* H, const float* hsum,
                          const int* feat, const uint2* hb, const int* flags,
                          float* out, long long n, const TpShape& s,
                          cudaStream_t stream) {
  const long long smem = tp_smem(s);
  long long resident = 0;
  cudaError_t err = tp_resident_blocks((const void*)kernel, smem, &resident);
  if (err != cudaSuccess) return (int)err;
  long long blocks = (n + s.bm - 1) / s.bm;
  if (!s.narrow) blocks *= tp_ceil(s.nt_total, s.nbt);   // leaf groups
  if (blocks > resident) blocks = resident;
  kernel<<<(unsigned)blocks, TP_THREADS, (size_t)smem, stream>>>(
      x, F, v, H, hsum, feat, hb, flags, out, n, s);
  return (int)cudaGetLastError();
}

// Scratch layout (bytes): feat (int32[p]) at 0, then, 256-byte aligned,
// H's bf16 fragments (ceil(l/8) * ceil(p/16) * 256 bytes).
static long long tp_hb_offset(int p) {
  return ((4LL * p + 255) / 256) * 256;
}

extern "C" long long tree_predict_scratch_bytes(int p, int l) {
  if (p < 0 || l < 1) return -1;
  return tp_hb_offset(p) + 256LL * tp_ceil(l, 8) * tp_ceil(p, 16);
}

// Dynamic shared memory one block takes for (k, p, l); -1 if no tile fits.
extern "C" long long tree_predict_smem_bytes(int k, int p, int l) {
  TpShape s;
  if (k < 0 || p < 0 || l < 1) return -1;
  if (tp_plan(k, p, l, true, &s) == 0) return -1;
  return tp_smem(s);
}

// Launches on `stream`; returns the first CUDA error (0 on success).
// x: (n, k); F: (k, p); v: (p,); H: (p, l); hsum: (l,); out: (n, l); all
// float32 and contiguous.  scratch: tree_predict_scratch_bytes(p, l) bytes,
// 256-byte aligned.  flags: int32[2], set here (flags[0]: H not in
// {-1, 0, 1}, so the fp32 score branch ran; flags[1]: columns of F that
// are not one-hot).
extern "C" int tree_predict_launch(const void* x, const void* F,
                                   const void* v, const void* H,
                                   const void* hsum, void* out, long long n,
                                   int k, int p, int l, void* scratch,
                                   void* flags, void* stream) {
  if (n < 0 || k < 0 || p < 0 || l < 1) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  TpShape s;
  const bool vec = ((uintptr_t)x & 15) == 0;
  const int mtw = tp_plan(k, p, l, vec, &s);
  if (mtw == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int* fl = (int*)flags;
  int* feat = (int*)scratch;
  uint2* hb = (uint2*)((char*)scratch + tp_hb_offset(p));
  cudaError_t err = cudaMemsetAsync(fl, 0, 2 * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const long long units = (long long)s.nt_total * s.kc_total * 32;
  const long long prep_blocks =
      tp_ceil(p, 32) + (units + TP_THREADS - 1) / TP_THREADS;
  if (prep_blocks > 0) {
    tree_predict_prep<<<(unsigned)prep_blocks, TP_THREADS, 0, st>>>(
        (const float*)F, (const float*)H, k, p, l, s.kc_total, s.nt_total,
        feat, hb, fl);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float *xf = (const float*)x, *Ff = (const float*)F,
              *vf = (const float*)v, *Hf = (const float*)H,
              *hf = (const float*)hsum;
  float* o = (float*)out;
  if (s.narrow)
    return tp_launch_main(tree_predict_narrow_kernel, xf, Ff, vf, Hf, hf, feat,
                          hb, fl, o, n, s, st);
  if (mtw == 4)
    return tp_launch_main(tree_predict_kernel<4>, xf, Ff, vf, Hf, hf, feat,
                          hb, fl, o, n, s, st);
  if (mtw == 2)
    return tp_launch_main(tree_predict_kernel<2>, xf, Ff, vf, Hf, hf, feat,
                          hb, fl, o, n, s, st);
  return tp_launch_main(tree_predict_kernel<1>, xf, Ff, vf, Hf, hf, feat, hb,
                        fl, o, n, s, st);
}
