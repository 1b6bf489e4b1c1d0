// 1-NN variants for Hopper (sm_90a): the squared distance and index of the
// nearest target for every query, in the three forms of the NN-variant
// microbench.
//
// Replaces the Pallas TPU kernels of tools/bench_nn_variants.py:
//   * _nn_kernel_packed (launched by nearest_packed)  -> form 0 (K3)
//   * _nn_kernel_aug    (launched by nearest_aug)     -> form 1 (K4,
//                                                        packed=True) and
//                                                        form 2 (packed=False)
// One template serves the three.
//
// Operands keep the TPU kernels' transposed layout: q [8, M] and t [8, N]
// f32, row-major, so row r of query j is q[r * M + j].  They are finite
// (padding is 1e6, as everywhere in the port).  What each form computes:
//   form 0   d2 = |t|^2 + sum_r q_r (-2 t_r), then + |q|^2 (the f32
//            expansion over the 8 rows; the _pad8 layout is x, y, z, 0...);
//            the packed key below;
//   form 1   d2 = sum_r q_r t_r (the augmented rows -2x, -2y, -2z, |q|^2, 1
//            against x, y, z, 1, |t|^2: the contraction *is* d2); the packed
//            key;
//   form 2   the same d2; its minimum and the first index reaching it, then
//            d = max(d2, 0).
// The packed key is key = (bits(max(d2, 0)) & ~low) | (col & low) with
// low = 2^idx_bits - 1: d is the minimum key with its low bits cleared (a
// truncated d2) and i its low bits.  The wrapper refuses N > 2^idx_bits, so
// col & low is col, and the minimum key is the lowest column whose
// truncated clamped d2 is the least.
//
// Bound: M*N pairs of 6 FP32 operations (3 FMAs once |t|^2 and -2t are
// known per target and |q|^2 is added once per query), over the H100's
// 67 TFLOP/s outside the tensor cores: 0.003005 ms at 16384 x 2048.  The
// bytes (32 per query and target column, 8 per output) are far below.  One
// warp instruction issues per clock per SM quarter, so every instruction a
// pair counts against the FMAs.  The design:
//   * R queries a thread, their 8 rows in registers, read straight from the
//     transposed layout (coalesced across lanes).  One broadcast LDS.128 of
//     a target feeds R pairs.
//   * Only the rows that are not zero.  Each warp checks once, with
//     __any_sync on the rows it already holds, whether its queries' rows
//     past 3 or past 5 are all zero, and walks the targets with the 3-row
//     (_pad8), 5-row (aug_q) or 8-row loop.  For finite operands a skipped
//     term is exact: fmaf(0, t, acc) == acc (up to the sign of a zero sum,
//     which neither the min nor the clamp sees).
//   * Targets staged in shared memory, in the form the loops read: form 0
//     stores (-2t0, -2t1, -2t2, |t|^2), (-2t3..-2t6), (-2t7) in three float4
//     slots; forms 1 and 2 store (t0..t3), (t4..t7) in two.  |t|^2 always
//     sums all 8 rows.  The next tile is loaded into registers while the
//     current one is consumed (a register prefetch of kPrefetch targets a
//     thread).
//   * The reduction: over a group of kGroup targets a thread keeps a running
//     fminf per query of the value the loop computes (form 0: d2 - |q|^2,
//     forms 1 and 2: d2), then one group value: form 0 adds |q|^2 once per
//     group, the packed forms clamp and truncate once per group, and a
//     strict '<' keeps (best value, group start).  This is exact: rounding
//     a sum, clamping at 0 and clearing low bits are all monotone
//     non-decreasing, so min_j f(x_j) = f(min_j x_j), and the first group
//     whose value reaches the least holds the lowest column reaching it.
//     At the end the thread re-evaluates the best group (every evaluation
//     is written with __fmaf_rn / __fadd_rn, so it is the same bit for bit)
//     and takes the first column whose value equals the best: the minimum
//     key's column, or form 2's first argmin.  The group comes from the
//     last tile in shared memory where it lies there (always, for a split
//     of one tile), else from device memory through the same staging.
//   * Targets split across blocks: the grid is (query tiles, S).  With
//     S > 1 each block writes its (best value, index) partials to a scratch
//     [S, M], and nn_variant_merge reads the S partials of a query in split
//     order with a strict '<', so the lowest index wins ties: deterministic,
//     no atomics, no initialised buffer.  With S = 1 the main kernel writes
//     the outputs.  The plan (R, block, S, split length) is chosen by
//     ops/nn_variants.py::plan.  A merge inside a thread-block cluster (the
//     S blocks of a query tile as one cluster, the partials read from the
//     other blocks' shared memory, no second kernel) was built and measured
//     slower for K3 at 16384 x 2048 on an H100: 18.9 against 14.2 us a call
//     at R = 2, block 256, S = 8, and 16.7 at its own best plan; the
//     cluster launch slowed the split kernel by more than the 1.6 us that
//     the merge kernel costs (PERF.md).
// Issued instructions a pair, counted in the SASS of the R = 2 instances
// (a group of 16 targets x 2 queries): the 3-row loop 159 a group, 4.97 a
// pair (3 FFMA, 15/16 FMNMX, 1/2 LDS.128, the rest the group's end), a
// ceiling of 60% of the bound at one instruction a clock; the 5-row loop
// 237, 7.4 (41%); the 8-row loop 352 for form 0, 11.0 (27%).  At the bench
// shape a K3 call takes about 2.8 times its loop's issue time on an H100
// (PERF.md): the fixed costs of a short block (loads, staging, recovery)
// and the merge launch weigh more than the loop.
//
// No tensor cores: 3xTF32 mma.sync.m16n8k8 would take the FFMAs off the
// FP32 pipes, but not the FMNMX of every pair, and the exact index needs the
// pair re-evaluated bit for bit, which an MMA's internal order does not
// promise.  No TMA: each 32-byte column is transformed (-2t, |t|^2) on its
// way into shared memory, and staging is a few percent of the instructions.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kRows = 8;
constexpr int kGroup = 16;      // targets per running-min group
constexpr int kPrefetch = 2;    // targets per thread per shared tile
constexpr int kMaxSplits = 8;   // S at most: the merge's loads, unrolled

enum Form { kPacked = 0, kAugPacked = 1, kAug = 2 };

template <int kForm>
struct Traits {
  static constexpr bool kExpanded = kForm == kPacked;
  static constexpr bool kKey = kForm != kAug;
  static constexpr int kSlots = kExpanded ? 3 : 2;
};

// A target's 8 rows in the form of the shared tile (the first kSlots of s).
template <int kForm>
__device__ __forceinline__ void stage(const float (&v)[kRows],
                                      float4 (&s)[3]) {
  if constexpr (Traits<kForm>::kExpanded) {
    float t2 = __fmul_rn(v[7], v[7]);
#pragma unroll
    for (int r = kRows - 2; r >= 0; --r) t2 = __fmaf_rn(v[r], v[r], t2);
    float m[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) m[r] = __fmul_rn(-2.f, v[r]);
    s[0] = make_float4(m[0], m[1], m[2], t2);
    s[1] = make_float4(m[3], m[4], m[5], m[6]);
    s[2] = make_float4(m[7], 0.f, 0.f, 0.f);
  } else {
    s[0] = make_float4(v[0], v[1], v[2], v[3]);
    s[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Target row r (a constant once unrolled) of the staged slots: -2 t_r for
// form 0, t_r for forms 1 and 2.
template <int kForm>
__device__ __forceinline__ float target_row(const float4 (&s)[3], int r) {
  if constexpr (Traits<kForm>::kExpanded) {
    switch (r) {
      case 0: return s[0].x;
      case 1: return s[0].y;
      case 2: return s[0].z;
      case 3: return s[1].x;
      case 4: return s[1].y;
      case 5: return s[1].z;
      case 6: return s[1].w;
      default: return s[2].x;
    }
  } else {
    switch (r) {
      case 0: return s[0].x;
      case 1: return s[0].y;
      case 2: return s[0].z;
      case 3: return s[0].w;
      case 4: return s[1].x;
      case 5: return s[1].y;
      case 6: return s[1].z;
      default: return s[1].w;
    }
  }
}

// The value the loop reduces for one pair, over the first KR query rows:
// form 0 d2 - |q|^2 = |t|^2 + sum q_r (-2 t_r), forms 1 and 2 d2.  Rows are
// summed from the highest down, so that dropping zero rows changes nothing.
template <int kForm, int KR>
__device__ __forceinline__ float pair_value(const float (&q)[kRows],
                                            const float4 (&s)[3]) {
  float acc = 0.f;
  if constexpr (Traits<kForm>::kExpanded) acc = s[0].w;      // |t|^2
#pragma unroll
  for (int r = KR - 1; r >= 0; --r)
    acc = __fmaf_rn(q[r], target_row<kForm>(s, r), acc);
  return acc;
}

// The slots of target j of a shared tile that the KR-row loop reads.
template <int kForm, int KR, int kTile>
__device__ __forceinline__ void load_slots(
    const float4 (&tile)[Traits<kForm>::kSlots][kTile], int j,
    float4 (&s)[3]) {
  s[0] = tile[0][j];
  if constexpr (KR > 3) s[1] = tile[1][j];
  if constexpr (Traits<kForm>::kExpanded && KR > 7) s[2] = tile[2][j];
}

// The value a group (or a single pair) is ranked by, from the reduced
// value x: form 0 adds |q|^2; the packed forms clamp at 0 and clear the low
// bits (as an int, so that -0 clamps to +0).  Monotone in x.
template <int kForm>
__device__ __forceinline__ float rank_value(float x, float q2, int low) {
  if constexpr (Traits<kForm>::kExpanded) x = __fadd_rn(x, q2);
  if constexpr (Traits<kForm>::kKey)
    x = __int_as_float(max(__float_as_int(x), 0) & ~low);
  return x;
}

// One shared tile of cnt targets starting at target `base`, walked by the
// KR-row loop: the running min over each group, then the strict '<'.
template <int kForm, int KR, int R, int kTile>
__device__ __forceinline__ void walk_tile(
    const float4 (&tile)[Traits<kForm>::kSlots][kTile], int base, int cnt,
    const float (&q)[R][kRows], const float (&q2)[R], int low,
    float (&best)[R], int (&best_g)[R]) {
  const int full = cnt / kGroup;
  for (int g = 0; g < full; ++g) {
    const int o = g * kGroup;
    float gm[R];
    float4 s[3];
    load_slots<kForm, KR>(tile, o, s);
#pragma unroll
    for (int r = 0; r < R; ++r) gm[r] = pair_value<kForm, KR>(q[r], s);
#pragma unroll
    for (int j = 1; j < kGroup; ++j) {
      load_slots<kForm, KR>(tile, o + j, s);
#pragma unroll
      for (int r = 0; r < R; ++r)
        gm[r] = fminf(gm[r], pair_value<kForm, KR>(q[r], s));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = rank_value<kForm>(gm[r], q2[r], low);
      if (v < best[r]) {
        best[r] = v;
        best_g[r] = base + o;
      }
    }
  }
  if (cnt > full * kGroup) {            // a ragged last group: N's end
    const int o = full * kGroup;
    float gm[R];
#pragma unroll
    for (int r = 0; r < R; ++r) gm[r] = CUDART_INF_F;
    for (int j = o; j < cnt; ++j) {
      float4 s[3];
      load_slots<kForm, KR>(tile, j, s);
#pragma unroll
      for (int r = 0; r < R; ++r)
        gm[r] = fminf(gm[r], pair_value<kForm, KR>(q[r], s));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float v = rank_value<kForm>(gm[r], q2[r], low);
      if (v < best[r]) {
        best[r] = v;
        best_g[r] = base + o;
      }
    }
  }
}

// The first column of the group at `g0` whose rank value is `best`.  The
// group is read from the last tile (at target `last_base`) where it lies
// there, each lane starting at its own offset (group starts are multiples
// of kGroup, so lanes walking in step would hit one bank); else from device
// memory through stage().  No break, so all loads are in flight together.
template <int kForm, int KR, int kTile>
__device__ __forceinline__ int recover(
    const float4 (&tile)[Traits<kForm>::kSlots][kTile], const float* t, int n,
    int g0, int last_base, int split_end, const float (&q)[kRows], float q2,
    int low, float best) {
  int first = kGroup;
  if (g0 >= last_base) {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int jj = (j + threadIdx.x) & (kGroup - 1);
      if (g0 + jj < split_end) {
        float4 s[3];
        load_slots<kForm, KR>(tile, g0 - last_base + jj, s);
        if (rank_value<kForm>(pair_value<kForm, KR>(q, s), q2, low) == best)
          first = min(first, jj);
      }
    }
  } else {
#pragma unroll
    for (int j = kGroup - 1; j >= 0; --j) {
      const int k = g0 + j;
      if (k < split_end) {
        float v[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) v[r] = t[(long long)r * n + k];
        float4 s[3];
        stage<kForm>(v, s);
        if (rank_value<kForm>(pair_value<kForm, KR>(q, s), q2, low) == best)
          first = j;
      }
    }
  }
  return g0 + (first < kGroup ? first : 0);
}

// This thread's kPrefetch targets of the tile at `base`, into registers.
template <int BT>
__device__ __forceinline__ void fetch(const float* t, int n, int base,
                                      int split_end,
                                      float (&v)[kPrefetch][kRows]) {
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p) {
    const int j = base + p * BT + threadIdx.x;
    if (j < split_end) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[p][r] = t[(long long)r * n + j];
    }
  }
}

template <int kForm>
__device__ __forceinline__ float finish(float best) {
  return Traits<kForm>::kKey ? best : (best > 0.f ? best : 0.f);
}

template <int kForm, int R, int BT>
__global__ void __launch_bounds__(BT)
nn_variant(const float* __restrict__ q, const float* __restrict__ t,
           float* __restrict__ d_out, int* __restrict__ i_out,
           float* __restrict__ part_v, int* __restrict__ part_i, int m, int n,
           int split_len, int idx_bits) {
  constexpr int kSlots = Traits<kForm>::kSlots;
  constexpr int kTile = BT * kPrefetch;
  constexpr int kQ = R * BT;             // queries a block
  static_assert(kTile % kGroup == 0, "a tile holds whole groups");
  static_assert((kGroup & (kGroup - 1)) == 0, "kGroup is a power of 2");
  __shared__ float4 tile[kSlots][kTile];

  const int tx = threadIdx.x;
  const int s = blockIdx.y;
  const int split_start = s * split_len;
  const int split_end = min(n, split_start + split_len);
  const long long q0 = (long long)blockIdx.x * kQ;
  const int low = (1 << idx_bits) - 1;

  // the first tile's targets, in flight while the queries load
  float pv[kPrefetch][kRows] = {};
  fetch<BT>(t, n, split_start, split_end, pv);

  float qr[R][kRows], q2[R], best[R];
  int best_g[R];
  bool nz3 = false, nz5 = false;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = q0 + r * BT + tx;
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      qr[r][k] = qi < m ? q[(long long)k * m + qi] : 0.f;
      if (k >= 5) nz5 |= qr[r][k] != 0.f;
      else if (k >= 3) nz3 |= qr[r][k] != 0.f;
    }
    q2[r] = __fmul_rn(qr[r][7], qr[r][7]);
#pragma unroll
    for (int k = kRows - 2; k >= 0; --k)
      q2[r] = __fmaf_rn(qr[r][k], qr[r][k], q2[r]);
    best[r] = CUDART_INF_F;
    best_g[r] = split_start;
  }
  // the rows this warp's loop needs (warp-uniform)
  const int rows = __any_sync(0xffffffffu, nz5)         ? 8
                   : __any_sync(0xffffffffu, nz3 || nz5) ? 5
                                                         : 3;

  for (int base = split_start; base < split_end; base += kTile) {
    __syncthreads();                       // previous tile fully consumed
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p) {
      const int j = p * BT + tx;
      if (base + j < split_end) {
        float4 st[3];
        stage<kForm>(pv[p], st);
#pragma unroll
        for (int k = 0; k < kSlots; ++k) tile[k][j] = st[k];
      }
    }
    __syncthreads();
    if (base + kTile < split_end)                        // in flight now
      fetch<BT>(t, n, base + kTile, split_end, pv);
    const int cnt = min(kTile, split_end - base);
    if (rows == 3)
      walk_tile<kForm, 3, R>(tile, base, cnt, qr, q2, low, best, best_g);
    else if (rows == 5)
      walk_tile<kForm, 5, R>(tile, base, cnt, qr, q2, low, best, best_g);
    else
      walk_tile<kForm, 8, R>(tile, base, cnt, qr, q2, low, best, best_g);
  }

  // recovery: the last tile is still in shared memory
  const int last_base =
      split_start + max(0, split_end - split_start - 1) / kTile * kTile;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = q0 + r * BT + tx;
    int idx = best_g[r];
    if (qi < m && split_end > split_start) {
      if (rows == 3)
        idx = recover<kForm, 3>(tile, t, n, best_g[r], last_base, split_end,
                                qr[r], q2[r], low, best[r]);
      else if (rows == 5)
        idx = recover<kForm, 5>(tile, t, n, best_g[r], last_base, split_end,
                                qr[r], q2[r], low, best[r]);
      else
        idx = recover<kForm, 8>(tile, t, n, best_g[r], last_base, split_end,
                                qr[r], q2[r], low, best[r]);
    }
    if (qi >= m) continue;
    if (gridDim.y == 1) {
      d_out[qi] = finish<kForm>(best[r]);
      i_out[qi] = idx;
    } else {
      part_v[(long long)s * m + qi] = best[r];
      part_i[(long long)s * m + qi] = idx;
    }
  }
}

// The S partials of each query in split order, strict '<': the lowest index
// wins ties.  All S loads are issued before the compares.
template <int kForm>
__global__ void nn_variant_merge(const float* __restrict__ part_v,
                                 const int* __restrict__ part_i,
                                 float* __restrict__ d_out,
                                 int* __restrict__ i_out, int m, int splits) {
  const long long qi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (qi >= m) return;
  float v[kMaxSplits];
  int i[kMaxSplits];
#pragma unroll
  for (int k = 0; k < kMaxSplits; ++k) {
    if (k < splits) {
      v[k] = part_v[(long long)k * m + qi];
      i[k] = part_i[(long long)k * m + qi];
    }
  }
  float b = v[0];
  int bi = i[0];
#pragma unroll
  for (int k = 1; k < kMaxSplits; ++k) {
    if (k < splits && v[k] < b) {
      b = v[k];
      bi = i[k];
    }
  }
  d_out[qi] = finish<kForm>(b);
  i_out[qi] = bi;
}

template <int kForm, int R, int BT>
int launch(dim3 grid, cudaStream_t st, const float* q, const float* t,
           float* d, int* idx, float* part_v, int* part_i, int m, int n,
           int split_len, int idx_bits) {
  nn_variant<kForm, R, BT><<<grid, BT, 0, st>>>(
      q, t, d, idx, part_v, part_i, m, n, split_len, idx_bits);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || grid.y == 1) return static_cast<int>(e);
  constexpr int kMergeBlock = 256;
  nn_variant_merge<kForm><<<(m + kMergeBlock - 1) / kMergeBlock, kMergeBlock,
                            0, st>>>(part_v, part_i, d, idx, m, grid.y);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int BT>
int launch_form(int form, dim3 grid, cudaStream_t st, const float* q,
                const float* t, float* d, int* idx, float* part_v,
                int* part_i, int m, int n, int split_len, int idx_bits) {
  switch (form) {
    case kPacked:
      return launch<kPacked, R, BT>(grid, st, q, t, d, idx, part_v, part_i,
                                    m, n, split_len, idx_bits);
    case kAugPacked:
      return launch<kAugPacked, R, BT>(grid, st, q, t, d, idx, part_v, part_i,
                                       m, n, split_len, idx_bits);
    case kAug:
      return launch<kAug, R, BT>(grid, st, q, t, d, idx, part_v, part_i, m, n,
                                 split_len, idx_bits);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// form 0: expanded + packed key (K3); 1: augmented + packed key (K4
// packed); 2: augmented, min and first argmin (K4).  q: [8, m] f32;
// t: [8, n] f32; d: [m] f32; idx: [m] i32; part_v, part_i: [splits, m]
// scratch, unused when splits == 1.  The plan: r queries a thread, block
// threads, splits target slices of split_len targets (a multiple of kGroup,
// none empty; split s covers [s * split_len, min(n, (s + 1) *
// split_len))).  Launches on `stream` and returns the launches' CUDA error
// (0 on success), or -1 for a plan this file has no instance of.
extern "C" int nn_variant_forward(int form, const float* q, const float* t,
                                  float* d, int* idx, float* part_v,
                                  int* part_i, int m, int n, int idx_bits,
                                  int r, int block, int splits,
                                  int split_len, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || idx_bits < 1 || idx_bits > 30 || splits < 1 ||
      splits > kMaxSplits || split_len <= 0 || split_len % kGroup != 0 ||
      (long long)(splits - 1) * split_len >= n ||
      (long long)splits * split_len < n)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long per_block = (long long)r * block;
  if (per_block <= 0) return -1;
  const dim3 grid(static_cast<unsigned>((m + per_block - 1) / per_block),
                  splits);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NV_CASE(RR, BB)                                                    \
  if (r == RR && block == BB)                                              \
    return launch_form<RR, BB>(form, grid, st, q, t, d, idx, part_v,      \
                               part_i, m, n, split_len, idx_bits);
  NV_CASE(2, 128) NV_CASE(2, 256) NV_CASE(4, 64) NV_CASE(4, 128)
#undef NV_CASE
  return -1;
}
