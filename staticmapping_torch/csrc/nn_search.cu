// Brute-force 1-NN for Hopper (sm_90a): squared distance and index of the
// nearest target for every query, over a batch of (query set, target set)
// pairs.
//
// Replaces the two Pallas TPU kernels of staticmapping_tpu/ops/nn_search.py:
//   * _nn_kernel          (launched by _nearest_pallas)         -> batch = 1
//   * _nn_kernel_batched  (launched by _nearest_pallas_batched) -> batch = B
// One kernel serves both: blockIdx.z is the batch index, and a broadcast
// operand is passed with batch stride 0 (as the TPU wrapper broadcast it).
//
// What it computes: for query q and the targets t_0..t_{N-1} of its batch
// element, idx = the lowest j reaching min_j fl(d'(q, t_j)), and
// d2 = |q - t_idx|^2 in FP32, where
//   d'(q, t) = fma(qx, -2tx, fma(qy, -2ty, fma(qz, -2tz, |t|^2)))
// is d^2 - |q|^2: |q|^2 does not change the argmin, so it is never added.
// Invalid targets are moved far away (1e6) by the caller, as nearest_1 does
// on the TPU.  Ragged M and N are masked here.  d' is selection-grade, as
// the TPU kernel's bf16x3 contraction is; the d2 output is recomputed for
// the chosen target in the difference form, so a duplicate of the query
// gives exactly 0.
//
// Bound: M*N*B pairs of 6 FP32 operations (the 3 FMAs of d') over the
// H100's 67 TFLOP/s outside the tensor cores; the bytes (12 per query and
// target, 8 per output) are far below that.  The card issues one warp
// instruction per clock per SM quarter, so every other instruction a pair
// costs counts against the FMAs: at least one FMNMX a pair, so 3 of 4
// issue slots (75% of the bound) is this design's ceiling.  The inner loop
// issues 3 FFMA + 15/16 FMNMX + 1/R LDS.128 + about 7/(16 R) a pair (4.75
// at R = 2, 4.44 at R = 4):
//   * staging: a block turns its target slice into float4
//     (-2x, -2y, -2z, |t|^2) in shared memory, one tile of kPrefetch
//     targets per thread at a time; the next tile is loaded into registers
//     (a register prefetch) while the current one is consumed;
//   * register tiling: each thread holds R queries, so one broadcast
//     LDS.128 of a target feeds R pairs of 3 FFMA each;
//   * reduction: over a group of kGroup consecutive targets a thread keeps a
//     running fminf per query (kGroup - 1 FMNMX per kGroup pairs), and after
//     the group one compare and two selects keep (best d', group start).  At
//     the end it recomputes d' over the best group: the first j whose d'
//     equals the best is the index.  The group comes from the last tile in
//     shared memory where it lies there (always, for a split of one tile),
//     else from device memory through the same augment(); both are written
//     with __fmaf_rn / __fmul_rn so that -fmad contraction cannot compute
//     |t|^2 differently in two places.  The result is exactly the first
//     index of the minimum of fl(d'), the strict '<' rule of _nearest_scan.
//     The recovery costs kGroup evaluations a query and split, scattered
//     across lanes, so kGroup trades the group overhead of the long splits
//     against the recovery of the short ones (16 measured best);
//   * targets split across blocks: the grid is (query tiles, S splits,
//     batch).  With S > 1 each block writes its (best d', idx) to a scratch
//     [S, B, M] and nn_merge reads the S partials in split order with a
//     strict '<', so the lowest index wins ties: deterministic, no atomics,
//     no initialised buffer.  With S = 1 the main kernel writes the outputs.
//     The plan (R, block, S, split length) is chosen by ops/nn_search.py.
//
// No tensor cores: the contraction has 5 useful rows; FP32-grade d' in TF32
// needs three K=8 passes (48 tensor-core flops a pair against 6 FP32 ones),
// and one bf16x3 K=16 pass (the TPU's own form) is less exact at 70 m
// coordinates.  Either way the min over every pair still costs at least one
// FP32-pipe instruction a pair, so the tensor cores would remove at most
// the 3 FFMA.  No TMA: the rows are 12 bytes and each tile is transformed on
// its way into shared memory, and staging is well under 1% of the issued
// instructions.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kGroup = 16;     // targets per running-min group
constexpr int kPrefetch = 4;   // targets per thread per shared tile

__device__ __forceinline__ float4 augment(float x, float y, float z) {
  const float w = __fmaf_rn(x, x, __fmaf_rn(y, y, __fmul_rn(z, z)));
  return make_float4(__fmul_rn(-2.f, x), __fmul_rn(-2.f, y),
                     __fmul_rn(-2.f, z), w);
}

// d^2 - |q|^2 against an augmented target
__device__ __forceinline__ float dprime(float qx, float qy, float qz,
                                        float4 a) {
  return __fmaf_rn(qx, a.x, __fmaf_rn(qy, a.y, __fmaf_rn(qz, a.z, a.w)));
}

// |q - t|^2 in the difference form
__device__ __forceinline__ float diff_d2(float qx, float qy, float qz,
                                         const float* t) {
  const float dx = qx - t[0];
  const float dy = qy - t[1];
  const float dz = qz - t[2];
  return fmaf(dx, dx, fmaf(dy, dy, dz * dz));
}

// This thread's kPrefetch targets of the tile at `base`, into registers.
template <int BT>
__device__ __forceinline__ void fetch(const float* tb, int base,
                                      int split_end, float (&px)[kPrefetch],
                                      float (&py)[kPrefetch],
                                      float (&pz)[kPrefetch]) {
#pragma unroll
  for (int p = 0; p < kPrefetch; ++p) {
    const int j = base + p * BT + threadIdx.x;
    if (j < split_end) {
      const float* t = tb + 3LL * j;
      px[p] = t[0];
      py[p] = t[1];
      pz[p] = t[2];
    }
  }
}

template <int R, int BT>
__global__ void __launch_bounds__(BT)
nn_main(const float* __restrict__ query, const float* __restrict__ target,
        float* __restrict__ d2_out, int* __restrict__ idx_out,
        float* __restrict__ part_d, int* __restrict__ part_i, int m, int n,
        int split_len, long long query_batch_stride,
        long long target_batch_stride) {
  constexpr int kTile = BT * kPrefetch;
  static_assert(kTile % kGroup == 0, "a tile holds whole groups");
  static_assert((kGroup & (kGroup - 1)) == 0, "kGroup is a power of 2");
  __shared__ float4 tile[kTile];

  const int tx = threadIdx.x;
  const int s = blockIdx.y;
  const int b = blockIdx.z;
  const float* qb = query + b * query_batch_stride;
  const float* tb = target + b * target_batch_stride;
  const int split_start = s * split_len;
  const int split_end = min(n, split_start + split_len);

  float qx[R], qy[R], qz[R], best[R];
  int best_g[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = (long long)blockIdx.x * (BT * R) + r * BT + tx;
    qx[r] = qy[r] = qz[r] = 0.f;
    if (qi < m) {
      qx[r] = qb[3 * qi];
      qy[r] = qb[3 * qi + 1];
      qz[r] = qb[3 * qi + 2];
    }
    best[r] = CUDART_INF_F;
    best_g[r] = split_start;
  }

  // register prefetch of this thread's kPrefetch targets of a tile
  float px[kPrefetch] = {}, py[kPrefetch] = {}, pz[kPrefetch] = {};
  fetch<BT>(tb, split_start, split_end, px, py, pz);

  for (int base = split_start; base < split_end; base += kTile) {
    __syncthreads();                       // previous tile fully consumed
#pragma unroll
    for (int p = 0; p < kPrefetch; ++p) {
      const int j = p * BT + tx;
      // past the split's end: d' = +inf, never a minimum
      tile[j] = base + j < split_end
                    ? augment(px[p], py[p], pz[p])
                    : make_float4(0.f, 0.f, 0.f, CUDART_INF_F);
    }
    __syncthreads();
    if (base + kTile < split_end)                        // in flight now
      fetch<BT>(tb, base + kTile, split_end, px, py, pz);

    const int groups = (min(kTile, split_end - base) + kGroup - 1) / kGroup;
    for (int g = 0; g < groups; ++g) {
      const float4* grp = tile + g * kGroup;
      float gm[R];
      {
        const float4 a = grp[0];
#pragma unroll
        for (int r = 0; r < R; ++r) gm[r] = dprime(qx[r], qy[r], qz[r], a);
      }
#pragma unroll
      for (int j = 1; j < kGroup; ++j) {
        const float4 a = grp[j];
#pragma unroll
        for (int r = 0; r < R; ++r)
          gm[r] = fminf(gm[r], dprime(qx[r], qy[r], qz[r], a));
      }
      const int gstart = base + g * kGroup;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (gm[r] < best[r]) {
          best[r] = gm[r];
          best_g[r] = gstart;
        }
      }
    }
  }

  // the last tile is still in shared memory (past the split's end it holds
  // +inf, which never equals a best)
  const int last_base =
      split_start + max(0, split_end - split_start - 1) / kTile * kTile;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long qi = (long long)blockIdx.x * (BT * R) + r * BT + tx;
    if (qi >= m) continue;
    // recovery: the first target of the best group whose d' is the best,
    // with no break so that all its loads are in flight together.  Where
    // the group lies in the last tile (a split of one tile always) it is
    // read from shared memory, each lane starting at its own offset: group
    // starts are multiples of kGroup, so lanes walking in step would all hit
    // one bank.  Else it is re-read from device memory.
    int idx = best_g[r];
    if (best_g[r] >= last_base && split_end > split_start) {
      const float4* grp = tile + (best_g[r] - last_base);
      int first = kGroup;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int jj = (j + tx) & (kGroup - 1);
        if (dprime(qx[r], qy[r], qz[r], grp[jj]) == best[r])
          first = min(first, jj);
      }
      if (first < kGroup) idx += first;
    } else {
#pragma unroll
      for (int j = kGroup - 1; j >= 0; --j) {
        const int k = best_g[r] + j;
        if (k < split_end) {
          const float* t = tb + 3LL * k;
          if (dprime(qx[r], qy[r], qz[r], augment(t[0], t[1], t[2])) ==
              best[r])
            idx = k;
        }
      }
    }
    const long long o = (long long)b * m + qi;
    if (gridDim.y == 1) {
      d2_out[o] = n > 0 ? diff_d2(qx[r], qy[r], qz[r], tb + 3LL * idx)
                        : CUDART_INF_F;
      idx_out[o] = idx;
    } else {
      const long long po = (long long)s * gridDim.z * m + o;
      part_d[po] = best[r];
      part_i[po] = idx;
    }
  }
}

// The S partials of each query in split order, strict '<': the lowest index
// wins ties.  Then d2 in the difference form for the chosen target.
__global__ void nn_merge(const float* __restrict__ query,
                         const float* __restrict__ target,
                         const float* __restrict__ part_d,
                         const int* __restrict__ part_i,
                         float* __restrict__ d2_out, int* __restrict__ idx_out,
                         int batch, int m, int splits,
                         long long query_batch_stride,
                         long long target_batch_stride) {
  const long long qi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = blockIdx.y;
  if (qi >= m) return;
  const long long o = (long long)b * m + qi;
  const long long plane = (long long)batch * m;
  float best = part_d[o];
  int idx = part_i[o];
#pragma unroll 4
  for (int s = 1; s < splits; ++s) {
    // both loads unconditional: a load behind the compare would make the
    // splits one memory round trip each
    const float d = part_d[s * plane + o];
    const int i = part_i[s * plane + o];
    if (d < best) {
      best = d;
      idx = i;
    }
  }
  const float* q = query + b * query_batch_stride + 3 * qi;
  d2_out[o] = diff_d2(q[0], q[1], q[2],
                      target + b * target_batch_stride + 3LL * idx);
  idx_out[o] = idx;
}

template <int R, int BT>
int launch_main(dim3 grid, cudaStream_t st, const float* query,
                const float* target, float* d2, int* idx, float* part_d,
                int* part_i, int m, int n, int split_len, long long qbs,
                long long tbs) {
  nn_main<R, BT><<<grid, BT, 0, st>>>(query, target, d2, idx, part_d, part_i,
                                      m, n, split_len, qbs, tbs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// query: [batch, m, 3] f32 (batch stride in floats, 0 = broadcast);
// target: [batch, n, 3] f32; d2: [batch, m] f32; idx: [batch, m] i32;
// part_d, part_i: [splits, batch, m] scratch, unused when splits == 1.
// The plan: r queries a thread, block threads, splits target slices of
// split_len targets (a multiple of kGroup; split s covers
// [s * split_len, min(n, (s + 1) * split_len))).  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or -1 for a plan this file
// has no instance of.
extern "C" int nn_search_forward(const float* query, const float* target,
                                 float* d2, int* idx, float* part_d,
                                 int* part_i, int batch, int m, int n,
                                 long long query_batch_stride,
                                 long long target_batch_stride, int r,
                                 int block, int splits, int split_len,
                                 void* stream) {
  if (batch <= 0 || m <= 0) return 0;
  if (r < 1 || block < 1 || splits < 1 || split_len % kGroup != 0) return -1;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)r * block;
  const long long tiles = (m + per_block - 1) / per_block;
  const dim3 grid(static_cast<unsigned>(tiles), splits, batch);
  int rc = -1;
#define NN_CASE(RR, BB)                                                     \
  if (r == RR && block == BB)                                               \
    rc = launch_main<RR, BB>(grid, st, query, target, d2, idx, part_d,      \
                             part_i, m, n, split_len, query_batch_stride,   \
                             target_batch_stride);
  NN_CASE(2, 128) NN_CASE(2, 256)
  NN_CASE(4, 64) NN_CASE(4, 128) NN_CASE(4, 256)
  NN_CASE(8, 64) NN_CASE(8, 128) NN_CASE(8, 256)
#undef NN_CASE
  if (rc != 0 || splits == 1) return rc;
  const int mb = 256;
  nn_merge<<<dim3((m + mb - 1) / mb, batch), mb, 0, st>>>(
      query, target, part_d, part_i, d2, idx, batch, m, splits,
      query_batch_stride, target_batch_stride);
  return static_cast<int>(cudaGetLastError());
}
