// 1-NN variants for Hopper (sm_90a): the squared distance and index of the
// nearest target for every query, in the three forms of the NN-variant
// microbench.
//
// Replaces the Pallas TPU kernels of tools/bench_nn_variants.py:
//   * _nn_kernel_packed (launched by nearest_packed)    -> kExpanded, packed
//   * _nn_kernel_aug    (launched by nearest_aug)       -> kAugmented,
//                                                          packed or not
// One template serves the three: the arithmetic (expanded or augmented) and
// the reduction (packed key or two reductions) are template arguments.
//
// Operands keep the TPU kernels' transposed layout: q [8, M] and t [8, N]
// f32, row-major, so row r of query j is q[r * M + j].  What each variant
// computes, per (query, target) pair, with every row of the contraction:
//   expanded   d2 = (|q|^2 + |t|^2) - 2 q.t over the 8 rows (the rows of
//              the _pad8 layout are x, y, z, 0...);
//   augmented  d2 = q.t over the 8 rows (query rows -2x, -2y, -2z, |q|^2, 1,
//              target rows x, y, z, 1, |t|^2: the contraction *is* d2).
// and per query:
//   packed     the minimum of key = (bits(max(d2, 0)) & ~low) | (col & low)
//              with low = 2^idx_bits - 1, so d = that key with its low bits
//              cleared (a truncated d2) and i = col mod 2^idx_bits; a tie of
//              truncated d2 goes to the lowest low bits.  The wrapper refuses
//              N > 2^idx_bits, where the index would wrap.
//   two        the minimum d2 and the first index reaching it (a strict '<'
//              walking the columns upward), then d = max(d2, 0).
// The TPU kernels' query chunks (qc) and target tiles (tc = N) were VMEM
// choices: here every block loops over all targets.
//
// Bound: the function needs M*N pairs of 6 FP32 operations (3 FMAs once
// |t|^2 and -2t are known per target), as the K1 kernel's does; bytes are
// 32 per query and target (8 rows) plus 8 per output.  So it is bound by operations,
// pairs * 6 / 67 TFLOP/s.  This kernel spends 8 FMAs on the full 8-row
// contraction (plus 1 for the expansion) and 2-3 integer or compare
// operations on the reduction: the simple form first, as the K1 kernel.  The
// design keeps one query per thread with its 8 rows in registers, stages
// 1024 targets at a time in shared memory as two float4 (a broadcast read
// feeds every thread of a warp), and splits the columns over blockDim.y
// groups so a 16k-query call still fills the card; the groups meet in
// shared memory at the end.  The block shape is a launch parameter, swept by
// the variant bench.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

namespace {

constexpr int kRows = 8;
constexpr int kTile = 1024;            // targets staged per shared tile
constexpr int kMaxThreads = 1024;

enum Arith { kExpanded = 0, kAugmented = 1 };

template <int kArith, bool kPacked>
__global__ void __launch_bounds__(kMaxThreads)
nn_variant_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  float* __restrict__ d_out, int* __restrict__ i_out, int m,
                  int n, int idx_bits) {
  __shared__ float4 lo[kTile];         // target rows 0-3
  __shared__ float4 hi[kTile];         // target rows 4-7
  __shared__ float t2s[kTile];         // |t|^2 (expanded only)
  __shared__ float red_d[kMaxThreads];
  __shared__ int red_i[kMaxThreads];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int flat = ty * blockDim.x + tx;
  const int qi = blockIdx.x * blockDim.x + tx;

  float qr[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) qr[r] = qi < m ? q[(long long)r * m + qi] : 0.f;
  float q2 = 0.f;
  if (kArith == kExpanded) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) q2 = fmaf(qr[r], qr[r], q2);
  }
  const int low = (1 << idx_bits) - 1;
  int best_key = INT_MAX;
  float best = CUDART_INF_F;
  int best_i = 0;

  for (int base = 0; base < n; base += kTile) {
    const int cnt = min(kTile, n - base);
    __syncthreads();                     // previous tile fully consumed
    for (int j = flat; j < cnt; j += nthreads) {
      float v[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) v[r] = t[(long long)r * n + base + j];
      lo[j] = make_float4(v[0], v[1], v[2], v[3]);
      hi[j] = make_float4(v[4], v[5], v[6], v[7]);
      if (kArith == kExpanded) {
        float s = 0.f;
#pragma unroll
        for (int r = 0; r < kRows; ++r) s = fmaf(v[r], v[r], s);
        t2s[j] = s;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = ty; j < cnt; j += blockDim.y) {
      const float4 a = lo[j];
      const float4 b = hi[j];
      float dot = qr[0] * a.x;
      dot = fmaf(qr[1], a.y, dot);
      dot = fmaf(qr[2], a.z, dot);
      dot = fmaf(qr[3], a.w, dot);
      dot = fmaf(qr[4], b.x, dot);
      dot = fmaf(qr[5], b.y, dot);
      dot = fmaf(qr[6], b.z, dot);
      dot = fmaf(qr[7], b.w, dot);
      const float d2 =
          kArith == kExpanded ? fmaf(-2.f, dot, q2 + t2s[j]) : dot;
      if (kPacked) {
        const float c = d2 > 0.f ? d2 : 0.f;
        const int key = (__float_as_int(c) & ~low) | ((base + j) & low);
        best_key = min(best_key, key);
      } else if (d2 < best) {
        best = d2;
        best_i = base + j;
      }
    }
  }

  if (kPacked) {
    red_i[flat] = best_key;
  } else {
    red_d[flat] = best;
    red_i[flat] = best_i;
  }
  __syncthreads();
  if (ty != 0 || qi >= m) return;
  for (int s = 1; s < blockDim.y; ++s) {
    const int o = s * blockDim.x + tx;
    if (kPacked) {
      best_key = min(best_key, red_i[o]);
    } else {
      const float d = red_d[o];
      const int i = red_i[o];
      if (d < best || (d == best && i < best_i)) {
        best = d;
        best_i = i;
      }
    }
  }
  if (kPacked) {
    d_out[qi] = __int_as_float(best_key & ~low);
    i_out[qi] = best_key & low;
  } else {
    d_out[qi] = best > 0.f ? best : 0.f;
    i_out[qi] = best_i;
  }
}

}  // namespace

// variant 0: expanded + packed (K3); 1: augmented + packed (K4 packed);
// 2: augmented + two reductions (K4).  q: [8, m] f32; t: [8, n] f32;
// d: [m] f32; idx: [m] i32.  The block is queries_per_block x split threads.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nn_variant_forward(int variant, const float* q, const float* t,
                                  float* d, int* idx, int m, int n,
                                  int idx_bits, int queries_per_block,
                                  int split, void* stream) {
  if (m <= 0) return 0;
  if (n <= 0 || queries_per_block <= 0 || split <= 0 ||
      queries_per_block * split > kMaxThreads || idx_bits < 0 ||
      idx_bits > 30)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(queries_per_block, split);
  const dim3 grid((m + queries_per_block - 1) / queries_per_block);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      nn_variant_kernel<kExpanded, true>
          <<<grid, block, 0, s>>>(q, t, d, idx, m, n, idx_bits);
      break;
    case 1:
      nn_variant_kernel<kAugmented, true>
          <<<grid, block, 0, s>>>(q, t, d, idx, m, n, idx_bits);
      break;
    case 2:
      nn_variant_kernel<kAugmented, false>
          <<<grid, block, 0, s>>>(q, t, d, idx, m, n, idx_bits);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
