// The device scalars of one PCG solve, and the block sums the fused
// iteration's kernels share (K1's p.q form in stencil_spmv.cu, the two
// update kernels in cg_fused.cu).
//
// The layout mirrors macroc_tpu_torch/solve/cg_state.py (SC_*, ST_*):
//   sc (double[SC_N]): rz, p.q, alpha, beta, rnorm, tol, div, abstol
//   st (int[ST_N]):    its, reason, active, maxits, preconditioned norm,
//                      the last-block counter
// The host writes them once before the loop and reads them every few
// iterations; everything in between stays on the card.
//
// Cross-block sums are deterministic: each block writes its partial sum,
// the last block to finish (an integer atomic on st[ST_COUNT], reset by that
// block) adds all partials in a fixed order, so repeat launches are bitwise
// equal whichever block finishes last.  No float atomics.

#pragma once

#include <cuda_runtime.h>

namespace macroc_cg {

enum { SC_RZ, SC_PQ, SC_ALPHA, SC_BETA, SC_RNORM, SC_TOL, SC_DIV, SC_ABSTOL, SC_N };
enum { ST_ITS, ST_REASON, ST_ACTIVE, ST_MAXITS, ST_PNORM, ST_COUNT, ST_N };

// PETSc KSPConvergedReason values (solve/cg_state.py)
constexpr int CONVERGED_RTOL = 2;
constexpr int CONVERGED_ATOL = 3;
constexpr int DIVERGED_DTOL = -4;

constexpr int THREADS = 256;  // every kernel of the iteration: 8 warps

// the sum of v over the block, in a fixed order; valid in thread 0.
// Every thread of the block must call it.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[THREADS / 32];
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) warp_sums[w] = v;
  __syncthreads();
  v = 0.0;
  if (w == 0) {
    v = lane < THREADS / 32 ? warp_sums[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();  // warp_sums may be reused by the next call
  return v;
}

// Thread 0 has written this block's partials; true in every thread of the
// block that finishes last.  That block resets the counter.
__device__ __forceinline__ bool last_block(int* st) {
  __shared__ bool last;
  if (threadIdx.x == 0) {
    __threadfence();  // the partials before the count
    last = atomicAdd(reinterpret_cast<unsigned*>(&st[ST_COUNT]), 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) st[ST_COUNT] = 0;
  return last;
}

// the sum of partials[0 .. count) in a fixed order (read past L1); valid in
// thread 0 of the last block
__device__ __forceinline__ double sum_partials(const double* partials, int count) {
  double v = 0.0;
  for (int i = threadIdx.x; i < count; i += blockDim.x) v += __ldcg(partials + i);
  return block_sum(v);
}

// the end of an iteration (thread 0 of the update kernel's last block):
// solve/cg_state.py::reason's rules, the -ksp_monitor trace, the flag
__device__ __forceinline__ void finish_iteration(double rz_new, double nn, double* sc,
                                                 int* st, double* trace) {
  const double rnorm = sqrt(nn);
  const int its = st[ST_ITS] + 1;
  int reason = 0;
  if (rnorm <= sc[SC_TOL])
    reason = rnorm <= sc[SC_ABSTOL] ? CONVERGED_ATOL : CONVERGED_RTOL;
  else if (rnorm >= sc[SC_DIV])
    reason = DIVERGED_DTOL;
  sc[SC_BETA] = rz_new / sc[SC_RZ];
  sc[SC_RZ] = rz_new;
  sc[SC_RNORM] = rnorm;
  st[ST_ITS] = its;
  st[ST_REASON] = reason;
  st[ST_ACTIVE] = reason == 0 && its < st[ST_MAXITS];
  if (trace) trace[its] = rnorm;
}

}  // namespace macroc_cg
