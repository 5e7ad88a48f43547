// K1: 27-point 3x3-block stencil SpMV, y = A x, in SoA layout.
//
// Replaces: macroc_tpu/ops/stencil_pallas.py::stencil_matvec_pallas
// (Pallas kernel _spmv_kernel_v2).
//
//   y[d,p] = sum_o sum_e A[o,d,e,p] * x[e, p + off(o)]
//   off(o) = (o/9 - 1, (o/3)%3 - 1, o%3 - 1),  x = 0 outside the box
//   A: (27,3,3,nx,ny,nz)   x, y: (3,nx,ny,nz)
//   halo != 0: x is (3,nx+2,ny+2,nz+2) and already carries a 1-node halo,
//   which is read (no zero outside the core box).
//
// Types: the operator type TA may be narrower than the vector type TX, as
// the TPU kernel allows (it accumulates in x's dtype): each product is
// (TX)a * x, accumulated in TX.  The JAX package feeds it bf16 MG level
// operators with f32 vectors (-mg_dtype bfloat16).  Entry points: (f32,f32),
// (f64,f64), (bf16,f32), (bf16,f64), (f16,f32), (f16,f64), (f32,f64).
//
// Bound: device memory.  Each node reads its 243 coefficients once and
// does 243 FMAs, so the kernel moves about 243 * sizeof(TA) + 6 * sizeof(TX)
// bytes per node (x is reused from L1/L2 by the 27 neighbours): 996 at
// f32/f32, 510 at bf16/f32 -- far below the card's flop/byte balance.
//
// Design: one thread per node, threads laid out with z fastest, so for
// every (o,d,e) the warp's 32 coefficient reads A[o,d,e,x,y,z..z+31] are
// one contiguous segment and the shifted x reads are too.  Three
// accumulators live in registers; the 27 offsets are unrolled.  Out-of-box
// neighbours are skipped by bounds checks, so x needs no padding.  The
// TPU kernel's aligned halo ring (8 in y, 128 in z) and its 128-multiple
// padding of A exist only for the TPU's (8,128) tiles and are dropped.
//
// The p.q form (DOT = true; port-only, for solve/cg.py's fused PCG loop):
// the same kernel, which also sums p.q over its block and, in the last
// block to finish, over the blocks in a fixed order, and sets the solve's
// device scalars p.q and alpha = rz / p.q (cg_state.cuh).  It returns at
// once when the solve's active flag is 0.  f32 and f64, A and x of one
// type, no halo.  It reads and writes what K1 does, so its bound is K1's.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "cg_state.cuh"

namespace {

// exact widening of an operator coefficient to the accumulator type
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float widen(__half v) { return __half2float(v); }

template <typename TA, typename TX, bool DOT>
__global__ void stencil_spmv_kernel(const TA* __restrict__ A,
                                    const TX* __restrict__ x,
                                    TX* __restrict__ y,
                                    int nx, int ny, int nz, int halo,
                                    double* __restrict__ partials,
                                    double* __restrict__ sc, int* __restrict__ st) {
  using namespace macroc_cg;
  if (DOT && st[ST_ACTIVE] == 0) return;
  const long long n = (long long)nx * ny * nz;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // the p.q form needs every thread of a block at its block sum
  const bool live = p < n;
  if (!DOT && !live) return;
  TX acc0 = TX(0), acc1 = TX(0), acc2 = TX(0);
  if (live) {
    const int k = (int)(p % nz);
    const int j = (int)((p / nz) % ny);
    const int i = (int)(p / ((long long)ny * nz));

    // x geometry: core node (i,j,k) sits at (i+h, j+h, k+h) of an
    // (nx+2h, ny+2h, nz+2h) box; neighbours within [-h, n-1+h] exist.
    const int h = halo ? 1 : 0;
    const int xy = ny + 2 * h, xz = nz + 2 * h;
    const long long xs = (long long)(nx + 2 * h) * xy * xz;  // per-dof stride

#pragma unroll
    for (int o = 0; o < 27; ++o) {
      const int ii = i + o / 9 - 1;
      const int jj = j + (o / 3) % 3 - 1;
      const int kk = k + o % 3 - 1;
      if (ii < -h || ii > nx - 1 + h || jj < -h || jj > ny - 1 + h ||
          kk < -h || kk > nz - 1 + h)
        continue;
      const long long q = ((long long)(ii + h) * xy + (jj + h)) * xz + (kk + h);
      const TX x0 = x[q], x1 = x[q + xs], x2 = x[q + 2 * xs];
      const TA* a = A + (long long)o * 9 * n + p;
      acc0 += TX(widen(a[0 * n])) * x0 + TX(widen(a[1 * n])) * x1 +
              TX(widen(a[2 * n])) * x2;
      acc1 += TX(widen(a[3 * n])) * x0 + TX(widen(a[4 * n])) * x1 +
              TX(widen(a[5 * n])) * x2;
      acc2 += TX(widen(a[6 * n])) * x0 + TX(widen(a[7 * n])) * x1 +
              TX(widen(a[8 * n])) * x2;
    }
    y[p] = acc0;
    y[p + n] = acc1;
    y[p + 2 * n] = acc2;
  }
  if constexpr (DOT) {
    // halo == 0: this node's own x is at p
    const double pq = live ? double(x[p] * acc0) + double(x[p + n] * acc1) +
                                 double(x[p + 2 * n] * acc2)
                           : 0.0;
    const double block = block_sum(pq);
    if (threadIdx.x == 0) partials[blockIdx.x] = block;
    if (!last_block(st)) return;
    const double total = sum_partials(partials, gridDim.x);
    if (threadIdx.x == 0) {
      sc[SC_PQ] = total;
      sc[SC_ALPHA] = sc[SC_RZ] / total;
    }
  }
}

template <typename TA, typename TX, bool DOT = false>
int launch(const void* A, const void* x, void* y, int nx, int ny, int nz,
           int halo, void* stream, double* partials = nullptr,
           double* sc = nullptr, int* st = nullptr) {
  const long long n = (long long)nx * ny * nz;
  const int threads = macroc_cg::THREADS;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    stencil_spmv_kernel<TA, TX, DOT><<<(unsigned)blocks, threads, 0,
                                       (cudaStream_t)stream>>>(
        (const TA*)A, (const TX*)x, (TX*)y, nx, ny, nz, halo, partials, sc, st);
  return (int)cudaGetLastError();
}

}  // namespace

#define MACROC_SPMV_ENTRY(NAME, TA, TX)                                     \
  int NAME(const void* A, const void* x, void* y, int nx, int ny, int nz, \
           int halo, void* stream) {                                      \
    return launch<TA, TX>(A, x, y, nx, ny, nz, halo, stream);             \
  }

extern "C" {

MACROC_SPMV_ENTRY(macroc_stencil_spmv_f32, float, float)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_f64, double, double)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_bf16_f32, __nv_bfloat16, float)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_bf16_f64, __nv_bfloat16, double)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_f16_f32, __half, float)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_f16_f64, __half, double)
MACROC_SPMV_ENTRY(macroc_stencil_spmv_f32_f64, float, double)

// the p.q form: partials holds one double per 256 nodes
#define MACROC_SPMV_DOT_ENTRY(NAME, T)                                      \
  int NAME(const void* A, const void* x, void* y, int nx, int ny, int nz, \
           double* partials, double* sc, int* st, void* stream) {         \
    return launch<T, T, true>(A, x, y, nx, ny, nz, 0, stream, partials,   \
                              sc, st);                                    \
  }

MACROC_SPMV_DOT_ENTRY(macroc_stencil_spmv_dot_f32, float)
MACROC_SPMV_DOT_ENTRY(macroc_stencil_spmv_dot_f64, double)

const char* macroc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
