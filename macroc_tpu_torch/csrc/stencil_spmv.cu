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
// Bound: device memory.  Each node reads its 243 coefficients once and
// does 243 FMAs, so the kernel moves about (243 + 6) * sizeof(T) bytes per
// node (x is reused from L1/L2 by the 27 neighbours) at 2 flops per 4 or 8
// bytes -- far below the card's flop/byte balance.
//
// Design: one thread per node, threads laid out with z fastest, so for
// every (o,d,e) the warp's 32 coefficient reads A[o,d,e,x,y,z..z+31] are
// one contiguous segment and the shifted x reads are too.  Three
// accumulators live in registers; the 27 offsets are unrolled.  Out-of-box
// neighbours are skipped by bounds checks, so x needs no padding.  The
// TPU kernel's aligned halo ring (8 in y, 128 in z) and its 128-multiple
// padding of A exist only for the TPU's (8,128) tiles and are dropped.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void stencil_spmv_kernel(const T* __restrict__ A,
                                    const T* __restrict__ x,
                                    T* __restrict__ y,
                                    int nx, int ny, int nz, int halo) {
  const long long n = (long long)nx * ny * nz;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int k = (int)(p % nz);
  const int j = (int)((p / nz) % ny);
  const int i = (int)(p / ((long long)ny * nz));

  // x geometry: core node (i,j,k) sits at (i+h, j+h, k+h) of an
  // (nx+2h, ny+2h, nz+2h) box; neighbours within [-h, n-1+h] exist.
  const int h = halo ? 1 : 0;
  const int xy = ny + 2 * h, xz = nz + 2 * h;
  const long long xs = (long long)(nx + 2 * h) * xy * xz;  // per-dof stride

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int ii = i + o / 9 - 1;
    const int jj = j + (o / 3) % 3 - 1;
    const int kk = k + o % 3 - 1;
    if (ii < -h || ii > nx - 1 + h || jj < -h || jj > ny - 1 + h ||
        kk < -h || kk > nz - 1 + h)
      continue;
    const long long q = ((long long)(ii + h) * xy + (jj + h)) * xz + (kk + h);
    const T x0 = x[q], x1 = x[q + xs], x2 = x[q + 2 * xs];
    const T* a = A + (long long)o * 9 * n + p;
    acc0 += a[0 * n] * x0 + a[1 * n] * x1 + a[2 * n] * x2;
    acc1 += a[3 * n] * x0 + a[4 * n] * x1 + a[5 * n] * x2;
    acc2 += a[6 * n] * x0 + a[7 * n] * x1 + a[8 * n] * x2;
  }
  y[p] = acc0;
  y[p + n] = acc1;
  y[p + 2 * n] = acc2;
}

template <typename T>
int launch(const void* A, const void* x, void* y, int nx, int ny, int nz,
           int halo, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    stencil_spmv_kernel<T><<<(unsigned)blocks, threads, 0,
                             (cudaStream_t)stream>>>(
        (const T*)A, (const T*)x, (T*)y, nx, ny, nz, halo);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int macroc_stencil_spmv_f32(const void* A, const void* x, void* y, int nx,
                            int ny, int nz, int halo, void* stream) {
  return launch<float>(A, x, y, nx, ny, nz, halo, stream);
}

int macroc_stencil_spmv_f64(const void* A, const void* x, void* y, int nx,
                            int ny, int nz, int halo, void* stream) {
  return launch<double>(A, x, y, nx, ny, nz, halo, stream);
}

const char* macroc_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
