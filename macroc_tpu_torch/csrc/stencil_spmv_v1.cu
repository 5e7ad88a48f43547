// K1v1: 27-point 3x3-block stencil SpMV, y = A x, in SoA layout, with the
// x halo window of each node tile staged in shared memory.
//
// Replaces: macroc_tpu/ops/stencil_pallas.py::stencil_matvec_pallas_v1
// (Pallas kernel _spmv_kernel: one grid step per spatial tile over all 27
// offsets, the tile's x halo window DMA'd into VMEM once).
//
//   y[d,p] = sum_o sum_e A[o,d,e,p] * x[e, p + off(o)]
//   off(o) = (o/9 - 1, (o/3)%3 - 1, o%3 - 1),  x = 0 outside the box
//   A: (27,3,3,nx,ny,nz)   x, y: (3,nx,ny,nz)
//
// Bound: device memory.  Each node streams its 243 coefficients once and
// does 243 FMAs, about (243 + 6) * sizeof(T) bytes per node at 2 flops per
// 4 or 8 bytes -- far below the card's flop/byte balance.
//
// Design: a block owns a (TX,TY,TZ) node tile, one thread per node, z
// fastest.  The block first copies the tile's x halo window
// (3, TX+2, TY+2, TZ+2) into shared memory, every thread taking strided
// elements of it; ragged edges and the box boundary are bounds-checked and
// zero-filled, so x needs no padding.  After one barrier each thread reads
// its 27 shifted x triples from shared memory and streams its A planes
// from device memory: for every (o,d,e) a warp's reads A[o,d,e,i,j,k..k+31]
// are one contiguous segment when TZ >= 32.  Unlike K1, which reads the
// shifted x through L1/L2, x leaves device memory once per tile plus its
// halo ring.  The TPU kernel's 8/128-aligned halo ring and its
// 128-multiple padding of A exist only for the TPU's (8,128) tiles and are
// not ported.  Sums are taken in T: f32 for f32 inputs, f64 for f64.
//
// The default tile (4,4,32) is 512 threads and stages 3*6*6*34 values:
// 14,688 bytes of shared memory in f32, 29,376 in f64.  A tile above 1024
// threads or 227 KB of shared memory is refused by the wrapper
// (ops/stencil_spmv.py::stencil_matvec_v1); windows above 48 KB opt in to
// the larger dynamic shared memory here.

#include <cuda_runtime.h>

namespace {

template <typename T>
__global__ void stencil_spmv_v1_kernel(const T* __restrict__ A,
                                       const T* __restrict__ x,
                                       T* __restrict__ y, int nx, int ny,
                                       int nz, int TX, int TY, int TZ) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const long long n = (long long)nx * ny * nz;
  const int WY = TY + 2, WZ = TZ + 2;
  const int wvol = (TX + 2) * WY * WZ;
  const int i0 = blockIdx.z * TX, j0 = blockIdx.y * TY, k0 = blockIdx.x * TZ;

  // stage the halo window: window cell (wi,wj,wk) is node
  // (i0+wi-1, j0+wj-1, k0+wk-1); consecutive threads take consecutive wk
  for (int t = threadIdx.x; t < 3 * wvol; t += blockDim.x) {
    const int e = t / wvol;
    const int r = t - e * wvol;
    const int wk = r % WZ;
    const int wj = (r / WZ) % WY;
    const int wi = r / (WZ * WY);
    const int gi = i0 + wi - 1, gj = j0 + wj - 1, gk = k0 + wk - 1;
    T v = T(0);
    if (gi >= 0 && gi < nx && gj >= 0 && gj < ny && gk >= 0 && gk < nz)
      v = x[e * n + ((long long)gi * ny + gj) * nz + gk];
    xs[t] = v;
  }
  __syncthreads();

  const int lk = threadIdx.x % TZ;
  const int lj = (threadIdx.x / TZ) % TY;
  const int li = threadIdx.x / (TZ * TY);
  const int i = i0 + li, j = j0 + lj, k = k0 + lk;
  if (i >= nx || j >= ny || k >= nz) return;
  const long long p = ((long long)i * ny + j) * nz + k;
  const int c = ((li + 1) * WY + (lj + 1)) * WZ + (lk + 1);  // own window cell

  T acc0 = T(0), acc1 = T(0), acc2 = T(0);
#pragma unroll
  for (int o = 0; o < 27; ++o) {
    const int s = c + ((o / 9 - 1) * WY + ((o / 3) % 3 - 1)) * WZ + (o % 3 - 1);
    const T x0 = xs[s], x1 = xs[s + wvol], x2 = xs[s + 2 * wvol];
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
           int TX, int TY, int TZ, void* stream) {
  const int threads = TX * TY * TZ;
  const size_t smem = (size_t)3 * (TX + 2) * (TY + 2) * (TZ + 2) * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        stencil_spmv_v1_kernel<T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((nz + TZ - 1) / TZ, (ny + TY - 1) / TY, (nx + TX - 1) / TX);
  if ((long long)nx * ny * nz > 0)
    stencil_spmv_v1_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
        (const T*)A, (const T*)x, (T*)y, nx, ny, nz, TX, TY, TZ);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int macroc_stencil_spmv_v1_f32(const void* A, const void* x, void* y, int nx,
                               int ny, int nz, int TX, int TY, int TZ,
                               void* stream) {
  return launch<float>(A, x, y, nx, ny, nz, TX, TY, TZ, stream);
}

int macroc_stencil_spmv_v1_f64(const void* A, const void* x, void* y, int nx,
                               int ny, int nz, int TX, int TY, int TZ,
                               void* stream) {
  return launch<double>(A, x, y, nx, ny, nz, TX, TY, TZ, stream);
}

}  // extern "C"
