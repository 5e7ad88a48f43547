// The fused PCG iteration's two update kernels (port-only: the JAX
// package's CG, macroc_tpu/solve/cg.py, is one lax.while_loop that XLA
// fuses; the port's loop is solve/cg.py::cg_solve).  With K1's p.q form
// (stencil_spmv.cu) an iteration is three kernels and the host reads no
// scalar inside it:
//
//   (a) cg_update_xr_kernel: alpha from the device scalars;
//       x += alpha p; r -= alpha q; z = inv_diag r (z = r without a
//       preconditioner); r.z and the monitored norm's square (z.z, or r.r
//       under the unpreconditioned norm) summed over the blocks, and in
//       the last block the end of the iteration (cg_state.cuh):
//       beta = rz_new / rz, rnorm, its, reason, the active flag, the trace.
//   (b) cg_update_p_kernel: p = z + beta p, z recomputed as inv_diag r
//       (reading r and inv_diag moves as many bytes as writing z in (a)
//       and reading it here, and needs no z vector).
//
// Both return at once when the solve's active flag is 0, so iterations the
// host queued after convergence change nothing.  Vectors are flat arrays
// of N values (the (3,nx,ny,nz) fields); scalars live in double, products
// are taken in T and summed in double.
//
// Bound: device memory.  (a) reads x, p, r, q, inv_diag and writes x, r:
// 7 sizeof(T) bytes per value, 84 B per node at f32; (b) reads p, r,
// inv_diag and writes p: 48 B per node at f32.  Design: a fixed grid of
// UPDATE_BLOCKS blocks striding over the vector (one wave on 132 SMs at
// 2,048 threads each), so the partials buffer has a fixed size and the
// sums a fixed order; 16-byte loads and stores (float4, double2), so a
// thread keeps four loads of 16 bytes in flight per step.

#include <cuda_runtime.h>

#include "cg_state.cuh"

namespace {

using namespace macroc_cg;

constexpr int UPDATE_BLOCKS = 1024;  // solve/cg_state.py::UPDATE_BLOCKS

// 16-byte vectors of T: every thread moves V values per load
template <typename T> struct Vec;
template <> struct Vec<float> { using type = float4; static constexpr int V = 4; };
template <> struct Vec<double> { using type = double2; static constexpr int V = 2; };

template <typename T>
__device__ __forceinline__ T& lane(typename Vec<T>::type& v, int k) {
  return reinterpret_cast<T*>(&v)[k];
}

// (a) on one value i; the sums in double
template <typename T>
__device__ __forceinline__ void update_xr_one(T& xi, T pi, T& ri, T qi, T invi, bool has_inv,
                                              bool pnorm, T alpha, double& rz, double& nn) {
  xi += alpha * pi;
  ri = ri - alpha * qi;
  const T zi = has_inv ? invi * ri : ri;
  rz += double(ri * zi);
  nn += pnorm ? double(zi * zi) : double(ri * ri);
}

template <typename T>
__global__ void cg_update_xr_kernel(T* __restrict__ x, const T* __restrict__ p,
                                    T* __restrict__ r, const T* __restrict__ q,
                                    const T* __restrict__ inv, long long N,
                                    double* __restrict__ partials,
                                    double* __restrict__ sc, int* __restrict__ st,
                                    double* __restrict__ trace) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::V;
  if (st[ST_ACTIVE] == 0) return;
  const T alpha = T(sc[SC_ALPHA]);
  const bool pnorm = st[ST_PNORM] != 0, has_inv = inv != nullptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  double rz = 0.0, nn = 0.0;
  // the vectors are whole (3,nx,ny,nz) tensors, 16-byte aligned: V values
  // per load up to the last whole vector, then one value per thread
  const long long NV = N / V;
  for (long long i = start; i < NV; i += stride) {
    VT xv = reinterpret_cast<VT*>(x)[i], rv = reinterpret_cast<VT*>(r)[i];
    VT pv = reinterpret_cast<const VT*>(p)[i], qv = reinterpret_cast<const VT*>(q)[i];
    VT iv = pv;
    if (has_inv) iv = reinterpret_cast<const VT*>(inv)[i];
#pragma unroll
    for (int k = 0; k < V; ++k)
      update_xr_one(lane<T>(xv, k), lane<T>(pv, k), lane<T>(rv, k), lane<T>(qv, k),
                    lane<T>(iv, k), has_inv, pnorm, alpha, rz, nn);
    reinterpret_cast<VT*>(x)[i] = xv;
    reinterpret_cast<VT*>(r)[i] = rv;
  }
  for (long long i = NV * V + start; i < N; i += stride)
    update_xr_one(x[i], p[i], r[i], q[i], has_inv ? inv[i] : T(0), has_inv, pnorm, alpha,
                  rz, nn);
  rz = block_sum(rz);
  nn = block_sum(nn);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = rz;
    partials[gridDim.x + blockIdx.x] = nn;
  }
  if (!last_block(st)) return;
  rz = sum_partials(partials, gridDim.x);
  nn = sum_partials(partials + gridDim.x, gridDim.x);
  if (threadIdx.x == 0) finish_iteration(rz, nn, sc, st, trace);
}

template <typename T>
__global__ void cg_update_p_kernel(T* __restrict__ p, const T* __restrict__ r,
                                   const T* __restrict__ inv, long long N,
                                   const double* __restrict__ sc,
                                   const int* __restrict__ st) {
  using VT = typename Vec<T>::type;
  constexpr int V = Vec<T>::V;
  if (st[ST_ACTIVE] == 0) return;
  const T beta = T(sc[SC_BETA]);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long start = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long NV = N / V;
  for (long long i = start; i < NV; i += stride) {
    VT pv = reinterpret_cast<VT*>(p)[i];
    VT zv = reinterpret_cast<const VT*>(r)[i];
    if (inv) {
      VT iv = reinterpret_cast<const VT*>(inv)[i];
#pragma unroll
      for (int k = 0; k < V; ++k) lane<T>(zv, k) = lane<T>(iv, k) * lane<T>(zv, k);
    }
#pragma unroll
    for (int k = 0; k < V; ++k) lane<T>(pv, k) = lane<T>(zv, k) + beta * lane<T>(pv, k);
    reinterpret_cast<VT*>(p)[i] = pv;
  }
  for (long long i = NV * V + start; i < N; i += stride) {
    const T zi = inv ? inv[i] * r[i] : r[i];
    p[i] = zi + beta * p[i];
  }
}

int grid_for(long long N) {
  const long long blocks = (N + THREADS - 1) / THREADS;
  return (int)(blocks < UPDATE_BLOCKS ? blocks : UPDATE_BLOCKS);
}

template <typename T>
int launch_xr(void* x, const void* p, void* r, const void* q, const void* inv,
              long long N, double* partials, double* sc, int* st, double* trace,
              void* stream) {
  if (N > 0)
    cg_update_xr_kernel<T><<<grid_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        (T*)x, (const T*)p, (T*)r, (const T*)q, (const T*)inv, N, partials, sc, st,
        trace);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_p(void* p, const void* r, const void* inv, long long N, const double* sc,
             const int* st, void* stream) {
  if (N > 0)
    cg_update_p_kernel<T><<<grid_for(N), THREADS, 0, (cudaStream_t)stream>>>(
        (T*)p, (const T*)r, (const T*)inv, N, sc, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// (x, p, r, q, inv or NULL, N, partials, sc, st, trace or NULL, stream)
int macroc_cg_update_xr_f32(void* x, const void* p, void* r, const void* q,
                            const void* inv, long long N, double* partials,
                            double* sc, int* st, double* trace, void* stream) {
  return launch_xr<float>(x, p, r, q, inv, N, partials, sc, st, trace, stream);
}
int macroc_cg_update_xr_f64(void* x, const void* p, void* r, const void* q,
                            const void* inv, long long N, double* partials,
                            double* sc, int* st, double* trace, void* stream) {
  return launch_xr<double>(x, p, r, q, inv, N, partials, sc, st, trace, stream);
}

// (p, r, inv or NULL, N, sc, st, stream)
int macroc_cg_update_p_f32(void* p, const void* r, const void* inv, long long N,
                           const double* sc, const int* st, void* stream) {
  return launch_p<float>(p, r, inv, N, sc, st, stream);
}
int macroc_cg_update_p_f64(void* p, const void* r, const void* inv, long long N,
                           const double* sc, const int* st, void* stream) {
  return launch_p<double>(p, r, inv, N, sc, st, stream);
}

}  // extern "C"
