// The J2 (von Mises) radial-return map with its consistent tangent, one
// thread per Gauss point (port-only: the JAX package's J2 engine,
// macroc_tpu/constitutive/j2.py::J2Engine.homogenize, is jnp code that XLA
// fuses; the port's plain version is constitutive/j2.py::j2_radial_return,
// about fifty tensor operations that build the (...,6,6) tangent and two
// more (...,6,6) temporaries on the way).
//
// A thread reads eps[6], eps_p[6] and alpha of its GP and writes stress[6],
// ctan[36], eps_p_new[6], alpha_new, f_trial and plastic (one byte), in the
// plain version's contiguous layouts; nothing else is allocated.  The
// arithmetic is j2_radial_return's, in its order: the trial stress
// sum_j e[j] C[i][j] with the engine's elastic matrix C; the deviator, its
// norm, f_trial = |s| - sqrt(2/3) (Sy + Ka alpha), dgamma, n = s / max(|s|,
// 1e-30); the stress and the engineering eps_p update (shear entries
// doubled); the tangent (2 mu theta I_dev + kappa 1x1) - (2 mu thetabar)
// n x n where plastic, C where elastic.  Every product, sum and quotient is
// rounded on its own (no contraction into fused multiply-adds), as the
// plain version's separate tensor operations round them; the material
// constants arrive as doubles computed as the plain version computes its
// Python floats, and are rounded to T once, as PyTorch rounds a Python
// scalar against a T tensor.
//
// Bound: device memory.  Per GP 13 values in and 50 values plus one byte
// out: 52 B read and 201 B written at f32, 4.245 GB at 128^3 nodes x 8
// GPs, 1.267 ms at 3.35 TB/s; about 356 operations a GP (140 where
// elastic) are far below the card's rate.  Design: a block takes GPS
// consecutive GPs (128 at f32, 64 at f64) and stages its rows through
// 24 KB of shared memory, so every device-memory access is a whole
// 16-byte vector of consecutive threads on consecutive addresses: the
// block loads its eps and eps_p rows coalesced into shared memory, each
// thread computes its GP from there and writes its stress, eps_p_new and
// 36 tangent values back into shared memory (the 6-vectors as 2-value
// vectors, the tangent as 16-byte vectors: conflict-free at f32), and the
// block copies the three out coalesced.  alpha, alpha_new, f_trial and
// plastic move one value a thread, already coalesced.  The first form
// (one thread's 144 tangent bytes stored straight to device memory, each
// warp store touching 32 sectors) ran at 0.34 of the bound.

#include <cuda_runtime.h>

namespace {

// GPs (and threads) per block: 48 values of T each in shared memory, 24 KB
template <typename T> constexpr int GPS = 512 / sizeof(T);

template <typename T> struct J2Params {
  T C[36];    // the elastic matrix, row-major: sigma = C eps (engineering)
  T mu2;      // 2 mu
  T hden;     // 2 mu + (2/3) Ka
  T Sy, Ka;
  T kappa;    // lam + 2 mu / 3
  T tb0;      // 1 / (1 + Ka / (3 mu))
  T sq23;     // sqrt(2/3)
};

// single-rounded arithmetic: never contracted into an FMA
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quo(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ float root(float a) { return __fsqrt_rn(a); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double quo(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ double root(double a) { return __dsqrt_rn(a); }

// the plain version's tables, as numpy builds them in double
__host__ __device__ constexpr double ones33(int i, int j) { return i < 3 && j < 3 ? 1.0 : 0.0; }
__host__ __device__ constexpr double i_dev(int i, int j) {
  return (i == j ? (i < 3 ? 1.0 : 0.5) : 0.0) - ones33(i, j) / 3.0;
}

// two values of T (8 or 16 bytes) and sixteen bytes of T
template <typename T> struct Vec;
template <> struct Vec<float> { using two = float2; using wide = float4; };
template <> struct Vec<double> { using two = double2; using wide = double2; };

// one thread's N values of T from/to its aligned row, in vectors of type VT
template <typename VT, typename T, int N>
__device__ __forceinline__ void load(const T* src, T (&v)[N]) {
  constexpr int V = sizeof(VT) / sizeof(T);
#pragma unroll
  for (int k = 0; k < N / V; ++k) {
    const VT w = reinterpret_cast<const VT*>(src)[k];
#pragma unroll
    for (int l = 0; l < V; ++l) v[k * V + l] = reinterpret_cast<const T*>(&w)[l];
  }
}

template <typename VT, typename T, int N>
__device__ __forceinline__ void store(T* dst, const T (&v)[N]) {
  constexpr int V = sizeof(VT) / sizeof(T);
#pragma unroll
  for (int k = 0; k < N / V; ++k) {
    VT w;
#pragma unroll
    for (int l = 0; l < V; ++l) reinterpret_cast<T*>(&w)[l] = v[k * V + l];
    reinterpret_cast<VT*>(dst)[k] = w;
  }
}

// the block's count consecutive values between device and shared memory,
// both 16-byte aligned: 16-byte vectors, then the ragged tail one by one
template <typename T>
__device__ __forceinline__ void block_copy(T* __restrict__ dst, const T* __restrict__ src,
                                           int count) {
  using VW = typename Vec<T>::wide;
  constexpr int V = sizeof(VW) / sizeof(T);
  const int nv = count / V;
  for (int i = threadIdx.x; i < nv; i += GPS<T>)
    reinterpret_cast<VW*>(dst)[i] = reinterpret_cast<const VW*>(src)[i];
  for (int i = nv * V + threadIdx.x; i < count; i += GPS<T>) dst[i] = src[i];
}

template <typename T>
__global__ void __launch_bounds__(GPS<T>)
j2_return_kernel(const T* __restrict__ eps, const T* __restrict__ eps_p,
                 const T* __restrict__ alpha, T* __restrict__ stress, T* __restrict__ ctan,
                 T* __restrict__ eps_p_new, T* __restrict__ alpha_new,
                 T* __restrict__ f_trial, bool* __restrict__ plastic, long long N,
                 const J2Params<T> P) {
  using V2 = typename Vec<T>::two;
  using VW = typename Vec<T>::wide;
  constexpr int B = GPS<T>;
  // the block's rows: eps then stress, eps_p then eps_p_new, the tangents
  __shared__ __align__(16) T s_e[6 * B], s_p[6 * B], s_c[36 * B];
  const long long g0 = (long long)blockIdx.x * B;
  const int nb = (int)(N - g0 < B ? N - g0 : B);
  block_copy(s_e, eps + 6 * g0, 6 * nb);
  block_copy(s_p, eps_p + 6 * g0, 6 * nb);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nb) {
    const long long g = g0 + t;
    T e[6], ep[6];
    load<V2>(s_e + 6 * t, e);
    load<V2>(s_p + 6 * t, ep);
    const T al = alpha[g];
#pragma unroll
    for (int k = 0; k < 6; ++k) e[k] = sub(e[k], ep[k]);

    // trial stress, deviator and its norm
    T sig[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      T acc = mul(e[0], P.C[6 * i]);
#pragma unroll
      for (int j = 1; j < 6; ++j) acc = add(acc, mul(e[j], P.C[6 * i + j]));
      sig[i] = acc;
    }
    const T p = quo(add(add(sig[0], sig[1]), sig[2]), T(3));
    T s[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) s[k] = k < 3 ? sub(sig[k], p) : sig[k];
    const T sn = add(add(mul(s[0], s[0]), mul(s[1], s[1])), mul(s[2], s[2]));
    const T ss = add(add(mul(s[3], s[3]), mul(s[4], s[4])), mul(s[5], s[5]));
    const T snorm = root(add(sn, mul(T(2), ss)));

    // yield test and return
    const T ft = sub(snorm, mul(P.sq23, add(P.Sy, mul(P.Ka, al))));
    const bool pl = ft > T(0);
    const T dg = pl ? quo(ft, P.hden) : T(0);
    const T safe = snorm > T(1e-30) ? snorm : T(1e-30);
    T n[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) n[k] = quo(s[k], safe);
    const T gm = mul(P.mu2, dg);
    T out[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) out[k] = sub(sig[k], mul(gm, n[k]));
    store<V2>(s_e + 6 * t, out);
#pragma unroll
    for (int k = 0; k < 6; ++k)
      out[k] = pl ? add(ep[k], mul(dg, k < 3 ? n[k] : mul(n[k], T(2)))) : ep[k];
    store<V2>(s_p + 6 * t, out);
    alpha_new[g] = pl ? add(al, mul(P.sq23, dg)) : al;
    f_trial[g] = ft;
    plastic[g] = pl;

    // consistent tangent: (2 mu theta I_dev + kappa 1x1) - (2 mu thetabar) n x n
    const T theta = sub(T(1), quo(gm, safe));
    const T thetabar = sub(P.tb0, sub(T(1), theta));
    const T a = mul(P.mu2, theta), b = mul(P.mu2, thetabar);
    T c[36];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        c[6 * i + j] = pl ? sub(add(mul(a, T(i_dev(i, j))), mul(P.kappa, T(ones33(i, j)))),
                                mul(mul(n[i], n[j]), b))
                          : P.C[6 * i + j];
      }
    }
    store<VW>(s_c + 36 * t, c);
  }
  __syncthreads();
  block_copy(stress + 6 * g0, s_e, 6 * nb);
  block_copy(eps_p_new + 6 * g0, s_p, 6 * nb);
  block_copy(ctan + 36 * g0, s_c, 36 * nb);
}

template <typename T>
int launch(const void* eps, const void* eps_p, const void* alpha, void* stress, void* ctan,
           void* eps_p_new, void* alpha_new, void* f_trial, void* plastic, long long N,
           const double* host, cudaStream_t stream) {
  J2Params<T> P;
  for (int k = 0; k < 36; ++k) P.C[k] = T(host[k]);
  P.mu2 = T(host[36]);
  P.hden = T(host[37]);
  P.Sy = T(host[38]);
  P.Ka = T(host[39]);
  P.kappa = T(host[40]);
  P.tb0 = T(host[41]);
  P.sq23 = T(host[42]);
  if (N > 0) {
    const long long blocks = (N + GPS<T> - 1) / GPS<T>;
    j2_return_kernel<T><<<(unsigned)blocks, GPS<T>, 0, stream>>>(
        static_cast<const T*>(eps), static_cast<const T*>(eps_p),
        static_cast<const T*>(alpha), static_cast<T*>(stress), static_cast<T*>(ctan),
        static_cast<T*>(eps_p_new), static_cast<T*>(alpha_new), static_cast<T*>(f_trial),
        static_cast<bool*>(plastic), N, P);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// (eps, eps_p, alpha, stress, ctan, eps_p_new, alpha_new, f_trial, plastic,
//  N, host double[43] params, stream); every pointer 16-byte aligned
#define J2_ENTRY(NAME, T)                                                             \
  extern "C" int NAME(const void* eps, const void* eps_p, const void* alpha,         \
                      void* stress, void* ctan, void* eps_p_new, void* alpha_new,    \
                      void* f_trial, void* plastic, long long N, const double* host, \
                      void* stream) {                                                 \
    return launch<T>(eps, eps_p, alpha, stress, ctan, eps_p_new, alpha_new, f_trial, \
                     plastic, N, host, static_cast<cudaStream_t>(stream));            \
  }

J2_ENTRY(macroc_j2_return_f32, float)
J2_ENTRY(macroc_j2_return_f64, double)
