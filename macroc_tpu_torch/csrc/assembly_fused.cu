// K2: fused stencil assembly -- per-GP tangents -> SoA stencil, in one
// kernel that never writes the element stiffness to device memory.
//
// Replaces: macroc_tpu/ops/assembly_pallas.py::assemble_stencil_soa_mxu,
// the whole function: its stage-1 einsum (Ke = M @ vec(C), M = B^T x B wg,
// a dense 576 x 288 product per element) and its Pallas combine
// (_combine_kernel).
//
//   ctan: (nex, ney, nez, 8, 6, 6); each element's 288 values contiguous,
//         elements at strides (sx, sy, 288) -- a contiguous tensor or a
//         slice of a node-shaped one
//   A   : (243, nx, ny, nz) = (27,3,3,nx,ny,nz); entry K = o*9 + d*3 + e
//   Ke[(a,d),(b,e)] = wg sum_g sum_v sum_w B_g[v,(a,d)] C_g[v,w] B_g[w,(b,e)]
//   A[K, elem + off_a] += Ke[(a,d),(b,e)],  o = offset(off_b - off_a)
//
// B's pattern (fem/element.py::b_matrix): column (n,d) has three nonzero
// Voigt rows R[d][t], holding dsh[g,n,D[d][t]].  So per GP
//   CB[v,(b,e)] = sum_t C_g[v,R[e][t]] dsh[g,b,D[e][t]]        (432 MAC)
//   Ke[(a,d),(b,e)] += sum_t dsh[g,a,D[d][t]] CB[R[d][t],(b,e)] (1,728 MAC)
// 17,280 MAC per element against the dense product's 165,888.  The
// wrapper (ops/assembly.py::assemble_stencil_soa_kernel) checks that B has
// that pattern and passes its 192 dsh values by value.
//
// Bound: at f32 about balanced.  Reading ctan once (1,152 B per element)
// and writing A once (972 B per node) is 1.31 ms at 3.35 TB/s on 127^3
// elements; its 70.8 GFLOP are 1.06 ms at 67 TFLOP/s FP32.  Tensor cores
// are out: TF32 stalls Newton, and the operator is not stored narrower.
//
// Design: a block owns a column of TY x TZ nodes over a chunk [i0, i1) of
// node layers along x, and marches along x one element layer at a time.
// Each element layer's (TY+1)(TZ+1) halo elements are computed by the
// block (1.29x recompute at 7 x 8, f32).  Elements that share a node
// differ in the parity of y or z, so the layer's elements are taken one
// parity class ("colour") at a time, in rounds of at most S elements of
// one colour: no two elements of a round touch the same node.  A round's
// ctan is staged in shared memory by cp.async, three stages deep, so the
// next round's copy overlaps this round's arithmetic.  A thread owns one Ke
// column (b,e) of one element and keeps its 24 rows in registers; the team
// of an element is 24 threads, laid out so that e is uniform across a warp
// (warp w holds e = w % 3 for 4 elements, lane = 8 * element + b), so
// every index into C and into the uniform dsh values is a compile-time
// constant: the uniform dsh operands come straight from the constant bank.
// The thread then adds its 24 values into the block's node accumulators in
// shared memory: two node layers (x and x+1) x 243 entries x TY*TZ nodes.
// No atomics: within a round each accumulator entry has one writer, a
// barrier separates rounds, and the round order is fixed, so two launches
// are bitwise equal.  When an element layer is done, the node layer below
// it is complete and is written to A once, in z-runs of TZ (32 B sectors at
// TZ = 8, f32), and its accumulators are cleared for the layer after next.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

// Voigt row of B's t-th nonzero in column dimension d, and the dsh
// component it holds (fem/element.py::b_matrix)
__host__ __device__ constexpr int voigt_row(int d, int t) {
  return d == 0 ? (t == 0 ? 0 : t == 1 ? 3 : 4)
       : d == 1 ? (t == 0 ? 1 : t == 1 ? 3 : 5)
                : (t == 0 ? 2 : t == 1 ? 4 : 5);
}
__host__ __device__ constexpr int dsh_comp(int d, int t) {
  return d == 0 ? t : d == 1 ? (t == 0 ? 1 : t == 1 ? 0 : 2)
                             : (t == 0 ? 2 : t == 1 ? 0 : 1);
}
// NODE_OFFSETS (VTK hexahedron order), fem/element.py
__host__ __device__ constexpr int off_x(int a) { return a == 1 || a == 2 || a == 5 || a == 6; }
__host__ __device__ constexpr int off_y(int a) { return a == 2 || a == 3 || a == 6 || a == 7; }
__host__ __device__ constexpr int off_z(int a) { return a >= 4; }

template <typename T>
struct Dsh {
  T v[8][8][3];  // dsh[g][node][component]
};

// Tiling per type: node column TY x TZ, S elements per round (24*S
// threads); shared memory ~180 KB either way, one block per SM.  At 7 x 8
// (f32) the 8 x 9 halo elements fall into colours of 20, 16, 20 and 16:
// one round of 20 each.
template <typename T> struct Tile;
template <> struct Tile<float> { static constexpr int TY = 7, TZ = 8, S = 20; };
template <> struct Tile<double> { static constexpr int TY = 4, TZ = 8, S = 8; };

template <typename T>
struct Geo {
  static constexpr int TY = Tile<T>::TY, TZ = Tile<T>::TZ, S = Tile<T>::S;
  static constexpr int NT = 24 * S;                   // threads
  static constexpr int VEC = 16 / sizeof(T);          // values per cp.async
  static constexpr int CH = 288 / VEC;                // copies per element
  static constexpr int SLOT = 288 + 32 / sizeof(T);   // padded: no bank conflicts
  static constexpr int NODES = TY * TZ;
  static constexpr int STR = NODES + 1;               // accumulator stride per K
  static constexpr int LAYER = 243 * STR;
  static constexpr int NBUF = 3;                      // ctan stages
  static constexpr size_t SMEM = (NBUF * S * SLOT + 2 * LAYER) * sizeof(T);
};

// the 24 rows of Ke column (b, E) of one element, over its 8 GPs
template <typename T, int E>
__device__ __forceinline__ void element_column(const T* __restrict__ cs,
                                               const Dsh<T>& P,
                                               const T (&md)[8][3],
                                               T (&ke)[24]) {
#pragma unroll
  for (int i = 0; i < 24; ++i) ke[i] = T(0);
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    const T* C = cs + g * 36;
    T cb[6];
#pragma unroll
    for (int v = 0; v < 6; ++v)
      cb[v] = C[v * 6 + voigt_row(E, 0)] * md[g][0] +
              C[v * 6 + voigt_row(E, 1)] * md[g][1] +
              C[v * 6 + voigt_row(E, 2)] * md[g][2];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int d = 0; d < 3; ++d)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          ke[a * 3 + d] += P.v[g][a][dsh_comp(d, t)] * cb[voigt_row(d, t)];
  }
}

// the halo elements of one parity class ("colour") of a node column:
// elements (y0 + 2*iy, z0 + 2*iz), iy < ny, iz < nz
struct Colour {
  int y0, ny, z0, nz;
};

__device__ __forceinline__ Colour colour_of(int c, int eyA, int eyB, int ezA,
                                            int ezB) {
  Colour k;
  k.y0 = eyA + ((eyA & 1) != (c >> 1));
  k.z0 = ezA + ((ezA & 1) != (c & 1));
  k.ny = k.y0 <= eyB ? (eyB - k.y0) / 2 + 1 : 0;
  k.nz = k.z0 <= ezB ? (ezB - k.z0) / 2 + 1 : 0;
  return k;
}

template <typename T>
__global__ void __launch_bounds__(Geo<T>::NT, 1)
assembly_fused_kernel(const T* __restrict__ ctan, T* __restrict__ A,
                      const __grid_constant__ Dsh<T> P, T wg, int nx, int ny,
                      int nz, long long sx, long long sy, int xchunk) {
  using G = Geo<T>;
  constexpr int TY = G::TY, TZ = G::TZ, S = G::S, NT = G::NT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);  // NBUF x S x SLOT staged ctan
  T* acc = cs + G::NBUF * S * G::SLOT;     // 2 x LAYER node accumulators

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int e = warp % 3;
  const int b = lane & 7;
  const int s = (warp / 3) * 4 + (lane >> 3);  // this thread's slot
  const int nex = nx - 1, ney = ny - 1, nez = nz - 1;
  const int k0 = blockIdx.x * TZ, j0 = blockIdx.y * TY;
  const int i0 = blockIdx.z * xchunk, i1 = min(i0 + xchunk, nx);
  // the column's halo elements, clipped to the grid, in four colours: a
  // round holds elements of one colour, which share no node
  const int eyA = max(j0 - 1, 0), eyB = min(j0 + TY - 1, ney - 1);
  const int ezA = max(k0 - 1, 0), ezB = min(k0 + TZ - 1, nez - 1);
  int nrc[4], nr = 0;  // rounds per colour and per element layer
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const Colour k = colour_of(c, eyA, eyB, ezA, ezB);
    nrc[c] = (k.ny * k.nz + S - 1) / S;
    nr += nrc[c];
  }
  const int exA = max(i0 - 1, 0), exB = min(i1 - 1, nex - 1);
  const int nq = (exB - exA + 1) * nr;
  // round q -> element layer, colour, first element of the colour
  auto round_of = [&](int q, int& ex, Colour& k, int& first) {
    ex = exA + q / nr;
    int r = q % nr, c = 0;
#pragma unroll
    for (int cc = 0; cc < 3; ++cc)
      if (c == cc && r >= nrc[cc]) { r -= nrc[cc]; c = cc + 1; }
    k = colour_of(c, eyA, eyB, ezA, ezB);
    first = r * S;
  };

  for (int i = tid; i < 2 * G::LAYER; i += NT) acc[i] = T(0);
  // this thread's dsh[g, b, D[e][t]] * wg
  T md[8][3];
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int t = 0; t < 3; ++t) md[g][t] = P.v[g][b][dsh_comp(e, t)] * wg;

  auto prefetch = [&](int q) {
    int ex, first;
    Colour k;
    round_of(q, ex, k, first);
    T* dst = cs + (q % G::NBUF) * S * G::SLOT;
    for (int idx = tid; idx < S * G::CH; idx += NT) {
      const int sl = idx / G::CH, c = idx - sl * G::CH;
      const int el = first + sl;
      if (el < k.ny * k.nz) {
        const int ey = k.y0 + 2 * (el / k.nz), ez = k.z0 + 2 * (el % k.nz);
        const T* src = ctan + ex * sx + ey * sy + (long long)ez * 288 + c * G::VEC;
        __pipeline_memcpy_async(dst + sl * G::SLOT + c * G::VEC, src, 16);
      }
    }
    __pipeline_commit();
  };

  auto write_layer = [&](int n) {
    T* L = acc + (n & 1) * G::LAYER;
    const long long plane = (long long)nx * ny * nz;
    for (int f = tid; f < 243 * G::NODES; f += NT) {
      const int K = f / G::NODES, q = f - K * G::NODES;
      const int j = j0 + q / TZ, k = k0 + q % TZ;
      T* src = L + K * G::STR + q;
      if (j < ny && k < nz) A[K * plane + ((long long)n * ny + j) * nz + k] = *src;
      *src = T(0);
    }
  };

  const int bx = off_x(b), by = off_y(b), bz = off_z(b);
  if (nq > 0) prefetch(0);
  for (int q = 0; q < nq; ++q) {
    // NBUF = 3: the buffer refilled here was last read two rounds ago,
    // before the previous round's barrier
    if (q + 1 < nq) prefetch(q + 1);
    else __pipeline_commit();  // an empty group keeps the count uniform
    __pipeline_wait_prior(1);
    __syncthreads();  // round q staged; round q-1's scatter done

    int ex, first;
    Colour k;
    round_of(q, ex, k, first);
    const int el = first + s;
    if (el < k.ny * k.nz) {
      const int ey = k.y0 + 2 * (el / k.nz), ez = k.z0 + 2 * (el % k.nz);
      const T* slot = cs + (q % G::NBUF) * S * G::SLOT + s * G::SLOT;
      T ke[24];
      if (e == 0) element_column<T, 0>(slot, P, md, ke);
      else if (e == 1) element_column<T, 1>(slot, P, md, ke);
      else element_column<T, 2>(slot, P, md, ke);
      // one colour per round: each accumulator entry has one writer
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int nl = ex + off_x(a);
        const int jl = ey + off_y(a) - j0, kl = ez + off_z(a) - k0;
        if (nl < i0 || nl >= i1 || jl < 0 || jl >= TY || kl < 0 || kl >= TZ) continue;
        const int o = (bx - off_x(a) + 1) * 9 + (by - off_y(a) + 1) * 3 + (bz - off_z(a) + 1);
        T* dst = acc + (nl & 1) * G::LAYER + jl * TZ + kl;
#pragma unroll
        for (int d = 0; d < 3; ++d) dst[(o * 9 + d * 3 + e) * G::STR] += ke[a * 3 + d];
      }
    }
    if ((q + 1) % nr == 0) {  // element layer ex is done
      __syncthreads();
      if (ex >= i0) write_layer(ex);
      if (ex == nex - 1 && i1 == nx) write_layer(nx - 1);
    }
  }
}

// Node layers per block along x.  One block runs per SM, and a chunk of c
// layers costs about c + 1 element layers (the halo layer below it): take
// the chunking with the least (waves of blocks) x (layers per block).
int x_chunk(int nx, int columns, int n_sm) {
  int best = nx, best_cost = -1;
  for (int chunks = 1; chunks <= nx && chunks <= 64; ++chunks) {
    const int xc = (nx + chunks - 1) / chunks;
    const int blocks = columns * ((nx + xc - 1) / xc);
    const int cost = (blocks + n_sm - 1) / n_sm * (xc + 1);
    if (best_cost < 0 || cost < best_cost) best_cost = cost, best = xc;
  }
  return best;
}

template <typename T>
int launch(const void* ctan, const void* dsh, void* A, double wg, int nx,
           int ny, int nz, long long sx, long long sy, void* stream) {
  using G = Geo<T>;
  Dsh<T> P;
  const T* h = static_cast<const T*>(dsh);
  for (int i = 0; i < 192; ++i) (&P.v[0][0][0])[i] = h[i];
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(assembly_fused_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int gz = (nz + G::TZ - 1) / G::TZ, gy = (ny + G::TY - 1) / G::TY;
  const int xchunk = x_chunk(nx, gy * gz, n_sm);
  const dim3 grid(gz, gy, (nx + xchunk - 1) / xchunk);
  assembly_fused_kernel<T><<<grid, G::NT, G::SMEM, (cudaStream_t)stream>>>(
      (const T*)ctan, (T*)A, P, (T)wg, nx, ny, nz, sx, sy, xchunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ctan: device, element strides (sx, sy, 288) in values; dsh: host
// T[8*8*3]; A: device (243, nx, ny, nz); nx, ny, nz >= 2; launched on the
// current device
int macroc_assembly_fused_f32(const void* ctan, const void* dsh, void* A,
                              double wg, int nx, int ny, int nz, long long sx,
                              long long sy, void* stream) {
  return launch<float>(ctan, dsh, A, wg, nx, ny, nz, sx, sy, stream);
}

int macroc_assembly_fused_f64(const void* ctan, const void* dsh, void* A,
                              double wg, int nx, int ny, int nz, long long sx,
                              long long sy, void* stream) {
  return launch<double>(ctan, dsh, A, wg, nx, ny, nz, sx, sy, stream);
}

}  // extern "C"
