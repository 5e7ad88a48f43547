// K2: stencil-assembly combine -- element stiffness blocks -> SoA stencil.
//
// Replaces: macroc_tpu/ops/assembly_pallas.py::assemble_stencil_soa_mxu
// (Pallas kernel _combine_kernel).  Stage 1 of that function, the element
// stiffness Ke = M @ vec(C_e), stays a plain matrix product (torch.matmul in
// the wrapper, as it was an XLA einsum outside the Pallas call).
//
//   Ke: (576, nex, ney, nez)  channel-major; channel a*72 + (d*8+b)*3 + e
//       holds the (a,d)x(b,e) entry of each element's stiffness
//   A : (243, nx, ny, nz) = (27,3,3,nx,ny,nz); entry K = o*9 + d*3 + e
//   A[K, p] = sum_a Ke[map[K][a], p - off_a]   over the (at most 8) element
//             offsets a that feed K; elements outside [0,ne) count as zero.
//
// Bound: device memory.  Every Ke value is read exactly once and every A
// value written once: (576 + 243) * sizeof(T) bytes per node, no flops
// beyond the adds.
//
// Design: one thread per (node, output entry K) -- the "channel group" is a
// single K.  blockIdx.y is K, so all threads of a block share one row of
// the __constant__ combine map (a broadcast read); threads run along the
// node index with z fastest, so both the Ke reads (channel-major: element z
// and z+1 are adjacent) and the A writes coalesce.  No atomics: each A entry
// has exactly one writer.  Element planes outside [0,ne) are skipped by
// bounds checks -- the TPU kernel's lane rotate onto a zero element plane
// and its VMEM tile budgets are dropped.

#include <cuda_runtime.h>

namespace {

// c_map[K][a] = Ke channel (a*72 + c) feeding stencil entry K from the
// element at offset a below the node, or -1.  Filled from the Python table
// (ops/assembly.py::combine_table) by macroc_set_combine_map.
__constant__ int c_map[243][8];

// NODE_OFFSETS (VTK hexahedron order), macroc_tpu_torch/fem/element.py
__constant__ int c_node_off[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};

template <typename T>
__global__ void assembly_combine_kernel(const T* __restrict__ Ke,
                                        T* __restrict__ A,
                                        int nx, int ny, int nz) {
  const long long n = (long long)nx * ny * nz;
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int K = blockIdx.y;
  const int k = (int)(p % nz);
  const int j = (int)((p / nz) % ny);
  const int i = (int)(p / ((long long)ny * nz));
  const int nex = nx - 1, ney = ny - 1, nez = nz - 1;
  const long long ne = (long long)nex * ney * nez;

  T acc = T(0);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int ch = c_map[K][a];
    if (ch < 0) continue;
    const int ei = i - c_node_off[a][0];
    const int ej = j - c_node_off[a][1];
    const int ek = k - c_node_off[a][2];
    if (ei < 0 || ei >= nex || ej < 0 || ej >= ney || ek < 0 || ek >= nez)
      continue;
    acc += Ke[(long long)ch * ne + ((long long)ei * ney + ej) * nez + ek];
  }
  A[(long long)K * n + p] = acc;
}

template <typename T>
int launch(const void* Ke, void* A, int nx, int ny, int nz, void* stream) {
  const long long n = (long long)nx * ny * nz;
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (n > 0)
    assembly_combine_kernel<T><<<dim3((unsigned)blocks, 243), threads, 0,
                                 (cudaStream_t)stream>>>(
        (const T*)Ke, (T*)A, nx, ny, nz);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// table: host int32[243*8]; copied to the current device's constant bank
int macroc_set_combine_map(const void* table) {
  cudaError_t err = cudaMemcpyToSymbol(c_map, table, sizeof(int) * 243 * 8);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int macroc_assembly_combine_f32(const void* Ke, void* A, int nx, int ny,
                                int nz, void* stream) {
  return launch<float>(Ke, A, nx, ny, nz, stream);
}

int macroc_assembly_combine_f64(const void* Ke, void* A, int nx, int ny,
                                int nz, void* stream) {
  return launch<double>(Ke, A, nx, ny, nz, stream);
}

}  // extern "C"
