// Galerkin-level fp32 stiffness apply from an assembled node stencil, and
// the kernel that assembles the stencil from a per-element Ke stack, for
// degree-1 voxel grids.
//
// Replaces: ndr_tpu/fem/pallas_kernels.py apply_k_pallas_cached (and its
// operand layout, ke_stream_layout), the fused apply of the non-coarsest
// cached multigrid levels under the Chebyshev smoother. The TPU kernel
// streams every element's d_pe x d_pe Ke (2,304 B in 3-D) on each apply.
// Here a level's operator is assembled once per hierarchy build into a node
// stencil: for every node its 3^N neighbour N x N blocks, 3^N N^2 fp32
// values (972 B per node in 3-D), stored slot-major,
//
//   S[((o * N + c) * N + d) * nodes + n] = K[(n, c), (n + off(o), d)],
//
// with o over the 3^N neighbour offsets in C order over (-1, 0, 1)^N. A slot
// whose neighbour lies outside the grid holds 0.
//
// ndr_cached_stencil_f32 (assembly). Slot (o, c, d) of node n sums, over the
// local nodes a of n's incident elements e = n - bits(a), the coefficient
// Ke_e[a N + c, b N + d] with bits(b) = bits(a) + o. One block per 32
// consecutive nodes. For each a in turn it reads rows a N .. a N + N - 1 of
// its nodes' elements (N d_pe contiguous values per element, so the reads
// are coalesced) and adds each value into its slot's accumulator in shared
// memory. Within one a no two values go to one slot, and the a are taken in
// order with a barrier between them, so every slot is summed in the fixed
// order a = 0, 1, ..., the order of the plain twin's slice adds, without
// atomics. The block then writes its slots, 32 consecutive nodes per warp
// store. Bound: bytes, the Ke stack read once and the stencil written once.
//
// ndr_apply_k_cached_f32 (apply). One thread per (node, output component):
// 128 consecutive nodes x N components per block, so at level 2 of a
// 192x96x96 hierarchy (30,625 nodes) 92k threads run where one thread per
// node gave 30k, fewer than the card holds. The lanes of a warp read
// neighbouring addresses of each slot row. Each thread sums its 3^N N slots
// times the neighbour u values in a fixed order; no atomics. The stencil is
// read once per apply, with streaming loads; u (1% of the stencil's bytes)
// is re-read through L1. Out-of-grid neighbours read the node's own u in
// place of a bounds branch and multiply it by 0. Bound: bytes, the stencil
// read once plus u read and f written once.
#include <cuda_runtime.h>

namespace {

constexpr int kAsmNodes = 32;      // nodes per assembly block
constexpr int kAsmThreads = 256;
constexpr int kApplyNodes = 128;   // nodes per apply block (x N components)

template <int NDIM>
struct Stencil {
  static constexpr int NPE = 1 << NDIM;                 // element nodes
  static constexpr int D = NPE * NDIM;                  // element DOFs
  static constexpr int ROWS = NDIM * D;                 // one local node's Ke rows
  static constexpr int NOFF = NDIM == 3 ? 27 : 9;       // neighbour offsets
  static constexpr int SLOTS = NOFF * NDIM * NDIM;
};

// Offset bit of local node `a` along `axis` (C order: last axis lowest bit).
template <int NDIM>
__device__ __forceinline__ int local_bit(int a, int axis) {
  return axis < NDIM ? (a >> (NDIM - 1 - axis)) & 1 : 0;
}

template <int NDIM>
__global__ void __launch_bounds__(kAsmThreads)
cached_stencil_kernel(const float* __restrict__ ke, float* __restrict__ S,
                      int ex, int ey, int ez, int nodes) {
  using St = Stencil<NDIM>;
  __shared__ float acc[St::SLOTS][kAsmNodes + 1];   // +1: no bank conflicts
  __shared__ long long rows_at[St::NPE][kAsmNodes];  // Ke offset, or -1
  __shared__ short slot_of[St::NPE][St::ROWS];
  const int t = threadIdx.x;
  const int base = blockIdx.x * kAsmNodes;
  const int ny = ey + 1;
  const int nz = NDIM == 3 ? ez + 1 : 1;

  for (int q = t; q < St::SLOTS * (kAsmNodes + 1); q += kAsmThreads) {
    (&acc[0][0])[q] = 0.0f;
  }
  // where rows a N .. a N + N - 1 of node n's element e = n - bits(a) start
  for (int q = t; q < St::NPE * kAsmNodes; q += kAsmThreads) {
    const int a = q / kAsmNodes;
    const int kk = q % kAsmNodes;
    const int n = base + kk;
    long long at = -1;
    if (n < nodes) {
      const int k = NDIM == 3 ? n % nz : 0;
      const int j = (n / nz) % ny;
      const int i = n / (nz * ny);
      const int ei = i - local_bit<NDIM>(a, 0);
      const int ej = j - local_bit<NDIM>(a, 1);
      const int ek = NDIM == 3 ? k - local_bit<NDIM>(a, 2) : 0;
      if (ei >= 0 && ei < ex && ej >= 0 && ej < ey &&
          (NDIM == 2 || (ek >= 0 && ek < ez))) {
        const long long e = NDIM == 3
            ? (static_cast<long long>(ei) * ey + ej) * ez + ek
            : static_cast<long long>(ei) * ey + ej;
        at = e * (St::D * St::D) + a * St::ROWS;
      }
    }
    rows_at[a][kk] = at;
  }
  // the slot that value w = c d_pe + b N + d of local node a's rows feeds
  for (int q = t; q < St::NPE * St::ROWS; q += kAsmThreads) {
    const int a = q / St::ROWS;
    const int w = q % St::ROWS;
    const int c = w / St::D;
    const int b = (w % St::D) / NDIM;
    const int d = w % NDIM;
    int o = 0;
    for (int axis = 0; axis < NDIM; ++axis) {
      o = o * 3 + local_bit<NDIM>(b, axis) - local_bit<NDIM>(a, axis) + 1;
    }
    slot_of[a][w] = static_cast<short>((o * NDIM + c) * NDIM + d);
  }
  __syncthreads();

  for (int a = 0; a < St::NPE; ++a) {
    for (int q = t; q < kAsmNodes * St::ROWS; q += kAsmThreads) {
      const int kk = q / St::ROWS;
      const int w = q % St::ROWS;
      const long long at = rows_at[a][kk];
      if (at >= 0) acc[slot_of[a][w]][kk] += __ldcs(ke + at + w);
    }
    __syncthreads();
  }

  for (int q = t; q < St::SLOTS * kAsmNodes; q += kAsmThreads) {
    const int s = q / kAsmNodes;
    const int kk = q % kAsmNodes;
    const int n = base + kk;
    if (n < nodes) S[static_cast<long long>(s) * nodes + n] = acc[s][kk];
  }
}

template <int NDIM>
__global__ void __launch_bounds__(kApplyNodes * NDIM)
cached_apply_kernel(const float* __restrict__ u, const float* __restrict__ S,
                    float* __restrict__ f, int nx, int ny, int nz) {
  using St = Stencil<NDIM>;
  const int nodes = nx * ny * nz;
  const int n = blockIdx.x * kApplyNodes + threadIdx.x;
  const int c = threadIdx.y;
  if (n >= nodes) return;
  // node multi-index (i, j, k); in 2-D the axes are (j, k) and i = 0
  const int k = n % nz;
  const int j = (n / nz) % ny;
  const int i = n / (nz * ny);
  const float* Sc = S + static_cast<long long>(c * NDIM) * nodes + n;
  float acc = 0.0f;
#pragma unroll
  for (int o = 0; o < St::NOFF; ++o) {
    const int si = NDIM == 3 ? o / 9 - 1 : 0;  // the offset's shift per axis
    const int sj = (NDIM == 3 ? (o / 3) % 3 : o / 3) - 1;
    const int sk = o % 3 - 1;
    const bool inside = i + si >= 0 && i + si < nx && j + sj >= 0 &&
                        j + sj < ny && k + sk >= 0 && k + sk < nz;
    const int m = inside ? n + (si * ny + sj) * nz + sk : n;
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      const float s = __ldcs(Sc + static_cast<long long>(o * NDIM * NDIM + d) * nodes);
      const float v = __ldg(u + static_cast<long long>(m) * NDIM + d);
      acc = fmaf(s, inside ? v : 0.0f, acc);
    }
  }
  f[static_cast<long long>(n) * NDIM + c] = acc;
}

}  // namespace

// ke: (ex, ey[, ez], d_pe, d_pe) fp32; S: (3^N, N, N) + node dims fp32,
// written in full. Returns a cudaError_t code.
extern "C" int ndr_cached_stencil_f32(const void* ke, void* S, int ndim, int ex,
                                      int ey, int ez, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int nodes = (ex + 1) * (ey + 1) * (ndim == 3 ? ez + 1 : 1);
  const unsigned int blocks = (nodes + kAsmNodes - 1) / kAsmNodes;
  const float* kp = static_cast<const float*>(ke);
  float* sp = static_cast<float*>(S);
  if (ndim == 3) {
    cached_stencil_kernel<3><<<blocks, kAsmThreads, 0, s>>>(kp, sp, ex, ey, ez, nodes);
  } else {
    cached_stencil_kernel<2><<<blocks, kAsmThreads, 0, s>>>(kp, sp, ex, ey, 1, nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

// u: node dims + (N,) fp32; S: a ndr_cached_stencil_f32 stencil of the same
// grid; f: node dims + (N,) fp32, written in full. Returns a cudaError_t code.
extern "C" int ndr_apply_k_cached_f32(const void* u, const void* S, void* f,
                                      int ndim, int ex, int ey, int ez,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const float* up = static_cast<const float*>(u);
  const float* sp = static_cast<const float*>(S);
  float* fp = static_cast<float*>(f);
  if (ndim == 3) {
    const int nodes = (ex + 1) * (ey + 1) * (ez + 1);
    const dim3 block(kApplyNodes, 3);
    cached_apply_kernel<3><<<(nodes + kApplyNodes - 1) / kApplyNodes, block, 0, s>>>(
        up, sp, fp, ex + 1, ey + 1, ez + 1);
  } else {
    const int nodes = (ex + 1) * (ey + 1);
    const dim3 block(kApplyNodes, 2);
    cached_apply_kernel<2><<<(nodes + kApplyNodes - 1) / kApplyNodes, block, 0, s>>>(
        up, sp, fp, 1, ex + 1, ey + 1);
  }
  return static_cast<int>(cudaGetLastError());
}
