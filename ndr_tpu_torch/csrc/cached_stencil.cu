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
// Ke_e[a N + c, b N + d] with bits(b) = bits(a) + o, in the order a = 0,
// 1, ..., the order of the plain twin's slice adds, so the two are bitwise
// equal. Bound: bytes, the Ke stack read once (736 MB at level 1 of a
// 192x96x96 hierarchy, 0.22 ms at 3.35 TB/s) and the stencil written once.
// A block owns 64 consecutive nodes and holds their slots in shared
// memory (63 KB in 3-D). It walks the 2^N local nodes a in phases with a
// barrier between them: in phase a it adds rows a N .. a N + N - 1 of each
// node's element e (N d_pe contiguous fp32, 288 B in 3-D, 16-B aligned)
// into the slots; within one phase no two values go to one slot, so there
// are no atomics. Loaded one value at a time, each load consumed by its
// shared-memory add before the next issues (a bounds branch and a
// slot-table lookup per value), a thread keeps one 4-B load in flight,
// far less than the card needs to reach its memory rate. Here TPN = 6
// threads per node (4 in 2-D) each load 3 float4 of a row set (1 in 2-D),
// four phases at a time: the loads of phases a + 4 .. a + 7 are issued
// before the adds of phases a .. a + 3, so each thread keeps 192 B in
// flight across four barriers (phase 0-3's loads go out before the
// accumulators are zeroed). Loads go through the L2's normal policy, not
// evict-first: a 288-B row set ends inside a 64-B line whose other half
// the block of the neighbouring node reads soon after. The slot of each
// value is a compile-time function of (a, row offset): the thread's slot
// offsets at a = 0 are computed once and each phase subtracts a constant.
// The block then writes its slots, 64 consecutive nodes per store run.
// Measured on an H100 (PERF.md): two, then four phases in flight,
// __ldg, and larger blocks each gained; lanes on consecutive nodes (fewer
// bank conflicts) lost; at level 2 of a 192x96x96 hierarchy (30,625 nodes)
// blocks of 32 to 64 nodes, and two or four phases, came within 15% of
// one another, whatever the wave count, so one design serves every level.
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
//
// bf16 storage (ndr_cached_stencil_bf16, ndr_apply_k_cached_bf16; the
// solver's cached_ke_dtype="bfloat16", the TPU kernel's bf16 Ke stream):
// the same two kernels, instantiated for a stencil stored as bf16. The
// assembly sums each slot in fp32 in shared memory, as above, and rounds
// once, to nearest even, when it stores the slot (2 B per slot: 486 B per
// node in 3-D); the apply widens each slot to fp32 and accumulates in fp32.
// Both stay bound by bytes, the stencil's half as many of them. The TPU
// kernel rounds each element's Ke entry and sums the rounded entries; here
// the assembled sum is rounded once, so no entry is less accurate.
//
// float64 (ndr_cached_stencil_f64, ndr_apply_k_cached_f64; the cached
// levels of a float64 hierarchy, which the JAX package applies in XLA):
// the same two kernels with a double compute type beside the storage type.
// The assembly reads the float64 Ke stack as double2 (16 B, so a thread's
// row set is 6 double2 in 3-D, 2 in 2-D) and sums each slot in double in
// shared memory, in the order above, so it stays bitwise equal to its twin.
// At 64 nodes a block's double slots would take 243 x 65 x 8 = 126,360 B
// of shared memory in 3-D, one resident block per SM; a float64 block owns
// 32 nodes (64,152 B) and keeps two phases in flight (6 double2 each):
// the same 192 B of loads in flight per thread as the fp32 design, in the
// same 96 registers of staging. The apply reads u, the stencil and f in
// double and accumulates with fma. Both stay bound by bytes: at level 1 of
// a 192x96x96 hierarchy (232,897 nodes) the stencil is 452.8 MB, the Ke
// stack 1.02 GB; the FP64 rate is far from the limit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// The stencil's storage types: fp32, bf16 held as its 16 bits, or double.
// A slot is stored from, and loaded as, the compute type (float for the
// first two, double for the last).
__device__ __forceinline__ void store_slot(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_slot(unsigned short* p, float v) {
  *p = __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void store_slot(double* p, double v) { *p = v; }
__device__ __forceinline__ float load_slot(const float* p) { return __ldcs(p); }
__device__ __forceinline__ float load_slot(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned int>(__ldcs(p)) << 16);
}
__device__ __forceinline__ double load_slot(const double* p) { return __ldcs(p); }

// a * b + c, rounded once
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// The compute type C of the assembly: the Ke stack's type, read as 16-B
// vectors of W values, and the assembly's block: kNodes nodes, their slots
// in shared memory as C, kPhases phases' loads in flight.
template <typename C>
struct Compute;
template <>
struct Compute<float> {
  using V = float4;
  static constexpr int W = 4;
  static constexpr int kNodes = 64;
  static constexpr int kPhases = 4;
  __device__ static V zero() { return make_float4(0.0f, 0.0f, 0.0f, 0.0f); }
};
template <>
struct Compute<double> {
  using V = double2;
  static constexpr int W = 2;
  static constexpr int kNodes = 32;
  static constexpr int kPhases = 2;
  __device__ static V zero() { return make_double2(0.0, 0.0); }
};

// Value i (compile-time after unrolling) of a vector.
__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ double lane(const double2& v, int i) {
  return i == 0 ? v.x : v.y;
}

constexpr int kApplyNodes = 128;   // nodes per apply block (x N components)

template <int NDIM>
struct Stencil {
  static constexpr int NPE = 1 << NDIM;                 // element nodes
  static constexpr int D = NPE * NDIM;                  // element DOFs
  static constexpr int ROWS = NDIM * D;                 // one local node's Ke rows
  static constexpr int NOFF = NDIM == 3 ? 27 : 9;       // neighbour offsets
  static constexpr int SLOTS = NOFF * NDIM * NDIM;
  static constexpr int TPN = NDIM == 3 ? 6 : 4;         // assembly threads per node
  static constexpr int CENTER = NOFF / 2;               // the offset (0, .., 0)
};

// The assembly's layout in vectors of the compute type C.
template <int NDIM, typename C>
struct Asm : Stencil<NDIM> {
  using St = Stencil<NDIM>;
  static constexpr int W = Compute<C>::W;
  static constexpr int EV = St::D * St::D / W;          // vectors per element's Ke
  static constexpr int VV = St::ROWS / W;               // vectors per row set
  static constexpr int PER = VV / St::TPN;              // vectors per thread and phase
  static constexpr int NODES = Compute<C>::kNodes;
  static constexpr int THREADS = NODES * St::TPN;
  static_assert(VV % St::TPN == 0, "a row set splits evenly over a node's threads");
};

// Offset bit of local node `a` along `axis` (C order: last axis lowest bit).
template <int NDIM>
__host__ __device__ constexpr int local_bit(int a, int axis) {
  return axis < NDIM ? (a >> (NDIM - 1 - axis)) & 1 : 0;
}

// The stencil offset index of bits(a), C order over (0, 1, 2)^N: the slot
// of (a, c, b, d) is ((bits3(b) + CENTER - bits3(a)) N + c) N + d.
template <int NDIM>
__host__ __device__ constexpr int bits3(int a) {
  int o = 0;
  for (int axis = 0; axis < NDIM; ++axis) o = o * 3 + local_bit<NDIM>(a, axis);
  return o;
}

template <int NDIM, typename T, typename C>
__global__ void __launch_bounds__(Asm<NDIM, C>::THREADS)
cached_stencil_kernel(const typename Compute<C>::V* __restrict__ ke, T* __restrict__ S,
                      int ex, int ey, int ez, int nodes) {
  using St = Asm<NDIM, C>;
  using V = typename Compute<C>::V;
  constexpr int N = NDIM;
  constexpr int stride = St::NODES + 1;  // odd: fewer bank conflicts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* acc = reinterpret_cast<C*>(smem_raw);  // SLOTS rows of `stride`
  const int t = threadIdx.x;
  const int kk = t / St::TPN, r = t % St::TPN;
  const int base = blockIdx.x * St::NODES;
  const int n = base + kk;
  const int ny = ey + 1;
  const int nz = NDIM == 3 ? ez + 1 : 1;
  const int k = NDIM == 3 ? n % nz : 0;
  const int j = (n / nz) % ny;
  const int i = n / (nz * ny);
  // the phases a whose element n - bits(a) lies in the grid
  unsigned valid = 0;
#pragma unroll
  for (int a = 0; a < St::NPE; ++a) {
    const int ei = i - local_bit<NDIM>(a, 0);
    const int ej = j - local_bit<NDIM>(a, 1);
    const int ek = k - local_bit<NDIM>(a, 2);
    if (n < nodes && ei >= 0 && ei < ex && ej >= 0 && ej < ey &&
        (NDIM == 2 || (ek >= 0 && ek < ez))) {
      valid |= 1u << a;
    }
  }
  // vector index of this thread's part of element (i, j, k)'s local node 0
  // rows (off the grid where n is on a far face; only valid phases' shifts
  // are added to it), and the element strides in vectors
  const long long s0 = static_cast<long long>(NDIM == 3 ? ey * ez : ey) * St::EV;
  const long long s1 = static_cast<long long>(NDIM == 3 ? ez : 1) * St::EV;
  const long long s2 = St::EV;
  const long long at0 = (static_cast<long long>(i) * s0 + j * s1 + (NDIM == 3 ? k * s2 : 0)) + r;
  // accumulator index of each value this thread loads, at phase 0
  int slot0[St::PER][St::W];
#pragma unroll
  for (int q = 0; q < St::PER; ++q) {
#pragma unroll
    for (int v = 0; v < St::W; ++v) {
      const int w = St::W * (r + q * St::TPN) + v;
      const int c = w / St::D, b = (w % St::D) / N, d = w % N;
      slot0[q][v] = (((bits3<N>(b) + St::CENTER) * N + c) * N + d) * stride + kk;
    }
  }
  auto load = [&](int a, V (&dst)[St::PER]) {
    const long long at = at0 + a * St::VV - local_bit<NDIM>(a, 0) * s0 -
                         local_bit<NDIM>(a, 1) * s1 - local_bit<NDIM>(a, 2) * s2;
    const bool in = (valid >> a) & 1;
#pragma unroll
    for (int q = 0; q < St::PER; ++q) {
      dst[q] = in ? __ldg(ke + at + q * St::TPN) : Compute<C>::zero();
    }
  };

  constexpr int P = Compute<C>::kPhases;
  V cur[P][St::PER], nxt[P][St::PER];
#pragma unroll
  for (int p = 0; p < P; ++p) load(p, cur[p]);
  for (int q = t; q < St::SLOTS * stride; q += St::THREADS) acc[q] = C(0);
  __syncthreads();
#pragma unroll
  for (int a0 = 0; a0 < St::NPE; a0 += P) {
    if (a0 + P < St::NPE) {  // in flight across these phases
#pragma unroll
      for (int p = 0; p < P; ++p) load(a0 + P + p, nxt[p]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int a = a0 + p;
      if ((valid >> a) & 1) {
        const int shift = bits3<N>(a) * N * N * stride;
#pragma unroll
        for (int q = 0; q < St::PER; ++q) {
#pragma unroll
          for (int v = 0; v < St::W; ++v) acc[slot0[q][v] - shift] += lane(cur[p][q], v);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int q = 0; q < St::PER; ++q) cur[p][q] = nxt[p][q];
    }
  }

  // node base + t % NODES, slots t / NODES, + TPN, ...
  const int col = t % St::NODES;
  if (base + col < nodes) {
    for (int s = t / St::NODES; s < St::SLOTS; s += St::TPN) {
      store_slot(S + static_cast<long long>(s) * nodes + base + col, acc[s * stride + col]);
    }
  }
}

template <int NDIM, typename T, typename C>
int launch_stencil(const C* ke, T* S, int ex, int ey, int ez, cudaStream_t s) {
  using St = Asm<NDIM, C>;
  // 63 KB in 3-D for fp32 (64 nodes), 64,152 B for double (32 nodes)
  constexpr size_t smem = sizeof(C) * St::SLOTS * (St::NODES + 1);
  // per launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      cached_stencil_kernel<NDIM, T, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nodes = (ex + 1) * (ey + 1) * (NDIM == 3 ? ez + 1 : 1);
  const unsigned int blocks = (nodes + St::NODES - 1) / St::NODES;
  cached_stencil_kernel<NDIM, T, C><<<blocks, St::THREADS, smem, s>>>(
      reinterpret_cast<const typename Compute<C>::V*>(ke), S, ex, ey, ez, nodes);
  return static_cast<int>(cudaGetLastError());
}

template <int NDIM, typename T, typename C>
__global__ void __launch_bounds__(kApplyNodes * NDIM)
cached_apply_kernel(const C* __restrict__ u, const T* __restrict__ S,
                    C* __restrict__ f, int nx, int ny, int nz) {
  using St = Stencil<NDIM>;
  const int nodes = nx * ny * nz;
  const int n = blockIdx.x * kApplyNodes + threadIdx.x;
  const int c = threadIdx.y;
  if (n >= nodes) return;
  // node multi-index (i, j, k); in 2-D the axes are (j, k) and i = 0
  const int k = n % nz;
  const int j = (n / nz) % ny;
  const int i = n / (nz * ny);
  const T* Sc = S + static_cast<long long>(c * NDIM) * nodes + n;
  C acc = C(0);
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
      const C s = load_slot(Sc + static_cast<long long>(o * NDIM * NDIM + d) * nodes);
      const C v = __ldg(u + static_cast<long long>(m) * NDIM + d);
      acc = fma_t(s, inside ? v : C(0), acc);
    }
  }
  f[static_cast<long long>(n) * NDIM + c] = acc;
}

template <typename T, typename C>
int stencil_entry(const void* ke, void* S, int ndim, int ex, int ey, int ez,
                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const C* kp = static_cast<const C*>(ke);
  T* sp = static_cast<T*>(S);
  if (reinterpret_cast<unsigned long long>(ke) % 16 != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (ndim == 3) return launch_stencil<3, T, C>(kp, sp, ex, ey, ez, s);
  if (ndim == 2) return launch_stencil<2, T, C>(kp, sp, ex, ey, 1, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, typename C>
int apply_entry(const void* u, const void* S, void* f, int ndim, int ex, int ey,
                int ez, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const C* up = static_cast<const C*>(u);
  const T* sp = static_cast<const T*>(S);
  C* fp = static_cast<C*>(f);
  if (ndim == 3) {
    const int nodes = (ex + 1) * (ey + 1) * (ez + 1);
    const dim3 block(kApplyNodes, 3);
    cached_apply_kernel<3, T, C><<<(nodes + kApplyNodes - 1) / kApplyNodes, block, 0, s>>>(
        up, sp, fp, ex + 1, ey + 1, ez + 1);
  } else {
    const int nodes = (ex + 1) * (ey + 1);
    const dim3 block(kApplyNodes, 2);
    cached_apply_kernel<2, T, C><<<(nodes + kApplyNodes - 1) / kApplyNodes, block, 0, s>>>(
        up, sp, fp, 1, ex + 1, ey + 1);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ke: (ex, ey[, ez], d_pe, d_pe), fp32 (_f32, _bf16) or float64 (_f64),
// 16-B aligned; S: (3^N, N, N) + node dims, fp32 (_f32), bf16 (_bf16) or
// float64 (_f64), written in full. Returns a cudaError_t code.
extern "C" int ndr_cached_stencil_f32(const void* ke, void* S, int ndim, int ex,
                                      int ey, int ez, void* stream) {
  return stencil_entry<float, float>(ke, S, ndim, ex, ey, ez, stream);
}

extern "C" int ndr_cached_stencil_bf16(const void* ke, void* S, int ndim, int ex,
                                       int ey, int ez, void* stream) {
  return stencil_entry<unsigned short, float>(ke, S, ndim, ex, ey, ez, stream);
}

extern "C" int ndr_cached_stencil_f64(const void* ke, void* S, int ndim, int ex,
                                      int ey, int ez, void* stream) {
  return stencil_entry<double, double>(ke, S, ndim, ex, ey, ez, stream);
}

// u: node dims + (N,), fp32 (_f32, _bf16) or float64 (_f64); S: a stencil
// of the same grid from the assembly of the same storage type; f: like u,
// written in full. Returns a cudaError_t code.
extern "C" int ndr_apply_k_cached_f32(const void* u, const void* S, void* f,
                                      int ndim, int ex, int ey, int ez,
                                      void* stream) {
  return apply_entry<float, float>(u, S, f, ndim, ex, ey, ez, stream);
}

extern "C" int ndr_apply_k_cached_bf16(const void* u, const void* S, void* f,
                                       int ndim, int ex, int ey, int ez,
                                       void* stream) {
  return apply_entry<unsigned short, float>(u, S, f, ndim, ex, ey, ez, stream);
}

extern "C" int ndr_apply_k_cached_f64(const void* u, const void* S, void* f,
                                      int ndim, int ex, int ey, int ez,
                                      void* stream) {
  return apply_entry<double, double>(u, S, f, ndim, ex, ey, ez, stream);
}
