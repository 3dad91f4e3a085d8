// Fine-level stiffness apply  f = K(E) u  for degree-1 voxel grids, in fp32
// and in float64: element-centric in the basis of the element's
// reflections, streamed along x with the element forces in shared memory.
//
// Replaces, in ndr_tpu/fem/pallas_kernels.py:
// - apply_k_pallas_flat (fp32), the default "flat32" fine kernel of
//   apply_k_pallas_fine: the fp32 apply of every CG iteration and level-0
//   smoothing step. It fuses the element gather, the K0 contraction, the
//   SIMP scale and the scatter; its lane padding, rolls and VMEM carry are
//   not carried over.
// - apply_k_pallas_df (float64), the refinement's true residual r = f - K u
//   under "flat32" and "variant" (apply_k_pallas_df_fine). The TPU has no
//   FP64, so that kernel builds an apply accurate to ~1e-11 from fp32
//   hi/lo pairs with bitmask splits and TwoSum. Hopper has native FP64:
//   this is the same design as the fp32 apply, instantiated for double (u,
//   young, f and the blocks in float64), with no split, no error-free
//   transforms and no accuracy floor.
//
// Bound on Hopper. With the dense K0, operations: 2^N N (2^N N) = 576 FMAs
// per element in 3-D against ~28 B (fp32) or ~56 B (float64) of u, young
// and f per node, so 1.77M elements at 192x96x96 need 2.1 GFLOP (31 us at
// 67 TFLOP/s fp32, 61 us at 34 TFLOP/s on the FP64 cores) but 51 / 101 MB
// (15 / 30 us at 3.35 TB/s). Issued as such (one thread per node, each K0
// coefficient a uniform-register load feeding one or two FMAs, 81 or more u
// loads per node) the contraction stays near a quarter of the FP32 rate.
// With the design below, ~0.55 GFLOP: bytes, in both types.
//
// Design. The stiffness of a box element of an isotropic material is
// invariant under reflecting the element along each axis (which swaps its
// node planes and flips one displacement component). In the basis of those
// reflections' characters K0 is block diagonal: with the Walsh-Hadamard
// transform over the 2^N element nodes applied to each component,
// u^[t, d] = sum_b (-1)^popcount(t & b) u[b, d], the transformed K0 couples
// (t, c) with (t', d) only where t ^ e_c = t' ^ e_d (e_c: the offset bit of
// axis c), which makes 2^N blocks B_s of N x N. So
//
//   K0 u_e = 2^-N W^T (B (W u_e)):
//
// two transforms of 2 N 2^N N adds and 2^N N^2 FMAs (72 in 3-D) in place of
// 576. The transforms are exact up to rounding and the 2^-N in the blocks is
// exact. The wrapper builds B in the kernel's type from the float64 K0 once
// per K0 tensor (kernels.reflection_blocks); it checks that K0's other
// coefficients vanish to that type's bound (they do, to rounding, for
// every element this package builds) and refuses a K0 whose do not.
//
// A block owns a TY x TZ column of nodes (z fastest, so the lanes of a warp
// take neighbouring z) and walks a chunk of its x planes, one element plane
// per step. One thread per element column of the (TY + 1) x (TZ + 1) plane
// around the node column walks along x with two things in registers: the u
// of its element's lower node plane, read (through L1) and transformed over
// the plane at the previous step, and the forces its previous element left
// for that plane. So each step reads one node plane of u (2^(N-1) N values,
// not 2^N N) and writes one node plane of forces, scaled by young and summed
// with the carried ones, to shared memory: 2^(N-1) N values in place of
// 2^N N. An element outside the grid computes nothing and reads nothing, so
// no load needs a bounds test. After one barrier, one thread per node of
// the completed node plane sums the forces of its <= 2^(N-1) element columns
// in the fixed order of the local node a and writes f. Two force buffers
// alternate, so that barrier is the only one per step. No atomics,
// deterministic. Elements on a column's edge are computed by both columns
// they touch ((TY + 1)(TZ + 1) / (TY TZ), ~1.17 at 192x96x96). The launcher
// picks TY x TZ so that node dims that are not a multiple of the tile
// (193x97x97, 65x33x17) waste few threads, and the chunk length so that the
// blocks fill the card's SMs in whole waves. 2-D grids run as one plane with
// an inactive x axis.
#include "reflection.cuh"

namespace {

// Block size and tile per type, each from its own ptxas line: a double
// carries twice a float's registers and shared memory. The double kernel
// takes 156 registers at 192 threads (2 blocks of 6 warps per SM, no
// spill); at 128 or 256 threads ptxas holds it to 128 registers and spills.
template <typename T>
struct Tune;
template <>
struct Tune<float> {
  static constexpr int kMaxThreads = 192;  // 128 and 256: 1-3% slower on 193x97x97 or 65x33x17
  static constexpr int kMaxTZ = 15;        // nodes per z line of a column
};
template <>
struct Tune<double> {
  static constexpr int kMaxThreads = 192;
  static constexpr int kMaxTZ = 15;
};

// Node-plane force buffers: the node sums of plane e read one buffer after
// the step's barrier while the next step writes the other; the step after
// that rewrites the first only past the next barrier, which every thread
// reaches after its sums.
constexpr int kBuffers = 2;
constexpr int kMaxDevices = 64;  // the launcher's per-device set-up

template <int NDIM>
struct Elem {
  static constexpr int N = NDIM;
  static constexpr int HX = NDIM == 3 ? 1 : 0;  // node planes past an element plane
  static constexpr int NPE = 1 << NDIM;
  static constexpr int SLOTS = 4 * NDIM;  // forces per element column and node plane
};

// Node dims (NX, NY, NZ), in 2-D NX = 1; node column TY x TZ; `chunk` node
// planes per block. Element columns of the tile: (TY + 1) x (TZ + 1), from
// (y0 - 1, z0 - 1). Local node b = (x bit, y bit, z bit), the x bit
// highest; a node plane's four are b mod 4.
template <typename T, int NDIM>
__global__ void __launch_bounds__(Tune<T>::kMaxThreads)
apply_k_fine_stream_kernel(const T* __restrict__ u, const T* __restrict__ young,
                           T* __restrict__ f, int NX, int NY, int NZ, int TY, int TZ,
                           int tiles_y, int tiles_z, int chunk) {
  using E = Elem<NDIM>;
  constexpr int N = E::N, HX = E::HX, NPE = E::NPE, SLOTS = E::SLOTS;
  // kBuffers x SLOTS x NE, element column fastest
  extern __shared__ __align__(16) unsigned char smem[];
  T* const fe = reinterpret_cast<T*>(smem);
  const int YZ = TZ + 1;
  const int NE = (TY + 1) * YZ;
  const int EX = NX - HX, EY = NY - 1, EZ = NZ - 1;

  const int bz = blockIdx.x % tiles_z;
  const int by = (blockIdx.x / tiles_z) % tiles_y;
  const int bc = blockIdx.x / (tiles_z * tiles_y);
  const int y0 = by * TY, z0 = bz * TZ;
  const int x0 = bc * chunk;
  const int x1 = min(NX, x0 + chunk);

  const int t = threadIdx.x;
  // this thread's element column (t < NE) and node column (t < TY TZ)
  const int gey = y0 - 1 + t / YZ, gez = z0 - 1 + t % YZ;
  const int ty = t / TZ, tz = t % TZ;
  const int gy = y0 + ty, gz = z0 + tz;
  const bool elem_thread = t < NE;
  const bool owner = t < TY * TZ && gy < NY && gz < NZ;
  // an element inside the grid has all its nodes inside: only those are
  // read, so no load needs a bounds test
  const bool elem_yz_in = gey >= 0 && gey < EY && gez >= 0 && gez < EZ;
  const long long sx = static_cast<long long>(NY) * NZ * N, sy = static_cast<long long>(NZ) * N;
  // node (x0 - HX, gey, gez) and element (x0 - HX, gey, gez), stepped by a plane
  const T* up = u + (static_cast<long long>(x0 - HX) * NY * NZ +
                     static_cast<long long>(gey) * NZ + gez) * N;
  const T* yp = young + (static_cast<long long>(x0 - HX) * EY + gey) * EZ + gez;
  const long long plane_elems = static_cast<long long>(EY) * EZ;
  const int node_col = (ty + 1) * YZ + tz + 1;  // element column (gy, gz)

  // the element's lower node plane of u, transformed over the plane, and
  // the forces the previous element left on it (3-D)
  T lo[4][N], carry[4][N];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      lo[b][d] = T(0);
      carry[b][d] = T(0);
    }
  }
  if (HX && elem_yz_in && x0 - HX >= 0) {
    load_plane<T, N>(lo, up, sy, true);
    wht<T, N>(lo, 3);
  }

  int fb = 0;  // force buffer of node plane e
  for (int e = x0 - HX; e < x1; ++e, up += sx, yp += plane_elems) {
    if (elem_thread) {
      // the element's upper node plane (in 2-D its only one), e + HX
      const bool plane_in = elem_yz_in && e + HX < NX;
      T hi[4][N];
      load_plane<T, N>(hi, up + HX * sx, sy, plane_in);
      wht<T, N>(hi, 3);
      T out[4][N];  // forces on node plane e
      if (plane_in && e >= 0 && e < EX) {  // element (e, gey, gez)
        T w[NPE][N];
        element_forces<T, N>(lo, hi, w);
        const T y = __ldg(yp);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int c = 0; c < N; ++c) {
            out[b][c] = fma_t(y, w[b][c], carry[b][c]);
            if (HX) carry[b][c] = y * w[b + 4 * HX][c];
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int c = 0; c < N; ++c) {
            out[b][c] = carry[b][c];
            carry[b][c] = T(0);
          }
        }
      }
      T* o = fe + fb * SLOTS * NE + t;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          o[(b * N + c) * NE] = out[b][c];
          if (HX) lo[b][c] = hi[b][c];
        }
      }
    }
    __syncthreads();

    if (e >= x0 && owner) {  // node plane e is complete: sum its columns' forces
      const T* in = fe + fb * SLOTS * NE + node_col;
      T acc[N];
#pragma unroll
      for (int c = 0; c < N; ++c) acc[c] = T(0);
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // the element column (gy, gz) - bits(a), where the node is local node a
        const int col = -((a >> 1) & 1) * YZ - (a & 1);
#pragma unroll
        for (int c = 0; c < N; ++c) acc[c] += in[(a * N + c) * NE + col];
      }
      T* out = f + ((static_cast<long long>(e) * NY + gy) * NZ + gz) * N;
#pragma unroll
      for (int c = 0; c < N; ++c) out[c] = acc[c];
    }
    fb ^= 1;
  }
}

// Largest tile extent <= cap that splits n into equal-as-possible parts.
int even_split(int n, int cap) {
  const int parts = (n + cap - 1) / cap;
  return (n + parts - 1) / parts;
}

template <typename T, int NDIM>
int launch(const T* u, const T* young, T* f, int NX, int NY, int NZ, cudaStream_t s) {
  using E = Elem<NDIM>;
  const int TZ = even_split(NZ, Tune<T>::kMaxTZ);
  const int TY = even_split(NY, Tune<T>::kMaxThreads / (TZ + 1) - 1);
  const int tiles_y = (NY + TY - 1) / TY;
  const int tiles_z = (NZ + TZ - 1) / TZ;
  const int columns = tiles_y * tiles_z;
  const int NE = (TY + 1) * (TZ + 1);
  const int threads = NE;  // one per element; NE > TY TZ, one per node too
  const size_t smem = sizeof(T) * kBuffers * NE * E::SLOTS;
  // set up once per device and shared-memory size: the size limit, and the
  // card's resident block slots for this configuration
  static size_t set_smem[kMaxDevices] = {};
  static long long slots[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem != set_smem[dev]) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(apply_k_fine_stream_kernel<T, NDIM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, apply_k_fine_stream_kernel<T, NDIM>, threads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    set_smem[dev] = smem;
    slots[dev] = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  // the chunk (x node planes per block) whose blocks take the fewest
  // waves x steps
  int chunk = NX;
  long long best = -1;
  for (int c = 1; c <= NX; ++c) {
    const long long blocks = static_cast<long long>(columns) * ((NX + c - 1) / c);
    const long long cost = (blocks + slots[dev] - 1) / slots[dev] * (c + E::HX);  // steps
    if (best < 0 || cost < best) {
      best = cost;
      chunk = c;
    }
  }
  const unsigned int blocks =
      static_cast<unsigned int>(columns) * ((NX + chunk - 1) / chunk);
  apply_k_fine_stream_kernel<T, NDIM><<<blocks, threads, smem, s>>>(
      u, young, f, NX, NY, NZ, TY, TZ, tiles_y, tiles_z, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int apply(const void* u, const void* young, void* f, int ndim, int ex, int ey, int ez,
          void* stream) {
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const T* up = static_cast<const T*>(u);
  const T* yp = static_cast<const T*>(young);
  T* fp = static_cast<T*>(f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3) return launch<T, 3>(up, yp, fp, ex + 1, ey + 1, ez + 1, s);
  return launch<T, 2>(up, yp, fp, 1, ex + 1, ey + 1, s);
}

template <typename T>
int set_both(const void* B, int ndim, void* stream) {
  const int err = set_blocks<T>(B, ndim, stream);
  return err ? err : fine_elem_set_blocks<T>(B, ndim, stream);
}

}  // namespace

// B: the 2^N reflection-basis blocks of K0 (kernels.reflection_blocks),
// 2^N N^2 values on the device, fp32 (ndr_fine_set_blocks_f32) or float64
// (ndr_fine_set_blocks_f64), copied on the stream into the constant memory
// of that type in both fine kernels (this one and fine_elem.cu's). Returns
// a cudaError_t code.
extern "C" int ndr_fine_set_blocks_f32(const void* B, int ndim, void* stream) {
  return set_both<float>(B, ndim, stream);
}

extern "C" int ndr_fine_set_blocks_f64(const void* B, int ndim, void* stream) {
  return set_both<double>(B, ndim, stream);
}

// u: nodes + (N,); young: dims; f: nodes + (N,), written in full; all fp32
// (ndr_apply_k_fine_f32) or all float64 (ndr_apply_k_fine_f64). The blocks
// of that type must have been set for this ndim. Returns a cudaError_t code.
extern "C" int ndr_apply_k_fine_f32(const void* u, const void* young, void* f, int ndim,
                                    int ex, int ey, int ez, void* stream) {
  return apply<float>(u, young, f, ndim, ex, ey, ez, stream);
}

extern "C" int ndr_apply_k_fine_f64(const void* u, const void* young, void* f, int ndim,
                                    int ex, int ey, int ez, void* stream) {
  return apply<double>(u, young, f, ndim, ex, ey, ez, stream);
}

// Message for a code returned by any ndr_* function.
extern "C" const char* ndr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
