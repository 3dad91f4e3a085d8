// Fine-level fp32 stiffness apply  f = K(E) u  for degree-1 voxel grids:
// element-centric in the basis of the element's reflections, streamed along
// x with the element forces in shared memory.
//
// Replaces: ndr_tpu/fem/pallas_kernels.py apply_k_pallas_flat, the default
// "flat32" fine kernel of apply_k_pallas_fine (the fp32 apply of every CG
// iteration and level-0 smoothing step). It fuses the element gather, the
// K0 contraction, the SIMP scale and the scatter; its lane padding, rolls
// and VMEM carry are not carried over.
//
// Bound on Hopper. With the dense K0, operations: 2^N N (2^N N) = 576 FMAs
// per element in 3-D against ~28 B of u, young and f per node, so 1.77M
// elements at 192x96x96 need 2.1 GFLOP (31 us at 67 TFLOP/s fp32) but 51 MB
// (15 us at 3.35 TB/s). Issued as such (one thread per node, each K0
// coefficient a uniform-register load feeding one or two FMAs, 81 or more u
// loads per node) the contraction stays near a quarter of the FP32 rate.
// With the design below, ~0.5 GFLOP: bytes.
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
// 576. The wrapper builds B from K0 once per K0 tensor
// (kernels.reflection_blocks); it checks that K0's other coefficients vanish
// (they do, to rounding, for every element this package builds) and refuses
// a K0 whose do not.
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

constexpr int kMaxThreads = 192;  // 128 and 256: 1-3% slower on 193x97x97 or 65x33x17
constexpr int kMaxTZ = 15;  // nodes per z line of a column

// Node-plane force buffers: the node sums of plane e read one buffer after
// the step's barrier while the next step writes the other; the step after
// that rewrites the first only past the next barrier, which every thread
// reaches after its sums.
constexpr int kBuffers = 2;

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
template <int NDIM>
__global__ void __launch_bounds__(kMaxThreads)
apply_k_fine_stream_kernel(const float* __restrict__ u,
                           const float* __restrict__ young, float* __restrict__ f,
                           int NX, int NY, int NZ, int TY, int TZ, int tiles_y,
                           int tiles_z, int chunk) {
  using E = Elem<NDIM>;
  constexpr int N = E::N, HX = E::HX, NPE = E::NPE, SLOTS = E::SLOTS;
  extern __shared__ float fe[];  // kBuffers x SLOTS x NE, element column fastest
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
  const float* up = u + (static_cast<long long>(x0 - HX) * NY * NZ +
                         static_cast<long long>(gey) * NZ + gez) * N;
  const float* yp = young + (static_cast<long long>(x0 - HX) * EY + gey) * EZ + gez;
  const long long plane_elems = static_cast<long long>(EY) * EZ;
  const int node_col = (ty + 1) * YZ + tz + 1;  // element column (gy, gz)

  // the element's lower node plane of u, transformed over the plane, and
  // the forces the previous element left on it (3-D)
  float lo[4][N], carry[4][N];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      lo[b][d] = 0.0f;
      carry[b][d] = 0.0f;
    }
  }
  if (HX && elem_yz_in && x0 - HX >= 0) {
    load_plane<N>(lo, up, sy, true);
    wht<N>(lo, 3);
  }

  int fb = 0;  // force buffer of node plane e
  for (int e = x0 - HX; e < x1; ++e, up += sx, yp += plane_elems) {
    if (elem_thread) {
      // the element's upper node plane (in 2-D its only one), e + HX
      const bool plane_in = elem_yz_in && e + HX < NX;
      float hi[4][N];
      load_plane<N>(hi, up + HX * sx, sy, plane_in);
      wht<N>(hi, 3);
      float out[4][N];  // forces on node plane e
      if (plane_in && e >= 0 && e < EX) {  // element (e, gey, gez)
        float w[NPE][N];
        element_forces<N>(lo, hi, w);
        const float y = __ldg(yp);
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int c = 0; c < N; ++c) {
            out[b][c] = fmaf(y, w[b][c], carry[b][c]);
            if (HX) carry[b][c] = y * w[b + 4 * HX][c];
          }
        }
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
#pragma unroll
          for (int c = 0; c < N; ++c) {
            out[b][c] = carry[b][c];
            carry[b][c] = 0.0f;
          }
        }
      }
      float* o = fe + fb * SLOTS * NE + t;
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
      const float* in = fe + fb * SLOTS * NE + node_col;
      float acc[N];
#pragma unroll
      for (int c = 0; c < N; ++c) acc[c] = 0.0f;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        // the element column (gy, gz) - bits(a), where the node is local node a
        const int col = -((a >> 1) & 1) * YZ - (a & 1);
#pragma unroll
        for (int c = 0; c < N; ++c) acc[c] += in[(a * N + c) * NE + col];
      }
      float* out = f + ((static_cast<long long>(e) * NY + gy) * NZ + gz) * N;
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

template <int NDIM>
int launch(const float* u, const float* young, float* f, int NX, int NY, int NZ,
           cudaStream_t s) {
  using E = Elem<NDIM>;
  const int TZ = even_split(NZ, kMaxTZ);
  const int TY = even_split(NY, kMaxThreads / (TZ + 1) - 1);
  const int tiles_y = (NY + TY - 1) / TY;
  const int tiles_z = (NZ + TZ - 1) / TZ;
  const int columns = tiles_y * tiles_z;
  const int NE = (TY + 1) * (TZ + 1);
  const int threads = NE;  // one per element; NE > TY TZ, one per node too
  const size_t smem = sizeof(float) * kBuffers * NE * E::SLOTS;
  // set up once per shared-memory size: the size limit, and the card's
  // resident block slots for this configuration
  static size_t set_smem = 0;
  static long long slots = 0;
  if (smem != set_smem) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(apply_k_fine_stream_kernel<NDIM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, apply_k_fine_stream_kernel<NDIM>, threads, smem);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    set_smem = smem;
    slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  }
  // the chunk (x node planes per block) whose blocks take the fewest
  // waves x steps
  int chunk = NX;
  long long best = -1;
  for (int c = 1; c <= NX; ++c) {
    const long long blocks = static_cast<long long>(columns) * ((NX + c - 1) / c);
    const long long cost = (blocks + slots - 1) / slots * (c + E::HX);  // steps
    if (best < 0 || cost < best) {
      best = cost;
      chunk = c;
    }
  }
  const unsigned int blocks =
      static_cast<unsigned int>(columns) * ((NX + chunk - 1) / chunk);
  apply_k_fine_stream_kernel<NDIM><<<blocks, threads, smem, s>>>(
      u, young, f, NX, NY, NZ, TY, TZ, tiles_y, tiles_z, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// B: the 2^N reflection-basis blocks of K0 (kernels.reflection_blocks),
// 2^N N^2 fp32 on the device, copied on the stream into the constant memory
// of both fp32 fine kernels (this one and apply_k_fine_elem_f32.cu's).
// Returns a cudaError_t code.
extern "C" int ndr_fine_set_blocks(const void* B, int ndim, void* stream) {
  const int err = set_blocks(B, ndim, stream);
  return err ? err : fine_elem_set_blocks(B, ndim, stream);
}

// u: nodes + (N,) fp32; young: dims fp32; f: nodes + (N,) fp32, written in
// full. The blocks must have been set by ndr_fine_set_blocks for this ndim.
// Returns a cudaError_t code.
extern "C" int ndr_apply_k_fine_f32(const void* u, const void* young, void* f,
                                    int ndim, int ex, int ey, int ez, void* stream) {
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const float* up = static_cast<const float*>(u);
  const float* yp = static_cast<const float*>(young);
  float* fp = static_cast<float*>(f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3) return launch<3>(up, yp, fp, ex + 1, ey + 1, ez + 1, s);
  return launch<2>(up, yp, fp, 1, ex + 1, ey + 1, s);
}
