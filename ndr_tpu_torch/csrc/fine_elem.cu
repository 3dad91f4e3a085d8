// Element-centric fine-level stiffness apply  f = K(E) u  for degree-1
// voxel grids, in fp32 and in float64, in the element's reflection basis,
// with partial forces only on the faces of its blocks.
//
// Replaces, in ndr_tpu/fem/pallas_kernels.py:
// - apply_k_pallas (fp32), the "variant" fine kernel of apply_k_pallas_fine
//   (body _kernel_body, stitch _stitch_partials);
// - apply_k_pallas_df_flat (float64), the "flat" float64 residual of
//   apply_k_pallas_df_fine, built on the TPU from fp32 hi/lo pairs because
//   the TPU has no FP64. Hopper has FP64: the same design as the fp32 apply,
//   instantiated for double (u, young, f, the blocks and the partials in
//   float64), no split.
// Kept from them: each element's contraction is done once, by one thread,
// with no edge element computed twice, and the partial forces of nodes that
// several blocks touch are stitched afterwards, in a fixed order, without
// atomics. Their VMEM slabs, lane padding and pre-sliced u variants are not
// carried over.
//
// Bound on Hopper: bytes. In the reflection basis (fine_stream.cu's head
// note: two Walsh-Hadamard transforms and 2^N N^2 = 72 FMAs per element in
// place of 576) 1.77M elements at 192x96x96 need ~0.55 GFLOP (8 us at 67
// TFLOP/s fp32, 16 us at 34 TFLOP/s on the FP64 cores) against 50.7 / 101.3
// MB of u, young and f (15 / 30 us at 3.35 TB/s) plus the face partials,
// written once and read once (~11 MB each way in fp32 at 192x96x96, with
// 7-element slabs of 14 x 16 element tiles). Carried over as the TPU kernels
// do it, the dense 576-FMA contraction is instruction-bound (each
// coefficient a uniform constant load), and one partial plane per (slab
// plane, trailing offset, component) is ~4.5x the f field, written and read
// back by a second pass.
//
// Design. A block owns TY x TZ element columns (z fastest) of one x-slab of
// SX elements; the launcher splits y and z into near-equal tiles of at most
// Tune<T>::kMaxThreads threads and picks SX (the TPU kernel's default is 8)
// so that the blocks fill the card's SMs in whole waves. One thread per
// element column walks the slab along x as fine_stream.cu's threads do: it
// carries in registers the u of its element's lower node plane, transformed
// over the plane, and the forces its previous element left on that plane,
// so each step reads one node plane of u and writes one node plane of
// forces (4 N values) into a shared-memory buffer of the tile's element
// columns, padded by one zero column on every side. After one barrier, one
// thread per node of the tile's (TY + 1) x (TZ + 1) node plane sums its <= 4
// element columns' forces in the fixed order of the local node a. A node
// whose every element lies in this block is written straight to f. A node
// on a block boundary inside the grid (a slab's first or last node plane,
// a tile's y or z face) gets forces from 2, 4 or 8 blocks: each block
// writes its sum into its own slot of the partials buffer (one slot per
// node of the block's shell), and the second pass (stitch_faces), one
// thread per such node, sums the slots of its blocks in a fixed order
// (lower block first along x, then y, then z) and writes f.
// The blocks' K0 contraction uses the reflection blocks of its type in this
// source's constant memory, uploaded once per K0 tensor by the wrapper
// (ndr_fine_set_blocks_f32 / _f64), not per launch. 2-D grids run as one
// node plane with an inactive x axis.
#include "reflection.cuh"

namespace {

// Node-plane force buffers, alternating as in fine_stream.cu: the node sums
// of plane p read one after the step's barrier while the next step writes
// the other.
constexpr int kBuffers = 2;
constexpr int kMaxSlab = 16;  // elements per slab

// Block size and tile per type, each from its own ptxas line: a double
// carries twice a float's registers and shared memory. The double kernel
// takes 128 registers at 256 threads (2 blocks of 8 warps per SM, no
// spill); at 128 threads ptxas holds it to 128 registers and spills, and at
// 192 (147 registers) it runs slower at 192x96x96.
template <typename T>
struct Tune;
template <>
struct Tune<float> {
  static constexpr int kMaxThreads = 256;  // (TY + 1)(TZ + 1)
  static constexpr int kMaxTZ = 16;        // elements per z line of a tile
};
template <>
struct Tune<double> {
  static constexpr int kMaxThreads = 256;
  static constexpr int kMaxTZ = 16;
};

// Block geometry, the same in both passes. Element counts (EX, EY, EZ):
// in 2-D EX = 1 and the grid's axes are y, z.
struct Geo {
  int EX, EY, EZ;
  int SX, TY, TZ;  // elements per block along x, y, z
  int tiles_y, tiles_z, nslabs;
  int SH;          // shell nodes per block: partials slots
};

// Node coordinate x lies on a block boundary inside the grid, so two
// blocks along that axis touch it.
__device__ __forceinline__ bool shared_coord(int x, int S, int E) {
  return x % S == 0 && x > 0 && x < E;
}

// Slot of shell node (lx, ly, lz) of a block with LX x LY x LZ elements:
// its two x faces in full, then the two y faces without their x edges,
// then the two z faces without their x and y edges; the strides are those
// of a full block.
template <int NDIM>
__device__ __forceinline__ int shell_index(int lx, int ly, int lz, int LX, int LY,
                                           int LZ, const Geo& g) {
  const int PZ = g.TZ + 1;
  if (NDIM == 3) {
    const int PY = g.TY + 1;
    if (lx == 0 || lx == LX) return ((lx != 0) * PY + ly) * PZ + lz;
    const int xf = 2 * PY * PZ;
    if (ly == 0 || ly == LY) return xf + ((ly != 0) * (g.SX - 1) + lx - 1) * PZ + lz;
    return xf + 2 * (g.SX - 1) * PZ + ((lz != 0) * (g.SX - 1) + lx - 1) * (g.TY - 1) +
           ly - 1;
  }
  if (ly == 0 || ly == LY) return (ly != 0) * PZ + lz;
  return 2 * PZ + (lz != 0) * (g.TY - 1) + ly - 1;
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(Tune<T>::kMaxThreads)
elem_blocks_kernel(const T* __restrict__ u, const T* __restrict__ young,
                   T* __restrict__ part, T* __restrict__ f, Geo g) {
  constexpr int N = NDIM, HX = NDIM == 3 ? 1 : 0, NPE = 1 << N, SLOTS = 4 * N;
  // kBuffers x SLOTS x PC, padded element column fastest
  extern __shared__ __align__(16) unsigned char smem[];
  T* const fe = reinterpret_cast<T*>(smem);
  const int PZc = g.TZ + 2;
  const int PC = (g.TY + 2) * PZc;
  const int NY = g.EY + 1, NZ = g.EZ + 1;

  const int bz = blockIdx.x % g.tiles_z;
  const int by = (blockIdx.x / g.tiles_z) % g.tiles_y;
  const int bs = blockIdx.x / (g.tiles_z * g.tiles_y);
  const int x0 = bs * g.SX, y0 = by * g.TY, z0 = bz * g.TZ;
  const int LX = min(g.SX, g.EX - x0), LY = min(g.TY, g.EY - y0), LZ = min(g.TZ, g.EZ - z0);

  const int t = threadIdx.x;
  // this thread's element column (t < TY TZ) and node (t < (TY + 1)(TZ + 1))
  const int ey = t / g.TZ, ez = t % g.TZ;
  const bool elem_in = t < g.TY * g.TZ && ey < LY && ez < LZ;
  const int ly = t / (g.TZ + 1), lz = t % (g.TZ + 1);
  const bool node_in = ly <= LY && lz <= LZ;
  const int gy = y0 + ly, gz = z0 + lz;
  const bool shared_yz = shared_coord(gy, g.TY, g.EY) || shared_coord(gz, g.TZ, g.EZ);

  // zero both buffers: the padding, and the columns outside the grid, stay 0
  for (int q = t; q < kBuffers * SLOTS * PC; q += blockDim.x) fe[q] = T(0);

  const long long sx = static_cast<long long>(NY) * NZ * N, sy = static_cast<long long>(NZ) * N;
  // node (x0, y0 + ey, z0 + ez) and element (x0, y0 + ey, z0 + ez), stepped by a plane
  const T* up = u + (static_cast<long long>(x0) * NY * NZ +
                     static_cast<long long>(y0 + ey) * NZ + z0 + ez) * N;
  const T* yp = young + (static_cast<long long>(x0) * g.EY + y0 + ey) * g.EZ + z0 + ez;
  const long long plane_elems = static_cast<long long>(g.EY) * g.EZ;
  T* const own = fe + (ey + 1) * PZc + ez + 1;  // this column's forces, buffer 0

  T lo[4][N], carry[4][N];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      lo[b][d] = T(0);
      carry[b][d] = T(0);
    }
  }
  if (HX && elem_in) {
    load_plane<T, N>(lo, up, sy, true);
    wht<T, N>(lo, 3);
  }
  __syncthreads();

  // sums the forces on node plane x0 + lx from buffer fb; writes f or the
  // node's partials slot
  auto node_sums = [&](int lx, int fb) {
    if (!node_in) return;
    const T* in = fe + fb * SLOTS * PC + (ly + 1) * PZc + lz + 1;
    T acc[N];
#pragma unroll
    for (int c = 0; c < N; ++c) acc[c] = T(0);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      // the element column (ly, lz) - bits(a), where the node is local node a
      const int col = -((a >> 1) & 1) * PZc - (a & 1);
#pragma unroll
      for (int c = 0; c < N; ++c) acc[c] += in[(a * N + c) * PC + col];
    }
    const int gx = x0 + lx;
    T* out;
    if (shared_yz || (HX && shared_coord(gx, g.SX, g.EX))) {
      out = part + (static_cast<long long>(blockIdx.x) * g.SH +
                    shell_index<NDIM>(lx, ly, lz, LX, LY, LZ, g)) * N;
    } else {
      out = f + ((static_cast<long long>(gx) * NY + gy) * NZ + gz) * N;
    }
#pragma unroll
    for (int c = 0; c < N; ++c) out[c] = acc[c];
  };

  int fb = 0;  // force buffer of node plane x0 + lx
  for (int lx = 0; lx < LX; ++lx, up += sx, yp += plane_elems) {
    if (elem_in) {  // element (x0 + lx, y0 + ey, z0 + ez)
      T hi[4][N];  // its upper node plane (in 2-D its only one)
      load_plane<T, N>(hi, up + HX * sx, sy, true);
      wht<T, N>(hi, 3);
      T w[NPE][N];
      element_forces<T, N>(lo, hi, w);
      const T y = __ldg(yp);
      T* o = own + fb * SLOTS * PC;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < N; ++c) {
          o[(b * N + c) * PC] = fma_t(y, w[b][c], carry[b][c]);
          if (HX) {
            carry[b][c] = y * w[b + 4 * HX][c];
            lo[b][c] = hi[b][c];
          }
        }
      }
    }
    __syncthreads();
    node_sums(lx, fb);
    fb ^= 1;
  }
  if (HX) {  // the slab's last node plane: the last element's carried forces
    if (elem_in) {
      T* o = own + fb * SLOTS * PC;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
#pragma unroll
        for (int c = 0; c < N; ++c) o[(b * N + c) * PC] = carry[b][c];
      }
    }
    __syncthreads();
    node_sums(LX, fb);
  }
}

// The first block (and the node's coordinate in it) along one axis of a
// node at coordinate x; `two`: a second block follows, in which the node
// is at coordinate 0.
struct AxisBlocks {
  int b, l;
  bool two;
};

__device__ __forceinline__ AxisBlocks axis_blocks(int x, int S, int E, int nblocks) {
  if (shared_coord(x, S, E)) return {x / S - 1, S, true};
  const int b = min(x / S, nblocks - 1);
  return {b, x - b * S, false};
}

// One thread per node on a block boundary inside the grid: first the
// nodes of the shared x planes (x = s SX, 0 < s < nslabs), then, plane by
// plane, the nodes of the other planes on a shared y line, then those on a
// shared z line and no shared y line. Each issues the loads of its <= 2^N
// blocks' slots together, sums them in a fixed order (lower block first
// along x, then y, then z) and writes f. 32-bit index arithmetic: the
// launcher refuses grids whose node count does not fit.
template <typename T, int NDIM>
__global__ void __launch_bounds__(256)
stitch_faces(const T* __restrict__ part, T* __restrict__ f, Geo g, int x_nodes,
             int plane_nodes, int total) {
  constexpr int N = NDIM;
  const int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= total) return;
  const int NY = g.EY + 1, NZ = g.EZ + 1;
  int x, y, z;
  if (q < x_nodes) {
    const int r = q % (NY * NZ);
    x = (q / (NY * NZ) + 1) * g.SX;
    y = r / NZ;
    z = r % NZ;
  } else {
    x = (q - x_nodes) / plane_nodes;
    if (NDIM == 3 && shared_coord(x, g.SX, g.EX)) return;  // stitched above
    const int r = (q - x_nodes) - x * plane_nodes;
    const int y_nodes = (g.tiles_y - 1) * NZ;
    if (r < y_nodes) {
      y = (r / NZ + 1) * g.TY;
      z = r % NZ;
    } else {
      y = (r - y_nodes) / (g.tiles_z - 1);
      z = ((r - y_nodes) % (g.tiles_z - 1) + 1) * g.TZ;
      if (shared_coord(y, g.TY, g.EY)) return;  // on a shared y line
    }
  }
  const AxisBlocks ax = axis_blocks(x, g.SX, g.EX, g.nslabs);
  const AxisBlocks ay = axis_blocks(y, g.TY, g.EY, g.tiles_y);
  const AxisBlocks az = axis_blocks(z, g.TZ, g.EZ, g.tiles_z);
  T v[8][N];
#pragma unroll
  for (int k = 0; k < 8; ++k) {  // block (ax.b + ix, ay.b + iy, az.b + iz)
    const int ix = k >> 2, iy = (k >> 1) & 1, iz = k & 1;
    const bool on = ix <= ax.two && iy <= ay.two && iz <= az.two;
    const int bx = ax.b + ix, by = ay.b + iy, bz = az.b + iz;
    const int slot = shell_index<NDIM>(
        ix ? 0 : ax.l, iy ? 0 : ay.l, iz ? 0 : az.l, min(g.SX, g.EX - bx * g.SX),
        min(g.TY, g.EY - by * g.TY), min(g.TZ, g.EZ - bz * g.TZ), g);
    const T* p =
        part + ((static_cast<long long>(bx * g.tiles_y + by) * g.tiles_z + bz) * g.SH + slot) * N;
#pragma unroll
    for (int c = 0; c < N; ++c) v[k][c] = on ? __ldg(p + c) : T(0);
  }
  T* out = f + (static_cast<long long>(x * NY + y) * NZ + z) * N;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    T acc = T(0);
#pragma unroll
    for (int k = 0; k < 8; ++k) acc += v[k][c];
    out[c] = acc;
  }
}

// Shell nodes per block of SX x TY x TZ elements (2-D: TY x TZ).
int shell_size(int ndim, int sx, int ty, int tz) {
  if (ndim == 3) return 2 * (ty + 1) * (tz + 1) + 2 * (sx - 1) * (tz + 1) + 2 * (sx - 1) * (ty - 1);
  return 2 * (tz + 1) + 2 * (ty - 1);
}

// Largest tile extent <= cap that splits n into equal-as-possible parts.
int even_split(int n, int cap) {
  const int parts = (n + cap - 1) / cap;
  return (n + parts - 1) / parts;
}

template <typename T, int NDIM>
size_t smem_bytes(const Geo& g) {
  return sizeof(T) * kBuffers * 4 * NDIM * (g.TY + 2) * (g.TZ + 2);
}

// Lets elem_blocks_kernel<T, NDIM> take g's shared memory on the current
// device (above 48 KB only after this; cheap, so done on every use).
template <typename T, int NDIM>
cudaError_t allow_smem(const Geo& g) {
  return cudaFuncSetAttribute(elem_blocks_kernel<T, NDIM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem_bytes<T, NDIM>(g)));
}

// The block geometry of a grid: TZ <= kMaxTZ and TY as even splits, and in
// 3-D the slab whose blocks take the fewest waves x steps on the current
// card (queried on every call; the wrapper caches the result per device).
template <typename T, int NDIM>
int pick_geometry(Geo& g) {
  g.TZ = even_split(g.EZ, Tune<T>::kMaxTZ);
  g.TY = even_split(g.EY, Tune<T>::kMaxThreads / (g.TZ + 1) - 1);
  g.tiles_y = (g.EY + g.TY - 1) / g.TY;
  g.tiles_z = (g.EZ + g.TZ - 1) / g.TZ;
  g.SX = 1;
  if (NDIM == 3) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = allow_smem<T, NDIM>(g);
    if (err == cudaSuccess) err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, elem_blocks_kernel<T, NDIM>, (g.TY + 1) * (g.TZ + 1),
          smem_bytes<T, NDIM>(g));
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long slots = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    long long best = -1;
    for (int sx = 1; sx <= kMaxSlab && sx <= g.EX; ++sx) {
      const long long blocks =
          static_cast<long long>(g.tiles_y) * g.tiles_z * ((g.EX + sx - 1) / sx);
      const long long cost = (blocks + slots - 1) / slots * (sx + 1);  // steps
      if (best < 0 || cost < best) {
        best = cost;
        g.SX = sx;
      }
    }
  }
  g.nslabs = (g.EX + g.SX - 1) / g.SX;
  g.SH = shell_size(NDIM, g.SX, g.TY, g.TZ);
  return 0;
}

Geo grid_geo(int ndim, int ex, int ey, int ez) {
  Geo g{};
  if (ndim == 3) {
    g.EX = ex, g.EY = ey, g.EZ = ez;
  } else {
    g.EX = 1, g.EY = ex, g.EZ = ey;
  }
  return g;
}

template <typename T, int NDIM>
int launch(const T* u, const T* young, T* part, T* f, const Geo& g, cudaStream_t s) {
  const int threads = (g.TY + 1) * (g.TZ + 1);
  const unsigned int blocks = static_cast<unsigned int>(g.nslabs) * g.tiles_y * g.tiles_z;
  cudaError_t err = allow_smem<T, NDIM>(g);
  if (err != cudaSuccess) return static_cast<int>(err);
  elem_blocks_kernel<T, NDIM><<<blocks, threads, smem_bytes<T, NDIM>(g), s>>>(
      u, young, part, f, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long NY = g.EY + 1, NZ = g.EZ + 1;
  const long long x_nodes = (g.nslabs - 1) * NY * NZ;
  const long long plane_nodes = (g.tiles_y - 1) * NZ + NY * (g.tiles_z - 1);
  const long long total = x_nodes + (NDIM == 3 ? g.EX + 1 : 1) * plane_nodes;
  if (total == 0) return 0;  // one block
  stitch_faces<T, NDIM><<<static_cast<unsigned int>((total + 255) / 256), 256, 0, s>>>(
      part, f, g, static_cast<int>(x_nodes), static_cast<int>(plane_nodes),
      static_cast<int>(total));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int geometry(int ndim, int ex, int ey, int ez, int* out) {
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  Geo g = grid_geo(ndim, ex, ey, ez);
  const int err = ndim == 3 ? pick_geometry<T, 3>(g) : pick_geometry<T, 2>(g);
  if (err) return err;
  const long long slots = static_cast<long long>(g.nslabs) * g.tiles_y * g.tiles_z * g.SH;
  if (slots >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  out[0] = g.SX, out[1] = g.TY, out[2] = g.TZ, out[3] = static_cast<int>(slots);
  return 0;
}

template <typename T>
int apply(const void* u, const void* young, void* part, void* f, int ndim, int ex, int ey,
          int ez, int sx, int ty, int tz, void* stream) {
  const long long nodes = static_cast<long long>(ex + 1) * (ey + 1) * (ndim == 3 ? ez + 1 : 1);
  if ((ndim != 2 && ndim != 3) || sx < 1 || ty < 1 || tz < 1 ||
      (ty + 1) * (tz + 1) > Tune<T>::kMaxThreads || nodes >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Geo g = grid_geo(ndim, ex, ey, ez);
  g.SX = ndim == 3 ? sx : 1, g.TY = ty, g.TZ = tz;
  g.nslabs = (g.EX + g.SX - 1) / g.SX;
  g.tiles_y = (g.EY + ty - 1) / ty;
  g.tiles_z = (g.EZ + tz - 1) / tz;
  g.SH = shell_size(ndim, g.SX, ty, tz);
  const T* up = static_cast<const T*>(u);
  const T* yp = static_cast<const T*>(young);
  T* pp = static_cast<T*>(part);
  T* fp = static_cast<T*>(f);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim == 3) return launch<T, 3>(up, yp, pp, fp, g, s);
  return launch<T, 2>(up, yp, pp, fp, g, s);
}

}  // namespace

// Copies the reflection blocks of type T into this kernel's constant
// memory (called by ndr_fine_set_blocks_f32 / _f64).
template <typename T>
int fine_elem_set_blocks(const void* B, int ndim, void* stream) {
  return set_blocks<T>(B, ndim, stream);
}
template int fine_elem_set_blocks<float>(const void*, int, void*);
template int fine_elem_set_blocks<double>(const void*, int, void*);

// The block geometry the fp32 (_f32) or float64 (_f64) kernel takes for a
// grid of elements (ex, ey[, ez]) on the current device: out[0..3] = slab
// SX (1 in 2-D), tile TY, TZ, and the partials slots (blocks x shell nodes
// per block); the scratch of ndr_apply_k_fine_elem_f32 / _f64 holds slots x
// N values of its type. Returns a cudaError_t code.
extern "C" int ndr_fine_elem_geometry_f32(int ndim, int ex, int ey, int ez, int* out) {
  return geometry<float>(ndim, ex, ey, ez, out);
}

extern "C" int ndr_fine_elem_geometry_f64(int ndim, int ex, int ey, int ez, int* out) {
  return geometry<double>(ndim, ex, ey, ez, out);
}

// u: nodes + (N,); young: dims; f: nodes + (N,), written in full; part: the
// scratch of the geometry (sx, ty, tz) that ndr_fine_elem_geometry_* of the
// same type gave, which the caller passes back; all fp32 (_f32) or all
// float64 (_f64). The blocks of that type must have been set for this ndim.
// Returns a cudaError_t code.
extern "C" int ndr_apply_k_fine_elem_f32(const void* u, const void* young, void* part,
                                         void* f, int ndim, int ex, int ey, int ez,
                                         int sx, int ty, int tz, void* stream) {
  return apply<float>(u, young, part, f, ndim, ex, ey, ez, sx, ty, tz, stream);
}

extern "C" int ndr_apply_k_fine_elem_f64(const void* u, const void* young, void* part,
                                         void* f, int ndim, int ex, int ey, int ez,
                                         int sx, int ty, int tz, void* stream) {
  return apply<double>(u, young, part, f, ndim, ex, ey, ez, sx, ty, tz, stream);
}
