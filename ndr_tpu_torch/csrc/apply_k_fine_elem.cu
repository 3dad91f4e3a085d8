// Element-centric fine-level float64 stiffness apply  f = K(E) u  for
// degree-1 voxel grids.
//
// Replaces, in ndr_tpu/fem/pallas_kernels.py: apply_k_pallas_df_flat (the
// "flat" float64 residual of apply_k_pallas_df_fine), built on the TPU
// from fp32 hi/lo pairs because the TPU has no FP64. Hopper has FP64, so
// this takes float64 u, young, K0 in and writes float64 f, no split. (The
// fp32 element-centric kernel, apply_k_pallas's counterpart, is
// apply_k_fine_elem_f32.cu.)
//
// Design, the TPU kernel's own: element-centric, deterministic, no
// atomics. Pass 1 (apply_k_elem_partials): one thread per (x-slab, trailing
// element column (y, z)). It walks the slab's elements along x, keeps the
// u values of the shared x-plane and the forces of the next x-plane (the
// carry) in registers, and writes node x-plane r of the slab for trailing
// offset t into its own slot part[s][r][t][c][y][z]: no two threads write
// one slot. Each slab writes T+1 planes; its last plane is the next slab's
// first. Pass 2 (sum_elem_partials): one thread per node sums the <= 2^(N-1)
// shifted partials (and the previous slab's last plane on a slab boundary)
// in a fixed order. Partials are component-major so that neighbouring
// threads (neighbouring z) touch neighbouring addresses in both passes.
// The TPU kernel's VMEM slabs, lane padding and pre-sliced u copies are
// not carried over.
//
// Bound on Hopper: operations. Per element (2^N N)^2 FMAs (576 in 3-D) and
// 2^N N scales, against ~56 B/node of u, young and f in float64: 1.77M
// elements at 192x96x96 need ~2.1 GFLOP (31 us at 67 TFLOP/s FP64) and
// 101 MB (30 us at 3.35 TB/s). The partials add ~4x the f field's bytes
// of traffic (written once, read once), which the node-centric kernel of
// apply_k_fine.cu does not pay; in exchange each element's contraction is
// done once instead of 2^N times.
#include "stencil.cuh"

namespace {

__constant__ double c_K0e_f64[24 * 24];

template <typename T>
__device__ __forceinline__ T k0e(int i);
template <>
__device__ __forceinline__ double k0e<double>(int i) { return c_K0e_f64[i]; }

// Flat node index of trailing offset t (C order over the offset bits) at
// node x-plane i of the element column (j, k).
template <int NDIM>
__device__ __forceinline__ long long column_node(int i, int j, int k, int t,
                                                 int ny, int nz) {
  const int t1 = (NDIM == 3) ? (t >> 1) & 1 : t & 1;
  const int t2 = (NDIM == 3) ? t & 1 : 0;
  return (static_cast<long long>(i) * ny + (j + t1)) * nz + (k + t2);
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(ndr::kThreads)
apply_k_elem_partials(const T* __restrict__ u, const T* __restrict__ young,
                      T* __restrict__ part, int ex, int ey, int ez, int slab,
                      int nslabs) {
  constexpr int NPE = 1 << NDIM;
  constexpr int NT = NPE / 2;        // trailing offsets
  constexpr int D = NPE * NDIM;      // element DOFs
  constexpr int W = NT * NDIM;       // values per x-plane of one column
  const long long R = (NDIM == 3) ? static_cast<long long>(ey) * ez : ey;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= R * nslabs) return;
  const int s = static_cast<int>(idx / R);
  const long long rr = idx - s * R;
  const int j = (NDIM == 3) ? static_cast<int>(rr / ez) : static_cast<int>(rr);
  const int k = (NDIM == 3) ? static_cast<int>(rr % ez) : 0;
  const int ny = ey + 1;
  const int nz = (NDIM == 3) ? ez + 1 : 1;
  const int i0 = s * slab;
  const int n = min(slab, ex - i0);
  // slot (plane r, offset t, component c) of this column
  T* out = part + static_cast<long long>(s) * (slab + 1) * W * R + rr;

  T ulo[W], uhi[W], carry[W];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const long long nd = column_node<NDIM>(i0, j, k, t, ny, nz);
#pragma unroll
    for (int d = 0; d < NDIM; ++d) {
      ulo[t * NDIM + d] = u[nd * NDIM + d];
      carry[t * NDIM + d] = T(0);
    }
  }
  for (int r = 0; r < n; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const long long nd = column_node<NDIM>(i + 1, j, k, t, ny, nz);
#pragma unroll
      for (int d = 0; d < NDIM; ++d) uhi[t * NDIM + d] = u[nd * NDIM + d];
    }
    const T y = young[static_cast<long long>(i) * R + rr];
    // local node a = a_x * NT + t; a_x = 0 nodes close plane r, a_x = 1
    // nodes start the carry of plane r + 1
#pragma unroll
    for (int a = 0; a < NPE; ++a) {
#pragma unroll
      for (int c = 0; c < NDIM; ++c) {
        T acc = T(0);
#pragma unroll
        for (int b = 0; b < NPE; ++b) {
#pragma unroll
          for (int d = 0; d < NDIM; ++d) {
            const T ub = (b < NT) ? ulo[b * NDIM + d] : uhi[(b - NT) * NDIM + d];
            acc += k0e<T>((a * NDIM + c) * D + b * NDIM + d) * ub;
          }
        }
        if (a < NT) {
          out[(static_cast<long long>(r) * W + a * NDIM + c) * R] =
              carry[a * NDIM + c] + y * acc;
        } else {
          carry[(a - NT) * NDIM + c] = y * acc;
        }
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) ulo[w] = uhi[w];
  }
#pragma unroll
  for (int w = 0; w < W; ++w) {
    out[(static_cast<long long>(n) * W + w) * R] = carry[w];
  }
}

template <typename T, int NDIM>
__global__ void __launch_bounds__(ndr::kThreads)
sum_elem_partials(const T* __restrict__ part, T* __restrict__ f, int ex, int ey,
                  int ez, int slab, int nslabs, long long nodes) {
  constexpr int NT = 1 << (NDIM - 1);
  constexpr int W = NT * NDIM;
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nodes) return;
  const int ny = ey + 1;
  const int nz = (NDIM == 3) ? ez + 1 : 1;
  const long long R = (NDIM == 3) ? static_cast<long long>(ey) * ez : ey;
  const ndr::NodeIndex nd = ndr::node_index<NDIM>(idx, ny, nz);
  const int s = min(nd.i / slab, nslabs - 1);
  const int r = nd.i - s * slab;
  const bool seam = (r == 0 && s > 0);  // also the previous slab's last plane
  const T* here = part + (static_cast<long long>(s) * (slab + 1) + r) * W * R;
  const T* prev =
      seam ? part + (static_cast<long long>(s - 1) * (slab + 1) + slab) * W * R
           : here;
  T acc[NDIM];
#pragma unroll
  for (int c = 0; c < NDIM; ++c) acc[c] = T(0);
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int t1 = (NDIM == 3) ? (t >> 1) & 1 : t & 1;
    const int t2 = (NDIM == 3) ? t & 1 : 0;
    const int j = nd.j - t1;
    const int k = nd.k - t2;
    if (j < 0 || j >= ey) continue;
    if (NDIM == 3 && (k < 0 || k >= ez)) continue;
    const long long rr = (NDIM == 3) ? static_cast<long long>(j) * ez + k : j;
#pragma unroll
    for (int c = 0; c < NDIM; ++c) {
      acc[c] += here[(t * NDIM + c) * R + rr];
      if (seam) acc[c] += prev[(t * NDIM + c) * R + rr];
    }
  }
#pragma unroll
  for (int c = 0; c < NDIM; ++c) f[idx * NDIM + c] = acc[c];
}

// Copies K0 into `c_K0` on the stream, then launches both passes.
template <typename T, typename Symbol>
int launch_elem(const Symbol& c_K0, const void* u, const void* young,
                const void* K0, void* part, void* f, int ndim, int ex, int ey,
                int ez, int slab, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((ndim != 2 && ndim != 3) || slab < 1 || ex < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int d_pe = (1 << ndim) * ndim;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_K0, K0, sizeof(T) * d_pe * d_pe, 0, cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nslabs = (ex + slab - 1) / slab;
  const long long R = (ndim == 3) ? static_cast<long long>(ey) * ez : ey;
  const unsigned int pblocks = ndr::num_blocks(R * nslabs);
  const long long nodes = ndr::num_nodes(ndim, ex, ey, ez);
  const unsigned int sblocks = ndr::num_blocks(nodes);
  const T* up = static_cast<const T*>(u);
  const T* yp = static_cast<const T*>(young);
  T* pp = static_cast<T*>(part);
  T* fp = static_cast<T*>(f);
  if (ndim == 3) {
    apply_k_elem_partials<T, 3><<<pblocks, ndr::kThreads, 0, st>>>(
        up, yp, pp, ex, ey, ez, slab, nslabs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_elem_partials<T, 3><<<sblocks, ndr::kThreads, 0, st>>>(
        pp, fp, ex, ey, ez, slab, nslabs, nodes);
  } else {
    apply_k_elem_partials<T, 2><<<pblocks, ndr::kThreads, 0, st>>>(
        up, yp, pp, ex, ey, 1, slab, nslabs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    sum_elem_partials<T, 2><<<sblocks, ndr::kThreads, 0, st>>>(
        pp, fp, ex, ey, 1, slab, nslabs, nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: nodes + (N,); young: dims; K0: (2^N N)^2 on the device, all float64;
// part: scratch of nslabs * (slab + 1) * 2^(N-1) * N * prod(dims[1:])
// float64, nslabs = ceil(ex / slab); f: nodes + (N,) float64, written in
// full. Returns a cudaError_t code.
extern "C" int ndr_apply_k_fine_elem_f64(const void* u, const void* young,
                                         const void* K0, void* part, void* f,
                                         int ndim, int ex, int ey, int ez,
                                         int slab, void* stream) {
  return launch_elem<double>(c_K0e_f64, u, young, K0, part, f, ndim, ex, ey,
                             ez, slab, stream);
}
