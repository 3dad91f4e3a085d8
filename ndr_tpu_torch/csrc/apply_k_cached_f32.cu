// Galerkin-level fp32 stiffness apply  f = sum_e scatter(Ke_e gather_e(u))
// from a per-element Ke stack, for degree-1 voxel grids.
//
// Replaces: ndr_tpu/fem/pallas_kernels.py apply_k_pallas_cached, the
// fused apply of the non-coarsest cached multigrid levels under the
// Chebyshev smoother. The stack keeps that kernel's coefficient-major
// stream layout (ke_stream_layout): (ex, d_pe^2, R) with the trailing
// element dims flattened to R = prod(dims[1:]), so coefficient k of
// element (i, r) sits at ((i * d_pe^2 + k) * R + r).
//
// Bound on Hopper: device-memory bytes of the Ke stack, 4 d_pe^2 B per
// element (2,304 B in 3-D) against ~28 B/node of u, f. Design: one
// thread per node, z fastest across a warp. A node reads only its own
// N rows of each incident element's Ke, so over all nodes the stack is
// read once per apply; with the stream layout, the lanes of a warp read
// coefficient k of neighbouring elements, i.e. neighbouring addresses,
// so every load is coalesced. No atomics.
#include "stencil.cuh"

namespace {

struct CachedCoef {
  const float* __restrict__ ke;
  long long d2;  // d_pe^2
  __device__ __forceinline__ float k(int ei, long long r, long long R,
                                     int i) const {
    return ke[(static_cast<long long>(ei) * d2 + i) * R + r];
  }
  __device__ __forceinline__ float scale(long long) const { return 1.0f; }
};

template <int NDIM>
__global__ void __launch_bounds__(ndr::kThreads)
apply_k_cached_f32_kernel(const float* __restrict__ u,
                          const float* __restrict__ ke,
                          float* __restrict__ f, int ex, int ey, int ez,
                          long long nodes) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nodes) return;
  constexpr long long d_pe = (1 << NDIM) * NDIM;
  ndr::node_apply<float, NDIM>(u, f, idx, ex, ey, ez,
                               CachedCoef{ke, d_pe * d_pe});
}

}  // namespace

// u: nodes + (N,) f32; ke: (ex, d_pe^2, R) f32; f: nodes + (N,) f32,
// written in full. Returns a cudaError_t code.
extern "C" int ndr_apply_k_cached_f32(const void* u, const void* ke, void* f,
                                      int ndim, int ex, int ey, int ez,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const long long nodes = ndr::num_nodes(ndim, ex, ey, ez);
  const unsigned int blocks = ndr::num_blocks(nodes);
  const float* up = static_cast<const float*>(u);
  const float* kp = static_cast<const float*>(ke);
  float* fp = static_cast<float*>(f);
  if (ndim == 3) {
    apply_k_cached_f32_kernel<3><<<blocks, ndr::kThreads, 0, s>>>(up, kp, fp, ex, ey, ez, nodes);
  } else {
    apply_k_cached_f32_kernel<2><<<blocks, ndr::kThreads, 0, s>>>(up, kp, fp, ex, ey, 1, nodes);
  }
  return static_cast<int>(cudaGetLastError());
}
