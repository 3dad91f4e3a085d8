// Fine-level float64 stiffness apply  f = K(E) u  for degree-1 voxel grids:
// the true residual r = f - K u of the mixed-precision refinement.
//
// Replaces: ndr_tpu/fem/pallas_kernels.py apply_k_pallas_df (reached
// through apply_k_pallas_df_fine), which builds an f64-accurate apply from
// fp32 hi/lo pairs with bitmask splits and TwoSum because the TPU has no
// native float64. Hopper has native FP64, so this is the node-centric
// stencil in double: no split, no error-free transforms, and no accuracy
// floor (the JAX solver used the two-float kernel only at tol >= 1e-6; this
// one serves every tol). The fp32 fine apply is apply_k_fine_f32.cu.
//
// Bound on Hopper: operations. Per node it must read N values of u and
// write N values of f, plus one young value per element (~56 B/node in 3-D
// in f64); the 2^N x 8N FMAs per node bound it. Design: one thread per node
// (z fastest across a warp), K0 in __constant__ memory (every lane of a
// warp reads the same coefficient, which the constant cache broadcasts),
// the 3^N neighbour u values and 2^N young values re-read through L1, so
// each byte of u and young comes from device memory about once per apply.
// No atomics: every node's output is summed by the thread that owns it.
#include "stencil.cuh"

namespace {

__constant__ double c_K0_f64[24 * 24];

template <typename T>
__device__ __forceinline__ T k0(int i);
template <>
__device__ __forceinline__ double k0<double>(int i) { return c_K0_f64[i]; }

template <typename T>
struct FineCoef {
  const T* __restrict__ young;
  __device__ __forceinline__ T k(int, long long, long long, int i) const {
    return k0<T>(i);
  }
  __device__ __forceinline__ T scale(long long e) const { return young[e]; }
};

template <typename T, int NDIM>
__global__ void __launch_bounds__(ndr::kThreads)
apply_k_fine_kernel(const T* __restrict__ u, const T* __restrict__ young,
                    T* __restrict__ f, int ex, int ey, int ez,
                    long long nodes) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nodes) return;
  ndr::node_apply<T, NDIM>(u, f, idx, ex, ey, ez, FineCoef<T>{young});
}

// Copies K0 into `c_K0` on the stream, then launches the kernel.
template <typename T, typename Symbol>
int launch_fine(const Symbol& c_K0, const void* u, const void* young,
                const void* K0, void* f, int ndim, int ex, int ey, int ez,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const int d_pe = (1 << ndim) * ndim;
  cudaError_t err = cudaMemcpyToSymbolAsync(
      c_K0, K0, sizeof(T) * d_pe * d_pe, 0, cudaMemcpyDeviceToDevice, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long nodes = ndr::num_nodes(ndim, ex, ey, ez);
  const unsigned int blocks = ndr::num_blocks(nodes);
  const T* up = static_cast<const T*>(u);
  const T* yp = static_cast<const T*>(young);
  T* fp = static_cast<T*>(f);
  if (ndim == 3) {
    apply_k_fine_kernel<T, 3><<<blocks, ndr::kThreads, 0, s>>>(up, yp, fp, ex, ey, ez, nodes);
  } else {
    apply_k_fine_kernel<T, 2><<<blocks, ndr::kThreads, 0, s>>>(up, yp, fp, ex, ey, 1, nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// u: nodes + (N,); young: dims; K0: (2^N N)^2 on the device, all float64;
// f: nodes + (N,) float64, written in full. Returns a cudaError_t code.
extern "C" int ndr_apply_k_fine_f64(const void* u, const void* young,
                                    const void* K0, void* f, int ndim, int ex,
                                    int ey, int ez, void* stream) {
  return launch_fine<double>(c_K0_f64, u, young, K0, f, ndim, ex, ey, ez, stream);
}

// Message for a code returned by any ndr_apply_* function.
extern "C" const char* ndr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
