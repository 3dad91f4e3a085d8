// Device helpers of the fine kernels that work in the element's reflection
// basis (fine_stream.cu, fine_elem.cu; the basis is described in
// fine_stream.cu), for T = float and T = double. Each includer keeps its own
// constant-memory copy of the reflection blocks of each type;
// ndr_fine_set_blocks_f32 / _f64 (fine_stream.cu) set both.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

// Sets fine_elem.cu's copy of the blocks of type T (defined there).
template <typename T>
int fine_elem_set_blocks(const void* B, int ndim, void* stream);

namespace {

// Reflection-basis blocks, B_s[c][d] / 2^N at ((s N + c) N + d), per type.
__constant__ float c_B[8 * 9];
__constant__ double c_B64[8 * 9];

template <typename T>
__device__ __forceinline__ T coef(int i);
template <>
__device__ __forceinline__ float coef<float>(int i) { return c_B[i]; }
template <>
__device__ __forceinline__ double coef<double>(int i) { return c_B64[i]; }

// a * b + c, rounded once
__device__ __forceinline__ float fma_t(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_t(double a, double b, double c) {
  return fma(a, b, c);
}

// In-place Walsh-Hadamard transform over the bits `bits` of the local node
// index of v[.][d].
template <typename T, int N, int NB>
__device__ __forceinline__ void wht(T (&v)[NB][N], int bits) {
#pragma unroll
  for (int bit = 1; bit < NB; bit <<= 1) {
    if (!(bits & bit)) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b & bit) continue;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        const T x = v[b][d], y = v[b | bit][d];
        v[b][d] = x + y;
        v[b | bit][d] = x - y;
      }
    }
  }
}

// u of the four nodes of an element's node plane from its first node p
// (strides N along z, sy along y), or zeros.
template <typename T, int N>
__device__ __forceinline__ void load_plane(T (&v)[4][N], const T* p, long long sy,
                                           bool in) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      v[b][d] = in ? __ldg(p + ((b >> 1) & 1) * sy + (b & 1) * N + d) : T(0);
    }
  }
}

// K0 u_e / young for an element whose lower and upper node planes of u
// are lo and hi, each already transformed over the plane (in 2-D, hi is the
// element's only plane): the x stage of the transform, the 2^N blocks of
// type T, the back transform. w[b][c]: force on local node b (x bit highest).
template <typename T, int N>
__device__ __forceinline__ void element_forces(const T (&lo)[4][N], const T (&hi)[4][N],
                                               T (&w)[1 << N][N]) {
  constexpr int HX = N == 3 ? 1 : 0;
  constexpr int NPE = 1 << N;
  T v[NPE][N];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      if (HX) {  // the transform's x stage
        v[b][d] = lo[b][d] + hi[b][d];
        v[b + 4 * HX][d] = lo[b][d] - hi[b][d];
      } else {
        v[b][d] = hi[b][d];
      }
    }
  }
#pragma unroll
  for (int s = 0; s < NPE; ++s) {
#pragma unroll
    for (int c = 0; c < N; ++c) {
      T acc = T(0);
#pragma unroll
      for (int d = 0; d < N; ++d) {
        acc = fma_t(coef<T>((s * N + c) * N + d), v[s ^ (1 << (N - 1 - d))][d], acc);
      }
      w[s ^ (1 << (N - 1 - c))][c] = acc;
    }
  }
  wht<T, N>(w, NPE - 1);
}

// Copies the 2^N reflection-basis blocks (kernels.reflection_blocks, of
// type T on the device) into this source's constant memory of type T on
// the stream.
template <typename T>
int set_blocks(const void* B, int ndim, void* stream) {
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(T) * (1 << ndim) * ndim * ndim;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    return static_cast<int>(
        cudaMemcpyToSymbolAsync(c_B, B, bytes, 0, cudaMemcpyDeviceToDevice, s));
  } else {
    return static_cast<int>(
        cudaMemcpyToSymbolAsync(c_B64, B, bytes, 0, cudaMemcpyDeviceToDevice, s));
  }
}

}  // namespace
