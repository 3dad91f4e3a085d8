// Device helpers of the fp32 fine kernels that work in the element's
// reflection basis (apply_k_fine_f32.cu, apply_k_fine_elem_f32.cu; the
// basis is described in apply_k_fine_f32.cu). Each includer keeps its own
// constant-memory copy of the reflection blocks; ndr_fine_set_blocks
// (apply_k_fine_f32.cu) sets both.
#pragma once

#include <cuda_runtime.h>

// Sets apply_k_fine_elem_f32.cu's copy (defined there).
int fine_elem_set_blocks(const void* B, int ndim, void* stream);

namespace {

// Reflection-basis blocks, B_s[c][d] / 2^N at ((s N + c) N + d).
__constant__ float c_B[8 * 9];

// In-place Walsh-Hadamard transform over the bits `bits` of the local node
// index of v[.][d].
template <int N, int NB>
__device__ __forceinline__ void wht(float (&v)[NB][N], int bits) {
#pragma unroll
  for (int bit = 1; bit < NB; bit <<= 1) {
    if (!(bits & bit)) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      if (b & bit) continue;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        const float x = v[b][d], y = v[b | bit][d];
        v[b][d] = x + y;
        v[b | bit][d] = x - y;
      }
    }
  }
}

// u of the four nodes of an element's node plane from its first node p
// (strides N along z, sy along y), or zeros.
template <int N>
__device__ __forceinline__ void load_plane(float (&v)[4][N], const float* p,
                                           long long sy, bool in) {
#pragma unroll
  for (int b = 0; b < 4; ++b) {
#pragma unroll
    for (int d = 0; d < N; ++d) {
      v[b][d] = in ? __ldg(p + ((b >> 1) & 1) * sy + (b & 1) * N + d) : 0.0f;
    }
  }
}

// K0 u_e / young for an element whose lower and upper node planes of u
// are lo and hi, each already transformed over the plane (in 2-D, hi is the
// element's only plane): the x stage of the transform, the 2^N blocks of
// c_B, the back transform. w[b][c]: force on local node b (x bit highest).
template <int N>
__device__ __forceinline__ void element_forces(const float (&lo)[4][N],
                                               const float (&hi)[4][N],
                                               float (&w)[1 << N][N]) {
  constexpr int HX = N == 3 ? 1 : 0;
  constexpr int NPE = 1 << N;
  float v[NPE][N];
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
      float acc = 0.0f;
#pragma unroll
      for (int d = 0; d < N; ++d) {
        acc = fmaf(c_B[(s * N + c) * N + d], v[s ^ (1 << (N - 1 - d))][d], acc);
      }
      w[s ^ (1 << (N - 1 - c))][c] = acc;
    }
  }
  wht<N>(w, NPE - 1);
}

// Copies the 2^N reflection-basis blocks (kernels.reflection_blocks, fp32
// on the device) into this source's c_B on the stream.
inline int set_blocks(const void* B, int ndim, void* stream) {
  if (ndim != 2 && ndim != 3) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaMemcpyToSymbolAsync(
      c_B, B, sizeof(float) * (1 << ndim) * ndim * ndim, 0, cudaMemcpyDeviceToDevice,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace
