// Node-centric stencil of the float64 fine apply (apply_k_fine.cu), and the
// index helpers the element-centric kernels (apply_k_fine_elem.cu) share.
//
// Conventions are ndr_tpu's (ndr_tpu/grid.py): element dims (ex, ey[, ez]),
// node dims one larger, C order (last axis fastest), node fields
// component-minor, element-local nodes in C order over their offset bits,
// element DOFs node-major / component-minor.
//
// One thread owns one node n and writes all N components of f[n]:
//
//   f[n, c] = sum over the <= 2^N elements e incident to n, where n is
//             local node a of e, of  sum_{b, d} Ke_e[a*N + c, b*N + d] * u[e + o_b, d]
//
// Every output is written once by one thread, so there are no atomics and
// no scatter pass, and the result does not depend on scheduling. With the
// z index fastest across a warp, neighbouring threads read neighbouring
// u and young addresses.
#pragma once

#include <cuda_runtime.h>

namespace ndr {

constexpr int kThreads = 256;

// Offset bit of local node `a` along axis `axis` (C order: last axis is
// the lowest bit).
template <int NDIM>
__device__ __forceinline__ int local_bit(int a, int axis) {
  return axis < NDIM ? (a >> (NDIM - 1 - axis)) & 1 : 0;
}

struct NodeIndex {
  int i, j, k;  // node multi-index (k = 0 in 2-D)
};

template <int NDIM>
__device__ __forceinline__ NodeIndex node_index(long long idx, int ny, int nz) {
  NodeIndex n;
  if (NDIM == 3) {
    n.k = static_cast<int>(idx % nz);
    idx /= nz;
  } else {
    n.k = 0;
  }
  n.j = static_cast<int>(idx % ny);
  n.i = static_cast<int>(idx / ny);
  return n;
}

// Sum over the incident elements of n. `Coef` supplies the per-element
// coefficient Ke_e[row, col] and the per-element scale (young); it is told
// the element's flat index and its (x, flattened-trailing) split.
template <typename T, int NDIM, typename Coef>
__device__ __forceinline__ void node_apply(const T* __restrict__ u,
                                           T* __restrict__ f, long long idx,
                                           int ex, int ey, int ez,
                                           const Coef& coef) {
  constexpr int NPE = 1 << NDIM;
  const int ny = ey + 1;
  const int nz = (NDIM == 3) ? ez + 1 : 1;
  const NodeIndex n = node_index<NDIM>(idx, ny, nz);

  T acc[NDIM];
#pragma unroll
  for (int c = 0; c < NDIM; ++c) acc[c] = T(0);

#pragma unroll
  for (int a = 0; a < NPE; ++a) {
    const int ei = n.i - local_bit<NDIM>(a, 0);
    const int ej = n.j - local_bit<NDIM>(a, 1);
    const int ek = (NDIM == 3) ? n.k - local_bit<NDIM>(a, 2) : 0;
    if (ei < 0 || ei >= ex || ej < 0 || ej >= ey) continue;
    if (NDIM == 3 && (ek < 0 || ek >= ez)) continue;
    // trailing (y[, z]) element index flattened, and the full flat index
    const long long r = (NDIM == 3) ? static_cast<long long>(ej) * ez + ek
                                    : static_cast<long long>(ej);
    const long long R = (NDIM == 3) ? static_cast<long long>(ey) * ez
                                    : static_cast<long long>(ey);
    const long long e = static_cast<long long>(ei) * R + r;

    T s[NDIM];
#pragma unroll
    for (int c = 0; c < NDIM; ++c) s[c] = T(0);
#pragma unroll
    for (int b = 0; b < NPE; ++b) {
      const long long ni = static_cast<long long>(ei + local_bit<NDIM>(b, 0));
      const long long nj = static_cast<long long>(ej + local_bit<NDIM>(b, 1));
      const long long nk =
          (NDIM == 3) ? static_cast<long long>(ek + local_bit<NDIM>(b, 2)) : 0;
      const long long node = (NDIM == 3) ? (ni * ny + nj) * nz + nk
                                         : ni * ny + nj;
#pragma unroll
      for (int d = 0; d < NDIM; ++d) {
        const T ub = u[node * NDIM + d];
#pragma unroll
        for (int c = 0; c < NDIM; ++c) {
          s[c] += coef.k(ei, r, R, (a * NDIM + c) * (NPE * NDIM) + b * NDIM + d) * ub;
        }
      }
    }
    const T scale = coef.scale(e);
#pragma unroll
    for (int c = 0; c < NDIM; ++c) acc[c] += scale * s[c];
  }
#pragma unroll
  for (int c = 0; c < NDIM; ++c) f[idx * NDIM + c] = acc[c];
}

inline long long num_nodes(int ndim, int ex, int ey, int ez) {
  long long n = static_cast<long long>(ex + 1) * (ey + 1);
  return ndim == 3 ? n * (ez + 1) : n;
}

inline unsigned int num_blocks(long long nodes) {
  return static_cast<unsigned int>((nodes + kThreads - 1) / kThreads);
}

}  // namespace ndr
