"""Reference-element machinery: Lagrange bases, Gauss quadrature, K0 (the
port's own copy of ``ndr_tpu/fem/element.py``; NumPy only).

Replaces the compile-time C++ template machinery of the reference
(LagrangePolynomial.hh, TensorProductBasisPolynomial.hh,
TensorProductQuadrature.hh, TensorProductPolynomialInterpolant.hh, and
Element_T in TensorProductSimulator.hh:96-214) with set-up-time NumPy.
The element stiffness matrix K0 is a small constant; only its
application is a hot path, so float64 NumPy here costs nothing at run
time.

Conventions match ndr_tpu_torch.grid: local element nodes are C-ordered
over the local multi-index, DOFs are node-major/component-minor.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Tuple

import numpy as np


# ---------------------------------------------------------------------------
# 1-D Lagrange bases on equispaced nodes of [0, 1]
# (reference: VoxelFEM/LagrangePolynomial.hh — compile-time polynomials on
#  nodePosition<Deg>(i) = i/Deg)
# ---------------------------------------------------------------------------

def lagrange_nodes_1d(degree: int) -> np.ndarray:
    return np.linspace(0.0, 1.0, degree + 1)


def lagrange_values_1d(degree: int, x: np.ndarray) -> np.ndarray:
    """Values of all degree-`degree` Lagrange basis polynomials at points x.

    Returns array of shape ``(degree+1, len(x))``.
    """
    nodes = lagrange_nodes_1d(degree)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.ones((degree + 1, x.size), dtype=np.float64)
    for i in range(degree + 1):
        for j in range(degree + 1):
            if j == i:
                continue
            out[i] *= (x - nodes[j]) / (nodes[i] - nodes[j])
    return out


def lagrange_derivs_1d(degree: int, x: np.ndarray) -> np.ndarray:
    """Derivatives of all Lagrange basis polynomials at points x.

    Returns array of shape ``(degree+1, len(x))``.
    """
    nodes = lagrange_nodes_1d(degree)
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.zeros((degree + 1, x.size), dtype=np.float64)
    for i in range(degree + 1):
        for k in range(degree + 1):  # product-rule term where factor k is differentiated
            if k == i:
                continue
            term = np.full(x.size, 1.0 / (nodes[i] - nodes[k]))
            for j in range(degree + 1):
                if j in (i, k):
                    continue
                term *= (x - nodes[j]) / (nodes[i] - nodes[j])
            out[i] += term
    return out


# ---------------------------------------------------------------------------
# Gauss-Legendre quadrature on [0, 1]
# (reference: VoxelFEM/TensorProductQuadrature.hh:118-173 — 1..5-point rules)
# ---------------------------------------------------------------------------

def gauss_rule_1d(num_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights mapped from [-1,1] to [0,1]."""
    pts, wts = np.polynomial.legendre.leggauss(num_points)
    return 0.5 * (pts + 1.0), 0.5 * wts


def gauss_rule_for_degree(poly_degree: int) -> Tuple[np.ndarray, np.ndarray]:
    """Smallest rule exact for polynomials of the given degree."""
    n = poly_degree // 2 + 1  # (2n-1) >= d
    return gauss_rule_1d(n)


def integrate_nd(f, degrees: Tuple[int, ...]) -> float:
    """Integrate ``f(p)`` over [0,1]^N exactly for per-dim poly degrees.

    Used only by tests (mirrors TensorProductQuadrature::integrate).
    """
    axes = [gauss_rule_for_degree(d) for d in degrees]
    total = 0.0
    for combo in itertools.product(*[range(len(a[0])) for a in axes]):
        p = np.array([axes[d][0][combo[d]] for d in range(len(degrees))])
        w = np.prod([axes[d][1][combo[d]] for d in range(len(degrees))])
        total += w * f(p)
    return total


# ---------------------------------------------------------------------------
# Isotropic elasticity
# (reference: MeshFEM/ElasticityTensor.hh:100-131 — 3-D uses standard Lamé,
#  2-D uses the *plane-stress* lambda = nu E / (1 - nu^2))
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class IsotropicMaterial:
    young: float
    poisson: float
    dim: int

    @property
    def lame(self) -> Tuple[float, float]:
        E, nu = self.young, self.poisson
        mu = E / (2.0 * (1.0 + nu))
        if self.dim == 2:
            lam = nu * E / (1.0 - nu * nu)  # plane stress
        else:
            lam = nu * E / ((1.0 + nu) * (1.0 - 2.0 * nu))
        return lam, mu

    def contract(self, eps: np.ndarray) -> np.ndarray:
        """C : eps for a symmetric strain tensor eps (N x N)."""
        lam, mu = self.lame
        return lam * np.trace(eps, axis1=-2, axis2=-1)[..., None, None] * np.eye(
            self.dim
        ) + 2.0 * mu * eps

    def full_tensor(self) -> np.ndarray:
        """Rank-4 elasticity tensor C_{ijkl}, shape (N,N,N,N)."""
        lam, mu = self.lame
        N = self.dim
        I = np.eye(N)
        C = lam * np.einsum("ij,kl->ijkl", I, I) + mu * (
            np.einsum("ik,jl->ijkl", I, I) + np.einsum("il,jk->ijkl", I, I)
        )
        return C


# ---------------------------------------------------------------------------
# Element stiffness
# ---------------------------------------------------------------------------

def _local_node_multi_indices(degrees: Tuple[int, ...]) -> np.ndarray:
    """All local node multi-indices in C order, shape (n_nodes, N)."""
    ranges = [range(d + 1) for d in degrees]
    return np.array(list(itertools.product(*ranges)), dtype=np.int64)


def shape_gradients_at(
    degrees: Tuple[int, ...], stretchings: np.ndarray, points: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Shape-function values and physical gradients at reference points.

    Args:
      degrees: per-dimension Lagrange degree.
      stretchings: per-dimension physical element size (maps d/dref to d/dx).
      points: (Q, N) reference coordinates in [0,1]^N.

    Returns:
      (values, grads): values (n_nodes, Q); grads (n_nodes, Q, N) in
      *physical* coordinates (reference divides by stretchings when building
      strains, TensorProductPolynomialInterpolant.hh Gradients/Strains).
    """
    N = len(degrees)
    points = np.atleast_2d(points)
    Q = points.shape[0]
    vals_1d = [lagrange_values_1d(degrees[d], points[:, d]) for d in range(N)]
    ders_1d = [lagrange_derivs_1d(degrees[d], points[:, d]) for d in range(N)]
    idx = _local_node_multi_indices(degrees)
    n_nodes = idx.shape[0]
    values = np.ones((n_nodes, Q))
    grads = np.zeros((n_nodes, Q, N))
    for a in range(n_nodes):
        for d in range(N):
            values[a] *= vals_1d[d][idx[a, d]]
    for a in range(n_nodes):
        for gd in range(N):  # gradient component
            g = np.ones(Q)
            for d in range(N):
                g *= (ders_1d if d == gd else vals_1d)[d][idx[a, d]]
            grads[a, :, gd] = g / stretchings[gd]
    return values, grads


def element_stiffness_matrix(
    degrees: Tuple[int, ...], stretchings, material: IsotropicMaterial
) -> np.ndarray:
    """Full-density element stiffness matrix K0.

    K0[(a,c),(b,e)] = vol * ∫_[0,1]^N  eps(a,c) : C : eps(b,e)  dref
    where eps(a,c) = sym(grad(phi_a) ⊗ e_c) with physical gradients.

    (reference: Element_T::Stiffness, TensorProductSimulator.hh:127-140;
     quadrature of degree 2*Degrees per dim, :117)

    Returns (n_dofs, n_dofs) float64 with DOFs node-major/component-minor.
    """
    N = len(degrees)
    stretchings = np.asarray(stretchings, dtype=np.float64)
    vol = float(np.prod(stretchings))

    # tensor-product Gauss rule exact for the strain-product integrand
    axes = [gauss_rule_for_degree(2 * d) for d in degrees]
    pts = np.array(
        [p for p in itertools.product(*[a[0] for a in axes])], dtype=np.float64
    )
    wts = np.array(
        [np.prod(w) for w in itertools.product(*[a[1] for a in axes])],
        dtype=np.float64,
    )

    _, grads = shape_gradients_at(degrees, stretchings, pts)  # (n_nodes, Q, N)
    n_nodes = grads.shape[0]
    Q = pts.shape[0]

    # strain tensors for each (node, component): (n_nodes, N, Q, N, N)
    eye = np.eye(N)
    # eps[a, c, q] = 0.5 * (e_c grad_a^T + grad_a e_c^T)
    eps = 0.5 * (
        np.einsum("ci,aqj->acqij", eye, grads) + np.einsum("cj,aqi->acqij", eye, grads)
    )
    sig = material.contract(eps)  # C : eps, same shape

    # K[(a,c),(b,e)] = sum_q w_q vol * eps[a,c,q] : sig[b,e,q]
    K = np.einsum("acqij,beqij,q->acbe", eps, sig, wts) * vol
    K = K.reshape(n_nodes * N, n_nodes * N)
    # numerical symmetrization
    return 0.5 * (K + K.T)


def constant_strain_load_matrix(
    degrees: Tuple[int, ...], stretchings, material: IsotropicMaterial
) -> np.ndarray:
    """Per-element load under unit macroscopic strains (homogenization).

    Returns array of shape (n_strains, n_nodes, N):
    ``l[s, j, c] = vol * ∫ eps(j,c) : (C : E^s) dref`` where ``E^s`` runs
    over the canonical symmetric unit strains (3 in 2-D, 6 in 3-D),
    ordered (xx, yy[, zz], shear pairs) with *unit* off-diagonal entries
    E^s_ij = E^s_ji = 1.

    (reference: Element_T::constantStrainLoad / constantStressLoad,
     TensorProductSimulator.hh:146-174)
    """
    N = len(degrees)
    stretchings = np.asarray(stretchings, dtype=np.float64)
    vol = float(np.prod(stretchings))
    axes = [gauss_rule_for_degree(2 * d) for d in degrees]
    pts = np.array([p for p in itertools.product(*[a[0] for a in axes])])
    wts = np.array([np.prod(w) for w in itertools.product(*[a[1] for a in axes])])

    _, grads = shape_gradients_at(degrees, stretchings, pts)
    eye = np.eye(N)
    eps = 0.5 * (
        np.einsum("ci,aqj->acqij", eye, grads) + np.einsum("cj,aqi->acqij", eye, grads)
    )

    strains = canonical_strains(N)
    sig = np.stack([material.contract(E) for E in strains])  # (S, N, N)
    load = np.einsum("acqij,sij,q->sac", eps, sig, wts) * vol
    return load


def canonical_strains(N: int) -> np.ndarray:
    """Canonical symmetric unit strains, shape (n_strains, N, N)."""
    out = []
    for i in range(N):
        E = np.zeros((N, N))
        E[i, i] = 1.0
        out.append(E)
    for i in range(N):
        for j in range(i + 1, N):
            E = np.zeros((N, N))
            E[i, j] = E[j, i] = 1.0
            out.append(E)
    return np.stack(out)
