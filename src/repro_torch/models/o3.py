"""Minimal real-spherical-harmonic O(3) machinery for NequIP (l ≤ 2): the
reference's numpy functions, copied, and its radial basis in torch.

Clebsch-Gordan coefficients for the *real* SH basis are computed
numerically at model-build time: the coupling tensor C(l1,l2→l3) is the
(1-dimensional) null space of the equivariance constraint
``C = D3ᵀ C (D1 ⊗ D2)`` stacked over random rotations, where the Wigner-D
matrices for real SH are themselves recovered by least squares from
``Y_l(R x) = D_l(R) Y_l(x)``. Exact to ~1e-12 and — unlike Gaunt-integral
couplings — includes the antisymmetric paths (e.g. 1⊗1→1, the cross
product). Cached per (l1, l2, l3).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

_SQRT_PI = np.sqrt(np.pi)


def sph_harm_np(vec: np.ndarray, l: int) -> np.ndarray:
    """Real spherical harmonics (orthonormal), vec [N, 3] need not be unit."""
    v = vec / np.maximum(np.linalg.norm(vec, axis=-1, keepdims=True), 1e-12)
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    if l == 0:
        return np.full(v.shape[:-1] + (1,), 0.5 / _SQRT_PI)
    if l == 1:
        c = np.sqrt(3.0 / (4 * np.pi))
        return np.stack([c * y, c * z, c * x], axis=-1)
    if l == 2:
        c = np.sqrt(15.0 / (4 * np.pi))
        c0 = np.sqrt(5.0 / (16 * np.pi))
        return np.stack(
            [
                c * x * y,
                c * y * z,
                c0 * (3 * z * z - 1.0),
                c * x * z,
                0.5 * c * (x * x - y * y),
            ],
            axis=-1,
        )
    raise NotImplementedError(f"l={l}")


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def wigner_d_np(r: np.ndarray, l: int, rng=None) -> np.ndarray:
    """D_l(R) with Y_l(R x) = D_l(R) Y_l(x), by least squares."""
    if l == 0:
        return np.ones((1, 1))
    rng = rng or np.random.default_rng(0)
    n = 8 * (2 * l + 1)
    x = rng.standard_normal((n, 3))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    a = sph_harm_np(x, l)  # [n, m]
    b = sph_harm_np(x @ r.T, l)  # [n, m] — rows Y(Rx)
    d, *_ = np.linalg.lstsq(a, b, rcond=None)
    return d.T  # b = a @ d  =>  Y(Rx) = D Y(x) with D = d.T


@lru_cache(maxsize=None)
def clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real-basis coupling tensor C [2l3+1, 2l1+1, 2l2+1], ||C|| = 1."""
    if not (abs(l1 - l2) <= l3 <= l1 + l2):
        raise ValueError(f"triangle violation ({l1},{l2},{l3})")
    rng = np.random.default_rng(42)
    m1, m2, m3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    rows = []
    for _ in range(4):
        r = _random_rotation(rng)
        d1 = wigner_d_np(r, l1, rng)
        d2 = wigner_d_np(r, l2, rng)
        d3 = wigner_d_np(r, l3, rng)
        # constraint: C[p,q,r] - sum_{a,b,c} D3[a,p] C[a,b,c] D1[b,q] D2[c,r] = 0
        op = np.einsum("ap,bq,cr->pqrabc", d3, d1, d2).reshape(
            m3 * m1 * m2, m3 * m1 * m2
        )
        rows.append(op - np.eye(m3 * m1 * m2))
    mat = np.concatenate(rows, axis=0)
    _, s, vt = np.linalg.svd(mat)
    null = vt[-1]
    if s[-1] > 1e-6:
        raise RuntimeError(f"no equivariant coupling for ({l1},{l2},{l3})")
    c = null.reshape(m3, m1, m2)
    # Fix sign: first max-magnitude entry positive.
    flat = c.ravel()
    c = c * np.sign(flat[np.argmax(np.abs(flat))])
    return c / np.linalg.norm(c)


def tp_paths(l_max: int):
    """All (l1, l2, l3) tensor-product paths with every l ≤ l_max."""
    paths = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                paths.append((l1, l2, l3))
    return paths


def bessel_basis_np(n_rbf: int, cutoff: float):
    """Returns f(r [E]) -> [E, n_rbf]: NequIP's Bessel radial basis with a
    polynomial cutoff envelope, in torch on ``r``'s device (the reference
    builds the same function in jnp)."""

    def basis(r):
        # the reference's float64 numpy frequencies, made on r's device with
        # no host copy (IEEE float64 products and quotients round alike)
        k = torch.arange(1, n_rbf + 1, dtype=torch.float64, device=r.device)
        freqs = (k * np.pi / cutoff).to(r.dtype)
        rc = torch.clamp(r, 1e-6, cutoff)
        b = torch.sin(rc[..., None] * freqs) / rc[..., None]
        # smooth cutoff envelope (p=6 polynomial, NequIP default family)
        u = torch.clamp(r / cutoff, 0.0, 1.0)
        env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8
        return b * env[..., None]

    return basis
