"""E(3)-equivariant building blocks: real spherical harmonics + CG couplings
(a copy of ``repro/models/equivariant.py``: the numpy tables bit for bit,
``real_sph_harm_l2`` over torch tensors).

Numpy (trace-time) machinery:
  * complex Clebsch-Gordan coefficients via the Racah closed form,
  * complex->real spherical-harmonic change of basis,
  * real-basis coupling tensors C[(2l1+1),(2l2+1),(2l3+1)] (made real by the
    standard i-phase fix when l1+l2+l3 is odd).

Equivariance of everything here is asserted numerically by the test suite
(rotation invariance of contracted scalars to ~1e-5).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _fact(n: int) -> float:
    return float(math.factorial(n))


def clebsch_gordan(j1: int, j2: int, j3: int) -> np.ndarray:
    """Numerically robust CG via projection (small j only, which is our case).

    Builds the coupling by projecting product states onto total-angular-
    momentum eigenstates constructed by explicit diagonalization of J^2, Jz in
    the product basis — avoids alternating-sum cancellation entirely and gives
    the standard Condon-Shortley phases up to per-j3 sign, which is irrelevant
    for equivariance (absorbed into learned weights).
    """
    def jz(j):
        return np.diag(np.arange(-j, j + 1, dtype=np.float64))

    # raising operator in the |j m> basis ordered m = -j..j
    def jp(j):
        m = np.arange(-j, j, dtype=np.float64)
        v = np.sqrt(j * (j + 1) - m * (m + 1))
        out = np.zeros((2 * j + 1, 2 * j + 1))
        for i, val in enumerate(v):
            out[i + 1, i] = val  # J+ |j,m> = v |j,m+1>
        return out

    n1, n2, n3 = 2 * j1 + 1, 2 * j2 + 1, 2 * j3 + 1
    i1, i2 = np.eye(n1), np.eye(n2)
    Jz = np.kron(jz(j1), i2) + np.kron(i1, jz(j2))
    Jp = np.kron(jp(j1), i2) + np.kron(i1, jp(j2))
    Jm = Jp.T
    J2 = Jm @ Jp + Jz @ Jz + Jz   # J^2 = J-J+ + Jz^2 + Jz  (hbar = 1)

    evals, evecs = np.linalg.eigh(J2)
    target = j3 * (j3 + 1)
    sel = np.abs(evals - target) < 1e-6
    sub = evecs[:, sel]                       # (n1*n2, n3) total-j3 subspace
    # within the subspace, diagonalize Jz to label m3
    zsub = sub.T @ Jz @ sub
    zvals, zvecs = np.linalg.eigh(zsub)
    states = sub @ zvecs                      # columns ordered m3 = -j3..j3
    # fix phases: make the highest-m1 component of each column positive
    cg = np.zeros((n1, n2, n3))
    for c in range(n3):
        col = states[:, c]
        nz = np.argmax(np.abs(col) > 1e-9)
        if col[nz] < 0:
            col = -col
        cg[:, :, c] = col.reshape(n1, n2)
    return cg


def real_sh_transform(l: int) -> np.ndarray:
    """U with  Y^real_a = sum_m U[a, m] Y^complex_m  (m ordered -l..l).

    Real convention: a=-l..-1 -> sin (odd), a=0 -> m=0, a=1..l -> cos (even).
    """
    n = 2 * l + 1
    u = np.zeros((n, n), complex)
    s2 = 1.0 / math.sqrt(2.0)
    u[l, l] = 1.0
    for m in range(1, l + 1):
        u[l + m, l + m] = (-1.0) ** m * s2       # cos row: ((-1)^m Y_m + Y_-m)/√2
        u[l + m, l - m] = s2
        u[l - m, l + m] = (-1.0) ** m * (-1j * s2)  # sin row
        u[l - m, l - m] = 1j * s2
    return u


def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Coupling tensor in the REAL spherical-harmonic basis (real-valued).

    Built numerically: C_real = U1 U2 conj(U3) . C_complex; when l1+l2+l3 is
    odd the tensor is purely imaginary and we use its imaginary part (the
    -i phase is a valid equivariant redefinition).
    """
    cg = clebsch_gordan(l1, l2, l3)
    u1, u2, u3 = (real_sh_transform(l) for l in (l1, l2, l3))
    c = np.einsum("am,bn,co,mno->abc", u1, u2, u3.conj(), cg.astype(complex))
    re, im = np.real(c), np.imag(c)
    return re if np.abs(re).sum() >= np.abs(im).sum() else im


def real_sph_harm_l2(unit_vecs: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics l=0,1,2 for unit vectors (..., 3).

    Returns (..., 9) in the order [l0; l1(-1,0,1); l2(-2..2)], e3nn-style
    component ordering (y, z, x) for l=1: the reference's nine components
    and constants, stacked with ``torch.stack``.
    """
    x = unit_vecs[..., 0]
    y = unit_vecs[..., 1]
    z = unit_vecs[..., 2]
    c0 = 0.28209479177387814          # 1/2 sqrt(1/pi)
    c1 = 0.4886025119029199           # sqrt(3/(4pi))
    c2a = 1.0925484305920792          # sqrt(15/(4pi))
    c2b = 0.31539156525252005         # 1/4 sqrt(5/pi)
    c2c = 0.5462742152960396          # 1/4 sqrt(15/pi)
    comps = [
        x * 0 + c0,
        c1 * y, c1 * z, c1 * x,
        c2a * x * y, c2a * y * z, c2b * (3 * z * z - 1.0),
        c2a * x * z, c2c * (x * x - y * y),
    ]
    return torch.stack(comps, dim=-1)


L_SLICES = {0: slice(0, 1), 1: slice(1, 4), 2: slice(4, 9)}


def coupling_paths(l_max: int) -> list[tuple[int, int, int]]:
    """All (l1, l2, l3) with l1,l2,l3 <= l_max, |l1-l2| <= l3 <= l1+l2."""
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l_max, l1 + l2) + 1):
                out.append((l1, l2, l3))
    return out
