"""Closed-form symmetric 3x3 eigendecomposition.

``jnp.linalg.eigh`` lowers to an iterative QDWH/Jacobi routine sized for
general matrices; every eigenproblem in this pipeline is a 3x3 covariance
(cloud OBBs — geometry/obb.py; per-plane OBBs; RANSAC refit plane fits —
extract/ransac.py), where the trigonometric closed form (Smith 1961,
"Eigenvalues of a symmetric 3x3 matrix") is a handful of elementwise ops and
batches over any leading dimensions.

Eigenvectors come from cross products of rows of (A - lambda I): the rows
span the eigenvector's orthogonal complement, so the largest pairwise
cross product is the eigenvector.  The middle vector is completed by
orthogonality, making the returned basis exactly orthonormal even for
nearly-degenerate spectra (where any basis of the degenerate subspace is
equally valid — the OBB/plane-fit consumers only need *an* orthonormal
eigenbasis, matching Eigen's behavior in the reference).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-20


def sym_eigvals3(A: jnp.ndarray) -> jnp.ndarray:
    """Eigenvalues (ascending) of symmetric (..., 3, 3) matrices."""
    a00 = A[..., 0, 0]
    a11 = A[..., 1, 1]
    a22 = A[..., 2, 2]
    a01 = A[..., 0, 1]
    a02 = A[..., 0, 2]
    a12 = A[..., 1, 2]
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    q = (a00 + a11 + a22) / 3.0
    b00 = a00 - q
    b11 = a11 - q
    b22 = a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, _EPS))
    # r = det(B)/2 with B = (A - qI)/p
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e_hi = q + 2.0 * p * jnp.cos(phi)
    e_lo = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return jnp.stack([e_lo, e_mid, e_hi], axis=-1)


def _eigvec(A: jnp.ndarray, lam: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of symmetric (..., 3, 3) A for eigenvalue lam:
    the largest cross product of two rows of (A - lam I)."""
    B = A - lam[..., None, None] * jnp.eye(3, dtype=A.dtype)
    r0 = B[..., 0, :]
    r1 = B[..., 1, :]
    r2 = B[..., 2, :]
    c01 = jnp.cross(r0, r1)
    c02 = jnp.cross(r0, r2)
    c12 = jnp.cross(r1, r2)
    n01 = jnp.sum(c01 * c01, axis=-1)
    n02 = jnp.sum(c02 * c02, axis=-1)
    n12 = jnp.sum(c12 * c12, axis=-1)
    best = jnp.where((n01 >= n02)[..., None] & (n01 >= n12)[..., None], c01,
                     jnp.where((n02 >= n12)[..., None], c02, c12))
    nb = jnp.maximum(jnp.sum(best * best, axis=-1, keepdims=True), 0.0)
    # degenerate (repeated eigenvalue lam): all row cross-products vanish
    # because B = A - lam I has rank <= 1; its rows are all parallel to the
    # OTHER (non-degenerate) eigenvector w, and every unit vector
    # orthogonal to w is a valid eigenvector of lam.  A fixed fallback
    # (e.g. e_x) can be exactly that other eigenvector — diag(c, 0, 0)
    # with lam = 0 would get e_x, mispairing vals/vecs — so build the
    # fallback per-matrix: project the identity axis with the smallest
    # |w| component onto w's orthogonal complement.
    rnorm2 = jnp.sum(B * B, axis=-1)                       # (..., 3) rows
    w = jnp.take_along_axis(
        B, jnp.argmax(rnorm2, axis=-1)[..., None, None]
        .repeat(3, axis=-1), axis=-2)[..., 0, :]           # (..., 3)
    wn2 = jnp.maximum(jnp.sum(w * w, axis=-1, keepdims=True), _EPS)
    axis = jnp.argmin(jnp.abs(w), axis=-1)                 # (...,)
    e = jnp.zeros_like(best)
    e = jnp.where(axis[..., None] == jnp.arange(3), 1.0, e)
    fb = e - (jnp.sum(e * w, axis=-1, keepdims=True) / wn2) * w
    fbn = jnp.maximum(jnp.linalg.norm(fb, axis=-1, keepdims=True), _EPS)
    # if B itself vanishes (A = lam I, fully degenerate) any unit vector
    # works — the projected axis reduces to the axis itself there
    fallback = fb / fbn
    ok = nb > 1e-30
    return jnp.where(ok, best / jnp.sqrt(jnp.where(ok, nb, 1.0)), fallback)


def sym_eigh3(A: jnp.ndarray):
    """(eigenvalues ascending, eigenvectors as columns) of symmetric
    (..., 3, 3) matrices — drop-in for ``jnp.linalg.eigh`` at 3x3.

    The basis is exactly orthonormal: v_lo and v_hi come from the closed
    form, v_mid completes by cross product, and v_lo is re-orthogonalized
    against the other two.
    """
    vals = sym_eigvals3(A)
    v_lo = _eigvec(A, vals[..., 0])
    v_hi = _eigvec(A, vals[..., 2])
    # guard v_hi against alignment with v_lo (repeated eigenvalues):
    # project out v_lo and renormalize, falling back to any orthogonal
    proj = v_hi - jnp.sum(v_hi * v_lo, axis=-1, keepdims=True) * v_lo
    pn = jnp.sum(proj * proj, axis=-1, keepdims=True)
    alt = jnp.cross(v_lo, jnp.where(
        (jnp.abs(v_lo[..., :1]) < 0.9),
        jnp.zeros_like(v_lo).at[..., 0].set(1.0),
        jnp.zeros_like(v_lo).at[..., 1].set(1.0)))
    alt = alt / jnp.maximum(
        jnp.linalg.norm(alt, axis=-1, keepdims=True), 1e-20)
    ok = pn > 1e-24
    v_hi = jnp.where(ok, proj / jnp.sqrt(jnp.where(ok, pn, 1.0)), alt)
    v_mid = jnp.cross(v_hi, v_lo)
    vecs = jnp.stack([v_lo, v_mid, v_hi], axis=-1)   # columns
    return vals, vecs


def smallest_eigvec3(A: jnp.ndarray) -> jnp.ndarray:
    """Unit eigenvector of the smallest eigenvalue (plane-fit normal)."""
    vals = sym_eigvals3(A)
    return _eigvec(A, vals[..., 0])
