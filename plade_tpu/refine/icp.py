"""Point-to-plane ICP refinement — batched Gauss-Newton on device.

**Addition vs the reference**: chsl/PLADE has no ICP of any kind (zero hits
for "icp" under code/PLADE/ — SURVEY "Critical negative findings"); its
output is the raw best-overlap hypothesis (code/PLADE/plade.cpp:545-575),
which is why the bundled room-pair result differs from ground truth at the
second decimal.  This module closes that gap on the device:

* correspondences: nearest target neighbor per transformed source point as
  one blocked dense distance pass, no KD-tree;
* residuals: point-to-plane ``n_q . (R s + t - q)`` with a correspondence
  distance gate;
* update: one 6x6 Gauss-Newton solve per iteration (twist [w; v]), applied
  via small-angle rotation update re-orthonormalized by SVD projection;
* fixed iteration count under ``lax.fori_loop`` — jit/vmap/shard friendly.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..knn.bruteforce import nearest_neighbor


def _orthonormalize(R: jnp.ndarray) -> jnp.ndarray:
    """Project a near-rotation onto SO(3) (SVD; det-corrected)."""
    U, _, Vt = jnp.linalg.svd(R)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(d)
    return U @ D @ Vt


def _skew(w):
    zeros = jnp.zeros_like(w[..., 0])
    return jnp.stack([
        jnp.stack([zeros, -w[..., 2], w[..., 1]], -1),
        jnp.stack([w[..., 2], zeros, -w[..., 0]], -1),
        jnp.stack([-w[..., 1], w[..., 0], zeros], -1),
    ], -2)


def refine_icp(R0, t0, src_points, src_mask, tgt_points, tgt_normals,
               max_corr, iters: int = 20):
    """Refine (R0, t0) so that R s + t aligns src onto tgt.

    src_points: (S, 3) BIG-padded; tgt_points/normals: (D, 3) BIG-padded
    (normals zero on padded rows — they contribute zero residuals).
    Returns (R, t, rmse, inlier_count).
    """
    max_corr2 = jnp.asarray(max_corr, jnp.float32) ** 2

    def body(_, state):
        R, t = state
        q = src_points @ R.T + t
        d2, idx = nearest_neighbor(q, tgt_points)
        valid = src_mask & (d2 <= max_corr2)
        nq = tgt_normals[idx]                       # (S, 3)
        pq = tgt_points[idx]
        r = jnp.sum(nq * (q - pq), axis=-1)         # (S,)
        # J = [ (q x n) ; n ] for twist [w; v]
        J = jnp.concatenate([jnp.cross(q, nq), nq], axis=-1)  # (S, 6)
        w = valid.astype(jnp.float32)
        A = (J * w[:, None]).T @ J                  # (6, 6)
        b = -(J * (w * r)[:, None]).sum(axis=0)     # (6,)
        A = A + 1e-6 * jnp.eye(6)
        x = jnp.linalg.solve(A, b)
        dR = _orthonormalize(jnp.eye(3) + _skew(x[:3]))
        dt = x[3:]
        return (_orthonormalize(dR @ R), dR @ t + dt)

    R, t = jax.lax.fori_loop(0, iters, body, (R0, t0))

    q = src_points @ R.T + t
    d2, idx = nearest_neighbor(q, tgt_points)
    valid = src_mask & (d2 <= max_corr2)
    nq = tgt_normals[idx]
    r = jnp.sum(nq * (q - tgt_points[idx]), axis=-1)
    w = valid.astype(jnp.float32)
    n = jnp.maximum(jnp.sum(w), 1.0)
    rmse = jnp.sqrt(jnp.sum(w * r * r) / n)
    return R, t, rmse, jnp.sum(valid.astype(jnp.int32))
