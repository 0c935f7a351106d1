"""Global pose-graph synchronization over pairwise registrations.

The reference registers each pair independently and stops (batch mode,
code/PLADE/main.cpp:97-158); multi-scan scenes (RESSO sequences) get no
global consistency.  This module adds it (SURVEY
section 7, build-plan step 7): given pairwise estimates
``T_ij`` (mapping scan j's frame into scan i's frame) with confidence
weights, recover world-from-scan poses ``(R_k, t_k)`` for all K scans.

Method — dense, fixed-shape, device-friendly (K is tens of scans):

1. **Rotation synchronization** (spectral): build the symmetric 3K x 3K
   block matrix A with A[i,j] = w_ij R_ij, A[j,i] = w_ij R_ij^T and
   A[k,k] = d_k I; the top-3 eigenvectors of A stack into 3x3 blocks that
   are projected to SO(3) per scan (SVD) — the classical eigenvector
   relaxation of rotation averaging (Singer 2011; Arie-Nachimson et al.,
   "Global Motion Estimation from Point Matches", 3DIMPVT 2012).
2. **Translation least squares**: with rotations fixed, each edge gives
   the linear constraint t_j - t_i = R_i t_ij; solve the weighted normal
   equations with the gauge t_0 = 0.

Identity convention: p_world = R_k p_k + t_k, and pairwise
p_i = R_ij p_j + t_ij, so consistency means R_j = R_i R_ij and
t_j = R_i t_ij + t_i.

Everything is jittable: edges are passed as padded fixed-size arrays with
a validity mask, so the solve can run on device and shard over scenes.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PoseGraph(NamedTuple):
    """Padded edge list: edge e maps scan src[e]'s frame into scan dst[e]'s
    frame by (R[e], t[e]) — dst is the registration target, src the
    source."""
    dst: jnp.ndarray       # (E,) int32
    src: jnp.ndarray       # (E,) int32
    R: jnp.ndarray         # (E, 3, 3)
    t: jnp.ndarray         # (E, 3)
    weight: jnp.ndarray    # (E,) float32 (0 = padded/invalid edge)


def _project_so3(M):
    """Closest rotation(s) to (..., 3, 3) in Frobenius norm via SVD."""
    U, _, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.concatenate([jnp.ones_like(det)[..., None],
                         jnp.ones_like(det)[..., None],
                         det[..., None]], axis=-1)
    return (U * D[..., None, :]) @ Vt


@functools.partial(jax.jit, static_argnames=("num_scans",))
def synchronize(graph: PoseGraph, num_scans: int):
    """Solve the pose graph; returns (R (K,3,3), t (K,3)) with scan 0 as
    the gauge (R_0 = I, t_0 = 0)."""
    K = num_scans
    w = graph.weight
    i, j = graph.dst, graph.src

    # ---- rotation synchronization ----
    A = jnp.zeros((K, K, 3, 3), jnp.float32)
    wR = w[:, None, None] * graph.R
    A = A.at[i, j].add(wR)
    A = A.at[j, i].add(jnp.swapaxes(wR, -1, -2))
    deg = jnp.zeros((K,), jnp.float32).at[i].add(w).at[j].add(w)
    eye = jnp.eye(3)[None, :, :] * jnp.maximum(deg, 1e-6)[:, None, None]
    A = A.at[jnp.arange(K), jnp.arange(K)].add(eye)
    Af = A.transpose(0, 2, 1, 3).reshape(3 * K, 3 * K)
    _, vecs = jnp.linalg.eigh(Af)
    V = vecs[:, -3:].reshape(K, 3, 3)              # top-3 eigvec blocks
    # With X_k = R_k^T the stacked X satisfies A X = X Lambda (since
    # R_ij X_j = R_i^T R_j R_j^T = X_i), so V_k ~ R_k^T Q for one global
    # orthogonal Q.  Project each block to O(3) (polar factor), flip all
    # dets together if Q landed in the det=-1 component (polar(M F) =
    # polar(M) F for orthogonal F), then undo the transpose; the remaining
    # left gauge Q^T cancels in the R_0-relative fix below.
    U, _, Vt = jnp.linalg.svd(V)
    P = U @ Vt                                     # (K, 3, 3) in O(3)
    flip = jnp.sign(jnp.sum(jnp.linalg.det(P)))
    F = jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(
        jnp.where(flip == 0, 1.0, flip))
    P = P @ F
    Rhat = jnp.swapaxes(P, -1, -2)                 # ~ Q^T R_k
    R = jnp.einsum("ij,kjl->kil", Rhat[0].T, Rhat)  # R_0-relative gauge

    # ---- translation least squares (gauge t_0 = 0) ----
    # edge residual: t_j - t_i - R_i t_ij = 0
    E = graph.t.shape[0]
    rhs = jnp.einsum("eij,ej->ei", R[i], graph.t)          # (E, 3)
    # build sparse incidence densely: rows = 3E, cols = 3K
    M = jnp.zeros((E, K), jnp.float32)
    M = M.at[jnp.arange(E), j].add(1.0)
    M = M.at[jnp.arange(E), i].add(-1.0)
    sw = jnp.sqrt(jnp.maximum(w, 0.0))
    Mw = M * sw[:, None]
    bw = rhs * sw[:, None]
    # drop the gauge column (t_0 = 0)
    Mg = Mw[:, 1:]
    AtA = Mg.T @ Mg + 1e-6 * jnp.eye(K - 1)
    Atb = Mg.T @ bw
    t_rest = jnp.linalg.solve(AtA, Atb)                    # (K-1, 3)
    t = jnp.concatenate([jnp.zeros((1, 3)), t_rest], axis=0)
    return R, t


def residuals(graph: PoseGraph, R, t):
    """Per-edge (rotation angle deg, translation norm) residuals."""
    i, j = graph.dst, graph.src
    Rp = jnp.einsum("eab,ebc->eac", R[i], graph.R)         # predicted R_j
    cosang = (jnp.einsum("eab,eab->e", Rp, R[j]) - 1.0) / 2.0
    ang = jnp.degrees(jnp.arccos(jnp.clip(cosang, -1.0, 1.0)))
    tp = jnp.einsum("eab,eb->ea", R[i], graph.t) + t[i]    # predicted t_j
    terr = jnp.linalg.norm(tp - t[j], axis=-1)
    return ang, terr


def from_edges(edges, num_scans: int, max_edges: int | None = None):
    """Build a padded PoseGraph from a python list of
    (dst, src, T (4,4) array-like, weight)."""
    import numpy as np
    E = max_edges or len(edges)
    dst = np.zeros((E,), np.int32)
    src = np.zeros((E,), np.int32)
    R = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
    t = np.zeros((E, 3), np.float32)
    w = np.zeros((E,), np.float32)
    for e, (d, s, T, wt) in enumerate(edges[:E]):
        T = np.asarray(T, np.float32)
        dst[e], src[e] = d, s
        R[e] = T[:3, :3]
        t[e] = T[:3, 3]
        w[e] = wt
    return PoseGraph(dst=jnp.asarray(dst), src=jnp.asarray(src),
                     R=jnp.asarray(R), t=jnp.asarray(t),
                     weight=jnp.asarray(w))
