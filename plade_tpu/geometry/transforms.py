"""SE(3) utilities: rotation estimation, Euler angles, transforms.

Device-side replacements for the reference's PCL/Eigen calls:

* :func:`rotation_from_two_vecs` replaces
  ``ComputeTransformationUsingTwoVecAndOnePoint`` (code/PLADE/util.cpp:604-624)
  which ran ``pcl::registration::TransformationEstimationSVD`` on the three
  direction correspondences (v1, v2, v1 x v2).  Here the rotation is the
  closed-form frame alignment R = F_dst @ F_src^T with orthonormal frames
  built by Gram-Schmidt — exact when the correspondences are consistent and
  fully batched (no per-hypothesis SVD).
* :func:`euler_angles` mirrors ``pcl::getEulerAngles`` used by the pose
  clustering embedding (util.cpp:1257-1262).
"""
from __future__ import annotations

import jax.numpy as jnp

_EPS = 1e-12


def normalize(v: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    return v / jnp.maximum(jnp.linalg.norm(v, axis=axis, keepdims=True), _EPS)


def orthonormal_frame(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Build a right-handed orthonormal frame (..., 3, 3) whose columns are
    [e1, e2, e3]: e1 along v1, e2 the v1-orthogonal part of v2."""
    e1 = normalize(v1)
    e2 = normalize(v2 - jnp.sum(v2 * e1, -1, keepdims=True) * e1)
    e3 = jnp.cross(e1, e2)
    return jnp.stack([e1, e2, e3], axis=-1)


def rotation_from_two_vecs(src1, src2, dst1, dst2) -> jnp.ndarray:
    """Rotation taking direction pair (src1, src2) onto (dst1, dst2).

    Batched over leading dims.  Replaces the 3-point SVD of
    util.cpp:604-624 with closed-form frame alignment.
    """
    fs = orthonormal_frame(src1, src2)
    fd = orthonormal_frame(dst1, dst2)
    return fd @ jnp.swapaxes(fs, -1, -2)


def euler_angles(R: jnp.ndarray):
    """(roll, pitch, yaw) following pcl::getEulerAngles conventions.

    R is (..., 3, 3).  Used only as a pose-clustering embedding
    (util.cpp:1245-1277), so branch-free formulas suffice.
    """
    roll = jnp.arctan2(R[..., 2, 1], R[..., 2, 2])
    pitch = jnp.arcsin(-jnp.clip(R[..., 2, 0], -1.0, 1.0))
    yaw = jnp.arctan2(R[..., 1, 0], R[..., 0, 0])
    return roll, pitch, yaw


def apply_rigid(R: jnp.ndarray, t: jnp.ndarray, points: jnp.ndarray):
    """Apply x -> R x + t. R: (..., 3, 3), t: (..., 3), points: (..., N, 3)."""
    return jnp.einsum("...ij,...nj->...ni", R, points) + t[..., None, :]


def kabsch(src: jnp.ndarray, dst: jnp.ndarray, weights=None):
    """Weighted least-squares rigid transform src -> dst via SVD (Kabsch).

    src/dst: (N, 3).  Used by ICP refinement and tests; the hot hypothesis
    path uses :func:`rotation_from_two_vecs` instead.
    """
    if weights is None:
        weights = jnp.ones(src.shape[0], src.dtype)
    w = weights / jnp.maximum(jnp.sum(weights), _EPS)
    sc = jnp.sum(src * w[:, None], axis=0)
    dc = jnp.sum(dst * w[:, None], axis=0)
    H = (src - sc).T @ ((dst - dc) * w[:, None])
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    S = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d]))
    R = Vt.T @ S @ U.T
    t = dc - R @ sc
    return R, t
