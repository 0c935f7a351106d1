"""Fixed-shape voxel-grid downsampling.

Replaces ``pcl::VoxelGrid`` / ``DownSamplePointCloud`` (code/PLADE/util.h:
161-184): every occupied voxel of side ``leaf`` contributes the centroid of
its points.  Device formulation: lexsort points by integer cell coordinates,
mark segment boundaries, scatter-mean into a padded output buffer.

Cells are ordered by a *hash* of their coordinates (ties broken by the
coordinates), not by the raw lexicographic cell key: the output buffer is
fixed-size, and when a cloud occupies more than ``max_out`` cells the
overflow must drop a spatially *uniform* subset.  Prefix-truncating a
coordinate-sorted cell list would keep an axis-aligned slab — source and
target clouds would then retain different regions and every downstream
overlap/penetration statistic would silently compare disjoint geometry.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..core.types import BIG, Cloud

# Classic spatial-hash primes (Teschner et al. 2003).  Plain numpy scalars:
# module-level jnp constants would initialize the XLA backend at import
# time, which breaks jax.distributed.initialize() in multi-process runs.
import numpy as _np

_HX = _np.int32(73856093)
_HY = _np.int32(19349663)
_HZ = _np.int32(83492791)
# independent second hash: sorting uses (h1, h2) as the cell key, giving
# 62 effective bits — collisions (two distinct cells adjacent-interleaved
# in the sort) are ~1e-11 for 10^5 cells, and even then the coordinate
# change detection merely splits the voxel, never merges two
_H2X = _np.int32(302451781)
_H2Y = _np.int32(160481219)
_H2Z = _np.int32(28411511)


def _cell_hash(ix, iy, iz):
    return (ix * _HX) ^ (iy * _HY) ^ (iz * _HZ)


def _cell_hash2(ix, iy, iz):
    return (ix * _H2X) ^ (iy * _H2Y) ^ (iz * _H2Z)


def voxel_downsample(points: jnp.ndarray, mask: jnp.ndarray, leaf,
                     max_out: int, normals: jnp.ndarray | None = None) -> Cloud:
    """Voxel-grid centroid downsample of the masked points.

    points: (N, 3) float32 (BIG-padded), mask: (N,) bool.
    Returns a Cloud padded to ``max_out``.  When ``normals`` is given, each
    voxel carries the normalized mean normal of its points (used by ICP's
    point-to-plane correspondences); otherwise normals are zeroed.
    """
    n = points.shape[0]
    big = jnp.float32(1e30)
    pmin = jnp.min(jnp.where(mask[:, None], points, big), axis=0)
    ijk = jnp.floor((points - pmin) / leaf).astype(jnp.int32)
    # Sort by the (h1, h2) cell hash pair: equal cells stay adjacent
    # (collision odds are negligible, see _cell_hash2); truncation at
    # max_out keeps a hash-uniform subset of cells; invalid points sort
    # last (h1 pinned to int32-max) with unique h2 so each is its own
    # segment.  Two sort keys instead of five: the lexsort carries every
    # key operand through the sort, a prepare-stage hot spot.
    arange = jnp.arange(n, dtype=jnp.int32)
    h = _cell_hash(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    h2 = _cell_hash2(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    key1 = jnp.where(mask, h & 0x7FFFFFFF, jnp.int32(0x7FFFFFFF))
    key2 = jnp.where(mask, h2, arange)
    ix = ijk[:, 0]
    iy = ijk[:, 1]
    iz = ijk[:, 2]
    order = jnp.lexsort((key2, key1))
    sx, sy, sz = ix[order], iy[order], iz[order]
    s1 = key1[order]
    s2 = key2[order]
    sp = points[order]
    sm = mask[order]
    changed = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (s1[1:] != s1[:-1]) | (s2[1:] != s2[:-1]) |
        (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (sz[1:] != sz[:-1]),
    ])
    seg = jnp.cumsum(changed.astype(jnp.int32)) - 1  # segment id per point
    count = jnp.where(sm.any(), jnp.max(jnp.where(sm, seg, -1)) + 1, 0)
    seg_clip = jnp.where(seg < max_out, seg, max_out)  # overflow -> dropped row
    sums = jnp.zeros((max_out + 1, 3), jnp.float32).at[seg_clip].add(
        jnp.where(sm[:, None], sp, 0.0))
    cnts = jnp.zeros((max_out + 1,), jnp.float32).at[seg_clip].add(
        sm.astype(jnp.float32))
    centroids = sums[:max_out] / jnp.maximum(cnts[:max_out, None], 1.0)
    valid = jnp.arange(max_out) < jnp.minimum(count, max_out)
    out_points = jnp.where(valid[:, None], centroids, BIG)
    if normals is not None:
        sn = normals[order]
        nsums = jnp.zeros((max_out + 1, 3), jnp.float32).at[seg_clip].add(
            jnp.where(sm[:, None], sn, 0.0))
        mean_n = nsums[:max_out]
        mean_n = mean_n / jnp.maximum(
            jnp.linalg.norm(mean_n, axis=-1, keepdims=True), 1e-12)
        out_normals = jnp.where(valid[:, None], mean_n, 0.0)
    else:
        out_normals = jnp.zeros((max_out, 3), jnp.float32)
    return Cloud(points=out_points,
                 normals=out_normals,
                 count=jnp.minimum(count, max_out).astype(jnp.int32))


def voxel_downsample_by_plane(points: jnp.ndarray, mask: jnp.ndarray,
                              point_plane: jnp.ndarray, leaf,
                              num_planes: int, max_out: int):
    """Per-plane voxel-grid downsample of all planes in ONE sorted pass.

    Replaces the reference's per-plane ``DownSamplePointCloud`` loop
    (plade.cpp:87-122) without 2*P full-cloud sorts: points are lexsorted
    once by (plane id, voxel cell); each (plane, cell) segment contributes
    its centroid to that plane's padded row block.

    Returns (pts (P, max_out, 3) BIG-padded, counts (P,) int32).
    """
    n = points.shape[0]
    ok = mask & (point_plane >= 0) & (point_plane < num_planes)
    big = jnp.float32(1e30)
    pmin = jnp.min(jnp.where(ok[:, None], points, big), axis=0)
    ijk = jnp.floor((points - pmin) / leaf).astype(jnp.int32)
    arange = jnp.arange(n, dtype=jnp.int32)
    kp = jnp.where(ok, point_plane, num_planes)
    # hash-ordered cells within each plane: per-plane truncation at max_out
    # drops a uniform subset, not an axis-aligned slab (see module
    # docstring).  Sort by (plane, h1, h2) — see voxel_downsample on the
    # two-hash cell key
    h = _cell_hash(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    h2 = _cell_hash2(ijk[:, 0], ijk[:, 1], ijk[:, 2])
    kh = jnp.where(ok, h, arange)
    kh2 = jnp.where(ok, h2, arange)
    kx = ijk[:, 0]
    ky = ijk[:, 1]
    kz = ijk[:, 2]
    order = jnp.lexsort((kh2, kh, kp))
    sp_, sm = points[order], ok[order]
    spl = kp[order]
    sh = kh[order]
    sh2 = kh2[order]
    sx, sy, sz = kx[order], ky[order], kz[order]
    changed = jnp.concatenate([
        jnp.ones((1,), jnp.bool_),
        (spl[1:] != spl[:-1]) | (sh[1:] != sh[:-1]) | (sh2[1:] != sh2[:-1])
        | (sx[1:] != sx[:-1]) | (sy[1:] != sy[:-1]) | (sz[1:] != sz[:-1]),
    ])
    seg = jnp.cumsum(changed.astype(jnp.int32)) - 1
    nseg = n  # upper bound
    # first segment id of each plane -> local cell index within the plane
    first_seg = jnp.full((num_planes + 1,), nseg, jnp.int32).at[
        jnp.minimum(spl, num_planes)].min(seg)
    local = seg - first_seg[jnp.minimum(spl, num_planes)]
    flat = jnp.where(sm & (local < max_out),
                     jnp.minimum(spl, num_planes - 1) * max_out + local,
                     num_planes * max_out)
    sums = jnp.zeros((num_planes * max_out + 1, 3), jnp.float32).at[flat].add(
        jnp.where(sm[:, None], sp_, 0.0))
    cnts = jnp.zeros((num_planes * max_out + 1,), jnp.float32).at[flat].add(
        sm.astype(jnp.float32))
    centroids = (sums[:-1] / jnp.maximum(cnts[:-1, None], 1.0)).reshape(
        num_planes, max_out, 3)
    occupied = (cnts[:-1] > 0).reshape(num_planes, max_out)
    counts = jnp.sum(occupied.astype(jnp.int32), axis=1)
    pts = jnp.where(occupied[..., None], centroids, BIG)
    return pts, counts
