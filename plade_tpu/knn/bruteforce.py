"""Blocked brute-force neighbor computations.

The reference funnels every neighbor query through FLANN/ANN KD-trees
(pcl::search::KdTree — SURVEY 2.2 rows 6, 8, 9).  Pointer-chasing trees are
the wrong shape for an accelerator; at the sizes this pipeline sees
(downsampled clouds of 10^4 points) the dense distance computation is a
streaming elementwise op fused into its reduction.  All entry points
stream over reference blocks with ``lax.scan`` so memory stays bounded at
``Q x block`` regardless of cloud size.

Padding convention: invalid points sit at BIG (core/types.py), so they can
never enter any radius or k-NN neighborhood and need no extra masks here.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _block_dist_sq(q: jnp.ndarray, r: jnp.ndarray) -> jnp.ndarray:
    """(Q,3) x (B,3) -> (Q,B) squared distances in diff form
    ``(q-r).(q-r)``: exact where the |q|^2 - 2 q.r + |r|^2 expansion
    cancels at spacing-scale distances, and a chain of elementwise ops
    that XLA fuses into the reduction consuming it, so the (Q, B) block
    never reaches device memory."""
    dx = q[:, 0, None] - r[None, :, 0]
    dy = q[:, 1, None] - r[None, :, 1]
    dz = q[:, 2, None] - r[None, :, 2]
    return dx * dx + dy * dy + dz * dz


def _blocks(refs: jnp.ndarray, block: int) -> jnp.ndarray:
    n = refs.shape[0]
    pad = (-n) % block
    if pad:
        refs = jnp.concatenate(
            [refs, jnp.full((pad, 3), 1e8, refs.dtype)], axis=0)
    return refs.reshape(-1, block, 3)


def min_dist_sq(queries: jnp.ndarray, refs: jnp.ndarray,
                block: int = 2048) -> jnp.ndarray:
    """Per-query squared distance to the nearest reference point."""
    rb = _blocks(refs, block)

    def step(carry, rr):
        return jnp.minimum(
            carry, jnp.min(_block_dist_sq(queries, rr), axis=1)), None

    init = jnp.full((queries.shape[0],), jnp.inf, jnp.float32)
    out, _ = jax.lax.scan(step, init, rb)
    return out


def count_within(queries: jnp.ndarray, refs: jnp.ndarray, radius,
                 block: int = 2048) -> jnp.ndarray:
    """Per-query count of reference points within ``radius``."""
    rb = _blocks(refs, block)
    r2 = jnp.asarray(radius, jnp.float32) ** 2

    def step(carry, r):
        d = _block_dist_sq(queries, r)
        return carry + jnp.sum((d <= r2).astype(jnp.int32), axis=1), None

    out, _ = jax.lax.scan(step, jnp.zeros((queries.shape[0],), jnp.int32), rb)
    return out


def nearest_neighbor(queries: jnp.ndarray, refs: jnp.ndarray,
                     block: int = 2048):
    """Per-query (squared distance, index) of the nearest reference point;
    ties go to the lowest index."""
    rb = _blocks(refs, block)

    def step(carry, rb_base):
        best_d, best_i = carry
        rr, base = rb_base
        d = _block_dist_sq(queries, rr)
        bd = jnp.min(d, axis=1)
        bi = jnp.argmin(d, axis=1).astype(jnp.int32) + base
        take = bd < best_d
        return (jnp.where(take, bd, best_d),
                jnp.where(take, bi, best_i)), None

    init = (jnp.full((queries.shape[0],), jnp.inf, jnp.float32),
            jnp.zeros((queries.shape[0],), jnp.int32))
    bases = jnp.arange(rb.shape[0], dtype=jnp.int32) * block
    (d2, idx), _ = jax.lax.scan(step, init, (rb, bases))
    return d2, idx


def topk_dist_sq(queries: jnp.ndarray, refs: jnp.ndarray, k: int,
                 block: int = 512) -> jnp.ndarray:
    """(Q, k) smallest squared distances (ascending) to the references.

    Streams query blocks against the full reference row and selects with
    ``lax.approx_min_k``, oversampling 2k+4 neighbors and keeping the
    smallest k of those.  On the GPU and the CPU ``approx_min_k`` lowers to
    an exact top-k, so the oversampling is redundant (ROADMAP Design 3).
    """
    Q = queries.shape[0]
    T = refs.shape[0]
    k2 = min(2 * k + 4, T)
    nq = (Q + block - 1) // block
    qp = jnp.pad(queries, ((0, nq * block - Q), (0, 0)),
                 constant_values=1e8)

    def step(_, qb):
        d = _block_dist_sq(qb, refs)
        vals, _ = jax.lax.approx_min_k(d, k2)
        return None, vals

    _, out = jax.lax.scan(step, None, qp.reshape(nq, block, 3))
    return jnp.sort(out.reshape(nq * block, k2), axis=1)[:Q, :k]


def average_spacing(points: jnp.ndarray, mask: jnp.ndarray, k: int = 6,
                    samples: int = 10000) -> jnp.ndarray:
    """Average point spacing, replicating ``average_spacing``
    (code/PLADE/util.cpp:1619-1648) including its quirks: strided sampling
    of <= ``samples`` query points, k-NN including the query itself, and the
    per-sample mean dividing the k-1 neighbor distances by k.
    """
    n = points.shape[0]
    count = jnp.sum(mask.astype(jnp.int32))
    # strided sample: step = floor(count / samples) when count > samples.
    step = jnp.maximum(count // samples, 1)
    idx = jnp.arange(samples, dtype=jnp.int32) * step
    sample_valid = idx < count
    idx = jnp.minimum(idx, jnp.maximum(count - 1, 0))
    q = points[idx]
    d = topk_dist_sq(q, points, k)          # d[:, 0] == 0 (self)
    per_sample = jnp.sum(jnp.sqrt(d[:, 1:]), axis=1) / k
    w = sample_valid.astype(jnp.float32)
    return jnp.sum(per_sample * w) / jnp.maximum(jnp.sum(w), 1.0)


@functools.partial(jax.jit, static_argnames=("k", "samples"))
def average_spacing_jit(points, mask, k: int = 6, samples: int = 10000):
    return average_spacing(points, mask, k, samples)
