"""Dense nearest-neighbour search (knn/bruteforce.py, verify/overlap.py)
against float64 numpy: the diff-form distances, the block scan's padding,
argmin ties, and the oriented overlap's normal gate."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from plade_tpu.knn import bruteforce
from plade_tpu.verify import overlap


def _unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _d2_64(q, r):
    qe = np.asarray(q, np.float64)
    re = np.asarray(r, np.float64)
    return ((qe[:, None, :] - re[None, :, :]) ** 2).sum(-1)


@pytest.mark.parametrize("block", [64, 512, 2048])
def test_nn_matches_float64(block, rng):
    """Any block size — a partial last block included — gives the float64
    distances and argmins."""
    q = jnp.asarray(rng.normal(size=(301, 3)).astype(np.float32))
    r = jnp.asarray(rng.normal(size=(1234, 3)).astype(np.float32))
    d, i = bruteforce.nearest_neighbor(q, r, block=block)
    d2 = _d2_64(q, r)
    np.testing.assert_allclose(np.asarray(d), d2.min(1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(i), d2.argmin(1))
    np.testing.assert_array_equal(
        np.asarray(bruteforce.min_dist_sq(q, r, block=block)), np.asarray(d))


def test_nn_exact_at_spacing_scale(rng):
    """Coordinates of O(100) with neighbours a few mm away: the diff form
    keeps these distances to float32 precision, where the
    |q|^2 - 2 q.r + |r|^2 expansion cancels to noise."""
    r = rng.uniform(100.0, 104.0, size=(700, 3)).astype(np.float32)
    q = (r[rng.integers(0, 700, 200)]
         + rng.normal(scale=0.003, size=(200, 3))).astype(np.float32)
    d, _ = bruteforce.nearest_neighbor(jnp.asarray(q), jnp.asarray(r))
    np.testing.assert_allclose(np.asarray(d), _d2_64(q, r).min(1),
                               rtol=1e-3, atol=1e-9)


def test_nn_padding_never_wins(rng):
    # fewer refs than one block: the BIG-padded rows must not win
    q = jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32))
    r = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    d, i = bruteforce.nearest_neighbor(q, r)
    assert int(np.asarray(i).max()) < 5
    np.testing.assert_allclose(np.asarray(d), _d2_64(q, r).min(1),
                               rtol=1e-5, atol=1e-6)


def test_nn_ties_take_lowest_index():
    """Duplicate references, in one block and across blocks: the argmin is
    the first copy, as jnp.argmin's."""
    base = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], np.float32)
    r = np.concatenate([base, base, np.full((60, 3), 5.0, np.float32),
                        base]).astype(np.float32)
    q = np.array([[0.1, 0.0, 0.0], [0.9, 0.0, 0.0]], np.float32)
    for block in (4, 64):
        _, i = bruteforce.nearest_neighbor(jnp.asarray(q), jnp.asarray(r),
                                           block=block)
        np.testing.assert_array_equal(np.asarray(i), [0, 1])


def test_nn_under_vmap_matches_per_lane(rng):
    """ICP vmaps the search over rescore modes: each lane equals its own
    unbatched call."""
    q = jnp.asarray(rng.normal(size=(3, 130, 3)).astype(np.float32))
    r = jnp.asarray(rng.normal(size=(300, 3)).astype(np.float32))
    db, ib = jax.vmap(lambda a: bruteforce.nearest_neighbor(a, r,
                                                            block=128))(q)
    for lane in range(3):
        d, i = bruteforce.nearest_neighbor(q[lane], r, block=128)
        np.testing.assert_array_equal(np.asarray(db[lane]), np.asarray(d))
        np.testing.assert_array_equal(np.asarray(ib[lane]), np.asarray(i))


@pytest.mark.parametrize("block", [128, 2048])
def test_oriented_nn_matches_float64(block, rng):
    """Normal-gated min distance vs float64 numpy, including a row where
    NO reference normal agrees (inf)."""
    q = rng.normal(size=(77, 3)).astype(np.float32)
    qn = _unit(rng.normal(size=(77, 3))).astype(np.float32)
    r = rng.normal(size=(999, 3)).astype(np.float32)
    # every reference normal points up, so a downward query agrees with none
    rn = rng.normal(size=(999, 3))
    rn[:, 2] = np.abs(rn[:, 2])
    rn = _unit(rn).astype(np.float32)
    qn[3] = [0.0, 0.0, -1.0]
    cos = 0.95
    got = np.asarray(overlap.oriented_min_dist_sq(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(r), jnp.asarray(rn),
        cos, block=block))
    gate = (qn.astype(np.float64) @ rn.astype(np.float64).T) >= cos
    want = np.where(gate, _d2_64(q, r), np.inf).min(1)
    fin = np.isfinite(want)
    assert not fin.all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-6)
    assert np.all(np.isinf(got[~fin]))


def test_oriented_zero_normal_refs_never_pass(rng):
    """Zero-normal references (the padding convention) fail a positive
    gate even when they are the nearest points."""
    q = (10.0 * np.arange(9)[:, None] * np.ones((1, 3))).astype(np.float32)
    qn = _unit(rng.normal(size=(9, 3))).astype(np.float32)
    r = np.concatenate([q + 1e-3, q + 1.0]).astype(np.float32)
    rn = np.concatenate([np.zeros_like(qn), qn]).astype(np.float32)
    got = np.asarray(overlap.oriented_min_dist_sq(
        jnp.asarray(q), jnp.asarray(qn), jnp.asarray(r), jnp.asarray(rn),
        0.5, block=8))
    np.testing.assert_allclose(got, 3.0, rtol=1e-5)


def test_exact_overlap_counts_match_float64(rng):
    """exact_overlap_counts (K candidate poses stacked into one query
    array) against a float64 per-candidate count, oriented and plain."""
    S, T, K = 120, 200, 3
    tgt = rng.normal(size=(T, 3)).astype(np.float32)
    tn = _unit(rng.normal(size=(T, 3))).astype(np.float32)
    src = (tgt[:S] + rng.normal(scale=0.05, size=(S, 3))).astype(np.float32)
    sn = tn[:S]
    smask = np.arange(S) < 100
    R = np.stack([np.eye(3)] * K).astype(np.float32)
    t = np.array([[0, 0, 0], [0.05, 0, 0], [0.5, 0, 0]], np.float32)
    r2 = 0.08 ** 2
    for cos in (0.0, 0.7):
        got = np.asarray(overlap.exact_overlap_counts(
            jnp.asarray(R), jnp.asarray(t), jnp.asarray(src),
            jnp.asarray(smask), jnp.asarray(tgt), r2,
            src_normals=jnp.asarray(sn), tgt_normals=jnp.asarray(tn),
            normal_cos=cos))
        for k in range(K):
            d2 = _d2_64(src + t[k], tgt)
            if cos > 0:
                d2 = np.where(sn.astype(np.float64) @ tn.T >= cos, d2, np.inf)
            want = int(np.sum((d2.min(1) <= r2) & smask))
            assert got[k] == want, (cos, k, got[k], want)
