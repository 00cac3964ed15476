"""The port's rect and Morton-code helpers (``repro_torch.core.geometry``)
and footprint padding (``repro_torch.core.footprint``) against the JAX
reference, bit for bit, on seeded numpy inputs with touching, empty and
out-of-square cases."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import footprint as j_fp  # noqa: E402
from repro.core import geometry as j_geo  # noqa: E402
from repro_torch.core import footprint as p_fp  # noqa: E402
from repro_torch.core import geometry as p_geo  # noqa: E402


def _rects(rng, n):
    """``n`` random rects in and around the unit square; a tenth empty
    (``x1 < x0`` or ``y1 < y0``) and a tenth zero-width."""
    lo = rng.uniform(-0.2, 1.0, (n, 2)).astype(np.float32)
    r = np.concatenate([lo, lo + rng.uniform(0.0, 0.4, (n, 2)).astype(np.float32)], axis=1)
    r[::10] = r[::10][:, [2, 3, 0, 1]]  # empty
    r[5::10, 2] = r[5::10, 0]  # zero width
    r[0] = p_geo.EMPTY_RECT
    return r


N_RANDOM, N_TOUCH = 400, 100


def _pairs(seed=0):
    """Rect pairs: ``N_RANDOM`` random ones, then ``N_TOUCH`` non-empty
    ``a`` rects each against a ``b`` that touches it on an edge, one at
    a corner, and one just off its edge."""
    rng = np.random.default_rng(seed)
    a, b = _rects(rng, N_RANDOM), _rects(rng, N_RANDOM)
    t = a[(a[:, 2] > a[:, 0]) & (a[:, 3] > a[:, 1])][:N_TOUCH]
    assert len(t) == N_TOUCH
    w = t[:, 2:3] - t[:, 0:1]
    edge = np.concatenate([t[:, 2:3], t[:, 1:2], t[:, 2:3] + w, t[:, 3:4]], axis=1)
    corner = np.concatenate([t[:, 2:4], t[:, 2:4] + np.float32(0.1)], axis=1)
    off = edge.copy()
    off[:, [0, 2]] = np.nextafter(off[:, [0, 2]], np.float32(2))
    return np.concatenate([a, t, t, t]), np.concatenate([b, edge, corner, off])


def _eq(got, want):
    got = [got] if isinstance(got, torch.Tensor) else list(got)
    want = [want] if not isinstance(want, tuple) else list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g.numpy(), w)


def test_rects_intersect_and_union_bound_bitwise():
    a, b = _pairs()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    hit = p_geo.rects_intersect(ta, tb)
    _eq(hit, j_geo.rects_intersect(ja, jb))
    touch = hit[N_RANDOM:]  # touching counts, just off does not
    assert touch[:2 * N_TOUCH].all() and not touch[2 * N_TOUCH:].any()
    _eq(p_geo.rect_union_bound(ta, tb), j_geo.rect_union_bound(ja, jb))
    # broadcasting: every rect against a few
    _eq(p_geo.rects_intersect(ta[:, None], tb[None, :7]),
        j_geo.rects_intersect(ja[:, None], jb[None, :7]))
    _eq(p_geo.rect_union_bound(ta[:, None], tb[None, :7]),
        j_geo.rect_union_bound(ja[:, None], jb[None, :7]))


def test_rect_center_bitwise():
    a, _ = _pairs(seed=1)
    cx, cy = p_geo.rect_center(torch.from_numpy(a))
    _eq((cx, cy), tuple(j_geo.rect_center(jnp.asarray(a))))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_morton_encode_bitwise(dtype):
    """Int32 codes as the reference gives them, including the wrap of a
    code of 2**31 or more (``iy`` >= 2**15) up to 2**16 − 1, and the
    reference's own numpy twin where no code wraps."""
    rng = np.random.default_rng(2)
    edges = np.array([0, 1, 2, 2**10 - 1, 2**15 - 1, 2**15, 2**16 - 2, 2**16 - 1])
    ix = np.concatenate([rng.integers(0, 2**16, 500), np.repeat(edges, len(edges))])
    iy = np.concatenate([rng.integers(0, 2**16, 500), np.tile(edges, len(edges))])
    ix, iy = ix.astype(dtype), iy.astype(dtype)
    got = p_geo.morton_encode(torch.from_numpy(ix), torch.from_numpy(iy))
    want = np.asarray(j_geo.morton_encode(jnp.asarray(ix.astype(np.int32)),
                                          jnp.asarray(iy.astype(np.int32))))
    _eq(got, want)
    assert (got < 0).any() and (got >= 0).any()
    small = iy < 2**15
    np.testing.assert_array_equal(got.numpy()[small].astype(np.int64),
                                  j_geo.morton_encode_np(ix[small], iy[small]))
    _eq(p_geo.morton_encode(3, 5), np.asarray(j_geo.morton_encode(3, 5)))
    grid = np.arange(4)
    _eq(p_geo.morton_encode(torch.from_numpy(grid)[:, None], torch.from_numpy(grid)[None, :]),
        np.asarray(j_geo.morton_encode(jnp.asarray(grid)[:, None], jnp.asarray(grid)[None, :])))


@pytest.mark.parametrize("grid", [1, 7, 64, 1024])
def test_point_to_cell_bitwise(grid):
    """Clipped int32 cells; points outside the square, on cell edges and
    just below 1 included."""
    rng = np.random.default_rng(3)
    edge = (np.arange(grid + 1) / grid).astype(np.float32)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 300).astype(np.float32), edge,
                        np.float32([0.0, -0.0, 1.0, np.nextafter(np.float32(1), 0), -1e-7])])
    y = rng.permutation(x)
    got = p_geo.point_to_cell(torch.from_numpy(x), torch.from_numpy(y), grid)
    _eq(got, tuple(j_geo.point_to_cell(jnp.asarray(x), jnp.asarray(y), grid)))
    assert got[0].min() >= 0 and got[0].max() <= grid - 1


@pytest.mark.parametrize("n", [0, 1, 3, 8, 11])
def test_make_footprint_np_and_batch(n):
    """Padding to 8 rects: fewer kept whole, more cut to the first 8, the
    rest ``EMPTY_RECT`` with amp 0; ``FootprintBatch.max_rects`` of the
    padded batch."""
    rng = np.random.default_rng(4 + n)
    rects = _rects(rng, n) if n else np.zeros((0, 4), np.float32)
    amps = rng.uniform(0.1, 1.0, n).astype(np.float32)
    got = p_fp.make_footprint_np(rects, amps, 8)
    want = j_fp.make_footprint_np(rects, amps, 8)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    r, a = got
    batch = p_fp.FootprintBatch(torch.from_numpy(np.stack([r, r])),
                                torch.from_numpy(np.stack([a, a])))
    j_batch = j_fp.FootprintBatch(jnp.asarray(np.stack([r, r])), jnp.asarray(np.stack([a, a])))
    assert batch.max_rects == j_batch.max_rects == 8
    with pytest.raises(AttributeError):
        batch.rects = batch.amps  # frozen, as the reference's
