"""The port's facet geometry (``africanus_tpu_torch/linalg/geometry.py``,
a numpy copy) against the JAX package's: the cases of
``tests/test_geometry_cases.py`` and the geometry cases of
``tests/test_linalg_gps.py`` run on the port's classes with their
assertions, and every array, extent and count they produce equals the
JAX package's on the same inputs, bit for bit (the same numpy
operations)."""

import importlib

import numpy as np
import pytest

JAX_GEOMETRY = importlib.import_module("africanus_tpu.linalg.geometry")
PORT_GEOMETRY = importlib.import_module("africanus_tpu_torch.linalg.geometry")


@pytest.fixture(scope="module")
def sinc2d():
    npx = 255
    s = np.sinc(np.linspace(-7, 7, npx))
    return np.outer(s, s).reshape((1, 1, npx, npx))


def _both(case, *args):
    """``case(geometry module, *args)`` on the port (asserting inside)
    and on the JAX package; their outputs must be equal."""
    got = case(PORT_GEOMETRY, *args)
    want = case(JAX_GEOMETRY, *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w), equal_nan=True)


def _main_hull(G):
    return G.BoundingConvexHull(
        np.array([[50, 60], [20, 40], [-74, 50], [-95, +10], [20, 60]]))


def _sinc_hull(G):
    return G.BoundingConvexHull(
        np.array([[-10, 120], [90, 268], [293, 110], [40, -30]]))


def _in_image(hull, npx):
    sm = np.array(hull.sparse_mask)
    sel = ((sm[:, 1] >= 0) & (sm[:, 1] < npx)
           & (sm[:, 0] >= 0) & (sm[:, 0] < npx))
    return sm[sel][:, 0] * npx + sm[sel][:, 1]


def test_port_hull_mask_area_and_normals():
    def case(G):
        hull = _main_hull(G)
        vals, mask = hull.corners, hull.mask
        assert mask.shape == (np.ptp(vals[:, 1]) + 1, np.ptp(vals[:, 0]) + 1)
        assert np.abs(mask.sum() - hull.area) / hull.area < 0.05
        unit = hull.rnormals / np.linalg.norm(hull.rnormals, axis=1,
                                              keepdims=True)
        for e, n in zip(hull.edges, unit):
            assert abs(np.dot(e[1] - e[0], n)) < 1e-8
        return vals, mask, hull.area, hull.rnormals, hull.edges
    _both(case)


def test_port_regional_extraction_conserves_flux(sinc2d):
    def case(G):
        hull = _sinc_hull(G)
        data, extents = G.BoundingConvexHull.regional_data(
            hull, sinc2d, oob_value=np.nan)
        assert tuple(extents) == (-10, 293, -30, 268)
        npx = sinc2d.shape[3]
        assert abs(sinc2d.ravel()[_in_image(hull, npx)].sum()
                   - np.nansum(data)) < 1e-8
        v = np.nanargmax(data)
        peak = (extents[0] + v % data.shape[3], extents[2] + v // data.shape[3])
        vs = np.nanargmax(sinc2d)
        assert peak == (vs % npx, vs // npx)
        return data, extents
    _both(case)


def test_port_hull_overlap_and_containment():
    def case(G):
        hull = _main_hull(G)
        bh2 = G.BoundingConvexHull(np.array([[-20, -120], [0, 60], [40, -60]]))
        bh3 = G.BoundingConvexHull(np.array([[-20, 58], [-40, 80], [20, 100]]))
        out = [hull.overlaps_with(bh2), hull.overlaps_with(bh3),
               bh2.overlaps_with(bh3)]
        inside = [p in hull for p in ((-1000, -1000), (30, 0), (0, 0),
                                      (-40, 30))]
        assert out == [True, False, False]
        assert inside == [False, False, False, True]
        return out, inside
    _both(case)


def test_port_bounding_box_properties():
    def case(G):
        bb = G.BoundingBox(-14, 20, 30, 49)
        assert bb.centre == [3, 39] and bb.box_npx == (35, 20)
        assert bb.mask.shape == bb.box_npx[::-1]
        assert bb.area == 35 * 20 == np.sum(bb.mask)
        assert (-15, 35) not in bb and (0, 35) in bb
        odd = G.BoundingBoxFactory.AxisAlignedBoundingBox(bb)
        assert odd.box_npx == (35, 21) and odd.area == 35 * 21
        assert (np.asarray(bb.sparse_mask) == np.asarray(odd.sparse_mask)).all()
        assert (-15, 35) not in odd and (0, 35) in odd
        sq = G.BoundingBoxFactory.AxisAlignedBoundingBox(bb, square=True)
        assert sq.box_npx[0] == sq.box_npx[1] and sq.box_npx[0] % 2 == 1
        assert sq.area == sq.box_npx[0] ** 2
        assert (np.asarray(bb.sparse_mask) == np.asarray(sq.sparse_mask)).all()
        return (bb.mask, bb.sparse_mask, odd.corners, odd.mask, sq.corners,
                sq.mask)
    _both(case)


def test_port_split_and_pad_boxes():
    def case(G):
        F = G.BoundingBoxFactory
        bb = G.BoundingBox(-14, 20, 30, 49)
        subs = F.SplitBox(bb, nsubboxes=3)
        assert len(subs) == 9
        xlims = [(c.corners[:, 0].min(), c.corners[:, 0].max())
                 for c in subs][0:3]
        ylims = [(c.corners[:, 1].min(), c.corners[:, 1].max())
                 for c in subs][0::3]
        assert np.all(np.asarray(xlims) == [(-14, -3), (-2, 9), (10, 20)])
        assert np.all(np.asarray(ylims) == [(30, 36), (37, 43), (44, 49)])
        assert sum(b.area for b in subs) == bb.area
        assert all(b.area == np.sum(b.mask) for b in subs)
        bb5 = G.BoundingBox(-14, 20, 30, 50)
        padded = F.PadBox(bb5, 41, 27)
        assert padded.box_npx == (41, 27) and bb5.centre == padded.centre
        assert np.sum(bb5.mask) == np.sum(padded.mask)
        padded_subs = [F.PadBox(b, 17, 11) for b in subs]
        assert all(b.box_npx == (17, 11) for b in padded_subs)
        assert (sum(np.sum(b.mask) for b in padded_subs)
                == sum(np.sum(b.mask) for b in subs))
        return ([b.corners for b in subs] + [padded.corners, padded.mask]
                + [b.mask for b in padded_subs])
    _both(case)


def test_port_facet_stitching(sinc2d):
    def case(G):
        F = G.BoundingBoxFactory
        hull = _sinc_hull(G)
        npx = sinc2d.shape[3]
        integral = sinc2d.ravel()[_in_image(hull, npx)].sum()
        regions = [F.PadBox(f, 63, 63) for f in F.SplitBox(
            F.AxisAlignedBoundingBox(hull), nsubboxes=5)]
        facets = [G.BoundingConvexHull.regional_data(r, sinc2d,
                                                     oob_value=np.nan)
                  for r in regions]
        stitched, region = G.BoundingBox.project_regions(
            [f[0] for f in facets], regions)
        assert abs(integral - np.nansum([np.nansum(f[0]) for f in facets])) < 1e-8
        assert abs(integral - np.sum(stitched)) < 1e-8
        v = np.argmax(stitched)
        peak = (region.corners[:, 0].min() + v % stitched.shape[3],
                region.corners[:, 1].min() + v // stitched.shape[3])
        vs = np.nanargmax(sinc2d)
        assert peak == (vs % npx, vs // npx)
        return [f[0] for f in facets] + [stitched, region.corners]
    _both(case)


def test_port_overlap_normalisation(sinc2d):
    def case(G):
        boxes = [G.BoundingBox(110, 138, 110, 135),
                 G.BoundingBox(115, 150, 109, 150),
                 G.BoundingBox(125, 130, 125, 130)]
        G.BoundingConvexHull.normalize_masks(boxes)
        exts = [G.BoundingConvexHull.regional_data(b, sinc2d)[0] for b in boxes]
        stitched, region = G.BoundingBox.project_regions(exts, boxes)
        v = np.nanargmax(stitched)
        peak = (region.corners[:, 0].min() + v % stitched.shape[3],
                region.corners[:, 1].min() + v // stitched.shape[3])
        npx = sinc2d.shape[3]
        vs = np.nanargmax(sinc2d)
        assert peak == (vs % npx, vs // npx)
        assert abs(1.0 - np.nanmax(stitched)) < 1e-8
        return [b.mask for b in boxes] + [stitched]
    _both(case)


def test_port_regional_data_oob_value_reference_semantics():
    def case(G):
        data = np.arange(1.0, 1.0 + 20 * 20).reshape(1, 1, 20, 20)
        hull = G.BoundingConvexHull([(4, 4), (14, 4), (4, 14)])
        win, _ = G.BoundingConvexHull.regional_data(hull, data, oob_value=3.0)
        mask = hull.mask
        inside = mask > 0
        assert inside.any() and (~inside).any()
        sl = win[0, 0]
        miny, minx = int(hull.corners[:, 1].min()), int(hull.corners[:, 0].min())
        src = data[0, 0, miny:miny + sl.shape[0], minx:minx + sl.shape[1]]
        np.testing.assert_allclose(sl[inside], (src * mask)[inside])
        np.testing.assert_allclose(sl[~inside], src[~inside] * 3.0)
        return (win,)
    _both(case)


def test_port_project_regions_shape_mismatch_raises():
    box = PORT_GEOMETRY.BoundingBox(0, 9, 0, 9)
    with pytest.raises(ValueError, match="bounding box"):
        PORT_GEOMETRY.BoundingBox.project_regions([np.ones((1, 1, 5, 5))],
                                                  [box])


# ---------------------------------------- the cases of test_linalg_gps.py

def test_port_bounding_convex_hull_basics():
    def case(G):
        hull = G.BoundingConvexHull([[0, 0], [10, 0], [10, 8], [0, 8], [5, 4]])
        assert (5, 4) in hull and (0, 0) in hull and (20, 20) not in hull
        assert hull.corners.shape[1] == 2
        assert hull.area > 0 and hull.circumference > 0
        for (y, x) in hull.sparse_mask[:16]:
            assert (x, y) in hull
        m = hull.mask
        assert m.shape == (9, 11) and m.max() == 1.0
        return hull.corners, hull.area, hull.circumference, m
    _both(case)


def test_port_hull_overlap():
    def case(G):
        h1 = G.BoundingConvexHull([[0, 0], [4, 0], [4, 4], [0, 4]])
        h2 = G.BoundingConvexHull([[2, 2], [6, 2], [6, 6], [2, 6]])
        h3 = G.BoundingConvexHull([[10, 10], [14, 10], [14, 14], [10, 14]])
        out = [h1.overlaps_with(h2), h1.overlaps_with(h3)]
        assert out == [True, False]
        return (out,)
    _both(case)


def test_port_bounding_box_and_factory():
    def case(G):
        F = G.BoundingBoxFactory
        bb = G.BoundingBox(0, 9, 0, 7, "box")
        assert bb.box_npx == (10, 8)
        assert (3, 3) in bb and (11, 3) not in bb
        assert len(bb.sparse_mask) == 80
        with pytest.raises(ValueError, match="integers"):
            G.BoundingBox(0.5, 9, 0, 7)
        hull = G.BoundingConvexHull([[0, 0], [10, 0], [10, 8], [0, 8]])
        aabb = F.AxisAlignedBoundingBox(hull)
        assert isinstance(aabb, G.BoundingBox)
        sq = F.AxisAlignedBoundingBox(hull, square=True)
        nx, ny = sq.box_npx
        assert abs(nx - ny) <= 1
        split = F.SplitBox(aabb, nsubboxes=2)
        assert len(split) == 4
        assert (sum(b.box_npx[0] * b.box_npx[1] for b in split)
                >= aabb.box_npx[0] * aabb.box_npx[1])
        padded = F.PadBox(aabb, 21, 21)
        assert padded.box_npx == (21, 21)
        with pytest.raises(ValueError, match="bigger"):
            F.PadBox(aabb, 2, 2)
        return [aabb.corners, sq.corners, padded.corners] + [
            b.corners for b in split]
    _both(case)


def test_port_regional_data_and_project():
    def case(G):
        cube = np.random.default_rng(42).normal(size=(1, 1, 20, 24))
        bb1 = G.BoundingBox(0, 11, 0, 9, "a")
        bb2 = G.BoundingBox(12, 23, 10, 19, "b")
        r1, _ = G.BoundingConvexHull.regional_data(bb1, cube, axes=(2, 3))
        r2, _ = G.BoundingConvexHull.regional_data(bb2, cube, axes=(2, 3))
        assert r1.shape == (1, 1, 10, 12)
        np.testing.assert_allclose(r1[0, 0], cube[0, 0, :10, :12], rtol=1e-12)
        stitched, combined = G.BoundingBox.project_regions([r1, r2], [bb1, bb2])
        assert stitched.shape == (1, 1, 20, 24)
        np.testing.assert_allclose(stitched[0, 0, :10, :12], cube[0, 0, :10, :12],
                                   rtol=1e-12)
        np.testing.assert_allclose(stitched[0, 0, 10:, 12:], cube[0, 0, 10:, 12:],
                                   rtol=1e-12)
        np.testing.assert_allclose(stitched[0, 0, 10:, :12], 0.0)
        return r1, r2, stitched, combined.corners
    _both(case)


def test_port_normalize_masks():
    def case(G):
        b1, b2 = G.BoundingBox(0, 5, 0, 5), G.BoundingBox(3, 8, 0, 5)
        G.BoundingConvexHull.normalize_masks([b1, b2])
        np.testing.assert_allclose(b1.mask[:, :3], 1.0)
        np.testing.assert_allclose(b1.mask[:, 3:], 0.5)
        return b1.mask, b2.mask
    _both(case)
