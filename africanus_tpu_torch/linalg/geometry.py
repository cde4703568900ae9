"""Facet geometry: bounding convex hulls and axis-aligned boxes.

Host-side equivalents of reference ``africanus/linalg/geometry.py``
(BoundingConvexHull:33, BoundingBox:453, BoundingBoxFactory:610), used to
slice facet regions out of image cubes and stitch them back. Pixel masks
are sparse lists of (y, x) integer coordinates with per-pixel weights so
overlapping facets can be coadded with normalised contributions.

This is pure host geometry (scipy ConvexHull); device code never sees it —
facet selection produces plain index arrays.

A copy of ``africanus_tpu/linalg/geometry.py``
(the port imports nothing of the JAX package).
"""

from __future__ import annotations

import copy

import numpy as np

__all__ = ["BoundingConvexHull", "BoundingBox", "BoundingBoxFactory"]


class BoundingConvexHull:
    """Convex hull of a set of points / hulls with a sparse pixel mask."""

    @staticmethod
    def _gather_vertices(hulls_or_points):
        """Flatten a mixed list of hulls / (x, y) pairs into an (n, 2)
        vertex array: hull-like items contribute their corner sets,
        bare pairs contribute one row each."""
        rows = []
        for item in hulls_or_points:
            corners = getattr(item, "corners", None)
            if corners is None:
                corners = np.asarray([item[0], item[1]], float)
            rows.append(np.atleast_2d(corners))
        return np.concatenate(rows, axis=0)

    def __init__(self, list_hulls, name="unnamed", mask=None,
                 check_mask_outofbounds=True):
        from scipy import spatial

        verts = self._gather_vertices(list_hulls)
        hull = spatial.ConvexHull(verts)

        self._name = name
        self._cached_filled_mask = None
        self._check_mask_outofbounds = check_mask_outofbounds
        self._vertices = verts
        self._hull = hull
        if mask is not None:
            self.sparse_mask = mask  # validated (+ filtered) by the setter
        else:
            self._mask, self._mask_weights = self.init_mask()

    # -- mask construction -------------------------------------------------
    def _extent(self):
        c = self.corners
        return (
            int(np.min(c[:, 0])),
            int(np.max(c[:, 0])),
            int(np.min(c[:, 1])),
            int(np.max(c[:, 1])),
        )

    def init_mask(self):
        """Sparse (y, x) mask of pixels inside the hull."""
        minx, maxx, miny, maxy = self._extent()
        xs = np.arange(minx, maxx + 1)
        ys = np.arange(miny, maxy + 1)
        yy, xx = np.meshgrid(ys, xs, indexing="ij")
        cells = list(zip(yy.ravel().tolist(), xx.ravel().tolist()))
        if self._check_mask_outofbounds:
            cells = [c for c in cells if (c[1], c[0]) in self]
        return cells, np.ones(len(cells))

    def invalidate_cached_masks(self):
        self._cached_filled_mask = None
        self._mask, self._mask_weights = self.init_mask()

    @property
    def sparse_mask(self):
        return self._mask

    @sparse_mask.setter
    def sparse_mask(self, mask):
        if not isinstance(mask, (list, np.ndarray)):
            raise TypeError("Mask must be list")
        if len(mask) > 0 and (not hasattr(mask[0], "__len__") or len(mask[0]) != 2):
            raise TypeError("sparse mask entries must be (y, x) pairs")
        if self._check_mask_outofbounds:
            self._mask = copy.deepcopy(
                [tuple(c) for c in mask if (c[1], c[0]) in self]
            )
        else:
            self._mask = copy.deepcopy([tuple(c) for c in mask])
        self._mask_weights = np.ones(len(self._mask))

    @property
    def sparse_mask_weights(self):
        return self._mask_weights

    # keep the reference's (typo'd) accessor name for API parity
    sprase_mask_weights = sparse_mask_weights

    @property
    def mask(self):
        """Filled rectangular (ny, nx) weight mask over the hull extent."""
        if self._cached_filled_mask is not None:
            return self._cached_filled_mask
        minx, maxx, miny, maxy = self._extent()
        nx, ny = maxx - minx + 1, maxy - miny + 1
        mesh = np.zeros(ny * nx)
        if nx > 0 and ny > 0 and len(self._mask) > 0:
            sm = np.array(self._mask)
            sel = (
                (sm[:, 1] >= minx)
                & (sm[:, 1] <= maxx)
                & (sm[:, 0] >= miny)
                & (sm[:, 0] <= maxy)
            )
            flat = (sm[sel][:, 0] - miny) * nx + (sm[sel][:, 1] - minx)
            mesh[flat] = self._mask_weights[sel]
        self._cached_filled_mask = mesh.reshape(ny, nx)
        return self._cached_filled_mask

    # -- region slicing ----------------------------------------------------
    @classmethod
    def regional_data(cls, sel_region, data_cube, axes=(2, 3), oob_value=0):
        """Slice the hull's bounding region out of ``data_cube`` along
        ``axes``, padding out-of-bounds areas with ``oob_value``.
        Returns (padded_data * filled_mask, window_extents)."""
        if not isinstance(sel_region, BoundingConvexHull):
            raise TypeError("argument must be a BoundingConvexHull instance")
        if not (hasattr(axes, "__len__") and len(axes) == 2):
            raise ValueError(
                "axes must be a length-2 sequence selecting the slice plane"
            )
        axes = sorted(axes)
        minx, maxx, miny, maxy = sel_region._extent()

        ny_im = data_cube.shape[axes[0]]
        nx_im = data_cube.shape[axes[1]]
        if minx > nx_im or miny > ny_im or maxx < 0 or maxy < 0:
            raise ValueError(
                "the bounding hull must overlap the image at least "
                "within the image"
            )

        pad_left = max(0, -minx)
        pad_bottom = max(0, -miny)
        pad_right = max(0, maxx - nx_im + 1)
        pad_top = max(0, maxy - ny_im + 1)

        slc = [slice(None)] * data_cube.ndim
        slc[axes[0]] = slice(miny + pad_bottom, maxy - pad_top + 1)
        slc[axes[1]] = slice(minx + pad_left, maxx - pad_right + 1)
        selected = data_cube[tuple(slc)]

        new_shape = list(data_cube.shape)
        new_shape[axes[0]] = maxy - miny + 1
        new_shape[axes[1]] = maxx - minx + 1
        # reference quirk preserved (geometry.py:219-222): the padding is
        # `zeros * oob_value`, i.e. zero for any finite oob_value (NaN
        # only for non-finite sentinels) — NOT filled with oob_value
        padded = np.zeros(tuple(new_shape), dtype=data_cube.dtype) * oob_value
        pslc = [slice(None)] * data_cube.ndim
        pslc[axes[0]] = slice(pad_bottom, maxy - miny + 1 - pad_top)
        pslc[axes[1]] = slice(pad_left, maxx - minx + 1 - pad_right)
        padded[tuple(pslc)] = selected

        # apply the filled weight mask over the sliced axes; in-extent
        # pixels OUTSIDE the hull take data * oob_value (the reference
        # substitutes oob_value for the mask zeros, geometry.py:252-254)
        mask = sel_region.mask.copy()
        mask[mask == 0] = oob_value
        shape = [1] * data_cube.ndim
        shape[axes[0]] = mask.shape[0]
        shape[axes[1]] = mask.shape[1]
        window = padded * mask.reshape(shape)
        return window, (minx, maxx, miny, maxy)

    @classmethod
    def normalize_masks(cls, regions, only_overlapped_regions=True):
        """Divide mask weights by the number of regions covering each pixel
        (painter's algorithm) so overlapping facets coadd to unity."""
        if not all(isinstance(r, BoundingConvexHull) for r in regions):
            raise TypeError("expected a sequence of BoundingConvexHull objects")
        from collections import Counter

        counts = Counter()
        for reg in regions:
            counts.update(map(tuple, reg.sparse_mask))

        for reg in regions:
            reg._cached_filled_mask = None
            for i, px in enumerate(map(tuple, reg.sparse_mask)):
                n = counts[px]
                if n > 1 or not only_overlapped_regions:
                    reg._mask_weights[i] = 1.0 / n

    # -- geometric properties ----------------------------------------------
    @property
    def circumference(self):
        lines = self.edges
        return np.sum(np.linalg.norm(lines[:, 1, :] - lines[:, 0, :], axis=1) + 1)

    @property
    def area(self):
        """Pixel-inclusive area (shoelace + half circumference − 1)."""
        c = self.corners
        nxt = np.roll(c, -1, axis=0)
        shoelace = 0.5 * np.abs(np.sum(c[:, 0] * nxt[:, 1] - nxt[:, 0] * c[:, 1]))
        return shoelace + 0.5 * self.circumference - 1

    @property
    def name(self):
        return self._name

    @name.setter
    def name(self, v):
        self._name = v

    @property
    def corners(self):
        """Hull vertices with clockwise winding."""
        return self._vertices[self._hull.vertices][::-1]

    def normals(self, left=True):
        out = []
        c = self.corners
        for i in range(c.shape[0]):
            edge = c[(i + 1) % c.shape[0]] - c[i]
            out.append((-edge[1], edge[0]) if left else (edge[1], -edge[0]))
        return np.asarray(out, dtype=np.double)

    @property
    def edges(self):
        c = self.corners
        return np.asarray(
            [(c[i], c[(i + 1) % c.shape[0]]) for i in range(c.shape[0])],
            dtype=np.double,
        )

    @property
    def edge_midpoints(self):
        return np.mean(self.edges, axis=1)

    @property
    def lnormals(self):
        return self.normals(left=True)

    @property
    def rnormals(self):
        return self.normals(left=False)

    def overlaps_with(self, other, min_sep_dist=0.5):
        """Separating-axis collision test against another hull."""
        if not isinstance(other, BoundingConvexHull):
            raise TypeError("right-hand side must be a BoundingConvexHull instance")
        normals = np.vstack([self.lnormals, other.lnormals])
        normals = normals / np.linalg.norm(normals, axis=1)[:, None]
        for n in normals:
            p1 = self.corners @ n
            p2 = other.corners @ n
            if (
                p2.min() - p1.max() > min_sep_dist
                or p1.min() - p2.max() > min_sep_dist
            ):
                return False
        return True

    @property
    def centre(self):
        """Integral barycentre of the hull vertices (truncated toward 0)."""
        return [
            int(np.floor(x) if x >= 0 else np.ceil(x))
            for x in np.mean(self._vertices, axis=0)
        ]

    def __contains__(self, s, tolerance=0.5):
        x, y = s
        xyvec = np.array([x, y])[None, :] - np.array(self.corners)
        dot = np.einsum("ij,ij->i", self.rnormals, xyvec)
        return bool(np.all(dot > -tolerance))

    def __str__(self):
        return ",".join(f"({x:d},{y:d})" for x, y in self.corners)


class BoundingBox(BoundingConvexHull):
    """Axis-aligned bounding box (reference ``linalg/geometry.py:453``):
    a :class:`BoundingConvexHull` whose corners are the integer pixel
    limits (xl, xu, yl, yu), inclusive on both ends. Supports the same
    mask/extraction protocol plus exact box splitting via
    :class:`BoundingBoxFactory`."""

    def __init__(self, xl, xu, yl, yu, name="unnamed", mask=None, **kwargs):
        if not all(
            isinstance(v, (int, np.integer)) for v in (xl, xu, yl, yu)
        ):
            raise ValueError("box limits must be integers (pixel coordinates)")
        self._box_npx = (abs(xu - xl + 1), abs(yu - yl + 1))
        super().__init__(
            [[xl, yl], [xl, yu], [xu, yu], [xu, yl]], name, mask=mask, **kwargs
        )

    def init_mask(self):
        minx, maxx, miny, maxy = self._extent()
        ys, xs = np.meshgrid(
            np.arange(miny, maxy + 1), np.arange(minx, maxx + 1), indexing="ij"
        )
        cells = np.stack([ys.ravel(), xs.ravel()], axis=1)
        return cells, np.ones(len(cells))

    def __contains__(self, s):
        minx, maxx, miny, maxy = self._extent()
        return minx <= s[0] <= maxx and miny <= s[1] <= maxy

    @property
    def box_npx(self):
        return self._box_npx

    @property
    def sparse_mask(self):
        return self._mask

    @sparse_mask.setter
    def sparse_mask(self, mask):
        if not isinstance(mask, (list, np.ndarray)):
            raise TypeError("Mask must be list")
        if len(mask) > 0 and (not hasattr(mask[0], "__len__") or len(mask[0]) != 2):
            raise TypeError("sparse mask entries must be (y, x) pairs")
        if len(mask) == 0:
            self._mask = []
            self._mask_weights = np.ones(0)
            return
        minx, maxx, miny, maxy = self._extent()
        sm = np.asarray(mask)
        sel = (
            (sm[:, 1] >= minx)
            & (sm[:, 1] <= maxx)
            & (sm[:, 0] >= miny)
            & (sm[:, 0] <= maxy)
        )
        self._mask = sm[sel]
        self._mask_weights = np.ones(len(self._mask))

    @classmethod
    def project_regions(cls, regional_data_list, regions_list, axes=(2, 3),
                        dtype=np.float64, **kwargs):
        """Stitch per-region cubes back into one contiguous cube."""
        if len(regional_data_list) != len(regions_list):
            raise TypeError(
                "region data and region lists must have equal "
                "length"
            )
        if not all(isinstance(x, np.ndarray) for x in regional_data_list):
            raise TypeError("region data entries must be numpy arrays")
        if not all(isinstance(x, BoundingBox) for x in regions_list):
            raise TypeError(
                "regions must be axis-aligned bounding boxes"
            )
        if len(regions_list) == 0:
            return np.empty((0,))

        axes = tuple(sorted(axes))
        minx = min(int(r.corners[:, 0].min()) for r in regions_list)
        maxx = max(int(r.corners[:, 0].max()) for r in regions_list)
        miny = min(int(r.corners[:, 1].min()) for r in regions_list)
        maxy = max(int(r.corners[:, 1].max()) for r in regions_list)
        npxx, npxy = maxx - minx + 1, maxy - miny + 1

        shape = list(regional_data_list[0].shape)
        shape[axes[0]] = npxy
        shape[axes[1]] = npxx
        stitched = np.zeros(tuple(shape), dtype=dtype)
        combined_mask = []
        for data, reg in zip(regional_data_list, regions_list):
            data = np.nan_to_num(data, nan=0.0)
            box_ny = int(reg.corners[:, 1].max() - reg.corners[:, 1].min()) + 1
            box_nx = int(reg.corners[:, 0].max() - reg.corners[:, 0].min()) + 1
            if (data.shape[axes[0]], data.shape[axes[1]]) != (box_ny, box_nx):
                # the reference raises when a region cube does not span
                # its bounding box (geometry.py project_regions shape
                # check) — silently corner-anchoring an undersized cube
                # would stitch a wrong image
                raise ValueError(
                    "Region data cube shape "
                    f"{(data.shape[axes[0]], data.shape[axes[1]])} does "
                    f"not match its bounding box extents {(box_ny, box_nx)}"
                )
            xl = int(reg.corners[:, 0].min()) - minx
            yl = int(reg.corners[:, 1].min()) - miny
            slc = [slice(None)] * stitched.ndim
            slc[axes[0]] = slice(yl, yl + data.shape[axes[0]])
            slc[axes[1]] = slice(xl, xl + data.shape[axes[1]])
            stitched[tuple(slc)] += data
            combined_mask += list(map(tuple, reg.sparse_mask))
        return stitched, BoundingBox(
            minx, maxx, miny, maxy, mask=combined_mask, **kwargs
        )


class BoundingBoxFactory:
    """Constructors deriving new :class:`BoundingBox` objects from
    existing hulls/boxes (reference ``linalg/geometry.py:610``):
    axis-aligned wrap, padded enlargement, and subdivision into a grid
    of child boxes."""

    @classmethod
    def AxisAlignedBoundingBox(cls, convex_hull_object, square=False,
                               enforce_odd=True, **kwargs):
        """Axis-aligned (optionally square / odd-sized) box around a hull."""
        if not isinstance(convex_hull_object, BoundingConvexHull):
            raise TypeError(
                "constructor argument must be an instance of "
                "BoundingConvexHull"
            )
        c = convex_hull_object.corners
        if square:
            nx = int(c[:, 0].max() - c[:, 0].min() + 1)
            ny = int(c[:, 1].max() - c[:, 1].min() + 1)
            boxdiam = max(nx, ny)
            boxrad = boxdiam // 2
            cx, cy = convex_hull_object.centre
            xl, xu = cx - boxrad, cx + boxdiam - boxrad - 1
            yl, yu = cy - boxrad, cy + boxdiam - boxrad - 1
        else:
            xl, xu = int(c[:, 0].min()), int(c[:, 0].max())
            yl, yu = int(c[:, 1].min()), int(c[:, 1].max())
        if enforce_odd:
            xu += (xu - xl) % 2
            yu += (yu - yl) % 2
        return BoundingBox(
            xl, xu, yl, yu, convex_hull_object.name,
            mask=convex_hull_object.sparse_mask, **kwargs,
        )

    @classmethod
    def SplitBox(cls, bounding_box_object, nsubboxes=1, **kwargs):
        """Split an axis-aligned box into an nsubboxes² grid of boxes."""
        if not isinstance(bounding_box_object, BoundingBox):
            raise TypeError("expected a BoundingBox instance")
        if not (isinstance(nsubboxes, int) and nsubboxes >= 1):
            raise ValueError("nsubboxes must be positive integers (1 or more)")
        c = bounding_box_object.corners
        xl, xu = int(c[:, 0].min()), int(c[:, 0].max())
        yl, yu = int(c[:, 1].min()), int(c[:, 1].max())
        stepx = int(np.ceil((xu - xl + 1) / float(nsubboxes)))
        stepy = int(np.ceil((yu - yl + 1) / float(nsubboxes)))
        x = xl + np.arange(nsubboxes + 1) * stepx
        y = yl + np.arange(nsubboxes + 1) * stepy

        boxes = []
        for j in range(nsubboxes):
            for i in range(nsubboxes):
                bxl, bxu = int(x[i]), int(x[i + 1]) - 1
                byl, byu = int(y[j]), int(y[j + 1]) - 1
                if i == nsubboxes - 1:
                    bxu = max(xu, min(bxu, xu))
                if j == nsubboxes - 1:
                    byu = max(yu, min(byu, yu))
                boxes.append(
                    BoundingBox(
                        bxl, bxu, byl, byu, bounding_box_object.name,
                        mask=bounding_box_object.sparse_mask, **kwargs,
                    )
                )
        return boxes

    @classmethod
    def PadBox(cls, bounding_box_object, desired_nx, desired_ny, **kwargs):
        """Pad a box to a desired size, centred on the original centre."""
        if not isinstance(bounding_box_object, BoundingBox):
            raise TypeError("expected a BoundingBox instance")
        nx, ny = bounding_box_object.box_npx
        if desired_nx - nx < 0 or desired_ny - ny < 0:
            raise ValueError("padded size must be at least the original (bigger or equal)")
        pad_left = desired_nx // 2
        pad_right = desired_nx - pad_left - 1
        pad_bottom = desired_ny // 2
        pad_top = desired_ny - pad_bottom - 1
        cx, cy = bounding_box_object.centre
        return BoundingBox(
            cx - pad_left, cx + pad_right, cy - pad_bottom, cy + pad_top,
            bounding_box_object.name,
            mask=bounding_box_object.sparse_mask, **kwargs,
        )
