"""Host-side geometry: oriented-bbox crops of NeRF-MVL point clouds
(copy of lidarnerf_tpu/utils/geometry.py, numpy).

`filter_bbox_dataset` keeps the points of a cloud inside an OBB: between its
lowest and highest corner in z, and inside the quadrilateral of its four
lowest corners in the xy-plane (an even-odd crossing test; points on an
edge or at a vertex count as inside).
"""

import numpy as np


def sort_quadrilateral(points):
    """Order 4 corners TL, TR, BR, BL."""
    pts = [list(p) for p in points]
    top_left = min(pts, key=lambda p: p[0] + p[1])
    bottom_right = max(pts, key=lambda p: p[0] + p[1])
    pts.remove(top_left)
    pts.remove(bottom_right)
    bottom_left, top_right = pts
    if bottom_left[1] > top_right[1]:
        bottom_left, top_right = top_right, bottom_left
    return np.array([top_left, top_right, bottom_right, bottom_left])


def points_in_poly(px, py, poly):
    """Even-odd crossing test of the points (px, py) against `poly` [n, 2];
    a point at a vertex or on an edge is inside."""
    px = np.asarray(px)
    py = np.asarray(py)
    inside = np.zeros(px.shape, bool)
    on_edge = np.zeros(px.shape, bool)
    n = len(poly)
    for i in range(n):
        x1, y1 = poly[i]
        x2, y2 = poly[(i + 1) % n]
        on_edge |= ((px == x1) & (py == y1)) | ((px == x2) & (py == y2))
        cond = (np.minimum(y1, y2) < py) & (py <= np.maximum(y1, y2))
        with np.errstate(divide="ignore", invalid="ignore"):
            x = x1 + (py - y1) * (x2 - x1) / (y2 - y1)
        on_edge |= cond & (x == px)
        inside ^= cond & (x > px)
    return inside | on_edge


def filter_bbox_dataset(pc, OBB_local):
    """Crop a point cloud to an oriented bbox (z-range + 2-D polygon).

    Args:
        pc: [N, 3] points.
        OBB_local: [8, 3] local-frame OBB corners.
    """
    pc = np.asarray(pc)
    OBB_local = np.asarray(OBB_local)
    z_min, z_max = OBB_local[:, 2].min(), OBB_local[:, 2].max()
    mask = (pc[:, 2] <= z_max) & (pc[:, 2] >= z_min)
    pc = pc[mask]
    obb_sorted = np.array(sorted(OBB_local.tolist(), key=lambda p: p[2]))
    poly = sort_quadrilateral(obb_sorted[:4, :2])
    keep = points_in_poly(pc[:, 0], pc[:, 1], poly)
    return pc[keep]
