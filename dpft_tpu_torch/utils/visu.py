"""Visualization utilities (matplotlib; no open3d dependency).

Functional equivalents of the full reference visualization surface
(src/dprt/utils/visu.py:14-552): TUM colormaps + scalar2rgba, camera images
with projected boxes, lidar point clouds (matplotlib 3D instead of open3d),
2D lidar-point overlays, the 3D radar-cube view (matplotlib 3D scatter
instead of the open3d voxel grid), 2D radar grids in polar or cartesian
layout with point/box overlays, and the top-level tesseract dispatcher.

Every top-level entry point takes ``dst``: when given, the figure is saved
to that file instead of shown (reference visu.py:57-77 save semantics).
Functions additionally return (fig, ax) for composition and testing.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from dpft_tpu_torch.utils.geometry import get_box_corners
from dpft_tpu_torch.utils.project import cart2spher, polar2cart, spher2cart

# Edges of the ground-anchored corner convention (utils/geometry.py).
_BOX_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 0),
    (4, 5), (5, 6), (6, 7), (7, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]

_TUM_BLUE = (0.0, 0.2, 0.34901960784313724)


def _tum_cm():
    """TUM blue-to-white linear colormap (reference visu.py:15-17)."""
    from matplotlib.colors import LinearSegmentedColormap

    return LinearSegmentedColormap.from_list(
        "tum", [_TUM_BLUE, (1.0, 1.0, 1.0)], N=100)


def get_tum_accent_cm():
    """TUM accent colors for class-colored boxes (reference visu.py:20-26)."""
    from matplotlib.colors import ListedColormap

    return ListedColormap(np.array([
        [162, 173, 0],
        [227, 114, 34],
        [152, 198, 234],
        [218, 215, 203],
    ]) / 255)


def scalar2rgba(scalars: np.ndarray, cm=None,
                norm: bool = True) -> np.ndarray:
    """Maps (n,) scalars to (n, 4) RGBA via a colormap, optionally min-max
    normalized (reference visu.py:29-54)."""
    from matplotlib.cm import ScalarMappable
    from matplotlib.colors import Normalize

    scalars = np.asarray(scalars)
    normalizer = None
    if norm:
        normalizer = Normalize(vmin=np.min(scalars), vmax=np.max(scalars),
                               clip=True)
    return ScalarMappable(norm=normalizer, cmap=cm).to_rgba(scalars.ravel())


def _get_ax(ax=None, subplot_kw=None):
    import matplotlib.pyplot as plt

    if ax is not None:
        return ax.figure, ax
    return plt.subplots(subplot_kw=subplot_kw or {})


def _finish(fig, dst: Optional[str], show: bool):
    if dst is not None:
        fig.savefig(dst)
    elif show:
        fig.show()


def visu_camera_data(image: np.ndarray, boxes: Optional[np.ndarray] = None,
                     projection: Optional[np.ndarray] = None, ax=None,
                     show: bool = True, dst: Optional[str] = None):
    """Shows a camera image, optionally with projected 3D boxes.

    image: (H, W, 3) RGB or BGR uint8/float; boxes: (M, >=7) raw-format
    boxes [x, y, z, theta, l, w, h, ...]; projection: (3|4, 4) camera
    matrix mapping box-frame points to pixels. dst saves instead of
    showing (reference visu.py:57-77).
    """
    fig, ax = _get_ax(ax)
    img = np.asarray(image)
    if img.dtype != np.uint8 and img.size and float(img.max()) > 1.0:
        # 0-255-ranged floats are cast for imshow; [0, 1]-normalized
        # floats pass through (imshow handles them natively — clipping
        # them to uint8 would render a black image).
        img = np.clip(img, 0, 255).astype(np.uint8)
    ax.imshow(img)
    ax.set_axis_off()

    if boxes is not None and projection is not None and len(boxes):
        corners = get_box_corners(boxes)  # (M, 8, 3)
        homo = np.concatenate(
            [corners, np.ones((*corners.shape[:2], 1))], axis=-1)
        proj = np.einsum("ij,mkj->mki", projection[:3, :4], homo)
        w = np.where(proj[..., 2] == 0, 1.0, proj[..., 2])
        u, v = proj[..., 0] / w, proj[..., 1] / w
        for m in range(corners.shape[0]):
            if np.any(proj[m, :, 2] <= 0):
                continue
            for a, b in _BOX_EDGES:
                ax.plot([u[m, a], u[m, b]], [v[m, a], v[m, b]],
                        color="lime", linewidth=1)
    _finish(fig, dst, show)
    return fig, ax


def visu_lidar_data(points: np.ndarray, boxes: Optional[np.ndarray] = None,
                    xlim: Sequence[float] = (-100, 100),
                    ylim: Sequence[float] = (-100, 100), cm=None, ax=None,
                    show: bool = True, dst: Optional[str] = None):
    """3D scatter of a lidar cloud (N, >=4), intensity-colored with the TUM
    colormap, with class-colored boxes (reference visu.py:79-148; open3d
    window replaced by a matplotlib 3D axis)."""
    fig, ax = _get_ax(ax, subplot_kw={"projection": "3d"})
    pts = np.asarray(points)
    keep = ((pts[:, 0] > xlim[0]) & (pts[:, 0] < xlim[1])
            & (pts[:, 1] > ylim[0]) & (pts[:, 1] < ylim[1]))
    pts = pts[keep]
    intensity = pts[:, 3] if pts.shape[1] > 3 else pts[:, 2]
    rgba = scalar2rgba(intensity, cm=cm if cm is not None else _tum_cm())
    ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c=rgba, s=0.5)

    if boxes is not None and len(boxes):
        boxes = np.asarray(boxes)
        accent = get_tum_accent_cm()
        corners = get_box_corners(boxes)
        for m in range(corners.shape[0]):
            color = (accent(int(boxes[m, 7])) if boxes.shape[1] > 7
                     else "red")
            for a, b in _BOX_EDGES:
                ax.plot(*zip(corners[m, a], corners[m, b]), color=color,
                        linewidth=1)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    _finish(fig, dst, show)
    return fig, ax


def visu_2d_lidar_points(ax, points: np.ndarray, dims: Tuple[int, int],
                         roi: Optional[Tuple[float, float, float, float]]
                         = None,
                         cart: bool = True, r_max: Optional[float] = None,
                         flip: bool = True) -> None:
    """Scatters lidar points onto an existing 2D radar axis
    (reference visu.py:150-195).

    dims are (x=0, y=1, z=2) component indices of the plotted plane. With
    roi, points are filtered in spherical coordinates (r/azimuth/elevation
    degrees, the radar raster space); with cart=False they stay spherical
    for plotting, optionally pinned to the r_max shell.
    """
    pts = np.array(points[:, :4], dtype=float)

    def to_spher(p):
        r, phi, roh = cart2spher(p[:, 0], p[:, 1], p[:, 2], degrees=True)
        if r_max is not None:
            r = np.full_like(r, r_max)
        return np.column_stack([r, phi, roh, p[:, 3]])

    def to_cart(p):
        x, y, z = spher2cart(p[:, 0], p[:, 1], p[:, 2], degrees=True)
        return np.column_stack([x, y, z, p[:, 3]])

    if roi is not None:
        # Filter in spherical raster space; the r_max pin survives the
        # round-trip, moving points onto the shell (reference
        # visu.py:174-180 semantics).
        sph = to_spher(pts)
        keep = ((sph[:, dims[0]] > roi[0]) & (sph[:, dims[0]] < roi[1])
                & (sph[:, dims[1]] > roi[2]) & (sph[:, dims[1]] < roi[3]))
        pts = to_cart(sph[keep])

    if not cart:
        pts = to_spher(pts)

    u = pts[:, dims[0]].copy()
    v = pts[:, dims[1]]
    if not flip:
        u = -u
    ax.scatter(u, v, s=0.2, c="black")


def visu_3d_radar_data(cube: np.ndarray, dims: str,
                       raster: Optional[List[np.ndarray]] = None,
                       cart: bool = False, cm=None, ax=None,
                       show: bool = True, dst: Optional[str] = None,
                       **kwargs):
    """3D view of a radar cube (N, M, K): one colored marker per cell
    (reference visu.py:196-264; the open3d voxel grid becomes a matplotlib
    3D scatter).

    raster holds the grid values of the three kept dimensions; with
    cart=True the data must be in 'rae' order (range, azimuth-deg,
    elevation-deg) and is resampled into cartesian x/y/z.
    """
    if cart and dims != "rae":
        raise ValueError(
            f"A cartesian transformation needs 'rae'-ordered data, got "
            f"{dims!r}.")

    cube = np.asarray(cube)
    if raster is not None:
        axes = [np.asarray(r) for r in raster]
    else:
        axes = [np.arange(n) for n in cube.shape]
    x, y, z = np.meshgrid(*axes, indexing="ij")

    if cart:
        x, y, z = spher2cart(x.ravel(), y.ravel(), z.ravel(), degrees=True)
    else:
        x, y, z = x.ravel(), y.ravel(), z.ravel()

    rcs = 10.0 * np.log10(cube).ravel()
    rgba = scalar2rgba(rcs, cm=cm if cm is not None else _tum_cm())

    fig, ax = _get_ax(ax, subplot_kw={"projection": "3d"})
    ax.scatter(x, y, z, c=rgba, s=1.0, marker="s")
    ax.set_xlabel(dims[0] if not cart else "x [m]")
    ax.set_ylabel(dims[1] if not cart else "y [m]")
    ax.set_zlabel(dims[2] if not cart else "z [m]")
    _finish(fig, dst, show)
    return fig, ax


def visu_2d_boxes(ax, boxes: np.ndarray, dims: Tuple[int, int],
                  cart: bool = True, r_max: Optional[float] = None,
                  flip: bool = False) -> None:
    """Draws boxes onto a 2D radar axis with spherically-curved edges
    (reference visu.py:265-347).

    Each box footprint edge is sampled at 50 points, mapped through
    cart2spher (optionally pinned to the r_max shell) and - for cartesian
    axes - back through spher2cart, so edges curve correctly in polar
    views. dims are sorted (x=0, y=1, z=2) component indices; boxes carry
    the class id at column -2 for the accent colormap.
    """
    boxes = np.asarray(boxes)
    M = boxes.shape[0]
    if M == 0:
        return
    dims = sorted(dims)
    res = 50

    corners3d = get_box_corners(boxes)  # (M, 8, 3), bottom 4 first
    if 0 in dims:
        quad = corners3d[:, :4, :]
    else:
        # Front view: span the azimuth extremes of bottom and top faces.
        rows = np.arange(M)
        quad = np.stack([
            corners3d[rows, np.argmin(corners3d[:, :4, dims[0]], axis=-1)],
            corners3d[rows, np.argmax(corners3d[:, :4, dims[0]], axis=-1)],
            corners3d[rows,
                      4 + np.argmax(corners3d[:, 4:, dims[0]], axis=-1)],
            corners3d[rows,
                      4 + np.argmin(corners3d[:, 4:, dims[0]], axis=-1)],
        ], axis=1)

    if flip:
        quad = quad.copy()
        quad[:, :, 1] *= -1

    # Sample every footprint edge: (M, 4 edges, res, 3)
    start = quad                                   # (M, 4, 3)
    end = np.roll(quad, -1, axis=1)
    t = np.linspace(0.0, 1.0, res)[None, None, :, None]
    pts = start[:, :, None, :] * (1 - t) + end[:, :, None, :] * t

    r, phi, roh = cart2spher(pts[..., 0].ravel(), pts[..., 1].ravel(),
                             pts[..., 2].ravel(), degrees=True)
    if r_max is not None:
        r = np.full_like(r, r_max)
    edges = np.stack([r, phi, roh], axis=-1).reshape(M, 4, res, 3)

    if cart:
        x, y, z = spher2cart(edges[..., 0].ravel(), edges[..., 1].ravel(),
                             edges[..., 2].ravel(), degrees=True)
        edges = np.stack([x, y, z], axis=-1).reshape(M, 4, res, 3)

    accent = get_tum_accent_cm()
    for m in range(M):
        color = accent(int(boxes[m, -2]))
        for e in range(4):
            u = edges[m, e, :, dims[1]] if flip else edges[m, e, :, dims[0]]
            v = edges[m, e, :, dims[0]] if flip else edges[m, e, :, dims[1]]
            ax.plot(u, v, color=color)


def visu_2d_radar_grid(ax, grid: np.ndarray,
                       raster: Optional[List[np.ndarray]] = None,
                       cart: bool = False, dims: str = "ra",
                       r_max: float = 1.0, cm=None,
                       flip: bool = False) -> None:
    """pcolormesh of a 2D radar grid (N, M) in dB, in raster, polar->cart,
    or spherical-shell layout (reference visu.py:348-400)."""
    import matplotlib.pyplot as plt

    grid = np.asarray(grid)
    if flip:
        grid = grid.T
        raster = list(reversed(raster)) if raster is not None else None

    # Explicit CELL EDGES (cell count + 1 per axis): matplotlib warns on
    # center coordinates whenever the transformed mesh is non-monotonic
    # (always the case for the polar->cartesian projections below) and
    # mis-places the cells; edges computed in raster space and then
    # projected are exact. The reference's +1 edge mesh (visu.py:363-367)
    # has the same intent but crashes matplotlib on the raster path.
    def centers_to_edges(c: np.ndarray) -> np.ndarray:
        c = np.asarray(c, dtype=np.float64)
        if c.size == 1:
            return np.array([c[0] - 0.5, c[0] + 0.5])
        mid = (c[:-1] + c[1:]) / 2.0
        return np.concatenate(([2 * c[0] - mid[0]], mid,
                               [2 * c[-1] - mid[-1]]))

    if raster is not None:
        x_edges = centers_to_edges(np.asarray(raster[0]))
        y_edges = centers_to_edges(np.asarray(raster[1]))
    else:
        x_edges = np.arange(grid.shape[0] + 1) - 0.5
        y_edges = np.arange(grid.shape[1] + 1) - 0.5
    x_mesh, y_mesh = np.meshgrid(x_edges, y_edges)

    if cart and dims in {"ra", "ar"}:
        shape = x_mesh.shape
        x_mesh, y_mesh = polar2cart(x_mesh.ravel(), y_mesh.ravel(),
                                    degrees=True)
        x_mesh, y_mesh = x_mesh.reshape(shape), y_mesh.reshape(shape)
    elif cart and dims in {"ae", "ea"}:
        shape = x_mesh.shape
        _, y_flat, x_flat = spher2cart(
            np.full(x_mesh.size, r_max), y_mesh.ravel(), x_mesh.ravel(),
            degrees=True)
        x_mesh, y_mesh = x_flat.reshape(shape), y_flat.reshape(shape)

    rcs = 10.0 * np.log10(grid)
    if flip:
        p = ax.pcolormesh(-y_mesh, x_mesh, rcs.T, cmap=cm, shading="flat")
    else:
        p = ax.pcolormesh(x_mesh, y_mesh, rcs.T, cmap=cm, shading="flat")
    plt.colorbar(p, ax=ax, label="Power in dB")


def visu_2d_radar_data(grid: np.ndarray, dims: str,
                       boxes: Optional[np.ndarray] = None,
                       points: Optional[np.ndarray] = None,
                       raster: Optional[List[np.ndarray]] = None,
                       roi: bool = True,
                       label: Optional[Tuple[str, str]] = None,
                       cart: bool = False, r_max: float = 1.0, cm=None,
                       ax=None, dst: Optional[str] = None,
                       show: bool = True, **kwargs):
    """2D radar grid figure with optional lidar-point and box overlays
    (reference visu.py:402-492)."""
    valid_dims = {"ra", "ar", "ae", "ea"}
    if cart and dims not in valid_dims:
        raise ValueError(
            f"Cartesian projection requires spatial, non-perpendicular "
            f"dims ({valid_dims}), got {dims!r}.")

    # Component indices exist only for spatial dims; non-spatial grids
    # (e.g. 'dr') are fine as long as no overlay needs them (the
    # reference's xyz is a lazy generator with the same effect).
    dims_to_xyz = {"r": 0, "a": 1, "e": 2}

    def xyz():
        return tuple(dims_to_xyz[d] for d in dims)

    flip = dims in {"ar", "ea"}
    shell_r = r_max if "e" in dims else None

    fig, ax = _get_ax(ax)
    cm = cm if cm is not None else "viridis"

    visu_2d_radar_grid(ax=ax, grid=grid, raster=raster, cart=cart,
                       dims=dims, r_max=shell_r, cm=cm, flip=flip)

    roi_bounds = None
    if roi and raster is not None:
        roi_bounds = (np.min(raster[0]), np.max(raster[0]),
                      np.min(raster[1]), np.max(raster[1]))

    if points is not None:
        visu_2d_lidar_points(ax, points, dims=xyz(), roi=roi_bounds,
                             cart=cart, r_max=shell_r, flip=not flip)
    if boxes is not None:
        visu_2d_boxes(ax, boxes, dims=xyz(), cart=cart, r_max=shell_r,
                      flip=flip)

    if label is not None:
        ax.set_xlabel(label[0])
        ax.set_ylabel(label[1])
    ax.axis("equal")
    _finish(fig, dst, show)
    return fig, ax


def visu_radar_data(plane: np.ndarray, channel: int = 0, ax=None,
                    show: bool = True, dst: Optional[str] = None):
    """Shows one channel of a processed RA/EA radar plane (H, W, C)."""
    fig, ax = _get_ax(ax)
    im = ax.imshow(np.asarray(plane)[..., channel], origin="lower",
                   aspect="auto", cmap="viridis")
    fig.colorbar(im, ax=ax)
    _finish(fig, dst, show)
    return fig, ax


def visu_radar_tesseract(tesseract: np.ndarray, dims: str,
                         raster: Dict[str, np.ndarray],
                         aggregation_func: Callable = np.max,
                         **kwargs):
    """Reduces the (doppler, range, elevation, azimuth) tesseract to the
    kept dims and dispatches to the 2D or 3D view (reference
    visu.py:493-552).

    dims: 2 or 3 characters of {'d', 'r', 'e', 'a'}, in plot order; the
    remaining axes are reduced with aggregation_func on the linear-power
    tesseract (dB conversion happens at plot time).
    """
    order = "drea"
    names_map = {"d": "doppler", "r": "range", "e": "elevation",
                 "a": "azimuth"}
    if not 1 < len(dims) < 4 or any(d not in order for d in dims):
        raise ValueError(
            f"dims must be 2 or 3 characters of {{d, r, e, a}}, got "
            f"{dims!r}.")

    tesseract = np.asarray(tesseract)
    r_max = float(np.max(raster["r"])) if "r" in raster else 1.0
    axis_raster = [np.asarray(raster[d]) for d in dims]

    kept_idx = [order.index(d) for d in dims]
    reduce_axes = tuple(i for i in range(4) if i not in kept_idx)
    data = aggregation_func(tesseract, axis=reduce_axes)
    # After reduction axes keep tesseract order; rearrange to dims order.
    data = np.moveaxis(data, np.arange(data.ndim), np.argsort(kept_idx))

    if len(dims) == 3:
        return visu_3d_radar_data(cube=data, dims=dims, raster=axis_raster,
                                  cm=_tum_cm(), **kwargs)
    return visu_2d_radar_data(
        grid=data, dims=dims, raster=axis_raster, r_max=r_max,
        label=tuple(names_map[d] for d in dims), cm=_tum_cm(), **kwargs)
