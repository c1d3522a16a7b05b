"""Figures drawn without a plotting library: a colour table, panel grids
and rasterised polylines, as uint8 RGB arrays for utils/imageio.write_png.

The card's host has no matplotlib, imageio or PIL, so the port draws the
JAX package's figures itself (render_img's 2x3 comparison, the ATE
trajectory plot, tools/viz.plot_trajectory): the same data, without
titles, axes, legends or fonts.
"""

from __future__ import annotations

import numpy as np

# matplotlib's 'plasma' colormap at its 256 entries, as uint8 RGB
# (round(255 * c)), row-major hex
_PLASMA_HEX = (
    "0d088710078813078916078a19068c1b068d1d068e20068f220690240691260591280592"
    "2a05932c05942e05952f059631059733059735049837049938049a3a049a3c049b3e049c"
    "3f049c41049d43039e44039e46039f48039f4903a04b03a14c02a14e02a25002a25102a3"
    "5302a35502a45601a45801a45901a55b01a55c01a65e01a66001a66100a76300a76400a7"
    "6600a76700a86900a86a00a86c00a86e00a86f00a87100a87201a87401a87501a87701a8"
    "7801a87a02a87b02a87d03a87e03a88004a88104a78305a78405a78606a68707a68808a6"
    "8a09a58b0aa58d0ba58e0ca48f0da4910ea3920fa39410a29511a19613a19814a099159f"
    "9a169f9c179e9d189d9e199da01a9ca11b9ba21d9aa31e9aa51f99a62098a72197a82296"
    "aa2395ab2494ac2694ad2793ae2892b02991b12a90b22b8fb32c8eb42e8db52f8cb6308b"
    "b7318ab83289ba3388bb3488bc3587bd3786be3885bf3984c03a83c13b82c23c81c33d80"
    "c43e7fc5407ec6417dc7427cc8437bc9447aca457acb4679cc4778cc4977cd4a76ce4b75"
    "cf4c74d04d73d14e72d24f71d35171d45270d5536fd5546ed6556dd7566cd8576bd9586a"
    "da5a6ada5b69db5c68dc5d67dd5e66de5f65de6164df6263e06363e16462e26561e26660"
    "e3685fe4695ee56a5de56b5de66c5ce76e5be76f5ae87059e97158e97257ea7457eb7556"
    "eb7655ec7754ed7953ed7a52ee7b51ef7c51ef7e50f07f4ff0804ef1814df1834cf2844b"
    "f3854bf3874af48849f48948f58b47f58c46f68d45f68f44f79044f79143f79342f89441"
    "f89540f9973ff9983ef99a3efa9b3dfa9c3cfa9e3bfb9f3afba139fba238fca338fca537"
    "fca636fca835fca934fdab33fdac33fdae32fdaf31fdb130fdb22ffdb42ffdb52efeb72d"
    "feb82cfeba2cfebb2bfebd2afebe2afec029fdc229fdc328fdc527fdc627fdc827fdca26"
    "fdcb26fccd25fcce25fcd025fcd225fbd324fbd524fbd724fad824fada24f9dc24f9dd25"
    "f8df25f8e125f7e225f7e425f6e626f6e826f5e926f5eb27f4ed27f3ee27f3f027f2f227"
    "f1f426f1f525f0f724f0f921")
PLASMA = np.frombuffer(bytes.fromhex("".join(_PLASMA_HEX)),
                       np.uint8).reshape(256, 3)

BLACK = (0, 0, 0)
BLUE = (0, 0, 255)
# the trajectory canvas (pixels) and its margin
PLOT_SIZE = 480
PLOT_MARGIN = 16


def colormap(img: np.ndarray, vmin: float, vmax: float) -> np.ndarray:
    """[H, W] values -> [H, W, 3] uint8 through PLASMA, as matplotlib maps
    a normalised value x: entry floor(256 x), below 0 the first entry, at 1
    and above the last; NaN reads as vmin."""
    x = (np.nan_to_num(np.asarray(img, np.float64), nan=vmin) - vmin) \
        / (vmax - vmin)
    idx = np.clip(np.floor(x * len(PLASMA)), 0, len(PLASMA) - 1)
    return PLASMA[idx.astype(np.int64)]


def to_u8(rgb: np.ndarray) -> np.ndarray:
    """RGB in [0, 1] (clipped) -> uint8, rounded."""
    return (np.clip(np.asarray(rgb, np.float64), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8)


def panel_grid(panels, cols: int) -> np.ndarray:
    """Equal-shape uint8 [h, w, 3] panels, row-major, tiled `cols` wide."""
    rows = [np.concatenate(panels[i:i + cols], 1)
            for i in range(0, len(panels), cols)]
    return np.concatenate(rows, 0)


def draw_polyline(canvas: np.ndarray, cols: np.ndarray, rows: np.ndarray,
                  color) -> None:
    """Set the pixels of the polyline through (cols[i], rows[i]) (pixel
    coordinates, float) in `canvas` [H, W, 3], one step per pixel of each
    segment's longer side."""
    h, w = canvas.shape[:2]
    c = np.asarray(cols, np.float64)
    r = np.asarray(rows, np.float64)
    for c0, r0, c1, r1 in zip(c[:-1], r[:-1], c[1:], r[1:]):
        n = max(int(np.ceil(max(abs(c1 - c0), abs(r1 - r0)))), 1)
        t = np.arange(n + 1) / n
        cc = np.rint(c0 + (c1 - c0) * t).astype(np.int64)
        rr = np.rint(r0 + (r1 - r0) * t).astype(np.int64)
        keep = (cc >= 0) & (cc < w) & (rr >= 0) & (rr < h)
        canvas[rr[keep], cc[keep]] = color


def comparison_panels(gt_depth, gt_rgb, color, depth):
    """The six panels of render_img (the JAX package's masking and
    clipping): ([input depth, rendered depth, depth residual, input rgb,
    rendered rgb, rgb residual], vmax of the depth panels); rendered depth
    and both residuals are 0 where the input depth is 0."""
    gt_depth = np.asarray(gt_depth)
    gt_rgb = np.asarray(gt_rgb)
    hole = gt_depth == 0
    depth_res = np.abs(gt_depth - depth)
    depth_res[hole] = 0
    color_res = np.clip(np.abs(gt_rgb - color), 0, 1)
    color_res[hole] = 0
    depth = depth.copy()
    depth[hole] = 0
    vmax = max(float(gt_depth.max()), 1e-3)
    return [gt_depth, depth, depth_res, np.clip(gt_rgb, 0, 1),
            np.clip(color, 0, 1), color_res], vmax


def comparison_figure(panels, vmax: float) -> np.ndarray:
    """comparison_panels as one uint8 image: the depth panels through
    plasma (0 to vmax) above the colour panels, 2 x 3."""
    return panel_grid([colormap(p, 0.0, vmax) for p in panels[:3]]
                      + [to_u8(p) for p in panels[3:]], 3)


def plot_polylines(lines) -> np.ndarray:
    """[(x, y, color), ...] world coordinates -> a white PLOT_SIZE^2 uint8
    canvas with every line drawn, x to the right and y up, one scale on
    both axes fitting all points inside PLOT_MARGIN."""
    canvas = np.full((PLOT_SIZE, PLOT_SIZE, 3), 255, np.uint8)
    xs = np.concatenate([np.asarray(x, np.float64) for x, _, _ in lines])
    ys = np.concatenate([np.asarray(y, np.float64) for _, y, _ in lines])
    x0, x1, y0, y1 = xs.min(), xs.max(), ys.min(), ys.max()
    span = PLOT_SIZE - 2 * PLOT_MARGIN - 1
    s = span / max(x1 - x0, y1 - y0, 1e-9)
    cx = PLOT_MARGIN + 0.5 * (span - s * (x1 - x0))
    cy = PLOT_MARGIN + 0.5 * (span - s * (y1 - y0))
    for x, y, color in lines:
        draw_polyline(canvas, cx + s * (np.asarray(x) - x0),
                      PLOT_SIZE - 1 - (cy + s * (np.asarray(y) - y0)), color)
    return canvas
