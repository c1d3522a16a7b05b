"""Plain PyTorch reference of the two TSDF fusions, a frame into the
moving brick-major local volume and a keyframe into the global grid, and
of the moving volume's re-centre. The fusions sweep every voxel (the
program sweeps only the bricks or tiles its host selection picks), in
chunks.

Frozen copy of the arithmetic of remixfusion_tpu_torch/ops/tsdf.py
(_project, _fuse_local_update, _global_update, integrate_global's voxel
coordinates) at the revision this benchmark was written against. It
imports nothing of the program.

`dtype=torch.bfloat16` runs the per-voxel arithmetic in bfloat16 (state
and inputs rounded, results widened back): the control, the precision
below the configuration's float32.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 21


def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _project(px, py, pz, K, c2w):
    tx, ty, tz = px - c2w[0, 3], py - c2w[1, 3], pz - c2w[2, 3]
    cam_x = c2w[0, 0] * tx + c2w[1, 0] * ty + c2w[2, 0] * tz
    cam_y = c2w[0, 1] * tx + c2w[1, 1] * ty + c2w[2, 1] * tz
    cam_z = c2w[0, 2] * tx + c2w[1, 2] * ty + c2w[2, 2] * tz
    inv_z = 1.0 / torch.where(cam_z > 0, cam_z, torch.ones_like(cam_z))
    pix_x = torch.round(_fma(K[0, 0] * cam_x, inv_z, K[0, 2])).to(torch.int64)
    pix_y = torch.round(_fma(K[1, 1] * cam_y, inv_z, K[1, 2])).to(torch.int64)
    return cam_x, cam_y, cam_z, pix_x, pix_y


def _lowered(dtype, *xs):
    if dtype == torch.float32:
        return xs
    return tuple(None if x is None else x.to(dtype).to(torch.float32)
                 for x in xs)


def _observe(px, py, pz, depth_flat, K, c2w, im_h, im_w, fma_norms):
    cam_x, cam_y, cam_z, pix_x, pix_y = _project(px, py, pz, K, c2w)
    in_img = (pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h)
    pxc, pyc = pix_x.clamp(0, im_w - 1), pix_y.clamp(0, im_h - 1)
    flat = pyc * im_w + pxc
    d = depth_flat[flat]
    vx = (pxc.to(torch.float32) - K[0, 2]) / K[0, 0]
    vy = (pyc.to(torch.float32) - K[1, 2]) / K[1, 1]
    if fma_norms:
        lam = torch.sqrt(_fma(vx, vx, vy * vy) + 1.0)
        norm = torch.sqrt(_fma(cam_z, cam_z, _fma(cam_x, cam_x,
                                                  cam_y * cam_y)))
    else:
        lam = torch.sqrt(vx * vx + vy * vy + 1.0)
        norm = torch.sqrt(cam_x * cam_x + cam_y * cam_y + cam_z * cam_z)
    sdf = -((norm / lam) - d)
    return sdf, (cam_z > 0) & in_img & (d > 0), flat


def local_update(tsdf, weight, color, px, py, pz, depth_flat, color_flat,
                 K, c2w, trunc, obs_w, im_h, im_w, clamp_w, dtype):
    """Running-mean update of the moving volume's voxels (tsdf / weight
    [M], color [M, 3] or None); returns them and the near-band mask."""
    sdf, upd, flat = _observe(px, py, pz, depth_flat, K, c2w, im_h, im_w,
                              False)
    upd = upd & (sdf >= -trunc)
    tsdf, weight, color, sdf = _lowered(dtype, tsdf, weight, color, sdf)
    dist = torch.clamp(sdf / trunc, max=1.0)
    w_new = weight + obs_w
    inv = 1.0 / torch.where(w_new != 0, w_new, torch.ones_like(w_new))
    new_t = (tsdf * weight + obs_w * dist) * inv
    new_w = torch.clamp(w_new, max=40.0) if clamp_w else w_new
    t_out = torch.where(upd, new_t, tsdf)
    w_out = torch.where(upd, new_w, weight)
    band = upd & (sdf <= trunc)
    if color is None:
        return t_out, w_out, None, band
    fused = (color * weight[:, None] + obs_w * color_flat[flat]) \
        * inv[:, None]
    fused = torch.clamp(torch.round(fused), max=255.0)
    c_out = torch.where(band[:, None], fused, color)
    return t_out, w_out, c_out, band


def fuse_local(tsdf, weight, color, origin, layout, depth, rgb255, K, c2w,
               voxel_size, trunc, obs_w, clamp_w, dtype=torch.float32,
               bricks=None):
    """The bricks `bricks` (rows, default every brick) of a brick-major
    volume [NB, b^3] (color [NB, b^3, 3]) fused with one frame; rgb255
    None leaves the color. Returns (tsdf, weight, color, band) as new
    tensors, band the voxels whose observation lies in the truncation
    band."""
    b, BY, BZ = layout
    nb, b3 = tsdf.shape
    dev = tsdf.device
    im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
    t_o, w_o, c_o = tsdf.clone(), weight.clone(), color.clone()
    band = torch.zeros((nb, b3), dtype=torch.bool, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    wi = torch.arange(b3, device=dev)
    per = max(1, CHUNK // b3)
    depth_flat = depth.reshape(-1)
    cflat = None if rgb255 is None else rgb255.reshape(-1, 3)
    rows = (torch.arange(nb, device=dev) if bricks is None
            else bricks.to(device=dev, dtype=torch.int64))
    for s in range(0, rows.numel(), per):
        ids = rows[s:s + per]
        vx = (ids // (BY * BZ))[:, None] * b + (wi // (b * b))[None]
        vy = ((ids // BZ) % BY)[:, None] * b + ((wi // b) % b)[None]
        vz = (ids % BZ)[:, None] * b + (wi % b)[None]
        p = [_fma(v.reshape(-1).to(torch.float32), vs, origin[a])
             for a, v in enumerate((vx, vy, vz))]
        col = None if rgb255 is None else color[ids].reshape(-1, 3)
        t2, w2, c2, bd = local_update(
            tsdf[ids].reshape(-1), weight[ids].reshape(-1), col, *p,
            depth_flat, cflat, K, c2w, trunc, obs_w, im_h, im_w, clamp_w,
            dtype)
        t_o[ids] = t2.reshape(-1, b3)
        w_o[ids] = w2.reshape(-1, b3)
        if c2 is not None:
            c_o[ids] = c2.reshape(-1, b3, 3)
        band[ids] = bd.reshape(-1, b3)
    return t_o, w_o, c_o, band


def surface_bricks(depth, K, c2w, origin, voxel_size, dims, b, stride=4):
    """Rows of the bricks of a brick-major volume [X/b, Y/b, Z/b] that hold
    a depth point: every `stride`-th pixel in each direction with depth,
    back-projected at c2w, the points outside the volume dropped. A fused
    frame's selection holds at least these (the reference's own selection
    of the near-surface band, whose bricks it widens by the truncation
    margin)."""
    dev = depth.device
    ys = torch.arange(0, depth.shape[0], stride, device=dev)
    xs = torch.arange(0, depth.shape[1], stride, device=dev)
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    d = depth[yy, xx].double().reshape(-1)
    keep = d > 0
    d = d[keep]
    Kd, c2w = K.double(), c2w.double()
    cam = torch.stack([(xx.reshape(-1)[keep] - Kd[0, 2]) / Kd[0, 0] * d,
                       (yy.reshape(-1)[keep] - Kd[1, 2]) / Kd[1, 1] * d,
                       d], -1)
    pts = cam @ c2w[:3, :3].T + c2w[:3, 3]
    cell = torch.floor((pts - origin.double()) / (b * voxel_size)).long()
    nb = torch.tensor([int(n) // b for n in dims], device=dev)
    inside = ((cell >= 0) & (cell < nb)).all(-1)
    cell = cell[inside]
    rows = (cell[:, 0] * nb[1] + cell[:, 1]) * nb[2] + cell[:, 2]
    return torch.unique(rows)


def integrate_grid(gbv, gbw, depth, rgb, K, c2w, bound, trunc, obs_w=1.0,
                   dtype=torch.float32):
    """Every voxel of the global grid gbv [R, R, R, 4] / gbw [R, R, R]
    fused with one keyframe. Returns (gbv, gbw, band) as new tensors."""
    R = gbv.shape[0]
    dev = gbv.device
    im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
    v_o, w_o = gbv.clone().reshape(-1, 4), gbw.clone().reshape(-1)
    band = torch.zeros(R ** 3, dtype=torch.bool, device=dev)
    origin, scale = bound[:, 0], bound[:, 1] - bound[:, 0]
    inv_r = float(np.float32(1.0 / R))
    depth_flat, cflat = depth.reshape(-1), rgb.reshape(-1, 3)

    def coord(i, a):
        o = origin[a]
        return _fma(((o + i.to(torch.float32)) - o) * inv_r, scale[a], o)

    for s in range(0, R ** 3, CHUNK):
        lin = torch.arange(s, min(s + CHUNK, R ** 3), device=dev)
        px, py, pz = (coord(lin // (R * R), 0), coord((lin // R) % R, 1),
                      coord(lin % R, 2))
        sdf, upd, flat = _observe(px, py, pz, depth_flat, K, c2w, im_h,
                                  im_w, True)
        upd = upd & (sdf >= -trunc)
        v, w = v_o[lin], w_o[lin]
        ts, cs, w, sdf = _lowered(dtype, v[:, 0], v[:, 1:], w, sdf)
        dist = torch.clamp(sdf / trunc, max=1.0)
        w_new = w + obs_w
        inv = 1.0 / torch.where(w_new != 0, w_new, torch.ones_like(w_new))
        new_t = (ts * w + obs_w * dist) * inv
        fused = torch.clamp((cs * w[:, None] + obs_w * cflat[flat])
                            * inv[:, None], max=1.0)
        deint = (obs_w < 0) & (w <= 1) & upd
        do = upd & ~(new_t > 1.0) & ~deint
        ts = torch.where(deint, 1.0, torch.where(do, new_t, ts))
        w = torch.where(deint, 0.0, torch.where(do, w_new, w))
        cs = torch.where(deint[:, None], 0.0,
                         torch.where(do[:, None], fused, cs))
        v_o[lin] = torch.cat([ts[:, None], cs], -1)
        w_o[lin] = w
        band[lin] = upd & (sdf <= trunc)
    return v_o.reshape(gbv.shape), w_o.reshape(gbw.shape), \
        band.reshape(gbw.shape)


def recentre(tsdf, weight, color, origin, new_origin, dims, b, voxel_size,
             dtype=torch.float32):
    """The moving volume re-centred at new_origin: voxel v of the new
    volume holds old voxel v + offset (offset = the origins' difference in
    whole voxels), and voxels with no old counterpart are empty (tsdf 1,
    weight 0, colour 0). Brick-major in and out ([NB, b^3], colour [NB,
    b^3, 3]); the shift itself is done on the dense volume by slicing."""
    X, Y, Z = (int(d) for d in dims)
    off = [int(v) for v in torch.round(
        (new_origin.double() - origin.double()) / voxel_size).tolist()]

    def dense(a, fill):
        ch = tuple(a.shape[2:])
        d = a.reshape((X // b, Y // b, Z // b, b, b, b) + ch).permute(
            (0, 3, 1, 4, 2, 5) + tuple(6 + i for i in range(len(ch))))
        d = d.reshape((X, Y, Z) + ch)
        if dtype != torch.float32:
            d = d.to(dtype).to(torch.float32)
        out = torch.full_like(d, fill)
        src, dst = [], []
        for n, o in zip((X, Y, Z), off):
            lo, hi = max(0, -o), min(n, n - o)
            dst.append(slice(lo, max(lo, hi)))
            src.append(slice(lo + o, max(lo, hi) + o))
        out[tuple(dst)] = d[tuple(src)]
        bm = out.reshape((X // b, b, Y // b, b, Z // b, b) + ch).permute(
            (0, 2, 4, 1, 3, 5) + tuple(6 + i for i in range(len(ch))))
        return bm.reshape(((X // b) * (Y // b) * (Z // b), b ** 3) + ch)

    return dense(tsdf, 1.0), dense(weight, 0.0), dense(color, 0.0)
