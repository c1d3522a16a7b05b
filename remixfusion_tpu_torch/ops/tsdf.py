"""TSDF volume operations for the moving local volume, in PyTorch.

Counterpart of the local-volume subset of remixfusion_tpu.ops.tsdf (the
reference's embedded CUDA kernels model/Volume.py:128-583):
  - _project / _fuse_local_update <- `integrate` (Volume.py:196-336)
  - fuse_bricks_bm    <- make_brick_fuser_bm (:1696): fusion of a host-
                         selected brick set on the brick-major state
  - fuse_dense        <- make_slab_fuser (:290, tiles=None: the full
                         sweep, in x-slabs of pick_slab_count) and
                         make_tiled_fuser (:352, the frustum tiles of
                         frustum_tiles) on a dense [X, Y, Z] volume;
                         fuse_frame (:97, local mode) is its full sweep
  - make_volume, reset_volume <- make_volume / `clean_tsdf`
                         (Volume.py:561-583)
  - trilinear         <- `tri_intepolate` (Volume.py:337-458)
  - nearest_tsdf      <- the tracker's per-candidate voxel lookup
                         (ROtracker.py:244-259)
  - shift_volume_bm   <- swap_rot_trans (Volume.py:128-194), whole bricks
  - shift_volume      <- the same on a dense [X, Y, Z] volume
  - filter_low_weight <- filter_tsdf (Volume.py:462-487)
  - BrickSelector     <- the host-side brick selection (numpy, a copy)
  - integrate_global  <- the global-grid `integrate` (mapper.py:37-158):
                         keyframe fusion into the dense [R, R, R(, 4)]
                         grid over host-selected tiles (frustum_tiles,
                         pick_global_tile, global_budget_buckets: numpy
                         copies) or the dense sweep

State is brick-major: tsdf/weight [NB, b^3], color [NB, b^3, 3], brick
(bx, by, bz) at row (bx*BY + by)*BZ + bz and voxel (i, j, k) of a brick at
column (i*b + j)*b + k. A fusion batch moves as one row gather and one row
scatter. The dense volume (volume.brick_fusion: false) is [X, Y, Z]. Unlike
the JAX functions, which return new arrays, fuse_bricks_bm, fuse_dense and
integrate_global update the state tensors in place (the selected rows
only), which saves a full copy of the volume per frame; the shifts return
new tensors.

Plain tensor code: no hand kernel here (the TPU package had none either).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class VolumeState(NamedTuple):
    """tsdf [NB, b^3] in [-1, 1] (1 = empty), weight [NB, b^3], color
    [NB, b^3, 3] in 0..255, origin [3] world position of voxel (0, 0, 0) —
    all float32 tensors on one device (dense [X, Y, Z] in shift_volume)."""

    tsdf: torch.Tensor
    weight: torch.Tensor
    color: torch.Tensor
    origin: torch.Tensor


def _fma(a, b, c):
    """a * b + c rounded once to float32 (a fused multiply-add)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def _project(px, py, pz, K, c2w):
    """World points -> camera coords and integer (round-half-even) pixel
    coords; w2c is the transposed rotation (Volume.py:250-256)."""
    tx = px - c2w[0, 3]
    ty = py - c2w[1, 3]
    tz = pz - c2w[2, 3]
    cam_x = c2w[0, 0] * tx + c2w[1, 0] * ty + c2w[2, 0] * tz
    cam_y = c2w[0, 1] * tx + c2w[1, 1] * ty + c2w[2, 1] * tz
    cam_z = c2w[0, 2] * tx + c2w[1, 2] * ty + c2w[2, 2] * tz
    inv_z = 1.0 / torch.where(cam_z > 0, cam_z, torch.ones_like(cam_z))
    pix_x = torch.round(_fma(K[0, 0] * cam_x, inv_z, K[0, 2])).to(torch.int64)
    pix_y = torch.round(_fma(K[1, 1] * cam_y, inv_z, K[1, 2])).to(torch.int64)
    return cam_x, cam_y, cam_z, pix_x, pix_y


def _fuse_local_update(tsdf, weight, color, px, py, pz, depth_flat,
                       color_flat, K, c2w, trunc_margin, obs_weight, im_h,
                       im_w, weight_clamp):
    """Local-volume running-mean update (Volume.py:196-336) on voxels of any
    shape S: tsdf/weight/px/py/pz [*S], color [*S, 3] or None (depth-only:
    returns (tsdf, weight)); depth_flat [H*W], color_flat [H*W, 3] or None.
    Same operations in the same order as the JAX function."""
    cam_x, cam_y, cam_z, pix_x, pix_y = _project(px, py, pz, K, c2w)
    in_front = cam_z > 0
    in_image = (pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h)
    pix_x_c = pix_x.clamp(0, im_w - 1)
    pix_y_c = pix_y.clamp(0, im_h - 1)
    flat_pix = pix_y_c * im_w + pix_x_c
    depth_val = depth_flat[flat_pix]
    valid_depth = depth_val > 0

    vec_x = (pix_x_c.to(torch.float32) - K[0, 2]) / K[0, 0]
    vec_y = (pix_y_c.to(torch.float32) - K[1, 2]) / K[1, 1]
    lam = torch.sqrt(vec_x * vec_x + vec_y * vec_y + 1.0)
    cam_norm = torch.sqrt(cam_x * cam_x + cam_y * cam_y + cam_z * cam_z)
    sdf = -((cam_norm / lam) - depth_val)

    within_trunc = sdf >= -trunc_margin
    update = in_front & in_image & valid_depth & within_trunc

    dist = torch.clamp(sdf / trunc_margin, max=1.0)
    w_new = weight + obs_weight
    inv_w_new = 1.0 / torch.where(w_new != 0, w_new, torch.ones_like(w_new))
    new_tsdf = (tsdf * weight + obs_weight * dist) * inv_w_new

    new_weight = torch.clamp(w_new, max=40.0) if weight_clamp else w_new
    tsdf_out = torch.where(update, new_tsdf, tsdf)
    weight_out = torch.where(update, new_weight, weight)
    if color is None:
        return tsdf_out, weight_out
    new_c = color_flat[flat_pix]
    fused_c = (color * weight[..., None] + obs_weight * new_c) \
        * inv_w_new[..., None]
    color_band = update & (sdf <= trunc_margin)
    fused_c = torch.clamp(torch.round(fused_c), max=255.0)
    color_out = torch.where(color_band[..., None], fused_c, color)
    return tsdf_out, weight_out, color_out


def _brick_voxels(ids, layout, device):
    """Voxel coordinates [B, b^3] x3 (int64) of brick rows `ids` [B]."""
    b, BY, BZ = layout
    wi = torch.arange(b ** 3, device=device)
    bx = ids // (BY * BZ)
    by = (ids // BZ) % BY
    bz = ids % BZ
    vx = bx[:, None] * b + (wi // (b * b))[None]
    vy = by[:, None] * b + ((wi // b) % b)[None]
    vz = bz[:, None] * b + (wi % b)[None]
    return vx, vy, vz


def fuse_bricks_bm(state: VolumeState, ids, depth, rgb255, K, c2w, *,
                   voxel_size: float, trunc_margin: float, layout,
                   weight_clamp: bool, obs_weight) -> VolumeState:
    """Fuse one frame into the bricks at rows `ids` [B] (int64, unique) of
    the brick-major state, in place. depth [H, W] meters; rgb255 [H, W, 3]
    in 0..255 or None for the depth-only update (color state untouched);
    K [3, 3], c2w [4, 4], obs_weight a float32 scalar tensor. Same math as
    make_brick_fuser_bm's fuse / fuse_nc."""
    if ids.numel() == 0:
        return state
    im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
    vx, vy, vz = _brick_voxels(ids, layout, ids.device)
    o = state.origin
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=o.device)
    px = _fma(vx.to(torch.float32), vs, o[0])
    py = _fma(vy.to(torch.float32), vs, o[1])
    pz = _fma(vz.to(torch.float32), vs, o[2])
    t = state.tsdf[ids]
    w = state.weight[ids]
    depth_flat = depth.reshape(-1)
    if rgb255 is None:
        t2, w2 = _fuse_local_update(
            t, w, None, px, py, pz, depth_flat, None, K, c2w, trunc_margin,
            obs_weight, im_h, im_w, weight_clamp)
    else:
        t2, w2, c2 = _fuse_local_update(
            t, w, state.color[ids], px, py, pz, depth_flat,
            rgb255.reshape(-1, 3), K, c2w, trunc_margin, obs_weight, im_h,
            im_w, weight_clamp)
        state.color[ids] = c2
    state.tsdf[ids] = t2
    state.weight[ids] = w2
    return state


def make_volume(dims, origin, device) -> VolumeState:
    """An empty dense volume: tsdf 1, weight 0, colour 0, at `origin`."""
    dims = tuple(int(d) for d in dims)
    return VolumeState(
        torch.ones(dims, dtype=torch.float32, device=device),
        torch.zeros(dims, dtype=torch.float32, device=device),
        torch.zeros(dims + (3,), dtype=torch.float32, device=device),
        torch.as_tensor(np.asarray(origin, np.float32), device=device))


def reset_volume(vol: VolumeState) -> VolumeState:
    """tsdf 1, weight 0, colour 0 (reference `clean_tsdf`)."""
    return VolumeState(torch.ones_like(vol.tsdf),
                       torch.zeros_like(vol.weight),
                       torch.zeros_like(vol.color), vol.origin)


# fuse_dense's working sets: the full sweep's x-slab holds at most
# _SLAB_TARGET_VOXELS voxels, a step of the tiled path _FUSE_CHUNK voxels.
_SLAB_TARGET_VOXELS = 4_000_000
_FUSE_CHUNK = 1 << 22


def pick_slab_count(X: int, yz: int) -> int:
    """Smallest divisor n of X whose x-slab (X / n * yz voxels) holds at
    most _SLAB_TARGET_VOXELS: the full sweep's working set."""
    for n in range(1, X + 1):
        if X % n == 0 and (X // n) * yz <= _SLAB_TARGET_VOXELS:
            return n
    return X


def fuse_dense(state: VolumeState, depth, rgb255, K, c2w, *,
               voxel_size: float, trunc_margin: float, weight_clamp: bool,
               obs_weight, tiles=None, tile: int | None = None
               ) -> VolumeState:
    """Fuse one frame into a dense [X, Y, Z] volume, in place. tiles=None:
    every voxel, in x-slabs of pick_slab_count (make_slab_fuser's full
    sweep); else `tiles` int [n, 3] are the voxel offsets (multiples of
    `tile`, which divides every dim) of the disjoint tiles to update, as
    frustum_tiles selects them (make_tiled_fuser), moved _FUSE_CHUNK voxels
    at a time. Voxel (i, j, k) sits at origin + (i, j, k) * voxel_size. depth
    [H, W] meters, rgb255 [H, W, 3] in 0..255, K [3, 3], c2w [4, 4],
    obs_weight a float32 scalar tensor: tensors on the volume's device.
    The per-voxel update is _fuse_local_update, the brick fuser's."""
    X, Y, Z = state.tsdf.shape
    dev = state.tsdf.device
    im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
    depth_flat = depth.reshape(-1)
    color_flat = rgb255.reshape(-1, 3)
    o = state.origin
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)

    def update(t, w, c, vx, vy, vz):
        return _fuse_local_update(
            t, w, c, _fma(vx.to(torch.float32), vs, o[0]),
            _fma(vy.to(torch.float32), vs, o[1]),
            _fma(vz.to(torch.float32), vs, o[2]), depth_flat, color_flat,
            K, c2w, trunc_margin, obs_weight, im_h, im_w, weight_clamp)

    if tiles is None:
        sx = X // pick_slab_count(X, Y * Z)
        vy = torch.arange(Y, device=dev)[None, :, None].expand(sx, Y, Z)
        vz = torch.arange(Z, device=dev)[None, None, :].expand(sx, Y, Z)
        for x0 in range(0, X, sx):
            vx = torch.arange(x0, x0 + sx, device=dev)[:, None, None] \
                .expand(sx, Y, Z)
            sl = slice(x0, x0 + sx)
            t2, w2, c2 = update(state.tsdf[sl], state.weight[sl],
                                state.color[sl], vx, vy, vz)
            state.tsdf[sl] = t2
            state.weight[sl] = w2
            state.color[sl] = c2
        return state
    t = int(tile)
    loc = torch.arange(t ** 3, device=dev)
    li, lj, lk = loc // (t * t), (loc // t) % t, loc % t
    offs = torch.as_tensor(np.asarray(tiles, np.int64).reshape(-1, 3),
                           device=dev)
    t_flat = state.tsdf.view(-1)
    w_flat = state.weight.view(-1)
    c_flat = state.color.view(-1, 3)
    per = max(1, _FUSE_CHUNK // t ** 3)
    for s in range(0, offs.shape[0], per):
        oc = offs[s:s + per]
        vx = (oc[:, 0:1] + li).reshape(-1)
        vy = (oc[:, 1:2] + lj).reshape(-1)
        vz = (oc[:, 2:3] + lk).reshape(-1)
        lin = (vx * Y + vy) * Z + vz
        t2, w2, c2 = update(t_flat[lin], w_flat[lin], c_flat[lin], vx, vy,
                            vz)
        t_flat[lin] = t2
        w_flat[lin] = w2
        c_flat[lin] = c2
    return state


def fuse_frame(vol: VolumeState, depth, color, K, c2w, *,
               voxel_size: float, trunc_margin: float, obs_weight=1.0,
               weight_clamp: bool = False) -> VolumeState:
    """Fuse one frame into every voxel of a dense volume (the JAX fuse_frame
    in local mode: colour taken as given, 0..255), returning a new
    VolumeState."""
    out = VolumeState(vol.tsdf.clone(), vol.weight.clone(),
                      vol.color.clone(), vol.origin)
    ow = torch.as_tensor(obs_weight, dtype=torch.float32,
                         device=vol.tsdf.device)
    return fuse_dense(out, depth, color, K, c2w, voxel_size=voxel_size,
                      trunc_margin=trunc_margin, weight_clamp=weight_clamp,
                      obs_weight=ow)


def trilinear(vol_tsdf, vol_color, vol_weight, pts, origin, voxel_size):
    """Trilinear tsdf / colour interpolation of a dense volume at world
    points [N, 3] (reference Volume.py:337-458): (tsdf [N], colour [N, 3],
    valid [N]); a point whose lower corner is outside [0, dim - 1) gets
    tsdf 1 and colour 0 and is invalid, and a valid point needs >= 4 of its
    8 corners observed (weight > 0)."""
    dims = vol_tsdf.shape
    dims_t = torch.tensor(dims, device=pts.device)
    pos = (pts - origin[None, :]) / voxel_size
    low = torch.floor(pos).to(torch.int64)
    inside = ((low >= 0) & (low < dims_t - 1)).all(-1)
    low_c = torch.minimum(low.clamp(min=0), dims_t - 2)
    frac = pos - low_c.to(torch.float32)
    tsdf_flat = vol_tsdf.reshape(-1)
    color_flat = vol_color.reshape(-1, 3)
    weight_flat = vol_weight.reshape(-1)
    sy, sx = dims[2], dims[1] * dims[2]
    base = low_c[:, 0] * sx + low_c[:, 1] * sy + low_c[:, 2]
    n = pts.shape[0]
    t_acc = torch.zeros(n, dtype=torch.float32, device=pts.device)
    c_acc = torch.zeros((n, 3), dtype=torch.float32, device=pts.device)
    w_cnt = torch.zeros(n, dtype=torch.float32, device=pts.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = base + dx * sx + dy * sy + dz
                w = ((dx * frac[:, 0] + (1 - dx) * (1 - frac[:, 0]))
                     * (dy * frac[:, 1] + (1 - dy) * (1 - frac[:, 1]))
                     * (dz * frac[:, 2] + (1 - dz) * (1 - frac[:, 2])))
                t_acc = t_acc + w * tsdf_flat[idx]
                c_acc = c_acc + w[:, None] * color_flat[idx]
                w_cnt = w_cnt + (weight_flat[idx] > 0)
    valid = inside & (w_cnt >= 4)
    return (torch.where(inside, t_acc, 1.0),
            torch.where(inside[:, None], c_acc, 0.0), valid)


def nearest_tsdf(vol_tsdf_flat, pts, origin, voxel_size, dims):
    """Nearest-voxel tsdf of a dense volume (flattened) at world points
    [..., 3]: (tsdf [...], valid [...]); a point whose rounded voxel lies
    outside [1, dim - 1) is invalid (reference ROtracker.py:244-259)."""
    pos = torch.round((pts - origin) / voxel_size).to(torch.int64)
    valid = torch.ones(pos.shape[:-1], dtype=torch.bool, device=pts.device)
    idx = torch.zeros(pos.shape[:-1], dtype=torch.int64, device=pts.device)
    for a in range(3):
        v = pos[..., a]
        valid = valid & (v >= 1) & (v < dims[a] - 1)
        idx = idx * dims[a] + v.clamp(0, dims[a] - 1)
    return vol_tsdf_flat[idx], valid


def truncated_points_mask(vol: VolumeState, trunc_tsdf: float = 0.5):
    """Mask of near-surface voxels |tsdf| < trunc_tsdf with weight > 0
    (reference `get_truncated_pc`); the compaction runs on the host."""
    return (vol.tsdf > -trunc_tsdf) & (vol.tsdf < trunc_tsdf) \
        & (vol.weight > 0)


def extract_truncated_points(vol: VolumeState, voxel_size, trunc_margin,
                             trunc_tsdf=0.5) -> np.ndarray:
    """Near-surface voxels of a dense volume as [N, 7] numpy rows (voxel
    center xyz, metric sdf, rgb 0..255)."""
    mask = truncated_points_mask(vol, trunc_tsdf).cpu().numpy()
    idx = np.argwhere(mask)
    origin = vol.origin.cpu().numpy()
    pts = origin[None, :] + (idx.astype(np.float32) + 0.5) * voxel_size
    tsdf = vol.tsdf.cpu().numpy()[mask] * trunc_margin
    rgb = vol.color.cpu().numpy()[mask]
    return np.concatenate([pts, tsdf[:, None], rgb], axis=1)


def bm_to_dense(arr: torch.Tensor, dims, b: int) -> torch.Tensor:
    """[NB, b^3, *C] brick-major -> [X, Y, Z, *C] dense."""
    X, Y, Z = dims
    ch = tuple(arr.shape[2:])
    a = arr.reshape((X // b, Y // b, Z // b, b, b, b) + ch)
    perm = (0, 3, 1, 4, 2, 5) + tuple(6 + i for i in range(len(ch)))
    return a.permute(perm).reshape((X, Y, Z) + ch)


def dense_to_bm(arr: torch.Tensor, b: int) -> torch.Tensor:
    """[X, Y, Z, *C] dense -> [NB, b^3, *C] brick-major."""
    X, Y, Z = arr.shape[:3]
    ch = tuple(arr.shape[3:])
    a = arr.reshape((X // b, b, Y // b, b, Z // b, b) + ch)
    perm = (0, 2, 4, 1, 3, 5) + tuple(6 + i for i in range(len(ch)))
    return a.permute(perm).reshape(((X // b) * (Y // b) * (Z // b), b ** 3)
                                   + ch)


def bm_vox_flat(layout, vx, vy, vz):
    """Flat index of voxel (vx, vy, vz) in a reshape(-1) of a brick-major
    array. layout = (b, BY, BZ)."""
    b, BY, BZ = layout
    bid = ((vx // b) * BY + vy // b) * BZ + vz // b
    within = ((vx % b) * b + vy % b) * b + vz % b
    return bid * (b * b * b) + within


def window_index(layout, base, side: int):
    """Flat indices [P, side^3] (into a reshape(-1) of a volume of layout
    (b, BY, BZ)) of the side^3 windows at integer bases [P, 3], cell order
    (dx * side + dy) * side + dz."""
    d = torch.arange(side, device=base.device)
    off = torch.stack(torch.meshgrid(d, d, d, indexing="ij"),
                      -1).reshape(1, side ** 3, 3)
    vox = base[:, None, :].to(torch.int64) + off
    return bm_vox_flat(layout, vox[..., 0], vox[..., 1], vox[..., 2])


def shift_volume_bm(vol: VolumeState, new_origin: torch.Tensor, voxel_size,
                    layout, dims) -> VolumeState:
    """Re-center a brick-major volume by a whole number of bricks: new brick
    i reads old brick i + offset, vacated bricks reset to empty."""
    b, BY, BZ = layout
    BX = dims[0] // b
    dev = vol.tsdf.device
    offset = torch.round((new_origin - vol.origin)
                         / (voxel_size * b)).to(torch.int64)
    bx = torch.arange(BX, device=dev)[:, None, None] + offset[0]
    by = torch.arange(BY, device=dev)[None, :, None] + offset[1]
    bz = torch.arange(BZ, device=dev)[None, None, :] + offset[2]
    inb = ((bx >= 0) & (bx < BX) & (by >= 0) & (by < BY) & (bz >= 0)
           & (bz < BZ)).reshape(-1)
    flat = ((bx.clamp(0, BX - 1) * BY + by.clamp(0, BY - 1)) * BZ
            + bz.clamp(0, BZ - 1)).reshape(-1)
    return VolumeState(
        torch.where(inb[:, None], vol.tsdf[flat], 1.0),
        torch.where(inb[:, None], vol.weight[flat], 0.0),
        torch.where(inb[:, None, None], vol.color[flat], 0.0),
        new_origin.to(torch.float32))


def shift_volume(vol: VolumeState, new_origin: torch.Tensor,
                 voxel_size) -> VolumeState:
    """Re-center a DENSE volume by an integer voxel offset; out-of-range
    voxels reset to empty."""
    dims = vol.tsdf.shape
    dev = vol.tsdf.device
    offset = torch.round((new_origin - vol.origin)
                         / voxel_size).to(torch.int64)
    ix = torch.arange(dims[0], device=dev)[:, None, None] + offset[0]
    iy = torch.arange(dims[1], device=dev)[None, :, None] + offset[1]
    iz = torch.arange(dims[2], device=dev)[None, None, :] + offset[2]
    inb = ((ix >= 0) & (ix < dims[0]) & (iy >= 0) & (iy < dims[1])
           & (iz >= 0) & (iz < dims[2]))
    flat = (ix.clamp(0, dims[0] - 1) * (dims[1] * dims[2])
            + iy.clamp(0, dims[1] - 1) * dims[2]
            + iz.clamp(0, dims[2] - 1)).reshape(-1)
    return VolumeState(
        torch.where(inb, vol.tsdf.reshape(-1)[flat].reshape(dims), 1.0),
        torch.where(inb, vol.weight.reshape(-1)[flat].reshape(dims), 0.0),
        torch.where(inb[..., None],
                    vol.color.reshape(-1, 3)[flat].reshape(dims + (3,)),
                    0.0),
        new_origin.to(torch.float32))


def filter_low_weight(vol: VolumeState, weight_threshold) -> VolumeState:
    """Prune voxels with 0 < weight < threshold (reference `filter_tsdf`)."""
    prune = (vol.weight > 0) & (vol.weight < weight_threshold)
    return VolumeState(
        torch.where(prune, 1.0, vol.tsdf),
        torch.where(prune, 0.0, vol.weight),
        torch.where(prune[..., None], 0.0, vol.color),
        vol.origin)


class BrickSelector:
    """Host-side brick selection (numpy; a copy of the JAX package's
    BrickSelector so both packages fuse the same bricks).

    Near-surface bricks: splat strided depth points, dilated by the
    truncation band, over their full lo..hi brick-cell span (corner
    enumeration can miss the point's own brick when the margin exceeds the
    brick side). Free-space bricks: the exact 8-corner frustum test of
    select_fusion_bricks (cached corner geometry), rotated round-robin over
    fs_every frames. Reference semantics: Volume.py:196-336 updates every
    in-frustum voxel in front of the surface; the rotation amortizes that
    over frames.

    IMPORTANT: the free-space test must stay the corner test, not a
    bounding-sphere approximation. A sphere test keeps image-BORDER
    straddle bricks the corner+pad test rejects; those bricks receive
    grazing-angle wall updates at slightly-wrong tracked poses, which
    corrodes the wall TSDF and destabilizes the tracking<->fusion loop
    (measured: 1 cm -> 49 cm ATE on the synthetic bench, reproducible
    across seeds).
    """

    def __init__(self, dims, b, voxel_size, K, im_h, im_w,
                 splat_stride: int = 4, pad_px: float = 16.0,
                 fs_scope: str = "frustum"):
        # fs_scope='seen': free-space carving restricted to bricks that
        # were EVER in a near-surface band (`self.seen`, a persistent
        # host-side bool[NB] ORed with each frame's near mask, shifted
        # with the volume on re-center). Carving's functional role is
        # erasing STALE surface — a brick that never held surface is
        # already at its carved state (tsdf=1 from init), so skipping it
        # changes only its (unused) free-space weight. Cuts the fused
        # brick set roughly in half on typical scenes. 'frustum' keeps the
        # reference-shaped carve of
        # every in-frustum brick (Volume.py:280-300 semantics).
        self.fs_scope = fs_scope
        self.dims = dims
        self.b = int(b)
        self.voxel_size = float(voxel_size)
        self.bs = self.b * self.voxel_size
        self.K = np.asarray(K, np.float32)
        self.H, self.W = int(im_h), int(im_w)
        self.stride = int(splat_stride)
        self.pad_px = float(pad_px)
        X, Y, Z = dims
        self.BX, self.BY, self.BZ = X // b, Y // b, Z // b
        self.NB = self.BX * self.BY * self.BZ
        # brick-center offsets from the volume origin (origin-independent)
        gx, gy, gz = np.meshgrid(np.arange(self.BX, dtype=np.float32),
                                 np.arange(self.BY, dtype=np.float32),
                                 np.arange(self.BZ, dtype=np.float32),
                                 indexing="ij")
        self.centers_rel = (np.stack(
            [gx, gy, gz], -1).reshape(-1, 3) + 0.5) * self.bs
        self.radius = float(np.sqrt(3.0) / 2.0 * self.bs)
        # 8 brick-corner offsets from the brick base (origin-independent);
        # base_rel[NB, 3] = brick base corner relative to the volume origin
        bs = self.bs
        self.base_rel = (self.centers_rel - 0.5 * bs).astype(np.float64)
        self.corner_offs = np.array(
            [[dx_, dy_, dz_] for dx_ in (0.0, bs) for dy_ in (0.0, bs)
             for dz_ in (0.0, bs)], np.float64)  # [8, 3]
        # strided pixel grid for the depth splat
        ys, xs = np.mgrid[0:self.H:self.stride, 0:self.W:self.stride]
        self.xs = xs.astype(np.float32).ravel()
        self.ys = ys.astype(np.float32).ravel()
        self.inv_fx = 1.0 / self.K[0, 0]
        self.inv_fy = 1.0 / self.K[1, 1]
        # superbrick (8^3-brick block) prefilter geometry: a coarse sphere
        # test over ~NB/512 blocks gates the per-brick frustum math
        sb = 8
        self.sb = sb
        NSX = (self.BX + sb - 1) // sb
        NSY = (self.BY + sb - 1) // sb
        NSZ = (self.BZ + sb - 1) // sb
        sx, sy, sz = np.meshgrid(np.arange(NSX, dtype=np.float32),
                                 np.arange(NSY, dtype=np.float32),
                                 np.arange(NSZ, dtype=np.float32),
                                 indexing="ij")
        self.sb_centers_rel = (np.stack([sx, sy, sz], -1).reshape(-1, 3)
                               + 0.5) * (sb * self.bs)
        self.sb_radius = float(np.sqrt(3.0) / 2.0 * sb * self.bs)
        bx, by, bz = np.unravel_index(np.arange(self.NB),
                                      (self.BX, self.BY, self.BZ))
        self.brick_sbid = ((bx // sb * NSY + by // sb) * NSZ
                           + bz // sb).astype(np.int32)
        # fs_scope='seen' state: bricks that ever held a near-surface band
        self.seen = np.zeros(self.NB, bool)

    def mark_seen(self, near_flat):
        self.seen[near_flat] = True

    def shift_seen(self, shift_vox):
        """Re-anchor the seen mask after a volume re-center: new brick i
        maps to old voxel position i*b + shift. Non-brick-aligned shifts
        mark every overlapped old brick (conservative OR over the up-to-8
        floor/ceil neighbours)."""
        old = self.seen.reshape(self.BX, self.BY, self.BZ)
        new = np.zeros_like(old)
        sh = np.asarray(shift_vox, np.float64) / self.b

        def rng(o, B):
            # overlap of [0, B) with [0, B) shifted by o: explicit length
            # so shifts beyond the grid (|o| >= B — e.g. a re-center after
            # a tracking runaway) cleanly produce an empty copy instead of
            # mismatched slice shapes
            ln = B - abs(o)
            return (max(o, 0), max(-o, 0), max(ln, 0))

        for fx_ in (np.floor, np.ceil):
            for fy_ in (np.floor, np.ceil):
                for fz_ in (np.floor, np.ceil):
                    sx, dx_, lx = rng(int(fx_(sh[0])), self.BX)
                    sy, dy_, ly = rng(int(fy_(sh[1])), self.BY)
                    sz, dz_, lz = rng(int(fz_(sh[2])), self.BZ)
                    if lx == 0 or ly == 0 or lz == 0:
                        continue
                    new[dx_:dx_ + lx, dy_:dy_ + ly, dz_:dz_ + lz] |= \
                        old[sx:sx + lx, sy:sy + ly, sz:sz + lz]
        self.seen = new.reshape(-1)

    def reseed_seen(self, tsdf_bm_min):
        """Rebuild the seen mask from volume content (checkpoint load):
        any brick whose min tsdf < 1 holds or held surface."""
        self.seen = np.asarray(tsdf_bm_min) < 1.0 - 1e-6

    def near_mask(self, origin, c2w, depth, trunc_margin):
        """Boolean [NB] mask of near-surface bricks + max depth."""
        d = np.asarray(depth)[::self.stride, ::self.stride].ravel()
        ok = d > 0
        d = d[ok]
        if d.size == 0:
            return np.zeros(self.NB, bool), 0.0
        dmax = float(d.max())
        cx = (self.xs[ok] - self.K[0, 2]) * self.inv_fx * d
        cy = (self.ys[ok] - self.K[1, 2]) * self.inv_fy * d
        R = np.asarray(c2w, np.float32)[:3, :3]
        t = np.asarray(c2w, np.float32)[:3, 3]
        pts = np.stack([cx, cy, d], -1) @ R.T + t
        gap = self.stride * dmax * max(self.inv_fx, self.inv_fy)
        m = trunc_margin + gap + self.voxel_size
        rel = (pts - np.asarray(origin, np.float32)) / self.bs
        BX, BY, BZ = self.BX, self.BY, self.BZ
        k = int(np.ceil(m / self.bs))
        dims_p = (BX + 2 * k, BY + 2 * k, BZ + 2 * k)
        grid = np.zeros(dims_p, bool)
        if m <= self.bs:
            # Exact per-point box cover. With 2m <= bs the [pt-m, pt+m]
            # band AABB touches at most 2 bricks per axis, so the 8 corner
            # cells ARE the minimal covering brick set; with m in
            # (bs/2, bs] it can straddle 3 bricks per axis, so each axis
            # contributes {lo, min(lo+1, hi), hi} — clipped to hi, so
            # padding duplicates rewrite the same cell harmlessly (the
            # old 8-corner shortcut here silently dropped the MIDDLE
            # brick, including the splat point's own, whenever the box
            # spanned 3). Both variants beat the brick-aligned ±k
            # dilation below, which overshoots the minimal set ~1.8x
            # (measured: 1882 -> ~1000 near bricks on the bench frames).
            # One flat scatter keeps the 1-core host cost low.
            mo = m / self.bs
            lo = np.floor(rel - mo).astype(np.int64) + k
            hi = np.floor(rel + mo).astype(np.int64) + k
            np.clip(lo, 0, np.asarray(dims_p) - 1, out=lo)
            np.clip(hi, 0, np.asarray(dims_p) - 1, out=hi)
            sy = dims_p[2]
            sx = dims_p[1] * dims_p[2]
            if 2 * m <= self.bs:
                fx = (lo[:, 0] * sx, hi[:, 0] * sx)
                fy = (lo[:, 1] * sy, hi[:, 1] * sy)
                fz = (lo[:, 2], hi[:, 2])
            else:
                fx = (lo[:, 0] * sx, np.minimum(lo[:, 0] + 1, hi[:, 0]) * sx,
                      hi[:, 0] * sx)
                fy = (lo[:, 1] * sy, np.minimum(lo[:, 1] + 1, hi[:, 1]) * sy,
                      hi[:, 1] * sy)
                fz = (lo[:, 2], np.minimum(lo[:, 2] + 1, hi[:, 2]),
                      hi[:, 2])
            flat = np.concatenate([a + b + c
                                   for a in fx for b in fy for c in fz])
            grid.reshape(-1)[flat] = True
        else:
            # wide margins (m > brick side): splat the point bricks, then
            # dilate by k bricks with three separable axis passes — a
            # (grid-aligned, slightly larger) superset of the per-point
            # box walk, at O(k * grid) boolean work
            cell = np.floor(rel).astype(np.int64) + k
            inside = ((cell >= 0).all(1) & (cell[:, 0] < dims_p[0])
                      & (cell[:, 1] < dims_p[1]) & (cell[:, 2] < dims_p[2]))
            cell = cell[inside]
            grid[cell[:, 0], cell[:, 1], cell[:, 2]] = True
            for axis in range(3):
                acc = grid.copy()
                for s in range(1, k + 1):
                    sl_f = [slice(None)] * 3
                    sl_b = [slice(None)] * 3
                    sl_f[axis] = slice(s, None)
                    sl_b[axis] = slice(None, -s)
                    acc[tuple(sl_f)] |= grid[tuple(sl_b)]
                    acc[tuple(sl_b)] |= grid[tuple(sl_f)]
                grid = acc
        return np.ascontiguousarray(grid[k:k + BX, k:k + BY,
                                         k:k + BZ]).reshape(-1), dmax

    def frustum_mask(self, origin, c2w, dmax, trunc_margin):
        """Boolean [NB] mask: the exact 8-corner frustum test of
        select_fusion_bricks (see class docstring for why the corner test,
        and its pad_px border rejection, is load-bearing).

        Two stages: a conservative bounding-sphere prefilter on brick
        centers (strict superset of the corner test: corner z <= z_c + r,
        corner near_cam >= z_c - r, and the projected-radius pixel bound
        dominates every corner's pixel for z_c > r), then the exact corner
        test on the surviving few-thousand candidates only."""
        c2w64 = np.asarray(c2w, np.float64)
        R, t = c2w64[:3, :3], c2w64[:3, 3]
        K = self.K
        depth_bound = dmax + trunc_margin + self.bs
        r = self.radius

        def sphere_cull(centers_rel, radius):
            """Conservative sphere-vs-frustum keep mask (float32)."""
            c = centers_rel + np.asarray(origin, np.float32)
            camc = (c - t.astype(np.float32)) @ R.astype(np.float32)
            zc = camc[:, 2]
            maybe_front = zc > -radius
            depth_may = zc - radius <= depth_bound
            zs = np.maximum(zc - radius, 1e-6)
            uc = K[0, 0] * camc[:, 0] / np.maximum(zc, 1e-6) + K[0, 2]
            vc = K[1, 1] * camc[:, 1] / np.maximum(zc, 1e-6) + K[1, 2]
            # |du| <= f*r/(z-r) * sqrt(1 + (x/z)^2): the off-axis term is
            # part of the exact sphere-projection bound, not optional
            ur = radius * K[0, 0] / zs * np.sqrt(
                1.0 + ((uc - K[0, 2]) / K[0, 0]) ** 2)
            vr = radius * K[1, 1] / zs * np.sqrt(
                1.0 + ((vc - K[1, 2]) / K[1, 1]) ** 2)
            pad = self.pad_px
            pix_may = ((uc + ur >= -pad) & (uc - ur < self.W + pad)
                       & (vc + vr >= -pad) & (vc - vr < self.H + pad))
            return maybe_front & depth_may & ((zc <= radius) | pix_may)

        # --- stage 0: superbrick sphere prefilter (~NB/512 tests)
        sb_keep = sphere_cull(self.sb_centers_rel, self.sb_radius)
        cand0 = sb_keep[self.brick_sbid]
        idx0 = np.flatnonzero(cand0)
        if idx0.size == 0:
            return np.zeros(self.NB, bool)

        # --- stage 1: per-brick sphere prefilter on the survivors
        keep1 = sphere_cull(self.centers_rel[idx0], r)
        idx = idx0[keep1]
        if idx.size == 0:
            return np.zeros(self.NB, bool)

        # --- stage 2: exact 8-corner test on candidates
        pad = self.pad_px
        pts8 = (self.base_rel[idx] + np.asarray(origin, np.float64))[:, None, :] \
            + self.corner_offs[None]
        cam = (pts8 - t) @ R  # w2c: R^T (x - t) per point
        z = cam[:, :, 2]
        front = z > 0
        any_front = front.any(1)
        eps = 1e-6
        u = K[0, 0] * cam[:, :, 0] / np.maximum(z, eps) + K[0, 2]
        v = K[1, 1] * cam[:, :, 1] / np.maximum(z, eps) + K[1, 2]
        out_l = np.where(front, u, -np.inf).max(1) < -pad
        out_r = np.where(front, u, np.inf).min(1) >= self.W + pad
        out_t = np.where(front, v, -np.inf).max(1) < -pad
        out_b = np.where(front, v, np.inf).min(1) >= self.H + pad
        near_cam = np.where(front, z, np.inf).min(1)
        ok = (any_front & ~(out_l | out_r | out_t | out_b)
              & (near_cam <= depth_bound))
        mask = np.zeros(self.NB, bool)
        mask[idx[ok]] = True
        return mask

    def select(self, origin, c2w, depth, trunc_margin, budget,
               fs_phase=0, fs_every=4, fs_span=1, update_seen=True):
        """Returns ([budget, 3] int32 brick coords padded with -1, n_near,
        n_selected, near_flat) — the brick contract of
        select_fusion_bricks plus the flat near-brick index set. Free-space
        bricks rotate over fs_every phases; fs_span > 1 takes fs_span
        consecutive phases, for a selection that serves fs_span frames
        (volume.sel_reuse). update_seen=False defers the
        fs_scope='seen' carve-history update: a look-ahead worker thread
        must not mutate `self.seen` (the main thread may shift_seen it
        concurrently on a re-center); the consumer applies mark_seen with
        the returned near_flat once it has validated the origin snapshot."""
        near, dmax = self.near_mask(origin, c2w, depth, trunc_margin)
        fr = self.frustum_mask(origin, c2w, dmax, trunc_margin)
        near_flat = np.flatnonzero(near)
        if self.fs_scope == "seen":
            fs_flat = np.flatnonzero(fr & ~near & self.seen)
            if update_seen:
                self.mark_seen(near_flat)
        else:
            fs_flat = np.flatnonzero(fr & ~near)
        if fs_every > 1 and fs_span < fs_every:
            fs_flat = fs_flat[(fs_flat - fs_phase) % fs_every < fs_span]
        n_near = len(near_flat)
        if n_near > budget:
            near_flat = near_flat[:budget]
            n_near = budget
        sel = np.concatenate([near_flat, fs_flat[:budget - n_near]])
        BY, BZ = self.BY, self.BZ
        coords = np.stack(
            [sel // (BY * BZ), (sel // BZ) % BY, sel % BZ], -1).astype(np.int32)
        pad = np.full((budget - len(sel), 3), -1, np.int32)
        return np.concatenate([coords, pad], 0), n_near, len(sel), near_flat


# ------------------------------------------------------------------------
# Global keyframe grid (the mapper's explicit branch)
# ------------------------------------------------------------------------


def pick_global_tile(R: int, lo: int = 8, hi: int = 40,
                     target: int = 24) -> int | None:
    """Divisor of R closest to `target` in [lo, hi]: the tile edge of the
    tiled global integrate, None when R has none (dense sweep only)."""
    best = None
    for t in range(lo, hi + 1):
        if R % t == 0 and (best is None or abs(t - target) < abs(best - target)):
            best = t
    return best


def global_budget_buckets(n_total: int) -> list:
    """Tile-budget buckets of the tiled global integrate: sixteenths of the
    tile count, 64-row aligned. A selection whose bucket reaches the whole
    grid takes the dense sweep instead (the JAX package's compile-variant
    bound; the port keeps the same decision so both integrate the same
    voxels)."""
    out = []
    for k in range(1, 16):
        b = min(-64 * (-(n_total * k) // (16 * 64)), n_total)
        if b not in out:
            out.append(b)
    return out


def frustum_tiles(dims, tile, origin, voxel_size, K, c2w, im_h, im_w,
                  max_depth=None, pad_px: float = 0.0, depth_map=None,
                  lam_max=None, trunc=None, free_rotate=None):
    """Host-side (numpy): voxel offsets [N, 3] of the tiles whose AABB
    intersects the view frustum (conservative corner test, `pad_px` wider
    than the image). With `depth_map` (+ lam_max, trunc) a tile is also
    dropped when its nearest corner lies beyond lam_max * (d_max + trunc)
    of the largest valid depth in its own padded image box, or when that
    box saw no valid depth. `free_rotate=(phase, every)`: tiles that are
    provably pure free space (every voxel further than trunc + 2 voxels in
    front of the surface) are kept only when flat_tile_id % every ==
    phase. A copy of remixfusion_tpu.ops.tsdf.frustum_tiles: the same tiles
    bit for bit."""
    t = int(tile)
    nx, ny, nz = ((dims[0] + t - 1) // t, (dims[1] + t - 1) // t,
                  (dims[2] + t - 1) // t)
    w2c_R = np.asarray(c2w, np.float32)[:3, :3].T
    w2c_t = (-w2c_R @ np.asarray(c2w, np.float32)[:3, 3]).astype(np.float32)
    origin32 = np.asarray(origin, np.float32)
    vs32 = np.asarray(voxel_size, np.float32)
    fx, fy, cx, cy = K[0][0], K[1][1], K[0][2], K[1][2]
    eps = 1e-6

    def corner_test(base, edge):
        corners = np.stack(np.meshgrid([0, edge], [0, edge], [0, edge],
                                       indexing="ij"),
                           -1).reshape(-1, 3).astype(np.float32)
        pts = (base[:, None, :].astype(np.float32) + corners[None, :, :]) \
            * vs32 + origin32[None, None, :]
        cam = pts @ w2c_R.T + w2c_t
        z = cam[:, :, 2]
        u = fx * cam[:, :, 0] / np.maximum(z, eps) + cx
        v = fy * cam[:, :, 1] / np.maximum(z, eps) + cy
        front = z > 0
        any_front = front.any(1)
        u_lo = np.where(front, u, -np.inf).max(1)
        u_hi = np.where(front, u, np.inf).min(1)
        v_lo = np.where(front, v, -np.inf).max(1)
        v_hi = np.where(front, v, np.inf).min(1)
        # boxes straddling the camera plane are never culled by borders
        all_front = front.all(1)
        out = (((u_lo < -pad_px) | (u_hi >= im_w + pad_px)
                | (v_lo < -pad_px) | (v_hi >= im_h + pad_px)) & all_front)
        keep = any_front & ~out
        z_near = np.where(all_front, np.where(front, z, np.inf).min(1), 0.0)
        if max_depth is not None:
            keep = keep & (z_near <= max_depth)
        z_far = np.where(front, z, -np.inf).max(1)
        return keep, z_near, u, v, front, all_front, z_far

    n_tiles = nx * ny * nz
    s = 4 if n_tiles >= 4096 else 1
    if s > 1:
        # supertile prefilter: a culled superbox holds no kept child
        sx, sy, sz = (nx + s - 1) // s, (ny + s - 1) // s, (nz + s - 1) // s
        gx, gy, gz = np.meshgrid(np.arange(sx), np.arange(sy),
                                 np.arange(sz), indexing="ij")
        sbase = np.stack([gx, gy, gz], -1).reshape(-1, 3) * (s * t)
        skeep = corner_test(sbase, s * t)[0]
        child = np.stack(np.meshgrid(np.arange(s), np.arange(s),
                                     np.arange(s), indexing="ij"),
                         -1).reshape(-1, 3) * t
        base = (sbase[skeep][:, None, :] + child[None, :, :]).reshape(-1, 3)
        inside = ((base[:, 0] < nx * t) & (base[:, 1] < ny * t)
                  & (base[:, 2] < nz * t))
        base = base[inside]
    else:
        gx, gy, gz = np.meshgrid(np.arange(nx), np.arange(ny),
                                 np.arange(nz), indexing="ij")
        base = np.stack([gx, gy, gz], -1).reshape(-1, 3) * t

    keep, z_near, u, v, front, all_front, z_far_c = corner_test(base, t)
    if depth_map is not None and keep.any():
        d = np.asarray(depth_map)
        H, W = d.shape
        blk = 32 if H * W <= 640 * 480 else 16
        ph, pw = (-H) % blk, (-W) % blk
        if ph or pw:
            d = np.pad(d, ((0, ph), (0, pw)))
        dmax_blk = d.reshape(d.shape[0] // blk, blk,
                             d.shape[1] // blk, blk).max((1, 3))
        nbh, nbw = dmax_blk.shape
        with np.errstate(invalid="ignore"):
            bu0 = np.clip(np.floor((u.min(1) - pad_px) / blk),
                          0, nbw - 1).astype(np.int64)
            bu1 = np.clip(np.floor((u.max(1) + pad_px) / blk),
                          0, nbw - 1).astype(np.int64)
            bv0 = np.clip(np.floor((v.min(1) - pad_px) / blk),
                          0, nbh - 1).astype(np.int64)
            bv1 = np.clip(np.floor((v.max(1) + pad_px) / blk),
                          0, nbh - 1).astype(np.int64)
        bu0 = np.where(all_front, bu0, 0)
        bv0 = np.where(all_front, bv0, 0)
        bu1 = np.where(all_front, bu1, nbw - 1)
        bv1 = np.where(all_front, bv1, nbh - 1)
        ki = np.flatnonzero(keep)
        bi = np.arange(nbh * nbw)
        br, bc = bi // nbw, bi % nbw
        member = ((br[None, :] >= bv0[ki, None])
                  & (br[None, :] <= bv1[ki, None])
                  & (bc[None, :] >= bu0[ki, None])
                  & (bc[None, :] <= bu1[ki, None]))
        reg_max = np.where(member, dmax_blk.reshape(-1)[None, :], 0.0).max(1)
        far = z_near[ki] > lam_max * (reg_max + trunc)
        dead = reg_max <= 0
        keep[ki[far | dead]] = False
        if free_rotate is not None:
            phase, every = int(free_rotate[0]), int(free_rotate[1])
            if every > 1:
                dmin_blk = np.where(d > 0, d, np.inf).reshape(
                    d.shape[0] // blk, blk,
                    d.shape[1] // blk, blk).min((1, 3))
                reg_min = np.where(member, dmin_blk.reshape(-1)[None, :],
                                   np.inf).min(1)
                z_far = z_far_c[ki]
                margin = trunc + 2.0 * float(np.max(vs32))
                free = all_front[ki] & np.isfinite(reg_min) \
                    & (reg_min - z_far > margin)
                tid = ((base[ki, 0] // t).astype(np.int64) * ny
                       + base[ki, 1] // t) * nz + base[ki, 2] // t
                keep[ki[free & ((tid % every) != phase)]] = False
    return base[keep].astype(np.int32)


def _global_update(v, w, px, py, pz, depth_flat, color_flat, K, c2w,
                   trunc_margin, obs_weight, im_h, im_w):
    """Global-grid running-mean update of voxels v [M, 4] (tsdf, rgb), w
    [M] at world points px/py/pz [M] (reference mapper.py:37-158): the
    update is skipped where the fused tsdf would exceed 1, a negative
    observation weight on a voxel of weight <= 1 resets it
    (de-integration), color is fused with the tsdf and clamped to <= 1.
    Same operations in the same order as the JAX tile update."""
    cam_x, cam_y, cam_z, pix_x, pix_y = _project(px, py, pz, K, c2w)
    in_front = cam_z > 0
    in_image = (pix_x >= 0) & (pix_x < im_w) & (pix_y >= 0) & (pix_y < im_h)
    pxc = pix_x.clamp(0, im_w - 1)
    pyc = pix_y.clamp(0, im_h - 1)
    flat_pix = pyc * im_w + pxc
    depth_val = depth_flat[flat_pix]
    new_c = color_flat[flat_pix]
    vec_x = (pxc.to(torch.float32) - K[0, 2]) / K[0, 0]
    vec_y = (pyc.to(torch.float32) - K[1, 2]) / K[1, 1]
    lam = torch.sqrt(_fma(vec_x, vec_x, vec_y * vec_y) + 1.0)
    cam_norm = torch.sqrt(_fma(cam_z, cam_z,
                               _fma(cam_x, cam_x, cam_y * cam_y)))
    sdf = -((cam_norm / lam) - depth_val)
    update = (in_front & in_image & (depth_val > 0)
              & (sdf >= -trunc_margin))
    ts, cs = v[:, 0], v[:, 1:]
    dist = torch.clamp(sdf / trunc_margin, max=1.0)
    w_new = w + obs_weight
    inv = 1.0 / torch.where(w_new != 0, w_new, torch.ones_like(w_new))
    new_tsdf = (ts * w + obs_weight * dist) * inv
    fused_c = torch.clamp((cs * w[:, None] + obs_weight * new_c)
                          * inv[:, None], max=1.0)
    deint = (obs_weight < 0) & (w <= 1) & update
    do_upd = update & ~(new_tsdf > 1.0) & ~deint
    ts = torch.where(deint, 1.0, torch.where(do_upd, new_tsdf, ts))
    w = torch.where(deint, 0.0, torch.where(do_upd, w_new, w))
    cs = torch.where(deint[:, None], 0.0,
                     torch.where(do_upd[:, None], fused_c, cs))
    return torch.cat([ts[:, None], cs], -1), w


def integrate_global(gbv, gbw, depth, rgb, K, c2w, bound, *,
                     trunc_margin: float, obs_weight: float = 1.0,
                     tiles=None, tile: int | None = None,
                     chunk: int = 1 << 21, x0: int = 0):
    """Fuse one keyframe into the global grid gbv [R, R, R, 4] / gbw
    [R, R, R] in place (the JAX package returns new arrays; updating the
    touched voxels in place saves two copies of the 128 MB grid per
    keyframe). Voxel i maps to bound_min + i / R * extent. `tiles`: voxel
    offsets [n, 3] (multiples of `tile`) of the tiles to update — the
    voxels outside them are provably not updated, or rotated free space —,
    or None for the dense sweep over every voxel. depth [H, W] meters, rgb
    [H, W, 3] in [0, 1], K [3, 3], c2w [4, 4], bound [3, 2]: tensors on the
    grid's device. Voxels move through in chunks of `chunk`.

    gbv / gbw may also be the x-slab [S, R, R, ...] of the grid that starts
    at voxel x0 (parallel/sharding.sharded_fuse_frame): every voxel takes
    its global index, so the slab gets the bits the whole grid's sweep gives
    those voxels. A slab is swept densely (tiles None)."""
    R = gbv.shape[1]
    S = gbv.shape[0]
    if gbv.shape[:3] != (S, R, R) or gbw.shape != gbv.shape[:3]:
        raise ValueError(f"integrate_global: gbv {tuple(gbv.shape)}, gbw "
                         f"{tuple(gbw.shape)}")
    if not (0 <= x0 and x0 + S <= R):
        raise ValueError(f"slab [{x0}, {x0 + S}) lies outside the grid of "
                         f"{R}")
    if tiles is not None and S != R:
        raise ValueError("integrate_global sweeps a slab densely (tiles "
                         "None)")
    dev = gbv.device
    im_h, im_w = int(depth.shape[0]), int(depth.shape[1])
    v_flat = gbv.view(-1, 4)
    w_flat = gbw.view(-1)
    depth_flat = depth.reshape(-1)
    color_flat = rgb.reshape(-1, 3)
    origin = bound[:, 0]
    scale = bound[:, 1] - bound[:, 0]
    inv_r = float(np.float32(1.0 / R))
    obs = float(obs_weight)

    def coord(i, a):
        o = origin[a]
        return _fma(((o + i.to(torch.float32)) - o) * inv_r, scale[a], o)

    def run(lin):
        ix, iy, iz = lin // (R * R) + x0, (lin // R) % R, lin % R
        v2, w2 = _global_update(
            v_flat[lin], w_flat[lin], coord(ix, 0), coord(iy, 1),
            coord(iz, 2), depth_flat, color_flat, K, c2w, trunc_margin, obs,
            im_h, im_w)
        v_flat[lin] = v2
        w_flat[lin] = w2

    if tiles is None:
        n = S * R * R
        for s in range(0, n, chunk):
            run(torch.arange(s, min(s + chunk, n), device=dev))
        return gbv, gbw
    t = int(tile)
    loc = torch.arange(t ** 3, device=dev)
    li, lj, lk = loc // (t * t), (loc // t) % t, loc % t
    offs = torch.as_tensor(np.asarray(tiles, np.int64), device=dev)
    per = max(1, chunk // t ** 3)
    for s in range(0, offs.shape[0], per):
        o = offs[s:s + per]
        lin = (((o[:, 0:1] + li) * R + (o[:, 1:2] + lj)) * R
               + (o[:, 2:3] + lk)).reshape(-1)
        run(lin)
    return gbv, gbw
