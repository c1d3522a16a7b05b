"""Fused brick-window candidate scoring: CUDA kernel + plain PyTorch version.

Replaces the Pallas TPU kernel `remixfusion_tpu/ops/pallas/brick_eval.py`
(`_kernel`, through its wrapper `brick_eval`): score C pose candidates
against P tier pixels, each pixel with its own 4^3 TSDF window, and return
mean |tsdf - expected| per candidate with the low-count guard.

The kernel is `csrc/brick_eval.cu` (built for sm_90a with nvcc, bound with
ctypes); its header gives the bound and the design. Its entry is
`brick_eval_volume`, the tracker's: each pixel's window is gathered from
the brick-major volume inside the kernel at the pixel's integer base and,
for the tracker's default bfloat16 track view, rounded through bfloat16; a
float32 track view scores the cells unrounded, as the JAX package does
(the quad-pack mirror of the TPU path is not ported: it only fed VMEM).
One launch per call, deterministic (fixed-order reduction, no atomics on
the sums). Its plain version is `fetch_windows` followed by
`brick_eval_reference`. No PyTorch call computes this function,
so there is no library yardstick.

`brick_eval` takes the JAX wrapper's layout, windows given as bricks
[P, >=64], and runs `brick_eval_reference` on CPU tensors: the function
held against the JAX `brick_eval`. It has no kernel and raises on a CUDA
tensor.

Argument layout: params f32[32], pix f32[P, >=8] (gx gy gz gt bx by bz ok),
table f32[>=6, C] (rows tx ty tz qx qy qz); windows in cell order
(dx*4+dy)*4+dz. Unlike the TPU kernel it takes any P and C (no 128 padding)
and any row width >= 8. On a CPU tensor `brick_eval_volume` runs its plain
version; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from remixfusion_tpu_torch.ops.tsdf import window_index

BRICK_SIDE = 4
BRICK_CELLS = BRICK_SIDE ** 3
# launch shape of csrc/brick_eval.cu: 256 threads a CTA, 2 candidates per
# thread, the CTAs an SM holds (the kernel's __launch_bounds__), pixels per
# tile
_THREADS = 256
_CAND_PER_THREAD = 2
_CTAS_PER_SM = 3
_TILE_PIX = 8


def brick_eval_reference(params, pix, bricks, table, *,
                         interp: str = "nearest") -> torch.Tensor:
    """Plain PyTorch version, the same float32 arithmetic in the same order
    as the kernel, materialising [C, P] intermediates."""
    vals, valid, _ = pair_terms(params, pix, bricks, table, interp=interp)
    zero = torch.zeros_like(vals)
    sv = torch.where(valid, torch.abs(vals - pix[None, :, 3]), zero).sum(1)
    sc = valid.to(torch.float32).sum(1)
    cost = sv / (sc + 1e-6)
    return torch.where(sc >= 0.5 * sc[0], cost, torch.full_like(cost, 1e6))


def pair_terms(params, pix, bricks, table, *, interp: str = "nearest"):
    """Per (candidate, pixel) pair: the looked-up TSDF value, the valid mask
    (ok, in image, in window), and the mask of pairs that reach the window
    lookup (ok and in image) — [C, P] each."""
    p = params
    R00, R01, R02, R10, R11, R12, R20, R21, R22 = (p[i] for i in range(9))
    Tx, Ty, Tz = p[9], p[10], p[11]
    ss = p[12:18]
    fx, fy, cx, cy, Wf, Hf, inv_vox = (p[18 + i] for i in range(7))

    gx, gy, gz = (pix[None, :, i] for i in range(3))
    bx, by, bz = (pix[None, :, 4 + i] for i in range(3))
    ok = pix[None, :, 7] > 0

    t0, t1, t2, qx, qy, qz = (table[i, :, None] * ss[i] for i in range(6))
    q0 = torch.sqrt(torch.clamp(1.0 - (qx * qx + qy * qy + qz * qz),
                                min=1e-12))

    c1x = qy * gz - qz * gy
    c1y = qz * gx - qx * gz
    c1z = qx * gy - qy * gx
    c2x = qy * c1z - qz * c1y
    c2y = qz * c1x - qx * c1z
    c2z = qx * c1y - qy * c1x
    xw = gx + 2.0 * q0 * c1x + 2.0 * c2x + t0 + Tx
    yw = gy + 2.0 * q0 * c1y + 2.0 * c2y + t1 + Ty
    zw = gz + 2.0 * q0 * c1z + 2.0 * c2z + t2 + Tz

    rx, ry, rz = xw - Tx, yw - Ty, zw - Tz
    cam_x = R00 * rx + R10 * ry + R20 * rz
    cam_y = R01 * rx + R11 * ry + R21 * rz
    cam_z = R02 * rx + R12 * ry + R22 * rz
    safe_z = torch.where(cam_z != 0.0, cam_z, torch.full_like(cam_z, 1e-9))
    px = torch.floor(cam_x * fx / safe_z + cx + 0.5)
    py = torch.floor(cam_y * fy / safe_z + cy + 0.5)
    in_img = (px >= 0) & (py >= 0) & (px < Wf) & (py < Hf) & (cam_z >= 0)

    side = float(BRICK_SIDE)
    win = bricks[:, :BRICK_CELLS]
    rows = torch.arange(win.shape[0], device=win.device)[None, :]
    if interp == "trilinear":
        fxc = xw * inv_vox - bx
        fyc = yw * inv_vox - by
        fzc = zw * inv_vox - bz
        in_brick = ((fxc >= 0) & (fxc <= side - 1) & (fyc >= 0)
                    & (fyc <= side - 1) & (fzc >= 0) & (fzc <= side - 1))
        ix = torch.clamp(torch.floor(fxc), 0.0, side - 2)
        iy = torch.clamp(torch.floor(fyc), 0.0, side - 2)
        iz = torch.clamp(torch.floor(fzc), 0.0, side - 2)
        tx = torch.clamp(fxc - ix, 0.0, 1.0)
        ty = torch.clamp(fyc - iy, 0.0, 1.0)
        tz = torch.clamp(fzc - iz, 0.0, 1.0)
        o = (ix * side + iy) * side + iz
        o = torch.where(in_brick, o, torch.zeros_like(o)).to(torch.int64)

        def at(k):
            return win[rows, o + k]

        c00 = at(0) + tz * (at(1) - at(0))
        c01 = at(4) + tz * (at(5) - at(4))
        c10 = at(16) + tz * (at(17) - at(16))
        c11 = at(20) + tz * (at(21) - at(20))
        c0 = c00 + ty * (c01 - c00)
        c1 = c10 + ty * (c11 - c10)
        vals = c0 + tx * (c1 - c0)
    elif interp == "nearest":
        ox = torch.round(xw * inv_vox) - bx
        oy = torch.round(yw * inv_vox) - by
        oz = torch.round(zw * inv_vox) - bz
        in_brick = ((ox >= 0) & (ox < side) & (oy >= 0) & (oy < side)
                    & (oz >= 0) & (oz < side))
        # truncate then clip, like the TPU kernel: with a volume origin off
        # the voxel lattice the offsets are fractional
        o = ((ox * side + oy) * side + oz)
        o = torch.where(in_brick, o, torch.zeros_like(o)).to(torch.int64)
        vals = win[rows, o.clamp(0, BRICK_CELLS - 1)]
    else:
        raise ValueError(f"interp must be 'nearest' or 'trilinear', "
                         f"got {interp!r}")

    reached = ok & in_img
    return vals, reached & in_brick, reached


TRACK_DTYPES = ("bfloat16", "float32")


def fetch_windows(tsdf_bm, layout, base,
                  track_dtype: str = "bfloat16") -> torch.Tensor:
    """Per-pixel 4^3 windows [P, 64] of the brick-major volume tsdf_bm
    [NB, b^3] (layout (b, BY, BZ)) at integer bases [P, 3], cell order
    (dx*4 + dy)*4 + dz, in the track view's dtype (bfloat16: rounded like
    the JAX track volume and widened back to float32; float32: as they
    are): the plain version's gather."""
    win = tsdf_bm.reshape(-1)[window_index(layout, base, BRICK_SIDE)]
    if track_dtype == "bfloat16":
        return win.to(torch.bfloat16).to(torch.float32)
    return win


def brick_eval_volume_reference(params, pix, base, tsdf_bm, layout, table,
                                *, interp: str = "nearest",
                                track_dtype: str = "bfloat16"
                                ) -> torch.Tensor:
    """Plain version of brick_eval_volume: the gather, then the windowed
    plain version."""
    return brick_eval_reference(
        params, pix, fetch_windows(tsdf_bm, layout, base, track_dtype),
        table, interp=interp)


def _lib():
    from remixfusion_tpu_torch.ops import build

    fn = build.load("brick_eval").brick_eval_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, i, vp, ctypes.c_longlong, vp, i, i, i, vp,
                       vp, vp, vp, i, i, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


def launch_shape(n_cand: int, n_pix: int, n_sm: int) -> tuple:
    """(candidate blocks, splits, pixels per split): as many CTAs as the
    SMs hold at once, each split a whole number of _TILE_PIX-pixel tiles
    and none empty."""
    cblocks = -(-n_cand // (_THREADS * _CAND_PER_THREAD))
    tiles = max(1, -(-n_pix // _TILE_PIX))
    want = max(1, min(tiles, -(-_CTAS_PER_SM * n_sm // cblocks)))
    per = -(-tiles // want) * _TILE_PIX
    return cblocks, max(1, -(-n_pix // per)), per


_done = {}  # device -> zeroed int32 counters, one per candidate block


def _counters(dev, cblocks: int) -> torch.Tensor:
    buf = _done.get(dev)
    if buf is None or buf.numel() < cblocks:
        buf = torch.zeros(max(cblocks, 64), dtype=torch.int32, device=dev)
        _done[dev] = buf
    return buf


def _check(params, pix, table, interp, extra):
    if interp not in ("nearest", "trilinear"):
        raise ValueError(f"interp must be 'nearest' or 'trilinear', "
                         f"got {interp!r}")
    if (params.shape != (32,) or pix.dim() != 2 or pix.shape[1] < 8
            or table.dim() != 2 or table.shape[0] < 6):
        raise ValueError(
            f"brick_eval shapes: params {tuple(params.shape)}, pix "
            f"{tuple(pix.shape)}, table {tuple(table.shape)}")
    tensors = (params, pix, table, extra)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("brick_eval takes float32 tensors")
    dev = pix.device
    if any(t.device != dev for t in tensors):
        raise ValueError("brick_eval inputs must share one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"brick_eval: unsupported device {dev}")
    return dev


def brick_eval_volume(params, pix, base, tsdf_bm, layout, table, *,
                      interp: str = "nearest", split_for: int | None = None,
                      track_dtype: str = "bfloat16"):
    """Cost [C] of every candidate, each pixel's window read from the
    brick-major volume tsdf_bm [NB, b^3] (layout (b, BY, BZ)) at its
    integer base (int32 [P, 3]) — the tracker's entry. track_dtype is the
    tracker's view of the volume: "bfloat16" rounds the window cells
    through bfloat16, "float32" scores them as they are (one kernel
    instantiation per lookup mode and track dtype, each with its count in
    brick_eval_volume.launches_by_kind). Every window must lie inside the
    volume (the tracker clamps its bases so). On a CPU tensor:
    brick_eval_volume_reference; on a CUDA tensor: the kernel, or an error.

    split_for: the candidate count whose launch splits the pixel axis
    (default C). A candidate's cost depends on the split alone, so a slice
    of a table (with the identity candidate first) launched with
    split_for = the whole table's count gets the bits the whole table's
    launch gives those candidates: candidate-sharded tracking relies on
    it."""
    from remixfusion_tpu_torch.ops import build

    dev = _check(params, pix, table, interp, tsdf_bm)
    if track_dtype not in TRACK_DTYPES:
        raise ValueError(f"track_dtype must be one of {TRACK_DTYPES}, got "
                         f"{track_dtype!r}")
    b, BY, BZ = (int(v) for v in layout)
    if (base.dtype != torch.int32 or base.shape != (pix.shape[0], 3)
            or base.device != dev or tsdf_bm.dim() != 2
            or tsdf_bm.shape[1] != b ** 3):
        raise ValueError(
            f"brick_eval_volume: base {base.dtype} {tuple(base.shape)}, "
            f"volume {tuple(tsdf_bm.shape)}, layout {(b, BY, BZ)}")
    if dev.type == "cpu":
        return brick_eval_volume_reference(params, pix, base, tsdf_bm,
                                           (b, BY, BZ), table, interp=interp,
                                           track_dtype=track_dtype)
    if not (params.is_contiguous() and table.is_contiguous()
            and pix.stride(1) == 1 and base.is_contiguous()
            and tsdf_bm.is_contiguous()):
        raise ValueError("brick_eval_volume needs contiguous params, table, "
                         "base and volume, and unit-stride rows in pix")
    n_pix, n_cand = pix.shape[0], table.shape[1]
    out = torch.empty((n_cand,), dtype=torch.float32, device=dev)
    if n_pix == 0:  # no pixel counts: cost 0, guard 0 >= 0 holds
        return out.zero_()
    n_sm = build.sm_count(dev)
    cblocks, splits, per = launch_shape(n_cand, n_pix, n_sm)
    if split_for is not None:
        _, splits, per = launch_shape(int(split_for), n_pix, n_sm)
    partial = torch.empty((splits * (2 * n_cand + cblocks),),
                          dtype=torch.float32, device=dev)
    rc = _lib()(params.data_ptr(), pix.data_ptr(), pix.stride(0),
                tsdf_bm.data_ptr(), tsdf_bm.stride(0), base.data_ptr(), b,
                BY, BZ, table.data_ptr(), partial.data_ptr(),
                _counters(dev, cblocks).data_ptr(), out.data_ptr(), n_cand,
                n_pix, splits, per, int(interp == "trilinear"),
                int(track_dtype == "bfloat16"),
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"brick_eval kernel launch failed: CUDA error {rc}")
    brick_eval_volume.launches += 1
    kind = f"{interp}/{track_dtype}"
    by_kind = brick_eval_volume.launches_by_kind
    by_kind[kind] = by_kind.get(kind, 0) + 1
    return out


# launches in all, and per instantiation ("nearest/bfloat16", ...)
brick_eval_volume.launches = 0
brick_eval_volume.launches_by_kind = {}


def brick_eval(params, pix, bricks, table, *, interp: str = "nearest"):
    """Cost [C] of every candidate, with the windows given as bricks
    [P, >=64] (the JAX wrapper's layout; used as they are): the plain
    version, on CPU tensors only; a CUDA tensor raises (the kernel's entry
    is brick_eval_volume)."""
    dev = _check(params, pix, table, interp, bricks)
    if (bricks.dim() != 2 or bricks.shape[0] != pix.shape[0]
            or bricks.shape[1] < BRICK_CELLS):
        raise ValueError(f"brick_eval shapes: pix {tuple(pix.shape)}, "
                         f"bricks {tuple(bricks.shape)}")
    if dev.type != "cpu":
        raise ValueError("brick_eval has no kernel for windows given as a "
                         "tensor: on a CUDA device use brick_eval_volume")
    return brick_eval_reference(params, pix, bricks, table, interp=interp)
