"""Peaks of one NVIDIA H100 and the operation and byte counts of the
port's two hand-written kernels and of a frame's field work.

The peaks are NVIDIA's data sheet (SXM part, dense rates). The kernel
counts are frozen copies of chip_smoke.py's (OPS_PAIR, OPS_LOOKUP and the
byte counts beside them, chip_smoke.py:411-419 and its kernel phases):
operations and bytes the algorithm needs for a call, from its shapes and,
where the work depends on the data, from its inputs.
"""

from __future__ import annotations

PEAK_FP32 = 67e12      # FP32 operations a second, outside the tensor cores
PEAK_BYTES = 3.35e12   # HBM3 bytes a second

# brick_eval: FP32 operations per (candidate, pixel) pair for the transform
# and reprojection, and per pair that reaches its window for the lookup and
# accumulation
OPS_PAIR = 64
OPS_LOOKUP = {"nearest": 17, "trilinear": 53}


def brick_eval_counts(C: int, P: int, pix_cols: int, table_rows: int,
                      reached: int, interp: str = "nearest") -> tuple:
    """(operations, bytes) of one brick_eval_volume launch over C
    candidates and P pixels, `reached` pairs reaching a window: params,
    pix, base and table read once, each pixel's 64 window cells read once,
    the C costs written once."""
    ops = C * P * OPS_PAIR + reached * OPS_LOOKUP[interp]
    nbytes = 4 * (32 + P * (pix_cols + 3 + 64) + C * table_rows + C)
    return ops, nbytes


def hash_table_grad_counts(n_points: int, levels: int, rows: int) -> tuple:
    """(operations, bytes) of one hash_table_grad launch: x and grad_out
    read once and the [rows, 2] table gradient written once; ~34 FP32
    operations per (point, level) for positions and weights and 4 per
    corner for its weight and contribution."""
    nbytes = 4 * (n_points * 3 + n_points * levels * 2) + 4 * rows * 2
    ops = n_points * levels * (34 + 8 * 4)
    return ops, nbytes


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the chip could take: operations or bytes at peak."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def mlp_flops(dims: list) -> int:
    """Multiply-add operations (2 each) of one point through a bias-free
    MLP of layer widths dims."""
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def decoder_dims(cfg: dict, enc_dim: int) -> tuple:
    """Layer widths of the SDF and colour decoders (decoder section)."""
    d = cfg["decoder"]
    pos = 3 * int(cfg["pos"]["n_bins"])
    sdf = ([enc_dim + pos + 1] + [d["hidden_dim"]] * (d["num_layers"] - 1)
           + [1 + d["geo_feat_dim"]])
    color = ([pos + 3 + d["geo_feat_dim"]]
             + [d["hidden_dim_color"]] * (d["num_layers_color"] - 1) + [3])
    return sdf, color


def field_point_flops(cfg: dict, enc_dim: int) -> int:
    """FP32 operations of one sample point through both decoders, forward
    and backward (the backward counted as twice the forward)."""
    sdf, color = decoder_dims(cfg, enc_dim)
    return 3 * (mlp_flops(sdf) + mlp_flops(color))


def encoding_dim(cfg: dict) -> int:
    """Feature width of the residual encoding: CPGrid's 16 + 32 + 48 + 48
    channels, HashGrid's 16 levels of 2."""
    name = cfg["grid"]["enc"].lower()
    if "cpgrid" in name:
        return 16 + 32 + 48 + 48
    if "hash" in name:
        return 16 * 2
    raise ValueError(f"no encoding width for {cfg['grid']['enc']}")


def reached_pairs(params, pix, table, chunk: int = 1024) -> int:
    """(candidate, pixel) pairs of one brick_eval launch that reach the
    window lookup: the pixel is valid and the candidate moves its vertex
    into the image in front of the camera (the geometry of the plain
    version's pair terms, ops/brick_eval.py, with the pose's translation
    added and taken off again left out), counted from the inputs."""
    import torch

    p = params.float()
    R = p[:9].reshape(3, 3)
    ss = p[12:18]
    fx, fy, cx, cy, Wf, Hf = (p[18 + i] for i in range(6))
    g = pix[:, :3].float()
    ok = pix[:, 7] > 0
    total = 0
    for s in range(0, table.shape[1], chunk):
        tab = table[:6, s:s + chunk].float()
        t = tab[:3].T * ss[:3]
        q = tab[3:].T * ss[3:]
        q0 = torch.sqrt(torch.clamp(1.0 - (q * q).sum(-1), min=1e-12))
        gx, gy, gz = g[None, :, 0], g[None, :, 1], g[None, :, 2]
        qx, qy, qz = q[:, 0, None], q[:, 1, None], q[:, 2, None]
        c1x, c1y, c1z = qy * gz - qz * gy, qz * gx - qx * gz, qx * gy - qy * gx
        w = [gx + 2.0 * q0[:, None] * c1x + 2.0 * (qy * c1z - qz * c1y)
             + t[:, 0, None],
             gy + 2.0 * q0[:, None] * c1y + 2.0 * (qz * c1x - qx * c1z)
             + t[:, 1, None],
             gz + 2.0 * q0[:, None] * c1z + 2.0 * (qx * c1y - qy * c1x)
             + t[:, 2, None]]
        cam = [R[0, a] * w[0] + R[1, a] * w[1] + R[2, a] * w[2]
               for a in range(3)]
        z = torch.where(cam[2] != 0.0, cam[2], torch.full_like(cam[2], 1e-9))
        px = torch.floor(cam[0] * fx / z + cx + 0.5)
        py = torch.floor(cam[1] * fy / z + cy + 0.5)
        reach = (ok[None, :] & (px >= 0) & (py >= 0) & (px < Wf)
                 & (py < Hf) & (cam[2] >= 0))
        total += int(reach.sum())
    return total
