"""Write a real-sensor dataset layout rendered from the synthetic scene.

    python -m remixfusion_tpu_torch.tools.write_layout \
        --config configs/Tum/fr1_desk.yaml --layout tum --out DIR \
        [--frames 40] [--color_size W H] [--degrees_per_frame 1.2]

Renders the analytic synthetic room (configs/Synthetic/synthetic.yaml's
scene, an orbit of 1.2 degrees per frame by default, 2.8 cm per frame at
its 1.35 m radius) at the target config's own raw
camera (cam.H, W, fx, fy, cx, cy, before any crop) and writes it in the
on-disk format of a real capture, so a real config runs through its
loader end to end: `python run_torch.py --config <target> --input_folder
DIR`, with mapping.bound / marching_cubes_bound set to the room (the
ground truth poses are in the layout). Layouts: tum (rgb.txt, depth.txt,
groundtruth.txt, rgb/ + depth/ PNG), bs3d (color/ PNG, depth/, poses.txt),
replica (results/frame*.jpg + depth*.png, traj.txt), scannet (color/*.jpg,
depth/, pose/*.txt), fastsyn (color/ PNG, depth/, traj.txt), azure
(zero-padded color/*.jpg, depth/, pose/), largeindoor (the ScanNet
structure with PNG colour) and iphone (images/, depth/, odometry.csv).

Depth is 16-bit PNG at cam.png_depth_scale. Colour is rendered once at the
depth camera and resampled (bilinear) for the colour camera:
  - at --color_size, larger or smaller than depth, so the loader's colour
    resize runs;
  - through cam.distortion: the colour is distorted so that the loader's
    cv2-exact undistort (with the intrinsics the pipeline hands it) brings
    it back onto the depth pixels.
PNG files go through utils/imageio; JPEG files (replica, scannet, azure)
through OpenCV.
"""

from __future__ import annotations

import argparse
import copy
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from remixfusion_tpu_torch.datasets.base import update_cam
from remixfusion_tpu_torch.utils import imageio

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# threads resampling and writing frames (zlib and numpy release the GIL)
_WORKERS = min(8, os.cpu_count() or 1)
SCENE_CONFIG = os.path.join(ROOT, "configs", "Synthetic", "synthetic.yaml")
LAYOUTS = ("tum", "bs3d", "replica", "scannet", "fastsyn", "azure",
           "largeindoor", "iphone")
ROOM = [[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]]  # the synthetic room's bound


def scene_dataset(target_cfg, n_frames: int,
                  degrees_per_frame: float = 1.2):
    """The synthetic scene rendered at target_cfg's raw camera."""
    from remixfusion_tpu_torch.config import load_config
    from remixfusion_tpu_torch.datasets.synthetic import SyntheticDataset

    cfg = load_config(SCENE_CONFIG)
    cam = target_cfg["cam"]
    cfg["cam"].update({k: cam[k] for k in ("H", "W", "fx", "fy", "cx",
                                            "cy", "far")})
    cfg["cam"]["crop_edge"] = 0
    syn = cfg["data"]["synthetic"]
    syn["n_frames"] = n_frames
    syn["orbit_degrees"] = degrees_per_frame * n_frames
    return SyntheticDataset(cfg)


def _bilinear_u8(img, px, py):
    """img [H, W, 3] uint8 sampled at float pixel positions (px, py);
    outside the image reads 0."""
    h, w = img.shape[:2]
    x0, y0 = np.floor(px).astype(np.int64), np.floor(py).astype(np.int64)
    fx, fy = px - x0, py - y0
    out = np.zeros(px.shape + (3,), np.float64)
    for dy, dx, wt in ((0, 0, (1 - fy) * (1 - fx)), (0, 1, (1 - fy) * fx),
                       (1, 0, fy * (1 - fx)), (1, 1, fy * fx)):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        tap = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
        out += np.where(inside[..., None], tap, 0) * wt[..., None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def _undistort_points(xd, yd, dist, iters: int = 40):
    """Normalized distorted coordinates -> undistorted (the fixed-point
    iteration of cv::undistortPoints) and where it converged."""
    d = np.zeros(5)
    d[:len(dist)] = dist
    k1, k2, p1, p2, k3 = d
    x, y = xd.copy(), yd.copy()
    for _ in range(iters):
        r2 = x * x + y * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        x, y = (xd - dx) / kr, (yd - dy) / kr
    r2 = x * x + y * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    ex = x * kr + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) - xd
    ey = y * kr + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y - yd
    return x, y, np.hypot(ex, ey) < 1e-9


def color_source_positions(target_cfg, color_hw):
    """For every pixel of the colour image to write, the (x, y) position
    in the depth camera's pinhole image whose colour it holds."""
    cam = target_cfg["cam"]
    H, W = int(cam["H"]), int(cam["W"])
    hc, wc = color_hw
    v, u = np.meshgrid(np.arange(hc, dtype=np.float64),
                       np.arange(wc, dtype=np.float64), indexing="ij")
    if cam.get("distortion") is None:
        # the loader's linear resize samples colour at half-pixel centres
        return (u + 0.5) * W / wc - 0.5, (v + 0.5) * H / hc - 0.5
    if (hc, wc) != (H, W):
        raise ValueError("write_layout: distorted colour must be written at "
                         "the depth size")
    # the loader undistorts with the intrinsics after update_cam
    kq = update_cam(copy.deepcopy(cam))
    x, y, ok = _undistort_points((u - kq["cx"]) / kq["fx"],
                                 (v - kq["cy"]) / kq["fy"],
                                 np.asarray(cam["distortion"], np.float64))
    px = np.where(ok, kq["fx"] * x + kq["cx"], -1e9)
    py = np.where(ok, kq["fy"] * y + kq["cy"], -1e9)
    return px, py


def render_frames(target_cfg, n_frames: int, color_hw=None,
                  degrees_per_frame: float = 1.2):
    """[(rgb uint8 [Hc, Wc, 3] RGB, depth float32 [H, W], c2w)] for the
    first n_frames of the orbit, rendered into the scene's disk cache (in
    worker processes when there are enough, SyntheticDataset.render_missing)
    and read back from it, resampled on threads."""
    ds = scene_dataset(target_cfg, n_frames, degrees_per_frame)
    hw = (int(target_cfg["cam"]["H"]), int(target_cfg["cam"]["W"]))
    color_hw = hw if color_hw is None else tuple(color_hw)
    resample = (color_hw != hw
                or target_cfg["cam"].get("distortion") is not None)
    pos = color_source_positions(target_cfg, color_hw) if resample else None
    ds.render_missing(range(n_frames))

    def one(i):
        # the cache holds the scene's own quantization of the colour
        with np.load(ds._disk_cache_path(i)) as data:
            rgb8, depth = data["rgb"], data["depth"]
        if pos is not None:
            rgb8 = _bilinear_u8(rgb8, *pos)
        return rgb8, depth, np.asarray(ds.poses[i], np.float32)

    with ThreadPoolExecutor(_WORKERS) as ex:
        return list(ex.map(one, range(n_frames)))


def _quat_xyzw(R):
    from scipy.spatial.transform import Rotation

    return Rotation.from_matrix(np.asarray(R, np.float64)).as_quat()


def _write_jpeg(path, rgb8):
    import cv2

    if not cv2.imwrite(path, rgb8[..., ::-1],
                       [cv2.IMWRITE_JPEG_QUALITY, 95]):
        raise OSError(f"cv2 could not write {path}")


def _tq_row(c2w):
    q = _quat_xyzw(c2w[:3, :3])
    t = c2w[:3, 3].astype(np.float64)
    return " ".join(f"{v:.9f}" for v in (*t, *q))


def write_layout(target_cfg, layout: str, out_dir: str, n_frames: int,
                 color_hw=None, degrees_per_frame: float = 1.2):
    """Render n_frames and write them under out_dir in `layout`'s format
    (the frames' files on threads). Returns the ground-truth c2w poses
    [n_frames, 4, 4]."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r} (known: {LAYOUTS})")
    frames = render_frames(target_cfg, n_frames, color_hw,
                           degrees_per_frame)
    scale = float(target_cfg["cam"]["png_depth_scale"])

    def d16(depth):
        return np.clip(np.rint(depth.astype(np.float64) * scale), 0,
                       65535).astype(np.uint16)

    def sub(*parts):
        path = os.path.join(out_dir, *parts)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        return path

    os.makedirs(out_dir, exist_ok=True)

    def write(i):
        """frame i's files; its row of the layout's pose file, if any."""
        rgb8, depth, c2w = frames[i]
        if layout == "tum":
            t = f"{1000.0 + i / 30.0:.6f}"
            imageio.write_png(sub("rgb", f"{t}.png"), rgb8)
            imageio.write_png(sub("depth", f"{t}.png"), d16(depth))
            return t, _tq_row(c2w)
        elif layout == "bs3d":
            imageio.write_png(sub("color", f"{i}.png"), rgb8)
            imageio.write_png(sub("depth", f"{i}.png"), d16(depth))
            return f"{i} {_tq_row(c2w)}"
        elif layout in ("replica", "fastsyn"):
            if layout == "replica":
                _write_jpeg(sub("results", f"frame{i:06d}.jpg"), rgb8)
                imageio.write_png(sub("results", f"depth{i:06d}.png"),
                                  d16(depth))
            else:
                imageio.write_png(sub("color", f"{i}.png"), rgb8)
                imageio.write_png(sub("depth", f"{i}.png"), d16(depth))
            return " ".join(f"{v:.9g}" for v in c2w.reshape(-1))
        elif layout in ("scannet", "azure", "largeindoor"):
            name = f"{i:06d}" if layout == "azure" else f"{i}"
            if layout == "largeindoor":
                imageio.write_png(sub("color", f"{name}.png"), rgb8)
            else:
                _write_jpeg(sub("color", f"{name}.jpg"), rgb8)
            imageio.write_png(sub("depth", f"{name}.png"), d16(depth))
            np.savetxt(sub("pose", f"{name}.txt"), c2w.astype(np.float64))
        else:  # iphone
            imageio.write_png(sub("images", f"{i:06d}.png"), rgb8)
            imageio.write_png(sub("depth", f"{i:06d}.png"), d16(depth))
            tq = _tq_row(c2w).replace(" ", ",")
            return f"{i / 30.0:.6f},{i},{tq}"

    with ThreadPoolExecutor(_WORKERS) as ex:
        rows = [r for r in ex.map(write, range(len(frames))) if r is not None]
    if layout == "tum":
        with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
            f.write("# timestamp filename\n" + "".join(
                f"{t} rgb/{t}.png\n" for t, _ in rows))
        with open(os.path.join(out_dir, "depth.txt"), "w") as f:
            f.write("# timestamp filename\n" + "".join(
                f"{t} depth/{t}.png\n" for t, _ in rows))
        with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
            f.write("# timestamp tx ty tz qx qy qz qw\n" + "".join(
                f"{t} {tq}\n" for t, tq in rows))
    elif layout == "bs3d":
        with open(os.path.join(out_dir, "poses.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    elif layout in ("replica", "fastsyn"):
        with open(os.path.join(out_dir, "traj.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")
    elif layout == "iphone":
        with open(os.path.join(out_dir, "odometry.csv"), "w") as f:
            f.write("timestamp,frame,x,y,z,qx,qy,qz,qw\n"
                    + "\n".join(rows) + "\n")
    return np.stack([c2w for _, _, c2w in frames])


def main(argv=None):
    from remixfusion_tpu_torch.config import load_config

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", required=True,
                    help="target config whose cam the frames are rendered "
                         "at")
    ap.add_argument("--layout", required=True, choices=LAYOUTS)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--color_size", type=int, nargs=2, metavar=("W", "H"),
                    help="write colour at W x H (default: the depth size)")
    ap.add_argument("--degrees_per_frame", type=float, default=1.2,
                    help="orbit speed (default 1.2, 2.8 cm per frame)")
    args = ap.parse_args(argv)
    cfg = load_config(args.config)
    hw = None if args.color_size is None else (args.color_size[1],
                                               args.color_size[0])
    write_layout(cfg, args.layout, args.out, args.frames, hw,
                 degrees_per_frame=args.degrees_per_frame)
    print(f"wrote {args.frames} frames of the {args.layout} layout to "
          f"{args.out}; run with mapping.bound = marching_cubes_bound = "
          f"{ROOM}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
