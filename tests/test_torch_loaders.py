"""Port parity for the real-sensor path's host side: utils/imageio (PNG
decode / encode, resize, undistort) against OpenCV, the eleven loaders of
datasets/loaders.py against the JAX package's on the same directories
(the fixture writers of tests/test_loaders.py), the dataset factory's
names, and tools/preprocess.py / tools/check_data.py against the JAX
tools.

Depth, poses, frame ids and lengths are bitwise equal. Colour is bitwise
where no resize runs (PNG, and JPEG through cv2 on both sides); a resize
(colour to the depth size, crop_size, downsample) is held to 1e-6: the
port computes cv::resize's taps and weights, in another order (1e-13 on
float64 before the float32 cast). Undistort reproduces cv::undistort's
1/32-pixel map and 15-bit fixed-point blend and is held bitwise."""

import copy
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from helpers import tiny_config  # noqa: E402
from remixfusion_tpu.datasets import get_dataset as jax_get_dataset  # noqa
from remixfusion_tpu.tools import check_data as jax_check  # noqa: E402
from remixfusion_tpu.tools import preprocess as jax_pre  # noqa: E402
from remixfusion_tpu_torch.datasets import get_dataset  # noqa: E402
from remixfusion_tpu_torch.datasets import loaders  # noqa: E402
from remixfusion_tpu_torch.datasets.base import update_cam  # noqa: E402
from remixfusion_tpu_torch.tools import check_data, preprocess  # noqa
from remixfusion_tpu_torch.utils import imageio  # noqa: E402
from test_loaders import H, W, cam_cfg, write_frame  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TUM_DIST = [0.2624, -0.9531, -0.0054, 0.0026, 1.1633]


# ------------------------------------------------------------------ PNG

def _test_image(kind, seed=0, h=37, w=53):
    """Gradients + noise (mixed PNG filter choices), odd sizes."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(3 * xx + yy) % 256, (xx * yy) % 251,
                     rng.integers(0, 256, (h, w)),
                     (7 * yy + 40) % 256], -1)
    if kind == "rgb":
        return base[..., :3].astype(np.uint8)
    if kind == "rgba":
        return base.astype(np.uint8)
    if kind == "gray":
        return base[..., 0].astype(np.uint8)
    return (1500 * xx + 700 * yy + rng.integers(0, 300, (h, w))).astype(
        np.uint16)  # gray16


def _cv2_write(path, img, level):
    bgr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    assert cv2.imwrite(path, bgr, [cv2.IMWRITE_PNG_COMPRESSION, level])


def _filter_types(path):
    """The filter byte of every row of a PNG (inflated IDAT)."""
    import zlib

    img, _ = imageio.read_png(path)
    data = open(path, "rb").read()
    idat = b"".join(body for kind, body in imageio._chunks(data, path)
                    if kind == b"IDAT")
    raw = zlib.decompress(idat)
    h = img.shape[0]
    row = len(raw) // h
    return {raw[i * row] for i in range(h)}


@pytest.mark.parametrize("level", [0, 3, 9])
@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray16"])
def test_png_decode_matches_cv2(tmp_path, kind, level):
    img = _test_image(kind, seed=level)
    path = str(tmp_path / f"{kind}.png")
    _cv2_write(path, img, level)
    if kind == "gray16":
        ours = imageio.imread_unchanged(path)
        ref = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        assert ours.dtype == np.uint16
    else:
        ours = imageio.imread_color(path)
        ref = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR),
                           cv2.COLOR_BGR2RGB)
        if kind == "gray":
            assert np.array_equal(imageio.imread_unchanged(path),
                                  cv2.imread(path, cv2.IMREAD_UNCHANGED))
    assert ours.shape == ref.shape and np.array_equal(ours, ref)


def test_png_cv2_files_cover_every_filter_type(tmp_path):
    """The decode cases above meet the four predicting filter types (Sub,
    Up, Average, Paeth: libpng filters adaptively at every level); type 0
    comes from write_png(filter='none'), read back by cv2 below."""
    seen = set()
    for level in (0, 3, 9):
        for kind in ("rgb", "rgba", "gray", "gray16"):
            path = str(tmp_path / f"{kind}{level}.png")
            _cv2_write(path, _test_image(kind, seed=level), level)
            seen |= _filter_types(path)
    assert {1, 2, 3, 4} <= seen, seen


@pytest.mark.parametrize("filt", ["none", "sub", "up"])
@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "gray16"])
def test_png_encode_round_trips_through_cv2(tmp_path, kind, filt):
    img = _test_image(kind, seed=5)
    path = str(tmp_path / f"{kind}.png")
    imageio.write_png(path, img, filter=filt, level=3)
    assert _filter_types(path) == {imageio._FILTERS[filt]}
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        back = back[..., [2, 1, 0, 3][:img.shape[2]]]
    assert back.dtype == img.dtype and np.array_equal(back, img)
    ours, _ = imageio.read_png(path)
    assert np.array_equal(ours, img)


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6])
def test_png_unfilter_native_matches_numpy(bpp):
    """The C++ unfilter against its numpy version on random scanlines
    with random filter types (all five, on every byte width)."""
    rng = np.random.default_rng(bpp)
    h, rowbytes = 23, 19 * bpp
    rows = rng.integers(0, 256, (h, rowbytes + 1), dtype=np.uint8)
    rows[:, 0] = rng.integers(0, 5, h)
    rows[:5, 0] = [0, 1, 2, 3, 4]
    raw = rows.tobytes()
    assert np.array_equal(imageio.unfilter(raw, h, rowbytes, bpp),
                          imageio.unfilter_reference(raw, h, rowbytes, bpp))
    bad = rows.copy()
    bad[7, 0] = 5
    for fn in (imageio.unfilter, imageio.unfilter_reference):
        with pytest.raises(ValueError, match="row 7"):
            fn(bad.tobytes(), h, rowbytes, bpp, name="x.png")


def _patch_ihdr(src, dst, offset, value):
    """Copy a PNG with one IHDR byte changed and its CRC recomputed."""
    import struct
    import zlib

    data = bytearray(open(src, "rb").read())
    data[16 + offset] = value
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    open(dst, "wb").write(bytes(data))


def test_png_unsupported_files_raise_with_name(tmp_path):
    rgb = str(tmp_path / "rgb.png")
    imageio.write_png(rgb, _test_image("rgb"))
    pal = str(tmp_path / "palette.png")
    _patch_ihdr(rgb, pal, 9, 3)  # colour type 3: palette
    with pytest.raises(ValueError, match="palette.png.*colour type 3"):
        imageio.read_png(pal)
    inter = str(tmp_path / "interlaced.png")
    _patch_ihdr(rgb, inter, 12, 1)  # Adam7 interlace
    with pytest.raises(ValueError, match="interlaced.png: interlaced"):
        imageio.read_png(inter)
    bad_crc = bytearray(open(rgb, "rb").read())
    bad_crc[40] ^= 0xFF  # a byte inside the IDAT chunk
    open(tmp_path / "crc.png", "wb").write(bytes(bad_crc))
    with pytest.raises(ValueError, match="crc.png: CRC mismatch"):
        imageio.read_png(str(tmp_path / "crc.png"))
    jpg = str(tmp_path / "a.jpg")
    cv2.imwrite(jpg, _test_image("rgb"))
    with pytest.raises(ValueError, match="a.jpg"):
        imageio.imread_unchanged(jpg)


def test_jpeg_reads_through_cv2_and_needs_it(tmp_path):
    img = _test_image("rgb")
    jpg = str(tmp_path / "frame.jpg")
    cv2.imwrite(jpg, img[..., ::-1])
    ref = cv2.cvtColor(cv2.imread(jpg), cv2.COLOR_BGR2RGB)
    assert np.array_equal(imageio.imread_color(jpg), ref)
    code = ("import sys\n"
            "sys.modules['cv2'] = None\n"
            "from remixfusion_tpu_torch.utils import imageio\n"
            "try:\n"
            f"    imageio.imread_color({jpg!r})\n"
            "except ImportError as e:\n"
            "    print('ImportError', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.startswith("ImportError") and jpg in out.stdout, (
        out.stdout, out.stderr)


# ------------------------------------------------------ resize, undistort

def _photo(h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([(xx * 0.4 + yy * 0.1) % 256,
                    np.sin(xx / 17.0) * 100 + 120,
                    rng.integers(0, 256, (h, w))], -1)
    return img.astype(np.uint8)


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (404, 532)), ((480, 640), (240, 320)),
    ((968, 1296), (480, 640)), ((480, 640), (968, 1296)),
    ((24, 32), (20, 28)), ((48, 64), (48, 64))])
def test_resize_linear_matches_cv2(src, dst):
    img = _photo(*src) / 255.0
    ref = cv2.resize(img, (dst[1], dst[0]))
    ours = imageio.resize(img, *dst)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    assert np.abs(ours - ref).max() <= 1e-6
    if src == dst:
        assert np.array_equal(ours, ref)


@pytest.mark.parametrize("src,dst", [
    ((480, 640), (404, 532)), ((480, 640), (240, 320)),
    ((480, 640), (160, 213)), ((24, 32), (44, 60))])
def test_resize_nearest_matches_cv2_bitwise(src, dst):
    depth = np.random.default_rng(2).uniform(0, 5, src).astype(np.float32)
    ref = cv2.resize(depth, (dst[1], dst[0]),
                     interpolation=cv2.INTER_NEAREST)
    assert np.array_equal(imageio.resize(depth, *dst, "nearest"), ref)


@pytest.mark.parametrize("factor", [2, 3])
def test_resize_area_matches_cv2_bitwise(factor):
    img = _photo(48 * factor, 64 * factor) / 255.0
    ref = cv2.resize(img, (64, 48), interpolation=cv2.INTER_AREA)
    assert np.array_equal(imageio.resize(img, 48, 64, "area"), ref)
    with pytest.raises(ValueError):
        imageio.resize(img, 47, 64, "area")


@pytest.mark.parametrize("shape,K", [
    ((480, 640), (517.3, 516.5, 318.6, 255.3)),
    # fr1_desk's intrinsics after crop_size / crop_edge, as the loader
    # hands them to undistort
    ((480, 640), (429.9993, 434.7266, 254.8373, 204.8748)),
    ((24, 32), (20.0, 20.0, 15.5, 11.5))])
def test_undistort_matches_cv2(shape, K):
    """Aimed at bits: the map quantized to 1/32 pixel as
    initUndistortRectifyMap does (in cv::undistort's row stripes) and the
    fixed-point blend of cv::remap. The test allows at most 1/255 on at
    most 0.5% of the pixels, for a map position a float64 ulp from a
    rounding boundary; every case here is bitwise."""
    img = _photo(*shape, seed=3)
    Km = np.array([[K[0], 0, K[2]], [0, K[1], K[3]], [0, 0, 1.0]])
    ref = cv2.undistort(img, Km, np.array(TUM_DIST))
    ours = imageio.undistort(img, Km, np.array(TUM_DIST))
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1 and (d > 0).mean() <= 0.005
    assert np.array_equal(ours, ref)


# --------------------------------------------------------------- loaders

def _tq_rows(n, seed):
    """n (tx ty tz qx qy qz qw) rows of unit quaternions."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return np.concatenate([rng.uniform(-1, 1, (n, 3)), q], 1)


def _mat_rows(n, seed):
    from scipy.spatial.transform import Rotation

    out = []
    for tq in _tq_rows(n, seed):
        c2w = np.eye(4)
        c2w[:3, :3] = Rotation.from_quat(tq[3:]).as_matrix()
        c2w[:3, 3] = tq[:3]
        out.append(c2w)
    return out


def _frame(path_rgb, path_depth, seed, color_hw=None):
    """write_frame's frame with a varied depth map (1-4 m in mm), colour
    optionally at another size."""
    write_frame(path_rgb, path_depth, seed=seed)
    depth = np.random.default_rng(seed + 100).integers(
        1000, 4000, (H, W)).astype(np.uint16)
    assert cv2.imwrite(path_depth, depth)
    if color_hw is not None:
        rgb = np.random.default_rng(seed).integers(
            0, 255, color_hw + (3,), dtype=np.uint8)
        assert cv2.imwrite(path_rgb, rgb)


def make_layout(kind, d, n=4, color_hw=None):
    """Write an n-frame `kind` layout under d; returns the dataset name."""
    os.makedirs(d, exist_ok=True)

    def sub(*parts):
        p = os.path.join(d, *parts)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    if kind == "replica":
        for i in range(n):
            _frame(sub("results", f"frame{i:06d}.jpg"),
                   sub("results", f"depth{i:06d}.png"), i, color_hw)
        np.savetxt(os.path.join(d, "traj.txt"),
                   np.stack([m.reshape(-1) for m in _mat_rows(n, 1)]))
    elif kind in ("fastsyn", "fastsyn_results"):
        for i in range(n):
            if kind == "fastsyn":
                _frame(sub("color", f"{i}.png"), sub("depth", f"{i}.png"),
                       i, color_hw)
            else:
                _frame(sub("results", f"frame{i:06d}.jpg"),
                       sub("results", f"depth{i:06d}.png"), i, color_hw)
        np.savetxt(os.path.join(d, "traj.txt"),
                   np.stack([m.reshape(-1) for m in _mat_rows(n, 2)]))
        kind = "Fast_syn"
    elif kind in ("bs3d", "uhumans"):
        ext = "jpg" if kind == "bs3d" else "png"
        for i in range(n):
            _frame(sub("color", f"{i}.{ext}"), sub("depth", f"{i}.png"), i,
                   color_hw)
        rows = np.concatenate([np.arange(n)[:, None], _tq_rows(n, 3)], 1)
        np.savetxt(os.path.join(d, "poses.txt"), rows)
        kind = "BS3D" if kind == "bs3d" else kind
    elif kind in ("scannet", "azure", "rgb", "realsense", "largeindoor"):
        ext = "png" if kind == "largeindoor" else "jpg"
        # numeric names past 9 show the numeric vs lexicographic orders
        names = ([f"{i:06d}" for i in range(n)] if kind in (
            "azure", "rgb", "realsense") else [str(i * 5) for i in range(n)])
        for i, name in enumerate(names):
            _frame(sub("color", f"{name}.{ext}"), sub("depth", f"{name}.png"),
                   i, color_hw)
        for name, m in zip(names, _mat_rows(n, 4)):
            np.savetxt(sub("pose", f"{name}.txt"), m)
        kind = "Largeindoor" if kind == "largeindoor" else kind
    elif kind == "iphone":
        for i in range(n):
            _frame(sub("images", f"{i}.png"), sub("depth", f"{i}.png"), i,
                   color_hw)
        rows = ["timestamp,frame,x,y,z,qx,qy,qz,qw"] + [
            ",".join(str(v) for v in [i / 30.0, i, *tq])
            for i, tq in enumerate(_tq_rows(n, 5))]
        open(os.path.join(d, "odometry.csv"), "w").write("\n".join(rows))
    elif kind == "tum":
        lines = {"rgb": ["# rgb"], "depth": ["# depth"], "gt": ["# gt"]}
        for i, tq in enumerate(_tq_rows(2 * n, 6)):
            # 60 fps: the 32 fps subsampling keeps every other frame
            t = 100.0 + i / 60.0
            _frame(sub("rgb", f"{t:.4f}.png"),
                   sub("depth", f"{t + 0.004:.4f}.png"), i, color_hw)
            lines["rgb"].append(f"{t:.4f} rgb/{t:.4f}.png")
            lines["depth"].append(f"{t + 0.004:.4f} depth/{t + 0.004:.4f}"
                                  f".png")
            lines["gt"].append(f"{t + 0.002:.4f} "
                               + " ".join(f"{v:.9f}" for v in tq))
        for name, fn in (("rgb", "rgb.txt"), ("depth", "depth.txt"),
                         ("gt", "groundtruth.txt")):
            open(os.path.join(d, fn), "w").write("\n".join(lines[name]))
    else:
        raise ValueError(kind)
    return kind


def _cfg(name, d, cam=None, data=None):
    cfg = tiny_config(dataset=name, data={"datadir": str(d), **(data or {})},
                      **cam_cfg())
    cfg["cam"].update(cam or {})
    update_cam(cfg["cam"])  # the pipelines apply it before the dataset
    return cfg


def _assert_same(ds_t, ds_j, rgb_tol=0.0):
    assert len(ds_t) == len(ds_j) > 0
    assert type(ds_t).__name__ == type(ds_j).__name__
    for i in range(len(ds_j)):
        ft, fj = ds_t[i], ds_j[i]
        assert ft["frame_id"] == fj["frame_id"]
        for k in ("c2w", "depth"):
            a, b = np.asarray(ft[k]), np.asarray(fj[k])
            assert a.dtype == b.dtype and np.array_equal(a, b), (i, k)
        assert ft["rgb"].dtype == fj["rgb"].dtype == np.float32
        assert ft["rgb"].shape == fj["rgb"].shape
        if rgb_tol:
            assert np.abs(ft["rgb"] - fj["rgb"]).max() <= rgb_tol, i
        else:
            assert np.array_equal(ft["rgb"], fj["rgb"]), i
        assert np.array_equal(ft["direction"], np.asarray(fj["direction"]))
    assert ds_t.H == ds_j.H and ds_t.W == ds_j.W
    assert np.array_equal(ds_t.K(), ds_j.K())


FAMILIES = ["replica", "fastsyn", "fastsyn_results", "bs3d", "uhumans",
            "scannet", "azure", "rgb", "realsense", "largeindoor", "iphone",
            "tum"]


@pytest.mark.parametrize("kind", FAMILIES)
def test_loader_matches_jax(tmp_path, kind):
    name = make_layout(kind, str(tmp_path / kind))
    cfg = _cfg(name, tmp_path / kind)
    ds_t = get_dataset(copy.deepcopy(cfg))
    _assert_same(ds_t, jax_get_dataset(copy.deepcopy(cfg)))
    assert len(ds_t) == 4


@pytest.mark.parametrize("kind,case", [
    ("tum", "crop_size"), ("scannet", "crop_edge"), ("bs3d", "downsample"),
    ("replica", "max_frames"), ("tum", "distortion"),
    ("largeindoor", "color_larger"), ("fastsyn", "color_smaller"),
    ("tum", "all")])
def test_loader_options_match_jax(tmp_path, kind, case):
    """crop_size (colour INTER_LINEAR, depth INTER_NEAREST), crop_edge,
    data.downsample 2 (INTER_AREA / INTER_NEAREST), max_frames, the
    five-term distortion and colour at another size than depth."""
    color_hw = {"color_larger": (2 * H + 6, 2 * W + 10),
                "color_smaller": (H - 6, W - 8)}.get(case)
    name = make_layout(kind, str(tmp_path / kind), color_hw=color_hw)
    cam, data = {}, {}
    if case in ("crop_size", "all"):
        cam["crop_size"] = [16, 24]
    if case in ("crop_edge", "all"):
        cam["crop_edge"] = 2
    if case in ("distortion", "all"):
        cam["distortion"] = TUM_DIST
    if case == "downsample":
        data["downsample"] = 2
    if case == "max_frames":
        data["max_frames"] = 2
    cfg = _cfg(name, tmp_path / kind, cam, data)
    ds_t = get_dataset(copy.deepcopy(cfg))
    resized = case in ("crop_size", "downsample", "color_larger",
                       "color_smaller", "all")
    _assert_same(ds_t, jax_get_dataset(copy.deepcopy(cfg)),
                 rgb_tol=1e-6 if resized else 0.0)
    f = ds_t[0]
    want = {"crop_size": (16, 24), "crop_edge": (H - 4, W - 4),
            "downsample": (H // 2, W // 2), "all": (16, 24)}.get(case,
                                                               (H, W))
    assert f["depth"].shape == want and f["rgb"].shape == want + (3,)
    assert len(ds_t) == (2 if case == "max_frames" else 4)


def test_png_layout_loads_without_cv2(tmp_path):
    """The PNG path needs no OpenCV: a largeindoor layout loads with cv2
    blocked, bitwise as with it."""
    name = make_layout("largeindoor", str(tmp_path / "li"))
    cfg = _cfg(name, tmp_path / "li")
    want = get_dataset(copy.deepcopy(cfg))[2]
    np.save(tmp_path / "want.npy", np.concatenate(
        [want["rgb"].reshape(-1), want["depth"].reshape(-1),
         want["c2w"].reshape(-1)]))
    code = ("import sys, json, numpy as np\n"
            "sys.modules['cv2'] = None\n"
            "sys.modules['PIL'] = None\n"
            "from remixfusion_tpu_torch.datasets import get_dataset\n"
            f"cfg = json.loads({repr(__import__('json').dumps(cfg))})\n"
            "f = get_dataset(cfg)[2]\n"
            "got = np.concatenate([f['rgb'].reshape(-1),"
            " f['depth'].reshape(-1), f['c2w'].reshape(-1)])\n"
            f"print(np.array_equal(got, np.load({str(tmp_path)!r}"
            " + '/want.npy')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "True", out.stderr


# ----------------------------------------------------- factory and tools

def test_factory_names_match_jax(tmp_path):
    """Every dataset name in configs/ and the mixed-case reference names
    resolve to the same loader class as in JAX; an unknown name raises
    ValueError; synthetic_large builds the multi-room building, as in
    JAX."""
    import re

    from remixfusion_tpu.datasets import factory as jax_factory
    from remixfusion_tpu_torch.datasets import factory

    src = open(jax_factory.__file__).read()
    jax_names = set(re.findall(r'"(\w+)": loaders\.', src))
    port_names = set(re.findall(r'"(\w+)": loaders\.',
                                open(factory.__file__).read()))
    assert port_names == jax_names and len(port_names) == 11
    used = set()
    for path in glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")):
        for line in open(path):
            if line.startswith("dataset:"):
                used.add(line.split(":", 1)[1].strip().strip("'\""))
    assert {"BS3D", "Fast_syn", "replica", "scannet", "tum",
            "uhumans"} <= used
    kinds = {"BS3D": "bs3d", "Fast_syn": "fastsyn", "replica": "replica",
             "scannet": "scannet", "tum": "tum", "uhumans": "uhumans",
             "Largeindoor": "largeindoor", "azure": "azure", "rgb": "rgb",
             "realsense": "realsense", "iphone": "iphone"}
    assert used - {"synthetic", "synthetic_large"} <= set(kinds)
    for name, kind in kinds.items():
        d = str(tmp_path / name)
        make_layout(kind, d, n=2)
        cfg = _cfg(name, d)
        ds_t = get_dataset(copy.deepcopy(cfg))
        assert type(ds_t).__name__ == type(
            jax_get_dataset(copy.deepcopy(cfg))).__name__
        assert isinstance(ds_t, loaders.FileRGBDDataset) and len(ds_t) == 2
    with pytest.raises(ValueError):
        get_dataset(_cfg("kinectfusion", tmp_path))
    large = _cfg("synthetic_large", tmp_path)
    ds_t = get_dataset(copy.deepcopy(large))
    assert type(ds_t).__name__ == type(
        jax_get_dataset(copy.deepcopy(large))).__name__ == \
        "SyntheticLargeDataset"


def _check_layouts(tmp_path):
    """The layouts of tests/test_check_data.py: a complete bs3d scene, the
    same without poses.txt, a TUM scene missing a depth frame, and a
    datadir that does not exist."""
    out = []
    d = tmp_path / "scene"
    (d / "color").mkdir(parents=True)
    (d / "depth").mkdir()
    rows = []
    for i in range(3):
        write_frame(str(d / "color" / f"{i}.jpg"),
                    str(d / "depth" / f"{i}.png"), seed=i)
        rows.append([i, 0.1 * i, 0, 0, 0, 0, 0, 1])
    np.savetxt(d / "poses.txt", np.asarray(rows))
    out.append(tiny_config(dataset="bs3d", data={"datadir": str(d)},
                           **cam_cfg()))
    d2 = tmp_path / "scene_noposes"
    import shutil
    shutil.copytree(d, d2)
    (d2 / "poses.txt").unlink()
    out.append(tiny_config(dataset="bs3d", data={"datadir": str(d2)},
                           **cam_cfg()))
    t = tmp_path / "fr1"
    (t / "rgb").mkdir(parents=True)
    (t / "depth").mkdir()
    for i in range(2):
        ts = 100.0 + i * 0.1
        write_frame(str(t / "rgb" / f"{ts:.4f}.png"),
                    str(t / "depth" / f"{ts:.4f}.png"), seed=i)
    (t / "rgb.txt").write_text("# rgb")
    (t / "depth.txt").write_text("# depth")
    (t / "groundtruth.txt").write_text("# gt")
    out.append(tiny_config(dataset="tum", data={"datadir": str(t)},
                           **cam_cfg()))
    t2 = tmp_path / "fr1_missing"
    shutil.copytree(t, t2)
    next((t2 / "depth").iterdir()).unlink()
    out.append(tiny_config(dataset="tum", data={"datadir": str(t2)},
                           **cam_cfg()))
    out.append(tiny_config(dataset="replica",
                           data={"datadir": str(tmp_path / "nope")},
                           **cam_cfg()))
    return out


def test_check_data_matches_jax(tmp_path):
    assert check_data.LAYOUTS == jax_check.LAYOUTS
    assert check_data.CAM_KEYS == jax_check.CAM_KEYS
    for cfg in _check_layouts(tmp_path):
        assert check_data.check_layout(cfg) == jax_check.check_layout(cfg)
        assert (check_data.frame_count_consistency(cfg)
                == jax_check.frame_count_consistency(cfg))
    # the port normalizes 'Fast_syn' as the factory does; JAX lowercases
    fs = tmp_path / "fs"
    make_layout("fastsyn", str(fs), n=2)
    cfg = _cfg("Fast_syn", fs)
    assert check_data.check_layout(cfg) == []
    assert "unknown dataset kind" in jax_check.check_layout(cfg)[0]


def test_check_data_cli(tmp_path, capsys):
    d = tmp_path / "li"
    make_layout("largeindoor", str(d), n=2)
    cfg_path = os.path.join(ROOT, "configs", "BS3D", "BS3D.yaml")
    assert check_data.main(["--config", cfg_path, "--input_folder",
                            str(tmp_path / "nope")]) == 1
    assert "does not exist" in capsys.readouterr().out
    assert check_data.main(["--config", cfg_path, "--input_folder",
                            str(d)]) == 1  # BS3D wants poses.txt
    assert "poses.txt" in capsys.readouterr().out


def test_preprocess_matches_jax(tmp_path):
    """Association, renaming and pose rewrite of a raw timestamped capture
    (tests/test_loaders.py's fixture) equal the JAX tool's."""
    results = {}
    for tag, mod in (("jax", jax_pre), ("port", preprocess)):
        d = tmp_path / tag
        (d / "color").mkdir(parents=True)
        (d / "depth").mkdir()
        for i in range(5):
            t = 5.0 + 0.1 * i
            write_frame(str(d / "color" / f"{t:.3f}.png"),
                        str(d / "depth" / f"{t + 0.004 * (i % 3):.3f}.png"),
                        seed=i)
        (d / "poses.txt").write_text("\n".join(
            f"{5.0 + 0.1 * i + 0.01:.3f} {0.1 * i} 0 0 0 0 0 1"
            for i in range(5)))
        ctxt, dtxt = mod.generate_timestamp_files(
            str(d / "color"), str(d / "depth"), str(d))
        cl, dl = mod.read_file_list(ctxt), mod.read_file_list(dtxt)
        matches = mod.associate(cl, dl)
        kept = mod.rename_files(str(d), matches, cl, dl)
        poses = np.loadtxt(mod.rewrite_poses(str(d), matches))
        organized = sorted(os.listdir(d / "color_organized"))
        results[tag] = (open(ctxt).read(), open(dtxt).read(), cl, dl,
                        matches, kept, poses.tolist(), organized)
    assert results["port"] == results["jax"]
    assert len(results["port"][4]) == 5


@pytest.mark.parametrize("layout,color_hw", [
    ("tum", None), ("bs3d", None), ("replica", None), ("scannet", None),
    ("fastsyn", None), ("azure", None), ("largeindoor", (62, 84)),
    ("iphone", None)])
def test_write_layout_loads_in_both_packages(tmp_path, layout, color_hw):
    """tools/write_layout renders the synthetic room at a config's camera
    into each layout: both packages' loaders read it alike, its poses are
    the scene's, its depth is the render's to the PNG's 1/scale step."""
    from remixfusion_tpu_torch.tools.write_layout import (scene_dataset,
                                                          write_layout)

    name = {"bs3d": "BS3D", "fastsyn": "Fast_syn",
            "largeindoor": "Largeindoor"}.get(layout, layout)
    cfg = tiny_config(dataset=name, data={"datadir": str(tmp_path)})
    cfg["cam"]["png_depth_scale"] = 5000.0 if layout == "tum" else 1000.0
    gt = write_layout(cfg, layout, str(tmp_path), 3, color_hw, workers=1)
    update_cam(cfg["cam"])
    ds_t = get_dataset(copy.deepcopy(cfg))
    _assert_same(ds_t, jax_get_dataset(copy.deepcopy(cfg)),
                 rgb_tol=1e-6 if color_hw else 0.0)
    assert len(ds_t) == 3
    scene = scene_dataset(cfg, 3)
    for i in range(3):
        assert np.abs(ds_t[i]["c2w"] - gt[i]).max() < 1e-6
        assert np.abs(ds_t[i]["c2w"] - scene.poses[i]).max() < 1e-6
        _, depth = scene.render(scene.poses[i])
        step = 1.0 / cfg["cam"]["png_depth_scale"]
        assert np.abs(ds_t[i]["depth"] - depth).max() <= 0.5 * step + 1e-6
