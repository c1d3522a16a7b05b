"""Image I/O of the real-sensor loaders: PNG decode and encode, resize and
undistort with OpenCV's arithmetic, JPEG through OpenCV.

Counterpart of the OpenCV calls in remixfusion_tpu.datasets.loaders
(`cv2.imread`, `cv2.resize`, `cv2.undistort`). The PNG path is the port's
own on every machine: the standard library's zlib inflates, and the
scanline unfiltering (Sub, Average and Paeth are serial along a row) runs
in host C++ (csrc/png.cpp, built with g++ into build/host/ at first use);
`unfilter_reference` is its numpy version for the tests. JPEG has no
decoder here: `imread_color` reads it through cv2, imported when a JPEG is
met, and raises ImportError naming the file where cv2 is missing.

`resize` and `undistort` follow OpenCV's arithmetic, not just its
semantics: resize computes its taps and weights as cv::resize does
(half-pixel centres, edge clamping, no antialiasing; area is the block
mean for integer factors; nearest is floor(x * src / dst)); undistort
quantizes its map to 1/32 pixel and blends with 15-bit fixed-point
weights as cv::initUndistortRectifyMap (CV_16SC2) and cv::remap
(INTER_LINEAR, constant 0 border) do.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
JPEG_SIGNATURE = b"\xff\xd8\xff"
# PNG colour type -> samples per pixel (gray, RGB, RGBA); palette (3) and
# gray + alpha (4) are not read
_CHANNELS = {0: 1, 2: 3, 6: 4}
_FILTERS = {"none": 0, "sub": 1, "up": 2}

# cv::remap's fixed point: 5 fraction bits per map coordinate, 15-bit
# weights (INTER_BITS, INTER_REMAP_COEF_BITS)
INTER_BITS = 5
INTER_TAB_SIZE = 1 << INTER_BITS
REMAP_COEF_BITS = 15


# ------------------------------------------------------------------ PNG

def _unfilter_lib():
    from remixfusion_tpu_torch.ops import build

    lib = build.load_host("png")
    if lib.png_unfilter.argtypes is None:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.png_unfilter.restype = ctypes.c_int64
        lib.png_unfilter.argtypes = [u8p, u8p, ctypes.c_int64,
                                     ctypes.c_int64, ctypes.c_int64]
    return lib


def unfilter(raw: bytes, height: int, rowbytes: int, bpp: int,
             name: str = "<png>") -> np.ndarray:
    """Reconstruct [height, rowbytes] bytes from inflated PNG scanlines
    (one filter byte + rowbytes per row), in host C++."""
    src = np.frombuffer(raw, np.uint8, count=height * (rowbytes + 1))
    out = np.empty((height, rowbytes), np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bad = _unfilter_lib().png_unfilter(
        src.ctypes.data_as(u8p), out.ctypes.data_as(u8p), height, rowbytes,
        bpp)
    if bad:
        raise ValueError(f"{name}: row {bad - 1} has an unknown PNG filter "
                         f"type {src[(bad - 1) * (rowbytes + 1)]}")
    return out


def unfilter_reference(raw: bytes, height: int, rowbytes: int, bpp: int,
                       name: str = "<png>") -> np.ndarray:
    """unfilter's plain numpy version (PNG specification, section 9)."""
    src = np.frombuffer(raw, np.uint8, count=height * (rowbytes + 1))
    src = src.reshape(height, rowbytes + 1).astype(np.int64)
    out = np.zeros((height, rowbytes), np.uint8)
    prev = np.zeros(rowbytes, np.int64)
    for y in range(height):
        f, line = int(src[y, 0]), src[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:
            cur = (np.cumsum(line.reshape(-1, bpp), 0) & 255).reshape(-1)
        elif f == 2:
            cur = (line + prev) & 255
        elif f in (3, 4):
            cur = line.copy()
            a = np.zeros(bpp, np.int64)   # reconstructed pixel to the left
            c = np.zeros(bpp, np.int64)   # ... and above it
            for i in range(0, rowbytes, bpp):
                b = prev[i:i + bpp]
                if f == 3:
                    pred = (a + b) >> 1
                else:
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a,
                                    np.where(pb <= pc, b, c))
                cur[i:i + bpp] = (line[i:i + bpp] + pred) & 255
                a, c = cur[i:i + bpp], b
        else:
            raise ValueError(f"{name}: row {y} has an unknown PNG filter "
                             f"type {f}")
        out[y] = cur
        prev = cur
    return out


def _chunks(data: bytes, name: str):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 12 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated {kind!r} chunk")
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos = end + 4


def read_png(path: str):
    """Decode a non-interlaced PNG of 8-bit gray, RGB or RGBA, or 16-bit
    gray. Returns (samples, has_trns): [H, W] uint8/uint16 for gray,
    [H, W, 3] / [H, W, 4] uint8 in file order (R, G, B[, A]) otherwise.
    Raises ValueError, naming the file, for anything else."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    ihdr, idat, has_trns = None, [], False
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"tRNS":
            has_trns = True
        elif kind == b"PLTE":
            raise ValueError(f"{path}: palette PNG is not supported")
        elif not kind[0] & 0x20 and kind != b"IEND":
            raise ValueError(f"{path}: unknown critical chunk {kind!r}")
    if ihdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, ctype, comp, filt, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if comp or filt:
        raise ValueError(f"{path}: unknown PNG compression/filter method")
    channels = _CHANNELS.get(ctype)
    if channels is None:
        raise ValueError(f"{path}: PNG colour type {ctype} (palette or "
                         f"gray + alpha) is not supported")
    if not (depth == 8 or (depth == 16 and ctype == 0)):
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {ctype} "
                         f"is not supported (8-bit gray/RGB/RGBA, 16-bit "
                         f"gray)")
    bpp = channels * depth // 8
    rowbytes = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"{path}: PNG image data is truncated")
    out = unfilter(raw, height, rowbytes, bpp, name=path)
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(height, width)
    else:
        img = out.reshape(height, width, channels)
        if channels == 1:
            img = img[..., 0]
    return img, has_trns


def write_png(path: str, img: np.ndarray, filter: str = "up",
              level: int = 6) -> None:
    """Encode uint8 gray [H, W], RGB [H, W, 3] or RGBA [H, W, 4], or uint16
    gray [H, W], as a PNG with one filter type ('none', 'sub' or 'up') on
    every row and zlib at `level`."""
    img = np.ascontiguousarray(img)
    if img.dtype == np.uint16 and img.ndim == 2:
        depth, ctype, channels = 16, 0, 1
        samples = img.astype(">u2")
    elif img.dtype == np.uint8 and (img.ndim == 2 or (
            img.ndim == 3 and img.shape[2] in (3, 4))):
        depth = 8
        channels = 1 if img.ndim == 2 else img.shape[2]
        ctype = {1: 0, 3: 2, 4: 6}[channels]
        samples = img
    else:
        raise ValueError(f"write_png: unsupported image {img.dtype} "
                         f"{img.shape}")
    if filter not in _FILTERS:
        raise ValueError(f"write_png: filter must be one of "
                         f"{sorted(_FILTERS)}, got {filter!r}")
    h, w = img.shape[:2]
    bpp = channels * depth // 8
    rows = np.ascontiguousarray(samples).view(np.uint8).reshape(h, w * bpp)
    filtered = rows.copy()
    if filter == "sub":
        filtered[:, bpp:] = rows[:, bpp:] - rows[:, :-bpp]
    elif filter == "up":
        filtered[1:] = rows[1:] - rows[:-1]
    raw = np.concatenate(
        [np.full((h, 1), _FILTERS[filter], np.uint8), filtered], 1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    data = (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _sniff(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        return "png"
    if head[:3] == JPEG_SIGNATURE:
        return "jpeg"
    raise ValueError(f"{path}: neither PNG nor JPEG")


def imread_color(path: str) -> np.ndarray:
    """[H, W, 3] uint8 RGB, as cv2.imread(path, IMREAD_COLOR) followed by
    COLOR_BGR2RGB gives it: gray is replicated, alpha dropped. PNG through
    the port's decoder; JPEG through cv2 (ImportError without it)."""
    if _sniff(path) == "jpeg":
        try:
            import cv2
        except ImportError as e:
            raise ImportError(
                f"{path}: reading JPEG needs OpenCV (the cv2 module), which "
                f"is not installed; convert the colour frames to PNG or "
                f"install OpenCV") from e
        bgr = cv2.imread(path, cv2.IMREAD_COLOR)
        if bgr is None:
            raise ValueError(f"{path}: cv2 could not decode the JPEG")
        return np.ascontiguousarray(bgr[..., ::-1])
    img, _ = read_png(path)
    if img.dtype != np.uint8:
        raise ValueError(f"{path}: 16-bit PNG read as colour is not "
                         f"supported")
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


def imread_unchanged(path: str) -> np.ndarray:
    """[H, W] uint8/uint16 of a gray PNG (depth maps), as
    cv2.imread(path, IMREAD_UNCHANGED) gives it."""
    if _sniff(path) != "png":
        raise ValueError(f"{path}: depth must be a PNG")
    img, has_trns = read_png(path)
    if img.ndim != 2 or has_trns:
        raise ValueError(f"{path}: depth PNG must be gray without "
                         f"transparency")
    return img


# --------------------------------------------------------------- resize

def _linear_taps(n_dst: int, n_src: int, scale: float):
    """INTER_LINEAR source indices and weights along one axis: half-pixel
    centres, taps clamped at the edges, the fraction in float64 (OpenCV 5
    keeps it in double; OpenCV 4 rounded it to float32, 3e-5 away)."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= n_src - 1
    f[low | high] = 0.0
    s[low] = 0
    s[high] = n_src - 1
    return s, np.minimum(s + 1, n_src - 1), 1.0 - f, f


def _area_fast(img, ky: int, kx: int):
    """cv::resize's INTER_AREA for integer factors: each block's cells
    summed in row-major order (four at a time, as its unrolled loop adds
    them), times float32(1 / area)."""
    h, w = img.shape[0] // ky, img.shape[1] // kx
    blocks = img[:h * ky, :w * kx].reshape(h, ky, w, kx, *img.shape[2:])
    cells = [blocks[:, sy, :, sx] for sy in range(ky) for sx in range(kx)]
    total = np.zeros_like(cells[0])
    k = 0
    while k <= len(cells) - 4:
        total = total + (((cells[k] + cells[k + 1]) + cells[k + 2])
                         + cells[k + 3])
        k += 4
    for c in cells[k:]:
        total = total + c
    scale = np.float32(1.0) / np.float32(len(cells))
    return (total * scale.astype(img.dtype)).astype(img.dtype)


def resize(img: np.ndarray, height: int, width: int,
           interp: str = "linear") -> np.ndarray:
    """cv2.resize(img, (width, height), interpolation=...) on a float32 or
    float64 image [H, W] or [H, W, C]: interp 'linear' (INTER_LINEAR),
    'area' (INTER_AREA, integer factors only) or 'nearest'
    (INTER_NEAREST). Equal sizes return a copy."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise ValueError(f"resize: float32/float64 image expected, got "
                         f"{img.dtype}")
    sh, sw = img.shape[:2]
    if (sh, sw) == (height, width):
        return img.copy()
    inv_x, inv_y = width / sw, height / sh
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if interp == "nearest":
        xs = np.minimum(np.floor(np.arange(width) * scale_x).astype(np.int64),
                        sw - 1)
        ys = np.minimum(np.floor(np.arange(height) * scale_y).astype(np.int64),
                        sh - 1)
        return img[ys][:, xs]
    if interp == "area":
        ix, iy = round(scale_x), round(scale_y)
        eps = np.finfo(np.float64).eps
        if not (abs(scale_x - ix) < eps and abs(scale_y - iy) < eps
                and ix >= 1 and iy >= 1):
            raise ValueError(f"resize: 'area' needs integer reduction "
                             f"factors, got {sh}x{sw} -> {height}x{width}")
        return _area_fast(img, iy, ix)
    if interp != "linear":
        raise ValueError(f"resize: unknown interpolation {interp!r}")
    wt = img.dtype.type
    x0, x1, ax0, ax1 = _linear_taps(width, sw, scale_x)
    y0, y1, by0, by1 = _linear_taps(height, sh, scale_y)
    extra = (None,) * (img.ndim - 2)
    ax0, ax1 = ax0.astype(wt)[(None, slice(None)) + extra], \
        ax1.astype(wt)[(None, slice(None)) + extra]
    rows = img[:, x0] * ax0 + img[:, x1] * ax1
    by0 = by0.astype(wt)[(slice(None), None) + extra]
    by1 = by1.astype(wt)[(slice(None), None) + extra]
    return rows[y0] * by0 + rows[y1] * by1


# ------------------------------------------------------------ undistort

def _remap_weights() -> np.ndarray:
    """cv::remap's bilinear table [32 * 32, 4] (int64): (1 - y, 1 - x),
    (1 - y, x), (y, 1 - x), (y, x) in 1/32768, with OpenCV's saturation of
    the whole-pixel entry (32768 does not fit a short: it becomes 32767
    and its sum-restoring +1 lands on the (y, x) tap)."""
    t = np.arange(INTER_TAB_SIZE, dtype=np.int64)
    ty, tx = np.meshgrid(t, t, indexing="ij")
    one = INTER_TAB_SIZE
    w = np.stack([(one - ty) * (one - tx), (one - ty) * tx,
                  ty * (one - tx), ty * tx], -1).reshape(-1, 4) * 32
    w[0] = (32767, 0, 0, 1)
    return w


_REMAP_W = _remap_weights()


def undistort_map(K, dist, height: int, width: int):
    """cv::initUndistortRectifyMap(K, dist, I, K, size, CV_16SC2) as
    cv::undistort builds it, in stripes of max(1, 4096 // width) rows with
    the new camera's cy moved by each stripe's first row: (ix, iy) int64
    [H, W] source positions in 1/32 pixel."""
    K = np.asarray(K, np.float64)
    d = np.zeros(5, np.float64)
    dist = np.asarray(dist, np.float64).reshape(-1)
    if dist.size not in (4, 5):
        raise ValueError(f"undistort: 4 or 5 distortion coefficients "
                         f"(k1 k2 p1 p2 [k3]) expected, got {dist.size}")
    d[:dist.size] = dist
    k1, k2, p1, p2, k3 = d
    fx, fy, u0, v0 = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    stripe = min(max(1, 4096 // max(width, 1)), height)
    ix = np.empty((height, width), np.int64)
    iy = np.empty((height, width), np.int64)
    for y0 in range(0, height, stripe):
        rows = min(stripe, height - y0)
        Ar = K.copy()
        Ar[1, 2] = v0 - y0
        ir = np.linalg.inv(Ar).reshape(-1)
        i = np.arange(rows, dtype=np.float64)[:, None]
        j = np.arange(width, dtype=np.float64)[None, :]
        _x = i * ir[1] + ir[2] + j * ir[0]
        _y = i * ir[4] + ir[5] + j * ir[3]
        _w = i * ir[7] + ir[8] + j * ir[6]
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
        u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
        v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
        ix[y0:y0 + rows] = np.rint(u * INTER_TAB_SIZE).astype(np.int64)
        iy[y0:y0 + rows] = np.rint(v * INTER_TAB_SIZE).astype(np.int64)
    return ix, iy


class Undistorter:
    """cv2.undistort(img, K, dist) for uint8 images of one size: the map
    (undistort_map) and each output pixel's four taps and 15-bit weights
    are built once; a call blends and rounds as cv::remap (INTER_LINEAR,
    BORDER_CONSTANT 0) does. Taps outside the image read 0."""

    def __init__(self, K, dist, height: int, width: int):
        ix, iy = undistort_map(K, dist, height, width)
        self.shape = (height, width)
        sx, sy = ix >> INTER_BITS, iy >> INTER_BITS
        frac = ((iy & (INTER_TAB_SIZE - 1)) * INTER_TAB_SIZE
                + (ix & (INTER_TAB_SIZE - 1)))
        self.weights = _REMAP_W[frac.reshape(-1)].T.astype(np.int32)
        taps = []
        for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yy, xx = sy + dy, sx + dx
            inside = (yy >= 0) & (yy < height) & (xx >= 0) & (xx < width)
            # outside taps index the zero pixel appended after the image
            taps.append(np.where(inside, yy * width + xx,
                                 height * width).reshape(-1))
        self.taps = np.stack(taps)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img)
        if img.dtype != np.uint8 or img.shape[:2] != self.shape:
            raise ValueError(f"undistort: uint8 image of {self.shape} "
                             f"expected, got {img.dtype} {img.shape}")
        flat = img.reshape(self.shape[0] * self.shape[1], -1)
        src = np.concatenate([flat, np.zeros((1, flat.shape[1]), np.uint8)])
        src = src.astype(np.int32)
        acc = sum(src[self.taps[k]] * self.weights[k][:, None]
                  for k in range(4))
        out = (acc + (1 << (REMAP_COEF_BITS - 1))) >> REMAP_COEF_BITS
        return out.astype(np.uint8).reshape(img.shape)


def undistort(img: np.ndarray, K, dist) -> np.ndarray:
    """cv2.undistort(img, K, dist) of a uint8 image (the new camera is K)."""
    return Undistorter(K, dist, img.shape[0], img.shape[1])(img)
