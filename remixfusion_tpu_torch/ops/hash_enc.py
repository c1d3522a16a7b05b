"""Multiresolution hash-grid encoding: index math, plain forward, and the
table gradient as a CUDA kernel (+ its plain PyTorch version).

Replaces the Pallas TPU kernel `remixfusion_tpu/ops/pallas/hash_enc.py`
(`_bwd_kernel`, through `_level_grad_table` inside the custom VJP
`hash_encode`): the gradient with respect to the hash table,

    dtable[offset_l + idx_c(n, l), :] += w_c(n, l) * grad_out[n, l, :]

over every point n, level l and trilinear corner c. The TPU kernel builds
it as a one-hot segment-sum on the MXU with bf16 operands; the port holds
the f32 gradient (what tiny-cuda-nn and the JAX `hash_impl: xla` path
compute).

The kernel is `csrc/hash_enc.cu` (sm_90a, nvcc, ctypes); its header gives
the bound and the design: persistent CTAs over contiguous point ranges,
equal rows combined per warp before each add, level 0 accumulated in
shared memory and flushed once per CTA, the other levels added with float2
atomicAdd, and each (point, level)'s 8 corner rows and
weights recomputed from x with the forward's own arithmetic. Recomputing
means the backward keeps only x and the table, not [8, N, L] index and
weight tensors (~250 MB at 242k points). Its bound is bytes: x (12 B) +
grad_out (128 B at 16 levels) per point plus the table write, ~27 MB or
~8 us at 3.35 TB/s for the render backward.

Index math, bit for bit the JAX package's (encodings.py:118-156):
pos = x * scale_l + 0.5 rounded once (XLA contracts it into a fused
multiply-add; computed here in float64 and rounded to float32, the same in
the kernel), corner = floor(pos), uint32 dense index cx + cy*res + cz*res^2
or the spatial hash cx ^ cy*2654435761 ^ cz*805459861, mod the level size,
plus the level offset. Corners of points outside [0, 1]^3 are negative and
wrap through uint32 as in JAX; torch computes them in int64 masked to 32
bits.

`HashEncodeFunction` is the autograd Function of the encoding: the forward
is plain PyTorch (the XLA path's per-corner gather structure); the backward
takes dtable from `hash_table_grad` when the table needs a gradient, and the
closed-form d x (hash_enc.py:279-304) in plain PyTorch when x needs one
(only in bundle adjustment).
"""

from __future__ import annotations

import ctypes

import torch

_M32 = 0xFFFFFFFF
_PRIMES = (1, 2654435761, 805459861)


def _mul_u32(a, b):
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and b in [0, 2^32)
    (tensor or int), without int64 overflow: b is split into 16-bit
    halves."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + ((a * hi) & 0xFFFF) * 65536) & _M32


def level_tensors(enc, device):
    """Per-level constants of a HashGridEncoding on `device` (uploaded
    once): scales f32 [L]; res, res^2 mod 2^32, size, offset int64 [L];
    hashed bool [L]; and `kernel`, the int32 [4, L] rows res / size /
    offset / hashed as the CUDA kernel reads them."""
    cache = enc.__dict__.setdefault("_level_cache", {})
    key = str(device)
    if key not in cache:
        L = enc.n_levels
        i64 = dict(dtype=torch.int64, device=device)
        res = torch.tensor(enc.resolutions, **i64)
        size = torch.tensor([enc.offsets[i + 1] - enc.offsets[i]
                             for i in range(L)], **i64)
        off = torch.tensor(enc.offsets[:-1], **i64)
        hashed = torch.tensor(enc.hashed, dtype=torch.bool, device=device)
        cache[key] = dict(
            scales=torch.tensor(enc.scales, dtype=torch.float32,
                                device=device),
            res=res, res2=_mul_u32(res, res), size=size, off=off,
            hashed=hashed, kernel=torch.stack(
                [res, size, off, hashed.to(torch.int64)]).to(
                    torch.int32).contiguous())
    return cache[key]


def positions(enc, x):
    """(corner int64 [N, L, 3], frac f32 [N, L, 3]) of points x [N, 3]:
    pos = x * scale + 0.5 rounded once to float32."""
    lv = level_tensors(enc, x.device)
    pos = (x.double()[:, None, :] * lv["scales"].double()[None, :, None]
           + 0.5).to(torch.float32)
    corner = torch.floor(pos)
    return corner.to(torch.int64), pos - corner


def corners(enc, corner, frac):
    """Yield (row int64 [N, L] — global table rows, level offsets added —,
    weight f32 [N, L], (dx, dy, dz)) for the 8 trilinear corners in the JAX
    order 000, 001, ..., 111."""
    lv = level_tensors(enc, corner.device)
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                cx = (corner[..., 0] + dx) & _M32
                cy = (corner[..., 1] + dy) & _M32
                cz = (corner[..., 2] + dz) & _M32
                dense = (cx + _mul_u32(cy, lv["res"])
                         + _mul_u32(cz, lv["res2"])) & _M32
                hashed = (cx ^ _mul_u32(cy, _PRIMES[1])
                          ^ _mul_u32(cz, _PRIMES[2]))
                idx = torch.where(lv["hashed"], hashed, dense)
                row = idx % lv["size"] + lv["off"]
                w = ((frac[..., 0] if dx else 1 - frac[..., 0])
                     * (frac[..., 1] if dy else 1 - frac[..., 1])
                     * (frac[..., 2] if dz else 1 - frac[..., 2]))
                yield row, w, (dx, dy, dz)


def hash_encode_reference(enc, table, x):
    """Plain forward: x [N, 3] -> [N, L * level_dim], the 8 per-corner
    gathers accumulated in [N, L, level_dim] (the XLA path's structure)."""
    n, L = x.shape[0], enc.n_levels
    corner, frac = positions(enc, x)
    out = torch.zeros((n, L, enc.level_dim), dtype=torch.float32,
                      device=x.device)
    for row, w, _ in corners(enc, corner, frac):
        out = out + w[..., None] * table[row]
    return out.reshape(n, L * enc.level_dim)


def hash_table_grad_reference(enc, x, grad_out, n_rows: int):
    """Plain PyTorch table gradient: the same index function, then one
    index_add_ per corner. grad_out [N, L * level_dim] -> [n_rows,
    level_dim]."""
    L, F = enc.n_levels, enc.level_dim
    g = grad_out.reshape(-1, L, F)
    corner, frac = positions(enc, x)
    dtable = torch.zeros((n_rows, F), dtype=torch.float32, device=x.device)
    for row, w, _ in corners(enc, corner, frac):
        dtable.index_add_(0, row.reshape(-1), (w[..., None] * g).reshape(
            -1, F))
    return dtable


def hash_dx(enc, table, x, grad_out):
    """Closed-form gradient wrt x [N, 3] (hash_enc.py:279-304): per corner
    the feature dot s_c = <table[row_c], g>, times the tent-weight
    derivatives, times the level scale."""
    n, L, F = x.shape[0], enc.n_levels, enc.level_dim
    g = grad_out.reshape(n, L, F)
    scales = level_tensors(enc, x.device)["scales"]
    corner, frac = positions(enc, x)
    dx = torch.zeros((n, 3), dtype=torch.float32, device=x.device)
    for row, _, (bx, by, bz) in corners(enc, corner, frac):
        sc = torch.sum(table[row] * g, -1)
        wx = frac[..., 0] if bx else 1 - frac[..., 0]
        wy = frac[..., 1] if by else 1 - frac[..., 1]
        wz = frac[..., 2] if bz else 1 - frac[..., 2]
        gx = (1.0 if bx else -1.0) * wy * wz * sc
        gy = (1.0 if by else -1.0) * wx * wz * sc
        gz = (1.0 if bz else -1.0) * wx * wy * sc
        dx = dx + torch.stack([torch.sum(gx * scales, 1),
                               torch.sum(gy * scales, 1),
                               torch.sum(gz * scales, 1)], -1)
    return dx


def _lib():
    from remixfusion_tpu_torch.ops import build

    fn = build.load("hash_enc").hash_table_grad_launch
    if fn.restype is not ctypes.c_int or fn.argtypes is None:
        vp, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, i, i, i, i, vp]
        fn.restype = ctypes.c_int
    return fn


# Persistent CTAs per SM of the kernel (512 threads each), and Hopper's
# shared memory (sm_90: 228 KB per SM, 1 KB reserved per block) less the
# kernel's static share (g and x of a 32-point chunk): what one CTA may use
# for level 0's accumulators. PERF.md has the sweep that chose level 0 in
# shared memory at 3 CTAs per SM on an H100.
_CTAS_PER_SM = 3
_SMEM_PER_CTA = 233472 // _CTAS_PER_SM - 1024 - 4 * (32 * 66 + 32 * 3)
_CHUNK = 32  # points per chunk of a CTA


def privatized_rows(enc) -> int:
    """Rows of level 0, accumulated in shared memory by the kernel (they
    are the table's first rows), or 0 where they do not fit one CTA's
    share."""
    rows = enc.offsets[1]
    return rows if rows * 8 <= _SMEM_PER_CTA else 0


def hash_table_grad(enc, x, grad_out, n_rows: int):
    """Table gradient [n_rows, 2] of the encoding at x [N, 3] for the
    output gradient grad_out [N, L * 2]. On CPU tensors: the plain version;
    on CUDA tensors: the kernel, or an error."""
    L = enc.n_levels
    if enc.level_dim != 2:
        raise ValueError("hash_table_grad takes level_dim 2 only")
    if x.dim() != 2 or x.shape[1] != 3 or grad_out.shape != (
            x.shape[0], 2 * L):
        raise ValueError(f"hash_table_grad shapes: x {tuple(x.shape)}, "
                         f"grad_out {tuple(grad_out.shape)}, levels {L}")
    if x.dtype != torch.float32 or grad_out.dtype != torch.float32:
        raise TypeError("hash_table_grad takes float32 tensors")
    if x.device != grad_out.device:
        raise ValueError("hash_table_grad inputs must share one device")
    dev = x.device
    if dev.type == "cpu":
        return hash_table_grad_reference(enc, x, grad_out, n_rows)
    if dev.type != "cuda":
        raise ValueError(f"hash_table_grad: unsupported device {dev}")
    if n_rows != enc.table_size:
        raise ValueError("hash_table_grad: n_rows is not the table size")
    from remixfusion_tpu_torch.ops import build

    x = x.contiguous()
    grad_out = grad_out.contiguous()
    lv = level_tensors(enc, dev)
    dtable = torch.zeros((n_rows, 2), dtype=torch.float32, device=dev)
    n = x.shape[0]
    if n == 0:
        return dtable
    n_ctas = min(build.sm_count(dev) * _CTAS_PER_SM, -(-n // _CHUNK))
    rc = _lib()(x.data_ptr(), grad_out.data_ptr(), dtable.data_ptr(),
                lv["scales"].data_ptr(), lv["kernel"].data_ptr(), n, L,
                privatized_rows(enc), n_ctas,
                torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"hash_table_grad kernel launch failed: CUDA error {rc}")
    hash_table_grad.launches += 1
    return dtable


hash_table_grad.launches = 0


class HashEncodeFunction(torch.autograd.Function):
    """Hash-grid encoding with the hand-written table gradient."""

    @staticmethod
    def forward(ctx, x, table, enc):
        ctx.enc = enc
        ctx.save_for_backward(x, table)
        return hash_encode_reference(enc, table, x)

    @staticmethod
    def backward(ctx, grad_out):
        x, table = ctx.saved_tensors
        enc = ctx.enc
        g = grad_out.contiguous()
        dx = dtable = None
        if ctx.needs_input_grad[1]:
            dtable = hash_table_grad(enc, x, g, table.shape[0])
        if ctx.needs_input_grad[0]:
            dx = hash_dx(enc, table, x, g)
        return dx, dtable, None
