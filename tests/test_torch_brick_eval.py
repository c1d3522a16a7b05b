"""Port parity: remixfusion_tpu_torch.ops.brick_eval (plain PyTorch path on
the CPU) against the JAX package's Pallas brick_eval in interpret mode, on
the same numpy inputs. The CUDA kernel itself is held against the plain
version on the card by chip_smoke.py and tests/test_torch_gpu.py.

Tolerance: the JAX test's own bar for this kernel (tests/test_tracking.py:
max |d| < 5e-3, mean < 1e-4) — both sides run the same float32 operation
order, but sums over pixels are taken in another order, and a reassociated
transform can move a point across a voxel/pixel rounding boundary. The
1e6 low-count guard positions must match exactly (counts are integers)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.ops.pallas import brick_eval as jax_be
from remixfusion_tpu.tracking.rotracker import ROTracker as JaxTracker
from remixfusion_tpu_torch.ops import brick_eval as be
from test_torch_gpu import brick_eval_inputs as _inputs
from test_torch_gpu import brick_volume_inputs

torch.set_num_threads(1)


@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("n_cand,n_pix", [(256, 256), (128, 384)])
def test_brick_eval_matches_jax(interp, n_cand, n_pix):
    params, pix, bricks, table = _inputs(n_cand, n_pix, 7, interp)
    ref = np.asarray(jax_be.brick_eval(
        jnp.asarray(params), jnp.asarray(pix), jnp.asarray(bricks),
        jnp.asarray(table), n_cand=n_cand, n_pix=n_pix, interp=interp))
    out = be.brick_eval(torch.from_numpy(params), torch.from_numpy(pix),
                        torch.from_numpy(bricks), torch.from_numpy(table),
                        interp=interp).numpy()
    assert out.shape == (n_cand,)
    guard_j, guard_t = ref >= 1e6, out >= 1e6
    assert np.array_equal(guard_j, guard_t)
    assert 0 < guard_t.sum() < n_cand  # both branches exercised
    d = np.abs(out - ref)[~guard_t]
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())


def test_brick_eval_narrow_rows_equal_padded_rows():
    """The port's wrapper takes the windows and pixel attributes without
    the TPU's 128/16-wide padding; results must not depend on it."""
    params, pix, bricks, table = map(torch.from_numpy,
                                     _inputs(128, 200, 3, "nearest"))
    wide = be.brick_eval(params, pix, bricks, table)
    narrow = be.brick_eval(params, pix[:, :8].contiguous(),
                           bricks[:, :64].contiguous(),
                           table[:6].contiguous())
    assert torch.equal(wide, narrow)


def test_brick_eval_rejects_bad_input():
    params, pix, bricks, table = map(torch.from_numpy,
                                     _inputs(128, 64, 1, "nearest"))
    with pytest.raises(ValueError):
        be.brick_eval(params, pix, bricks, table, interp="cubic")
    with pytest.raises(ValueError):
        be.brick_eval(params, pix, bricks[:10], table)
    with pytest.raises(TypeError):
        be.brick_eval(params.double(), pix, bricks, table)


def _jax_windows(tsdf_bm, layout, base, track_dtype="bfloat16"):
    """The JAX tracker's brick-major window gather (no quad-pack mirror),
    rounded through bfloat16 as its default track volume is, or as they are
    from a float32 track volume."""
    b, BY, BZ = layout
    dims = (tsdf_bm.shape[0] // (BY * BZ) * b, BY * b, BZ * b)
    jt = JaxTracker(tiny_config(RO={"eval_mode": "pallas"}), 48, 64,
                    np.eye(3, dtype=np.float32), dims, 0.05,
                    brick_layout=layout)
    win = jt._fetch_windows((jnp.asarray(tsdf_bm).reshape(-1), None),
                            jnp.asarray(base), 4)
    if track_dtype == "bfloat16":
        win = win.astype(jnp.bfloat16)
    return np.asarray(win.astype(jnp.float32))


def test_fetch_windows_match_jax_brick_major():
    """The volume entry's plain gather equals the JAX brick-major gather
    rounded through bf16, bit for bit, on windows that cross brick faces
    on every axis."""
    _, _, base, tsdf_bm, layout, _ = brick_volume_inputs(128, 640, 3,
                                                         "nearest")
    assert ((base % layout[0]) > layout[0] - 4).any(0).all()
    ref = _jax_windows(tsdf_bm, layout, base)
    got = be.fetch_windows(torch.from_numpy(tsdf_bm), layout,
                           torch.from_numpy(base)).numpy()
    assert got.shape == (640, 64)
    assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    # the rounding is real: the field is not bf16-exact
    t = torch.from_numpy(tsdf_bm)
    assert not torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
    # a float32 track view reads the cells as they are
    got = be.fetch_windows(t, layout, torch.from_numpy(base), "float32")
    ref = _jax_windows(tsdf_bm, layout, base, "float32")
    assert np.array_equal(got.numpy().view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize(
    "interp,track_dtype", [("nearest", "bfloat16"), ("trilinear", "bfloat16"),
                           ("nearest", "float32"), ("trilinear", "float32")],
    ids=["nearest", "trilinear", "nearest-float32", "trilinear-float32"])
def test_brick_eval_volume_matches_jax(interp, track_dtype):
    """The volume entry's costs against the JAX brick_eval (interpret mode)
    fed the JAX tracker's windows, bf16-rounded or unrounded float32 as the
    track dtype says: the bar of the windowed test."""
    n_cand, n_pix = 256, 256
    params, pix, base, tsdf_bm, layout, table = brick_volume_inputs(
        n_cand, n_pix, 9, interp)
    bricks = np.zeros((n_pix, 128), np.float32)
    bricks[:, :64] = _jax_windows(tsdf_bm, layout, base, track_dtype)
    ref = np.asarray(jax_be.brick_eval(
        jnp.asarray(params), jnp.asarray(pix), jnp.asarray(bricks),
        jnp.asarray(table), n_cand=n_cand, n_pix=n_pix, interp=interp))
    args = [torch.from_numpy(a) for a in (params, pix, base, tsdf_bm)]
    out = be.brick_eval_volume(*args, layout, torch.from_numpy(table),
                               interp=interp,
                               track_dtype=track_dtype).numpy()
    guard_j, guard_t = ref >= 1e6, out >= 1e6
    assert np.array_equal(guard_j, guard_t)
    assert guard_t.sum() < n_cand
    d = np.abs(out - ref)[~guard_t]
    assert d.max() < 5e-3 and d.mean() < 1e-4, (d.max(), d.mean())
    if track_dtype == "float32":  # the window rounding moves the costs
        other = be.brick_eval_volume(*args, layout, torch.from_numpy(table),
                                     interp=interp).numpy()
        assert np.abs(other - out)[~guard_t].max() > 1e-4


def test_brick_eval_volume_rejects_bad_input():
    params, pix, base, tsdf_bm, layout, table = (
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in brick_volume_inputs(128, 64, 1, "nearest"))
    with pytest.raises(ValueError):  # int64 bases
        be.brick_eval_volume(params, pix, base.long(), tsdf_bm, layout, table)
    with pytest.raises(ValueError):  # volume rows are not b^3 cells
        be.brick_eval_volume(params, pix, base, tsdf_bm[:, :512], layout,
                             table)
    with pytest.raises(ValueError):
        be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                             interp="cubic")
    with pytest.raises(ValueError):
        be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                             track_dtype="float16")


@pytest.mark.parametrize("n_cand,n_pix", [(10240, 300), (3072, 1200),
                                          (1024, 4800), (1, 1), (700, 9)])
def test_launch_shape_covers_every_pixel(n_cand, n_pix):
    """The kernel's launch shape: whole tiles per split, no empty split,
    every pixel in exactly one split, about as many CTAs as an H100's 132
    SMs hold at once."""
    per_cta = 256 * be._CAND_PER_THREAD
    resident = be._CTAS_PER_SM * 132
    cblocks, splits, per = be.launch_shape(n_cand, n_pix, 132)
    assert cblocks * per_cta >= n_cand > (cblocks - 1) * per_cta
    assert per % 8 == 0
    assert splits * per >= n_pix > (splits - 1) * per
    assert cblocks * splits < resident + cblocks
