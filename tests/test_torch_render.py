"""Port parity of the rendering path and the 2D metrics against the JAX
package on the CPU (tests/helpers.tiny_config sizes):

  - SSIM (map and mean within 1e-9) and mse2psnr against
    remixfusion_tpu.utils.metrics on seeded 48x64x3 images with a zeroed
    region; the random-feature proxy within 1e-8 relative of the JAX
    formula with exact convolutions (the same filter bank, bit for bit);
  - the LPIPS network against lpips_jax._build with random weights of the
    converter's shapes on 96x128 images (1e-4 relative), and an npz
    round trip through weights_available() / perceptual_distance;
  - render_frame against the JAX render_frame on a tiny scene (the JAX
    weights carried across with load_scene_numpy, training.perturb 0 so
    that no draw enters) at gap 1 and 4 with a 45x62 camera's rays (ceil
    shapes), with and without a target depth, with the JAX pipeline's own
    buffers (the bf16 query mirror, which the port scene then holds too)
    and with the mirror absent on both sides: rgb and depth within 1e-4;
  - render_img's six panels against the arrays computed from the JAX
    render, its PNG read back bit for bit;
  - calc_2d_metric of both packages from one JAX checkpoint.npz;
  - update_GBV against the JAX update_GBV, the port's mirror refreshed;
  - the plasma table against matplotlib's."""

import contextlib
import copy
import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.slam import RemixFusionTPU
from remixfusion_tpu.utils import lpips_jax
from remixfusion_tpu.utils import metrics as jmetrics
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.tools.rendering_eval import calc_2d_metric
from remixfusion_tpu_torch.utils import lpips, metrics, plot
from remixfusion_tpu_torch.utils.convert import load_scene_numpy
from remixfusion_tpu_torch.utils.imageio import read_png

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _images(seed, h=48, w=64):
    """float64 images (the JAX SSIM filters in the input's precision; the
    port's always in float64) with a zeroed region in the ground truth."""
    rng = np.random.default_rng(seed)
    gt = rng.uniform(0, 1, (h, w, 3))
    gt[10:20, 5:30] = 0.0
    gt[30:, 50:, 1] = 0.0
    img = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1)
    return img, gt


@pytest.mark.parametrize("seed", [0, 1])
def test_ssim_and_psnr_match_jax(seed):
    img, gt = _images(seed)
    ref_map, ref = jmetrics.ssim(img, gt)
    got_map, got = metrics.ssim(img, gt, device="cpu")
    assert got_map.shape == ref_map.shape == (48, 64, 3)
    assert np.abs(got_map - ref_map).max() <= 1e-9
    assert abs(got - ref) <= 1e-9
    mse = float(((img - gt) ** 2).mean())
    assert metrics.mse2psnr(mse) == jmetrics.mse2psnr(mse)
    assert metrics.mse2psnr(0.0) == jmetrics.mse2psnr(0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_random_feature_perceptual_matches_jax(seed, monkeypatch):
    """The proxy within 1e-8 relative of the JAX formula evaluated with
    exact (direct) convolutions, and within 1e-6 of the JAX function as it
    is: its fftconvolve rounds the features by ~1e-16 absolute, which the
    per-pixel normalisation amplifies where a pixel's feature norm is
    small (2e-8 to 6e-8 relative on these images)."""
    import scipy.signal

    np.testing.assert_array_equal(metrics.random_feature_bank(),
                                  jmetrics._random_feature_bank())
    img, gt = _images(seed)
    got = metrics.random_feature_perceptual(img, gt, device="cpu")
    ref_fft = jmetrics.random_feature_perceptual(img, gt)
    monkeypatch.setattr(
        scipy.signal, "fftconvolve", lambda a, b, mode: scipy.signal.convolve(
            a, b, mode=mode, method="direct"))
    ref = jmetrics.random_feature_perceptual(img, gt)
    assert ref > 0.01
    assert abs(got - ref) <= 1e-8 * ref
    assert abs(got - ref_fft) <= 1e-6 * ref_fft
    value, kind = metrics.perceptual_distance(img, gt, device="cpu")
    assert (value, kind) == (got, "rf_perceptual")


def _fake_lpips_params(rng):
    """Random weights with the shapes scripts/convert_lpips_weights.py
    writes."""
    params, in_ch = {}, 3
    for i, (out_ch, k, _s, _p) in enumerate(lpips.CONVS):
        params[f"conv{i}_w"] = rng.normal(
            0, 0.05, (out_ch, in_ch, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.01, out_ch).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 1, out_ch)).astype(
            np.float32)
        in_ch = out_ch
    return params


def test_lpips_network_matches_jax(tmp_path, monkeypatch):
    assert lpips.CONVS == lpips_jax._CONVS
    rng = np.random.default_rng(0)
    params = _fake_lpips_params(rng)
    a = rng.uniform(0, 1, (96, 128, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    ref = float(lpips_jax._build(params)(a, b))
    net = lpips.LPIPS(params)
    got = lpips.lpips(a, b, device="cpu", net=net)
    assert ref > 1e-3
    assert abs(got - ref) <= 1e-4 * ref
    assert lpips.lpips(a, a, device="cpu", net=net) < 1e-6

    # the converter's npz under the asset's name selects true LPIPS
    path = tmp_path / "lpips_alex.npz"
    monkeypatch.setattr(lpips, "ASSET", str(path))
    assert not lpips.weights_available()
    with pytest.raises(FileNotFoundError):
        lpips.load(device="cpu")
    np.savez(path, **params)
    assert lpips.weights_available()
    value, kind = metrics.perceptual_distance(a, b, device="cpu")
    assert kind == "lpips" and value == got


# ------------------------------------------------------------ rendering

# the scene's camera is tiny_config's 48x64 (the JAX proxy's pyramid needs
# sides divisible by 4); render_frame is also driven with the directions of
# this odd camera: [::4] keeps ceil(45 / 4) x ceil(62 / 4) rays
ODD_CAM = {"H": 45, "W": 62, "cx": 30.5, "cy": 22.0}
_STATE = {}


def _cfg(tmp, **over):
    return tiny_config(
        data={"output": str(tmp), "exp_name": "render",
              "synthetic": {"n_frames": 12, "orbit_degrees": 25.0}},
        training={"perturb": 0}, mapping={"first_iters": 20}, **over)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _scenes(tmp_path_factory):
    """A JAX pipeline after first-frame mapping (its own buffers, the bf16
    query mirror included), a port pipeline holding the same scene (and so
    its own mirror), and frame 3 of the odd camera; built once per
    module."""
    if not _STATE:
        from remixfusion_tpu_torch.datasets import get_dataset

        tmp = tmp_path_factory.mktemp("render")
        j = RemixFusionTPU(_cfg(tmp / "jax"))
        j.first_frame_mapping()
        j.buffers = j.buffers._replace(gbv_tm=None, gbw_tm=None)
        assert j.buffers.gbq is not None
        p = RemixFusionTorch(_cfg(tmp / "port"), device="cpu")
        load_scene_numpy(p.scene, _np_tree(j.params), _np_tree(j.buffers))
        odd = get_dataset(_cfg(tmp / "odd", cam=ODD_CAM))[3]
        _STATE.update(j=j, p=p, tmp=tmp, odd=odd)
    return _STATE


@contextlib.contextmanager
def _without_mirror(j, p):
    """Both pipelines' scenes without the bf16 query mirror inside the
    block (their hot queries read the float32 grid), restored after."""
    kept = j.buffers
    j.buffers = kept._replace(gbq=None)
    p.scene.gbq = None
    try:
        yield
    finally:
        j.buffers = kept
        p.scene.refresh_gbq()


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
@pytest.mark.parametrize("gap", [1, 4])
@pytest.mark.parametrize("guided", [False, True])
def test_render_frame_matches_jax(tmp_path_factory, gap, guided, mirror):
    s = _scenes(tmp_path_factory)
    j, p, b = s["j"], s["p"], s["odd"]
    td = b["depth"] if guided else None
    with (contextlib.nullcontext() if mirror else _without_mirror(j, p)):
        assert (p.scene.gbq is None) == (j.buffers.gbq is None) == (
            not mirror)
        rgb_j, dep_j = j.render_frame(b["c2w"], b["direction"], gap=gap,
                                      target_depth=td)
        rgb, dep = p.render_frame(b["c2w"], b["direction"], gap=gap,
                                  target_depth=td)
    shape = (-(-45 // gap), -(-62 // gap))
    assert dep.shape == dep_j.shape == shape
    assert rgb.shape == rgb_j.shape == shape + (3,)
    assert np.abs(dep_j).max() > 1.0
    assert np.abs(rgb - rgb_j).max() <= 1e-4, np.abs(rgb - rgb_j).max()
    assert np.abs(dep - dep_j).max() <= 1e-4, np.abs(dep - dep_j).max()


def test_render_frame_chunks_and_pads(tmp_path_factory, monkeypatch):
    """Chunks of 300 rays (the last one padded) render what one chunk
    renders."""
    from remixfusion_tpu_torch.slam import pipeline

    p = _scenes(tmp_path_factory)["p"]
    b = p.dataset[5]
    one = p.render_frame(b["c2w"], b["direction"], gap=2,
                         target_depth=b["depth"])
    monkeypatch.setattr(pipeline, "_RENDER_CHUNK", 300)
    many = p.render_frame(b["c2w"], b["direction"], gap=2,
                          target_depth=b["depth"])
    assert 24 * 32 % 300
    for x, y in zip(one, many):
        assert np.abs(x - y).max() <= 1e-6


def test_render_img_panels_match_jax(tmp_path_factory):
    s = _scenes(tmp_path_factory)
    j, p = s["j"], s["p"]
    b = j.dataset[6]
    gap = 4
    path = p.render_img(6, b["depth"], b["rgb"], b["c2w"], b["direction"])
    assert os.path.basename(path) == "6.png"
    assert os.path.basename(p.render_img(
        6, b["depth"], b["rgb"], b["c2w"], b["direction"],
        prefix="x")) == "6_x.png"

    # the JAX figure's arrays (pipeline.py:1669-1688) from the JAX render
    gt_depth = np.asarray(b["depth"])[::gap, ::gap]
    gt_rgb = np.asarray(b["rgb"])[::gap, ::gap]
    color_j, depth_j = j.render_frame(b["c2w"], b["direction"], gap=gap)
    depth_res = np.abs(gt_depth - depth_j)
    depth_res[gt_depth == 0] = 0
    color_res = np.clip(np.abs(gt_rgb - color_j), 0, 1)
    color_res[gt_depth == 0] = 0
    depth_m = depth_j.copy()
    depth_m[gt_depth == 0] = 0
    want = [gt_depth, depth_m, depth_res, np.clip(gt_rgb, 0, 1),
            np.clip(color_j, 0, 1), color_res]
    color, depth = p.render_frame(b["c2w"], b["direction"], gap=gap)
    panels, vmax = plot.comparison_panels(gt_depth, gt_rgb, color, depth)
    assert vmax == max(float(gt_depth.max()), 1e-3)
    for got, ref in zip(panels, want):
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-4

    img, _ = read_png(path)
    assert img.shape == (2 * 12, 3 * 16, 3)
    np.testing.assert_array_equal(img, plot.comparison_figure(panels, vmax))


def _jax_rendering_eval():
    spec = importlib.util.spec_from_file_location(
        "jax_rendering_eval", os.path.join(ROOT, "rendering_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_calc_2d_metric_matches_jax_from_one_checkpoint(tmp_path_factory,
                                                        capsys):
    """Both packages score the same JAX checkpoint.npz (the port reads the
    JAX keys) at the ground-truth poses of 12 frames, every 4th."""
    s = _scenes(tmp_path_factory)
    j = s["j"]
    ckpt = str(s["tmp"] / "checkpoint.npz")
    j.save_ckpt(ckpt)
    poses = np.stack([np.asarray(q, np.float32) for q in j.dataset.poses])
    ref = _jax_rendering_eval().calc_2d_metric(j, poses, gap=4)

    p = RemixFusionTorch(_cfg(s["tmp"] / "port2"), device="cpu")
    p.load_ckpt(ckpt)
    got = calc_2d_metric(p, poses, gap=4, save=True)
    assert got["frames"] == [0, 4, 8] and len(got["render_ms"]) == 3
    assert "rf_perceptual" in ref and "rf_perceptual" in got
    assert abs(got["psnr"] - ref["psnr"]) <= 1e-3
    assert abs(got["ssim"] - ref["ssim"]) <= 1e-4
    assert abs(got["depth_l1"] - ref["depth_l1"]) <= 1e-4
    assert abs(got["rf_perceptual"] - ref["rf_perceptual"]) <= \
        1e-4 * ref["rf_perceptual"]
    rgb, _ = read_png(os.path.join(p.out_dir, "psnr", "4.png"))
    dep, _ = read_png(os.path.join(p.out_dir, "psnr", "4_d.png"))
    assert rgb.shape == (48, 64, 3) and dep.dtype == np.uint16
    assert "PSNR:" in capsys.readouterr().out


def test_update_gbv_matches_jax(tmp_path_factory):
    """The global grid re-fused from keyframes 0 and 2 at their poses."""
    s = _scenes(tmp_path_factory)
    j, p = s["j"], s["p"]
    kept_j, kept_p = j.buffers, (p.scene.gbv.clone(), p.scene.gbw.clone())
    try:
        for sys_ in (j, p):
            for i in (0, 2):
                sys_.est_c2w_data[i] = j.dataset.poses[i]
        j.update_GBV(3)
        p.update_GBV(3)
        gbv, gbw = np.asarray(j.buffers.gbv), np.asarray(j.buffers.gbw)
        updated = int((gbw > 0).sum())
        assert updated > 0.01 * gbw.size
        np.testing.assert_array_equal(p.scene.gbw.numpy(), gbw)
        d = np.abs(p.scene.gbv.numpy() - gbv)
        assert d[..., 0].max() <= 1e-5
        assert (d[..., 1:].max(-1) > 1e-6).sum() <= 1e-5 * updated
        # the re-fused grid's bf16 query mirror, as JAX repacks its own
        assert j.buffers.gbq is not None
        assert torch.equal(p.scene.gbq, p.scene.gbv.to(torch.bfloat16))
    finally:
        j.buffers = kept_j
        p.scene.gbv.copy_(kept_p[0])
        p.scene.gbw.copy_(kept_p[1])
        p.scene.refresh_gbq()


def test_plasma_table_is_matplotlibs():
    cm = pytest.importorskip("matplotlib.cm")
    colors = pytest.importorskip("matplotlib.colors")
    want = (cm.plasma(np.arange(256))[:, :3] * 255 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(plot.PLASMA, want)
    x = np.random.default_rng(0).uniform(-0.5, 3.5, (40, 50))
    ref = (cm.plasma(colors.Normalize(0.0, 3.0)(x))[..., :3] * 255
           + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(plot.colormap(x, 0.0, 3.0), ref)
