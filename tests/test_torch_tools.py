"""Port parity of the trajectory tools, the live viewer and the offline
visualizers against the JAX package on the CPU:

  - core/traj.Trajectory's TUM file, byte for byte, and its read back;
  - pose_evaluation (and its _na / _RO forms): the same result lines, a
    trajectory plot; align_ba bit for bit;
  - the live viewer's endpoints and trajectory downsampling (as
    tests/test_viz.py holds the JAX one), encode_bmp's bytes equal to the
    JAX encoder's;
  - tools/viz: shade_depth bit for bit, render_sequence's images equal to
    the JAX ones on the same mesh, plot_trajectory's PNG;
  - tools/rgb2video on a few PNG frames, with either writer and with none;
  - a tiny run of both pipelines with mesh.vis and mesh.render_img: the same
    tracking_result.txt line count and frame ids; viz.live runs the viewer,
    viz.live 0 does no viewer work."""

import copy
import json
import os
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from helpers import tiny_config
from remixfusion_tpu.core.traj import Trajectory as JTrajectory
from remixfusion_tpu.tools import eval_ate as jeval
from remixfusion_tpu.tools import live_viewer as jlive
from remixfusion_tpu.tools import viz as jviz
from remixfusion_tpu_torch.core.traj import Trajectory
from remixfusion_tpu_torch.tools import eval_ate, live_viewer, rgb2video, viz
from remixfusion_tpu_torch.utils.imageio import read_png, write_png
from remixfusion_tpu_torch.utils.meshio import write_ply_mesh

torch.set_num_threads(1)


def _poses(n, seed):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = Rotation.random(random_state=rng).as_matrix()
        out[i, :3, 3] = rng.normal(size=3)
    return out


def test_trajectory_tum_bytes_match_jax(tmp_path):
    poses = _poses(6, 0)
    ours, ref = Trajectory(), JTrajectory()
    for i, p in enumerate(poses):
        ours.add(0.5 * i, p)
        ref.add(0.5 * i, p)
    ours.write_tum(str(tmp_path / "a.txt"))
    ref.write_tum(str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == \
        (tmp_path / "b.txt").read_bytes()
    back = Trajectory.read_tum(str(tmp_path / "a.txt"))
    np.testing.assert_array_equal(
        back.as_array(), JTrajectory.read_tum(str(tmp_path / "b.txt"))
        .as_array())
    assert len(back) == 6 and back.timestamps == ref.timestamps
    assert np.abs(back.as_array() - poses).max() < 1e-5
    assert Trajectory().as_array().shape == (0, 4, 4)


@pytest.mark.parametrize("form", ["", "_na", "_RO"])
def test_pose_evaluation_lines_match_jax(tmp_path, form, capsys):
    gt = _poses(20, 1).astype(np.float32)
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(2).normal(0, 0.01, (20, 3))
    ours = getattr(eval_ate, "pose_evaluation" + form)
    ref = getattr(jeval, "pose_evaluation" + form)
    dicts = {i: est[i] for i in range(12)}
    for fid, e in ((7, est), (11, dicts)):
        s_ours = ours(gt, e, 1, str(tmp_path / "port"), fid)
        s_ref = ref(gt, e, 1, str(tmp_path / "jax"), fid)
        assert s_ours == s_ref
    name = "RO_result.txt" if form == "_RO" else "tracking_result.txt"
    lines = (tmp_path / "port" / name).read_text()
    assert lines == (tmp_path / "jax" / name).read_text()
    assert [ln.split()[0] for ln in lines.splitlines()] == ["7", "11"]
    assert lines.splitlines()[1].endswith("pairs: 12")
    img = "RO" if form == "_RO" else "frame"
    plot, _ = read_png(str(tmp_path / "port" / f"{img}_11.png"))
    assert plot.ndim == 3 and (plot != 255).any()
    assert "ate-rmse(cm)" in capsys.readouterr().out


def test_align_ba_matches_jax():
    gt = _poses(20, 3).astype(np.float32)
    est = np.einsum("ij,njk->nik", _poses(1, 4)[0], gt).astype(np.float32)
    aligned, T = eval_ate.align_ba(est, gt)
    ref_aligned, ref_T = jeval.align_ba(est, gt)
    np.testing.assert_array_equal(aligned, ref_aligned)
    np.testing.assert_array_equal(T, ref_T)
    assert np.abs(aligned[:, :3, 3] - gt[:, :3, 3]).max() < 1e-4


# ------------------------------------------------------------ live viewer

def _get(url):
    return urllib.request.urlopen(url, timeout=10).read()


def test_live_viewer_endpoints():
    v = live_viewer.LiveViewer(port=0, host="127.0.0.1")
    base = f"http://127.0.0.1:{v.port}"
    try:
        assert b"remixfusion_tpu_torch" in _get(base + "/")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/frame", timeout=10)
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nothing", timeout=10)

        v.publish_frame(np.random.default_rng(0).random((24, 32, 3)))
        v.publish_state(
            frame=7, n=100, fps=16.5,
            est=np.tile(np.eye(4, dtype=np.float32), (5, 1, 1)),
            gt=np.zeros((5, 3), np.float32), extra={"ate_cm": 0.76})
        st = json.loads(_get(base + "/state.json"))
        assert st["frame"] == 7 and st["n"] == 100
        assert abs(st["fps"] - 16.5) < 1e-6
        assert len(st["est"]) == 5 and len(st["gt"]) == 5
        assert st["extra"]["ate_cm"] == 0.76
        body = _get(base + "/frame")
        assert body[:3] == b"\xff\xd8\xff" or body[:2] == b"BM"

        seq0 = st["seq"]
        v.publish_frame(np.zeros((24, 32, 3), np.uint8))
        assert json.loads(_get(base + "/state.json"))["seq"] == seq0 + 1
        assert len(_get(base + "/frame")) > 0
    finally:
        v.stop()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(base + "/state.json", timeout=10)


def test_live_viewer_downsamples_long_trajectories():
    v = live_viewer.LiveViewer(port=0, host="127.0.0.1")
    try:
        poses = np.tile(np.eye(4, dtype=np.float32), (2000, 1, 1))
        poses[:, 0, 3] = np.linspace(0, 1, 2000)
        v.publish_state(frame=1999, est=poses, max_pts=400)
        st = json.loads(_get(f"http://127.0.0.1:{v.port}/state.json"))
        assert 400 <= len(st["est"]) <= 401
        assert st["est"][0][0] == 0.0 and st["est"][-1][0] > 0.99
    finally:
        v.stop()


@pytest.mark.parametrize("shape", [(2, 3), (5, 7), (24, 32)])
def test_encode_bmp_bytes_match_jax(shape):
    rgb = np.random.default_rng(5).integers(0, 256, shape + (3,), np.uint8)
    data = live_viewer.encode_bmp(rgb)
    assert data == jlive.encode_bmp(rgb)
    assert data[:2] == b"BM"
    assert int.from_bytes(data[18:22], "little") == shape[1]
    assert int.from_bytes(data[22:26], "little") == shape[0]


# ------------------------------------------------------------------- viz

def test_shade_depth_matches_jax():
    rng = np.random.default_rng(6)
    d = rng.uniform(0.5, 3.0, (30, 40)).astype(np.float32)
    d[5:9, 10:20] = 0.0
    np.testing.assert_array_equal(viz.shade_depth(d), jviz.shade_depth(d))


def _box_mesh(path):
    """A 1 m cube's 12 triangles centred 2.5 m in front of the origin."""
    c = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                  for z in (2.0, 3.0)], np.float32)
    faces = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                      [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                      [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int32)
    write_ply_mesh(path, c, faces)


def test_render_sequence_matches_jax(tmp_path):
    pytest.importorskip("imageio")  # the JAX tool writes through imageio
    mesh = str(tmp_path / "box.ply")
    _box_mesh(mesh)
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    poses[:, 0, 3] = np.linspace(-0.3, 0.3, 4)
    ours = viz.render_sequence(mesh, poses, K, 48, 64, str(tmp_path / "a"),
                               every=2)
    ref = jviz.render_sequence(mesh, poses, K, 48, 64, str(tmp_path / "b"),
                               every=2)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in ref] == ["viz_00000.png",
                                               "viz_00002.png"]
    for a, b in zip(ours, ref):
        img, _ = read_png(a)
        ref_img, _ = read_png(b)
        np.testing.assert_array_equal(img, ref_img)
        assert (img > 0).any() and (img == 0).any()


def test_plot_trajectory_writes_png(tmp_path):
    poses = np.tile(np.eye(4, dtype=np.float32), (5, 1, 1))
    poses[:, 0, 3] = np.linspace(0, 1, 5)
    poses[:, 2, 3] = np.linspace(0, 0.5, 5)
    out = viz.plot_trajectory(poses, poses + 0.01,
                              str(tmp_path / "traj.png"))
    img, _ = read_png(out)
    assert img.shape[2] == 3
    assert ((img == [0, 0, 255]).all(-1)).any()
    assert ((img == [0, 0, 0]).all(-1)).any()


# -------------------------------------------------------------- rgb2video

def _frames(tmp_path, n=4):
    d = tmp_path / "frames"
    d.mkdir()
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (16, 24, 3), np.uint8) for _ in range(n)]
    for i, f in enumerate(frames):
        write_png(str(d / f"f{i:03d}.png"), f)
    return d, frames


def test_rgb2video_writes_a_video_or_gif(tmp_path):
    d, _ = _frames(tmp_path)
    out = rgb2video.frames_to_video(str(d), str(tmp_path / "v.mp4"), fps=5)
    assert out in (str(tmp_path / "v.mp4"), str(tmp_path / "v.gif"))
    assert os.path.getsize(out) > 0
    with pytest.raises(FileNotFoundError):
        rgb2video.frames_to_video(str(d), str(tmp_path / "w.mp4"),
                                  pattern="*.jpg")


def test_rgb2video_gif_without_imageio(tmp_path, monkeypatch):
    Image = pytest.importorskip("PIL.Image")
    d, frames = _frames(tmp_path)
    monkeypatch.setitem(sys.modules, "imageio", None)
    out = rgb2video.frames_to_video(str(d), str(tmp_path / "v.mp4"), fps=5)
    assert out == str(tmp_path / "v.gif")
    with Image.open(out) as gif:
        assert gif.n_frames == len(frames)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="imageio.*PIL"):
        rgb2video.frames_to_video(str(d), str(tmp_path / "x.mp4"))


# ---------------------------------------------------------- pipeline hooks

N_RUN = 12


def _run_cfg(tmp, **viz_cfg):
    return tiny_config(
        data={"output": str(tmp), "exp_name": "vis",
              "synthetic": {"n_frames": N_RUN, "orbit_degrees": 25.0}},
        mesh={"resolution": 64, "vis": 4, "voxel_eval": 0.1,
              "voxel_final": 0.1, "visualisation": False,
              "mesh_bound_scale": 1.02, "only_final": 1, "render_img": 1},
        viz={"live": 0, "live_every": 2, "live_render_every": 0, **viz_cfg})


def _ids(path):
    with open(path) as f:
        return [(ln.split()[0], ln.split()[-1]) for ln in f]


def test_mesh_vis_lines_match_jax(tmp_path, monkeypatch):
    """mesh.vis 4 with mesh.render_img: each package appends an ATE line
    (and its plot, and the comparison figure) at frames 4 and 8, and the
    final line at frame 11; the same frame ids and pair counts. With
    viz.live 0 no viewer runs and no frame is published."""
    from remixfusion_tpu.slam import RemixFusionTPU
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    j = RemixFusionTPU(_run_cfg(tmp_path / "jax"))
    j.first_frame_mapping()
    for i in range(1, N_RUN):
        j.track_frame(i, j._get_frame(i))
        while j.tracking_idx > j.mapping_idx + 2 and j.mapping_idx + 2 < N_RUN:
            j.mapping_round(j.mapping_idx + 2)
    j._harvest_pending_track()
    while j.tracking_idx > j.mapping_idx + 2 and j.mapping_idx + 2 < N_RUN:
        j.mapping_round(j.mapping_idx + 2)
    j._apply_pending_ba()
    jeval.pose_evaluation(j.pose_gt, j.convert_relative_pose_npy(), 1,
                          j.out_dir, N_RUN - 1)
    j.close()

    s = RemixFusionTorch(_run_cfg(tmp_path / "port"), device="cpu")
    assert s.viewer is None

    def no_viewer_work(*a):
        raise AssertionError("viewer work with viz.live 0")

    monkeypatch.setattr(s, "_publish_live", no_viewer_work)
    s.run()
    out = tmp_path / "port" / "vis"
    ids = _ids(out / "tracking_result.txt")
    assert ids == _ids(tmp_path / "jax" / "vis" / "tracking_result.txt")
    assert ids == [("4", "5"), ("8", "9"), ("11", "12")]
    for name in ("4.png", "8.png", "frame_4.png", "frame_8.png",
                 "frame_11.png"):
        assert (out / name).exists(), name
    img, _ = read_png(str(out / "4.png"))
    assert img.shape == (2 * 12, 3 * 16, 3)


def test_live_viewer_follows_a_run(tmp_path):
    """viz.live 1: the state after finalize holds the whole trajectory, the
    frames published were the input at stride 2 and, every 4th frame, a
    gap-8 render; close() releases the port."""
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    cfg = _run_cfg(tmp_path, live=1, live_render_every=4)
    cfg["mesh"].update(vis=0, render_img=0)
    s = RemixFusionTorch(cfg, device="cpu")
    shapes = []
    publish = s.viewer.publish_frame

    def record(rgb):
        shapes.append(np.asarray(rgb).shape[:2])
        publish(rgb)

    s.viewer.publish_frame = record
    port = s.viewer.port
    try:
        s.run()
        st = json.loads(_get(f"http://127.0.0.1:{port}/state.json"))
        body = _get(f"http://127.0.0.1:{port}/frame")
    finally:
        s.close()
    assert st["frame"] == N_RUN - 1 and len(st["est"]) == N_RUN
    assert st["extra"] == {"status": "finished"}
    assert body[:3] == b"\xff\xd8\xff" or body[:2] == b"BM"
    # frames 2..10 every 2nd; 4 and 8 rendered at gap 8 (6 x 8)
    assert shapes == [(24, 32), (6, 8), (24, 32), (6, 8), (24, 32)]
    assert s.viewer is None
    s.close()
    with pytest.raises(urllib.error.URLError):
        urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json",
                               timeout=10)
