"""Port parity of the mesh half of the end of run (marching tetrahedra, PLY
IO, the scene's mesh queries, extract_mesh, the analytic GT mesh, the local
volume export, the depth rasterizer, culling and the reconstruction
metrics) against the JAX package on the CPU, and the port's end of run on
a tiny slice.

Inputs are made from numpy seeds. The scene for the query and extract_mesh
tests is a JAX scene whose parameters are replaced by seeded uniform draws
(the decoders' zero-initialised output layers would otherwise hide the
explicit tsdf input of query_color_residual) and whose grid holds a sphere
with a weight mask cutting it; it goes across with utils/convert.

Tolerances: marching on the same SDF array is bitwise between the two
packages' native libraries (same source, same g++ flags) and between the
two numpy versions; native against numpy as canonical meshes (sorted
vertices, remapped faces) to 1e-6 of the coordinate (voxel-index units),
since g++ may contract the edge interpolation into an FMA. Scene queries
to 1e-5 relative to the largest value of the output. extract_mesh: the
SDF grid to 1e-5 and the weight mask identical; end to end, counts within
1%, symmetric mean nearest-vertex distance < 1e-4 m, colors within 1
(uint8 truncation). Rasterizer 1e-5; metrics 1e-6."""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from helpers import tiny_config
from remixfusion_tpu.datasets import get_dataset as jax_get_dataset
from remixfusion_tpu.models.scene_rep import SceneRepresentation as JScene
from remixfusion_tpu.ops import marching_cubes as jmc
from remixfusion_tpu.ops import tsdf as jtsdf
from remixfusion_tpu.tools import cull_mesh as jcull
from remixfusion_tpu.tools import eval_recon as jeval
from remixfusion_tpu.tracking.volume import MovingVolume as JaxVolume
from remixfusion_tpu.utils import mesh as jmesh
from remixfusion_tpu.utils import meshio as jio
from remixfusion_tpu.utils import raster as jraster
from remixfusion_tpu_torch.datasets import get_dataset
from remixfusion_tpu_torch.ops import marching_cubes as pmc
from remixfusion_tpu_torch.ops import tsdf as ptsdf
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.slam import pipeline as ppipe
from remixfusion_tpu_torch.tools import cull_mesh as pcull
from remixfusion_tpu_torch.tools import eval_recon as peval
from remixfusion_tpu_torch.tracking.volume import MovingVolume
from remixfusion_tpu_torch.utils import mesh as pmesh
from remixfusion_tpu_torch.utils import meshio as pio
from remixfusion_tpu_torch.utils import raster as praster
from remixfusion_tpu_torch.utils.convert import scene_from_numpy

torch.set_num_threads(1)
NUM_KF = 8


# ------------------------------------------------------------ marching

def sphere_volume(seed, shape=(20, 22, 24)):
    """Two spheres' SDF with a little noise, and a mask cutting them."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(*[np.arange(n) for n in shape],
                             indexing="ij"), -1).astype(np.float64)
    d = np.minimum(np.linalg.norm(g - (9.3, 10.1, 11.7), axis=-1) - 6.2,
                   np.linalg.norm(g - (14.0, 6.0, 17.5), axis=-1) - 3.1)
    vol = (d + 0.05 * rng.standard_normal(shape)).astype(np.float32)
    mask = g[..., 0] + 0.5 * g[..., 2] < 24.0
    return vol, mask


def canonical(verts, faces):
    """Vertices sorted lexicographically, faces remapped and each face
    rotated to start at its smallest index, faces sorted."""
    order = np.lexsort(verts.T[::-1])
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    f = rank[faces]
    f = np.array([np.roll(t, -int(np.argmin(t))) for t in f])
    f = f[np.lexsort(f.T[::-1])]
    return verts[order], f


@pytest.mark.parametrize("masked", [False, True])
def test_marching_cubes_matches_jax(masked):
    vol, mask = sphere_volume(0)
    mask = mask if masked else None
    assert jmc._load_native() is not None
    v, f = pmc.marching_cubes(vol, 0.0, mask=mask)
    jv, jf = jmc.marching_cubes(vol, 0.0, mask=mask)
    assert len(f) > 500
    assert np.array_equal(v, jv) and np.array_equal(f, jf)
    rv, rf = pmc.marching_cubes_reference(vol, 0.0, mask=mask)
    jrv, jrf = jmc._numpy_mc(vol, mask, 0.0)
    assert np.array_equal(rv, jrv) and np.array_equal(rf, jrf)
    cv, cf = canonical(v, f)
    crv, crf = canonical(rv, rf)
    # vertices are in voxel-index units (up to 24 here), where one float32
    # ulp exceeds 1e-6 absolute: the bound is 1e-6 of the coordinate
    assert (np.abs(cv - crv) <= 1e-6 * np.maximum(1.0, np.abs(crv))).all()
    assert np.array_equal(cf, crf)
    n = pmc.vertex_normals(v, f)
    assert np.abs(n - jmc.vertex_normals(jv, jf)).max() <= 1e-6
    assert np.allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)


def test_marching_cubes_level_out_of_range_raises():
    vol, _ = sphere_volume(1)
    for level in (float(vol.max()) + 1.0, float(vol.min()) - 1.0):
        with pytest.raises(ValueError, match="outside"):
            pmc.marching_cubes(vol, level)
        with pytest.raises(ValueError, match="outside"):
            jmc.marching_cubes(vol, level)


def test_host_build_failure_raises(tmp_path, monkeypatch):
    """A g++ failure raises with the compiler's output; nothing falls back
    to the numpy version."""
    from remixfusion_tpu_torch.ops import build
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(build, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "HOST_BUILD_DIR", str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for broken.cpp"):
        build.load_host("broken")


# ----------------------------------------------------------------- PLY

@pytest.mark.parametrize("binary", [True, False])
def test_ply_bytes_and_cross_read(tmp_path, binary):
    vol, _ = sphere_volume(2)
    v, f = pmc.marching_cubes(vol, 0.0)
    rng = np.random.default_rng(3)
    c = rng.integers(0, 256, (len(v), 3)).astype(np.uint8)
    n = pmc.vertex_normals(v, f)
    a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
    pio.write_ply_mesh(a, v, f, colors=c, normals=n, binary=binary)
    jio.write_ply_mesh(b, v, f, colors=c, normals=n, binary=binary)
    assert a.read_bytes() == b.read_bytes()
    for reader, path in ((pio.read_ply, b), (jio.read_ply, a)):
        rv, rf = reader(path)
        assert np.array_equal(rf, f)
        if binary:
            assert np.array_equal(rv, v)
        else:
            assert np.abs(rv - v).max() <= 1e-6
    pio.write_ply_points(a, v[:50], c[:50])
    jio.write_ply_points(b, v[:50], c[:50])
    assert a.read_bytes() == b.read_bytes()


# --------------------------------------------------------- scene queries

_SCENES = {}


def scene_pair(enc):
    """(config, JAX scene, params, buffers, port scene) with seeded
    parameters and a sphere grid (built once per encoder)."""
    if enc not in _SCENES:
        cfg = tiny_config(grid={"enc": enc, "hash_impl": "xla"})
        bound = np.asarray(cfg["mapping"]["bound"], np.float32)
        js = JScene(cfg, bound, NUM_KF)
        params, buffers = js.init(jax.random.PRNGKey(0))
        rng = np.random.default_rng(11)
        params = jax.tree_util.tree_map(
            lambda a: jnp.asarray(rng.uniform(-0.15, 0.15, np.shape(a)),
                                  jnp.float32), params)
        R = js.gbv_resolution
        w = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"),
                     -1) / R * 4.0
        d = np.linalg.norm(w - (2.0, 2.1, 1.9), axis=-1) - 0.9
        gbv = np.zeros((R, R, R, 4), np.float32)
        gbv[..., 0] = np.clip(d / 0.25, -1.0, 1.0)
        gbv[..., 1:] = 0.5 + 0.45 * np.sin(1.7 * w + (0.0, 1.0, 2.0))
        gbw = ((w[..., 0] < 2.55) * (1.0 + rng.random((R, R, R)))).astype(
            np.float32)
        buffers = buffers._replace(gbv=jnp.asarray(gbv),
                                   gbw=jnp.asarray(gbw), gbq=None,
                                   gbv_tm=None, gbw_tm=None)
        ts = scene_from_numpy(cfg, bound, NUM_KF,
                              jax.tree_util.tree_map(np.asarray, params),
                              jax.tree_util.tree_map(np.asarray, buffers))
        _SCENES[enc] = (cfg, js, params, buffers, ts)
    return _SCENES[enc]


def _close(a, b):
    """Within 1e-5 of the reference's largest magnitude: XLA contracts
    the trilinear sums into FMAs, which moves a small value among large
    ones by an ulp of the large ones."""
    assert np.abs(a - b).max() <= 1e-5 * max(1.0, float(np.abs(b).max()))


@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_scene_mesh_queries_match_jax(enc):
    cfg, js, params, buffers, ts = scene_pair(enc)
    pts = np.random.default_rng(5).uniform(0.2, 0.8, (3000, 3)).astype(
        np.float32)
    x, tx = jnp.asarray(pts), torch.tensor(pts)
    names = ("query_sdf_ex", "query_w_res", "query_color_residual",
             "query_color_ex", "query_sdf_res")
    refs = jax.jit(lambda p: [getattr(js, n)(params, buffers, p)
                              for n in names])(x)
    with torch.no_grad():
        for name, ref in zip(names, refs):
            _close(getattr(ts, name)(tx).numpy(), np.asarray(ref))
        # the trap: query_color_residual feeds the decoder the RAW explicit
        # tsdf; this input has points beyond trunc / c_trunc, where the
        # rescaled and clamped input of query_color_sdf would differ
        ex = ts.query_gbv(tx)
        assert (ex[:, 0].abs() > ts.trunc / ts.c_trunc).float().mean() > 0.3
        scaled = torch.clamp(ts._explicit_tsdf(ex), -1.0, 1.0)[:, None]
        wrong = ts.decoder_res(ts.embed_res_fn(ts._table(), tx),
                               ts.embedpos_fn(None, tx), scaled,
                               ex[..., 1:])[..., :3] + ex[..., 1:]
        assert np.abs(wrong.numpy() - np.asarray(refs[2])).max() > 1e-3


def test_checkpoint_fields_match_jax():
    """save_ckpt's param_<i> follow jax.tree_util.tree_flatten of the
    JAX SceneParams, and the buffers keep their names."""
    for enc in ("CPGrid", "HashGrid"):
        cfg, js, params, buffers, ts = scene_pair(enc)
        state = RemixFusionTorch._model_state_dict(
            types.SimpleNamespace(scene=ts))
        flat = jax.tree_util.tree_leaves(params)
        assert sorted(k for k in state if k.startswith("param_")) == \
            sorted(f"param_{i}" for i in range(len(flat)))
        for i, p in enumerate(flat):
            assert np.array_equal(state[f"param_{i}"], np.asarray(p)), i
        for k, ref in (("gbv", buffers.gbv), ("gbw", buffers.gbw),
                       ("rba_init_c2w", buffers.rba.init_c2w)):
            assert np.array_equal(state[k], np.asarray(ref)), k


# -------------------------------------------------------- extract_mesh

def _jax_grids(js, params, buffers, flat_norm, explicit):
    q = js.query_sdf_ex if explicit else js.query_sdf_res
    sdf = jmesh._chunked_query(jax.jit(lambda p: q(params, buffers, p)),
                               flat_norm)
    w = jmesh._chunked_query(
        jax.jit(lambda p: js.query_w_res(params, buffers, p)), flat_norm)
    return sdf, w


@pytest.mark.parametrize("enc,explicit", [("CPGrid", False),
                                          ("HashGrid", False),
                                          ("CPGrid", True)])
def test_extract_mesh_matches_jax(enc, explicit, tmp_path):
    cfg, js, params, buffers, ts = scene_pair(enc)
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    vox = cfg["mesh"]["voxel_final"]
    info = {}
    path = str(tmp_path / "port.ply")
    v, f, c = pmesh.extract_mesh(ts, cfg, bound, bound, voxel_size=vox,
                                 mesh_savepath=path, explicit_only=explicit,
                                 info=info)
    jv, jf, jc = jmesh.extract_mesh(js, params, buffers, cfg, bound, bound,
                                    voxel_size=vox, explicit_only=explicit,
                                    mesh_savepath=str(tmp_path / "jax.ply"))
    # the grids
    axes, flat_norm = pmesh.grid_points(bound, bound, voxel_size=vox)
    assert [len(a) for a in axes] == [41, 41, 41]
    sdf_j, w_j = _jax_grids(js, params, buffers, flat_norm, explicit)
    sh = info["sdf"].shape
    assert np.abs(info["sdf"] - sdf_j.reshape(sh)).max() <= 1e-5
    assert np.array_equal(info["weight"] > 0, w_j.reshape(sh) > 0)
    # the port's marching + metric transform on JAX's grid: bitwise
    mv, mf = pmesh.grid_to_mesh(sdf_j.reshape(sh), w_j.reshape(sh), axes,
                                cfg)
    assert np.array_equal(mv, jv) and np.array_equal(mf, jf)
    # end to end
    assert len(f) > 1000
    assert abs(len(v) - len(jv)) <= 0.01 * len(jv)
    assert abs(len(f) - len(jf)) <= 0.01 * len(jf)
    d1, i1 = cKDTree(jv).query(v)
    d2, _ = cKDTree(v).query(jv)
    assert 0.5 * (d1.mean() + d2.mean()) < 1e-4
    same = d1 < 1e-6
    assert same.mean() > 0.99
    assert np.abs(c[same].astype(int) - jc[i1[same]].astype(int)).max() <= 1
    rv, rf = pio.read_ply(path)
    assert np.array_equal(rv, v) and np.array_equal(rf, f)


def test_extract_mesh_empty_when_nothing_below_level(tmp_path):
    cfg, js, params, buffers, ts = scene_pair("CPGrid")
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    saved = ts.gbw.clone()
    try:
        ts.gbw.zero_()
        path = str(tmp_path / "none.ply")
        v, f, c = pmesh.extract_mesh(ts, cfg, bound, voxel_size=0.2,
                                     mesh_savepath=path)
    finally:
        ts.gbw.copy_(saved)
    assert len(v) == 0 and len(f) == 0 and c is None
    assert not os.path.exists(path)


# ------------------------------------------- GT mesh and local volume

def test_gt_mesh_matches_jax():
    cfg = tiny_config()
    pv, pf = get_dataset(cfg).gt_mesh(voxel_size=0.1)
    jv, jf = jax_get_dataset(cfg).gt_mesh(voxel_size=0.1)
    assert len(pf) > 1000
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf)


def test_local_volume_export_matches_jax():
    cfg = tiny_config(volume={"voxel_size": 0.05})
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, 2.0)
    jv = JaxVolume(copy.deepcopy(cfg), pose)
    tv = MovingVolume(copy.deepcopy(cfg), pose, "cpu")
    rng = np.random.default_rng(8)
    dims = tv.dims
    g = np.stack(np.meshgrid(*[np.arange(n) for n in dims], indexing="ij"),
                 -1).astype(np.float32)
    d = np.linalg.norm(g - (0.45 * dims[0], 0.5 * dims[1], 0.55 * dims[2]),
                       axis=-1) - 0.3 * min(dims)
    dense_t = torch.tensor(np.clip(d / 3.0, -1, 1).astype(np.float32))
    dense_w = torch.tensor(((rng.random(dims) < 0.8)
                            * rng.uniform(1, 5, dims)).astype(np.float32))
    dense_c = torch.tensor(rng.uniform(0, 255, dims + (3,)).astype(
        np.float32))
    b = tv.brick
    tv.state = ptsdf.VolumeState(
        ptsdf.dense_to_bm(dense_t, b).contiguous(),
        ptsdf.dense_to_bm(dense_w, b).contiguous(),
        ptsdf.dense_to_bm(dense_c, b).contiguous(), tv.state.origin)
    jv.state = jtsdf.VolumeState(*(jnp.asarray(a.numpy())
                                   for a in tv.state[:3]), jv.state.origin)
    assert np.array_equal(tv.state.origin.numpy(), np.asarray(jv.state.origin))
    out, ref = tv.get_mesh(), jv.get_mesh()
    assert len(out[1]) > 1000
    for a, r in zip(out, ref):
        assert a.dtype == r.dtype and np.array_equal(a, r)
    pc, jpc = tv.get_truncated_pc(), jv.get_truncated_pc()
    assert len(pc) > 100 and pc.dtype == jpc.dtype
    assert np.array_equal(pc, jpc)


# ---------------------------------------------- rasterizer and culling

def _sphere_mesh():
    cfg = tiny_config()
    ds = get_dataset(cfg)
    v, f = ds.gt_mesh(voxel_size=0.2)
    return cfg, ds, v, f


def test_render_mesh_depth_native_and_plain():
    cfg, ds, v, f = _sphere_mesh()
    K, H, W = ds.K(), ds.H, ds.W
    for i in (0, 5):
        c2w = ds.poses[i]
        d = praster.render_mesh_depth(v, f, K, c2w, H, W)
        ref = praster.render_mesh_depth_reference(v, f, K, c2w, H, W)
        jd = jraster.render_mesh_depth(v, f, K, c2w, H, W)
        assert (d > 0).mean() > 0.2
        assert np.abs(d - ref).max() <= 1e-5
        assert np.abs(d - jd).max() <= 1e-5


@pytest.mark.parametrize("depth_flag", [True, False])
def test_cull_one_mesh_matches_jax(depth_flag, tmp_path):
    cfg, ds, v, f = _sphere_mesh()
    jds = jax_get_dataset(cfg)
    src = str(tmp_path / "in.ply")
    pio.write_ply_mesh(src, v, f)
    poses = [ds.poses[i] for i in range(0, 12, 5)]
    pv, pf = pcull.cull_one_mesh(cfg, poses, src, str(tmp_path / "p.ply"), 5,
                                 ds, depth_flag=depth_flag, eps=0.1)
    jv, jf = jcull.cull_one_mesh(cfg, poses, src, str(tmp_path / "j.ply"), 5,
                                 jds, depth_flag=depth_flag, eps=0.1)
    assert 0 < len(pf) < len(f)
    assert np.array_equal(pv, jv) and np.array_equal(pf, jf)
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()


def test_reconstruction_metrics_match_jax():
    cfg, ds, v, f = _sphere_mesh()
    rng = np.random.default_rng(9)
    rec = (v + rng.normal(0, 0.01, v.shape)).astype(np.float32)
    a = peval.sample_surface(rec, f, 5000, seed=3)
    assert np.abs(a - jeval.sample_surface(rec, f, 5000, seed=3)).max() \
        <= 1e-6
    m = peval.calc_3d_metric(rec, f, v, f, n_points=4000, seed=1)
    jm = jeval.calc_3d_metric(rec, f, v, f, n_points=4000, seed=1)
    assert m.keys() == jm.keys()
    for k in m:
        assert abs(m[k] - jm[k]) <= 1e-6 * max(1.0, abs(jm[k])), k
    K, H, W = ds.K(), ds.H, ds.W
    l1 = peval.calc_2d_depth_l1((rec, f), (v, f), K, H, W, n_views=6)
    jl1 = jeval.calc_2d_depth_l1((rec, f), (v, f), K, H, W, n_views=6)
    assert np.isfinite(l1) and abs(l1 - jl1) <= 1e-6


# ------------------------------------------------------------ the slice

def _slice_cfg(tmp):
    return tiny_config(
        data={"output": str(tmp), "exp_name": "mesh",
              "synthetic": {"n_frames": 5, "orbit_degrees": 20.0}},
        RO={"eval_mode": "pallas", "tsdf_interp": "nearest",
            "save_volume": 1, "save_freq": 2},
        volume={"voxel_size": 0.025}, tracking={"harvest_depth": 1},
        mapping={"save_ckpt": True},
        mesh={"vis": 2, "only_final": 0, "voxel_eval": 0.2})


def test_slice_writes_meshes_and_culling_failure_raises(tmp_path,
                                                        monkeypatch):
    s = RemixFusionTorch(_slice_cfg(tmp_path), device="cpu")
    out = s.run()
    for key in ("mesh_path", "mesh_cull_path"):
        v, f = pio.read_ply(out[key])
        assert len(v) > 0 and len(f) > 0, key
        assert (v >= -0.5).all() and (v <= 4.5).all(), key
    assert out["mesh_path"] == os.path.join(s.out_dir, "mesh.ply")
    assert 0 < out["mesh_cull_faces"] <= out["mesh_faces"]
    for k in ("query", "marching", "write", "cull"):
        assert out[f"mesh_{k}_ms"] >= 0.0
    # the mesh.vis snapshot after the round at frame 2, and the local
    # volume dumps of the RO.save_volume frames (every 2nd, and the last)
    for name in ("mesh_track2.ply", "RO/2.ply", "RO/4.ply"):
        v, f = pio.read_ply(os.path.join(s.out_dir, name))
        assert len(f) > 0, name
    assert sorted(os.listdir(os.path.join(s.out_dir, "RO"))) == \
        ["2.ply", "4.ply"]
    ckpt = np.load(os.path.join(s.out_dir, "checkpoint.npz"))
    assert {"pose", "pose_rel", "gbv", "gbw", "param_0"} <= set(ckpt.files)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ppipe, "cull_one_mesh", broken)
    with pytest.raises(OSError, match="disk full"):
        s.finalize(out["frames"], {})
