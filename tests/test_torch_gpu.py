"""Kernel tests that need a CUDA card (marker `gpu`); they skip elsewhere.

This file imports neither JAX nor the JAX package, so it also runs on a GPU
host without JAX, where tests/conftest.py (which imports JAX) cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Each test holds a hand-written kernel against its plain PyTorch version on
the card, or a plain path on the card (mesh queries, rendering, the image
metrics, resume) against the same path on the CPU, with the tolerance of
the CPU parity tests."""

import numpy as np
import pytest
import torch

from remixfusion_tpu_torch.ops import brick_eval as be


@pytest.fixture
def cuda_device():
    """Decides at run time (never at import) whether a card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel has no CPU mode); run on a "
                    "GPU host: python -m pytest --noconftest "
                    "tests/test_torch_gpu.py")
    return torch.device("cuda")


def brick_eval_inputs(n_cand, n_pix, seed, interp):
    """A camera looking down +z at points 1-3 m away, their 4^3 windows of a
    smooth field, and PST-like candidates scaled by a few-cm search size."""
    rng = np.random.default_rng(seed)
    H, W, f = 48, 64, 40.0
    inv_vox = 1.0 / 0.05
    u = rng.uniform(0, W, n_pix)
    v = rng.uniform(0, H, n_pix)
    z = rng.uniform(1.0, 3.0, n_pix)
    g = np.stack([(u - W / 2) * z / f, (v - H / 2) * z / f, z], -1)
    origin = np.array([-2.0, -2.0, 0.0])
    base = np.round((g - origin) * inv_vox) - 2
    d = np.arange(4)
    cells = np.stack(np.meshgrid(d, d, d, indexing="ij"), -1).reshape(-1, 3)
    vox = base[:, None, :] + cells[None]
    bricks = np.zeros((n_pix, 128), np.float32)
    bricks[:, :64] = np.sin(0.3 * vox.sum(-1)) + 0.1 * rng.standard_normal(
        (n_pix, 64))
    ok = (rng.random(n_pix) > 0.1).astype(np.float32)
    pix = np.zeros((n_pix, 16), np.float32)
    pix[:, :3] = g
    pix[:, 3] = rng.uniform(-0.2, 0.2, n_pix)
    pix[:, 4:7] = base + origin * inv_vox
    pix[:, 7] = ok
    table = np.zeros((8, n_cand), np.float32)
    pts = rng.standard_normal((n_cand, 6))
    pts /= np.linalg.norm(pts, axis=1, keepdims=True)
    pts *= rng.random((n_cand, 1)) ** (1 / 6)
    pts[0] = 0.0
    table[:6] = pts.T
    ss = np.array([0.12, 0.12, 0.12, 0.05, 0.05, 0.05])
    params = np.zeros(32, np.float32)
    params[0:9] = np.eye(3).reshape(-1)
    params[12:18] = ss
    params[18:25] = [f, f, W / 2 - 0.5, H / 2 - 0.5, W, H, inv_vox]
    return params, pix, bricks, table


def brick_volume_inputs(n_cand, n_pix, seed, interp):
    """brick_eval_inputs' camera, candidates and pixels, with each pixel's
    window read from a brick-major volume (10^3 bricks, 100 x 100 x 70
    voxels) of a noisy smooth field that bfloat16 does not hold exactly, at
    integer bases clamped inside the volume as the tracker clamps them:
    (params, pix, base int32 [P, 3], tsdf_bm [NB, 1000], layout, table)."""
    params, pix, _, table = brick_eval_inputs(n_cand, n_pix, seed, interp)
    rng = np.random.default_rng(seed + 1)
    b, dims = 10, np.array([100, 100, 70])
    inv_vox, origin = params[24], np.array([-2.0, -2.0, 0.0], np.float32)
    base = np.round((pix[:, :3] - origin) * inv_vox).astype(np.int64) - 2
    base = np.clip(base, 1, dims - 1 - 4).astype(np.int32)
    pix[:, 4:7] = base + origin * inv_vox
    ii = np.stack(np.meshgrid(*(np.arange(d) for d in dims),
                              indexing="ij"), -1)
    dense = (np.sin(0.3 * ii.sum(-1)) + 0.1 * rng.standard_normal(
        tuple(dims))).astype(np.float32)
    X, Y, Z = (int(d) for d in dims)
    tsdf_bm = np.ascontiguousarray(dense.reshape(
        X // b, b, Y // b, b, Z // b, b).transpose(0, 2, 4, 1, 3, 5)
        .reshape(-1, b ** 3))
    return params, pix, base, tsdf_bm, (b, Y // b, Z // b), table


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("n_cand,n_pix", [(10240, 300), (3072, 1200),
                                          (1024, 4800)])
def test_brick_eval_volume_kernel_matches_plain(cuda_device, interp, n_cand,
                                                n_pix):
    """The tracker's entry at the tier shapes: windows gathered in the
    kernel (crossing brick faces on every axis), one launch per call, the
    same bits on a second call."""
    params, pix, base, tsdf_bm, layout, table = brick_volume_inputs(
        n_cand, n_pix, 13, interp)
    assert ((base % layout[0]) > layout[0] - 4).any(0).all()
    params, pix, base, tsdf_bm, table = (
        torch.from_numpy(a).to(cuda_device)
        for a in (params, pix, base, tsdf_bm, table))
    before = be.brick_eval_volume.launches
    out = be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                               interp=interp)
    again = be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                                 interp=interp)
    torch.cuda.synchronize()
    assert be.brick_eval_volume.launches == before + 2
    assert torch.equal(out, again)
    ref = be.brick_eval_volume_reference(params, pix, base, tsdf_bm, layout,
                                         table, interp=interp)
    assert torch.equal(out >= 1e6, ref >= 1e6)
    keep = out < 1e6
    d = (out - ref).abs()[keep]
    assert d.max().item() < 5e-3 and d.mean().item() < 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
@pytest.mark.parametrize("n_cand,n_pix", [(10240, 300), (3072, 1200),
                                          (1024, 4800)])
def test_brick_eval_float32_windows_match_plain(cuda_device, interp, n_cand,
                                                n_pix):
    """The float32-window instantiation (a float32 track view: the cells
    scored unrounded) against its plain version at the tier shapes, counted
    under its own kind, and apart from the bfloat16 instantiation's costs
    on a field that bfloat16 does not hold exactly."""
    params, pix, base, tsdf_bm, layout, table = brick_volume_inputs(
        n_cand, n_pix, 17, interp)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (params, pix, base, tsdf_bm)]
    table = torch.from_numpy(table).to(cuda_device)
    kind = f"{interp}/float32"
    before = be.brick_eval_volume.launches_by_kind.get(kind, 0)
    out = be.brick_eval_volume(*args, layout, table, interp=interp,
                               track_dtype="float32")
    again = be.brick_eval_volume(*args, layout, table, interp=interp,
                                 track_dtype="float32")
    rounded = be.brick_eval_volume(*args, layout, table, interp=interp)
    torch.cuda.synchronize()
    assert be.brick_eval_volume.launches_by_kind[kind] == before + 2
    assert torch.equal(out, again)
    ref = be.brick_eval_volume_reference(*args, layout, table, interp=interp,
                                         track_dtype="float32")
    assert torch.equal(out >= 1e6, ref >= 1e6)
    keep = out < 1e6
    d = (out - ref).abs()[keep]
    assert d.max().item() < 5e-3 and d.mean().item() < 1e-4
    assert not torch.equal(out, rounded)


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_brick_eval_kernel_matches_plain(cuda_device, interp):
    """The kernel against its plain version at the finest tier's shape; the
    windowed entry has no kernel and raises on the card."""
    params, pix, base, tsdf_bm, layout, table = brick_volume_inputs(
        1024, 4800, 11, interp)
    bricks = be.fetch_windows(torch.from_numpy(tsdf_bm), layout,
                              torch.from_numpy(base))
    params, pix, base, tsdf_bm, table, bricks = (
        torch.as_tensor(a).to(cuda_device)
        for a in (params, pix, base, tsdf_bm, table, bricks))
    before = be.brick_eval_volume.launches
    out = be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                               interp=interp)
    torch.cuda.synchronize()
    assert be.brick_eval_volume.launches == before + 1
    ref = be.brick_eval_reference(params, pix, bricks, table, interp=interp)
    assert torch.equal(out >= 1e6, ref >= 1e6)
    keep = out < 1e6
    d = (out - ref).abs()[keep]
    assert d.max().item() < 5e-3 and d.mean().item() < 1e-4
    with pytest.raises(ValueError):
        be.brick_eval(params, pix, bricks, table, interp=interp)


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_brick_eval_perturbed_tier_matches_plain(cuda_device, interp):
    """One tier of the tracker with RO.sample_range 2.0 (ScanNet's), built
    on the card: each pixel shifted along its ray by U(-2, 1) x trunc, so
    the expected tsdf (pix[:, 3]) spans [-1, 1) and saturates to 1.0 past
    the truncation. The kernel against its plain version at the finest
    tier's shape (C = 1024)."""
    from helpers import tiny_config
    from remixfusion_tpu_torch.tracking.rotracker import ROTracker

    _, _, _, tsdf_bm, layout, _ = brick_volume_inputs(1024, 4800, 17,
                                                      interp)
    cfg = tiny_config(
        RO={"eval_mode": "pallas", "tsdf_interp": interp,
            "sample_range": 2.0, "cut_dist": 20.0,
            "PST_size": [10240, 3072, 1024], "depth_level": [4, 2, 1]},
        volume={"trunc": 0.15})
    K = np.array([[40.0, 0, 31.5], [0, 40.0, 23.5], [0, 0, 1]], np.float32)
    tt = ROTracker(cfg, 48, 64, K, (100, 100, 70), 0.05, layout,
                   cuda_device)
    rng = np.random.default_rng(18)
    depth = torch.tensor(rng.uniform(1.0, 3.0, (48, 64)).astype(np.float32),
                         device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    vn = tt.vertex_normal_maps(depth, generator=gen)
    origin = torch.tensor([-2.0, -2.0, 0.0], device=cuda_device)
    eye = torch.eye(3, device=cuda_device)
    params, pix, base = tt.tier_inputs(1, 0, eye, torch.zeros(
        3, device=cuda_device), tt.init_search_size(), vn, origin)
    gt = pix[pix[:, 7] > 0, 3]
    assert bool((gt == 1.0).any()) and bool((gt < 0).any())
    table = tt.pst_t[2][0]
    tsdf_bm = torch.from_numpy(tsdf_bm).to(cuda_device)
    out = be.brick_eval_volume(params, pix, base, tsdf_bm, layout, table,
                               interp=interp)
    ref = be.brick_eval_volume_reference(params, pix, base, tsdf_bm, layout,
                                         table, interp=interp)
    torch.cuda.synchronize()
    assert torch.equal(out >= 1e6, ref >= 1e6)
    keep = out < 1e6
    assert bool(keep.any())
    d = (out - ref).abs()[keep]
    assert d.max().item() < 5e-3 and d.mean().item() < 1e-4


def hash_grad_inputs(n_pts, seed):
    """The bench_hashgrid encoder (16 levels, 2^16 hashed, desired
    resolution 200), points inside and around the unit cube, and an output
    gradient of mapping-step scale."""
    from remixfusion_tpu_torch.models.encodings import HashGridEncoding

    enc = HashGridEncoding(16, 2, 16, 16, 200)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, (n_pts, 3)).astype(np.float32)
    g = (1e-3 * rng.standard_normal((n_pts, 32))).astype(np.float32)
    return enc, x, g


@pytest.mark.gpu
@pytest.mark.parametrize("n_pts", [29791, 120832])
def test_hash_table_grad_kernel_matches_plain(cuda_device, n_pts):
    from remixfusion_tpu_torch.ops import hash_enc as he

    enc, x, g = hash_grad_inputs(n_pts, 5)
    x, g = torch.from_numpy(x).to(cuda_device), torch.from_numpy(g).to(
        cuda_device)
    before = he.hash_table_grad.launches
    out = he.hash_table_grad(enc, x, g, enc.table_size)
    torch.cuda.synchronize()
    assert he.hash_table_grad.launches == before + 1
    ref = he.hash_table_grad_reference(enc, x, g, enc.table_size)
    # atomics add in another order than index_add_: float32 reassociation
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale
    # rows no point touched stay exactly zero in both
    assert torch.equal(out == 0, ref == 0)


@pytest.mark.gpu
def test_candidate_sharded_brick_eval_matches_single_process(cuda_device,
                                                             tmp_path):
    """Candidate-sharded brick_eval on the card: a 2-rank gloo world (NCCL
    refuses two ranks on one card) scores the full tiers (10240 / 3072 /
    1024 candidates, 5121 / 1537 / 513 a rank with the identity column)
    and gathers the costs: bitwise the single-process kernel's on the same
    volume and frame, one launch per tier on every rank."""
    import sharding_ranks
    from helpers import tiny_config
    from remixfusion_tpu_torch.parallel.launch import spawn

    cfg = tiny_config(
        RO={"eval_mode": "pallas", "depth_level": [4, 2, 1],
            "PST_size": [10240, 3072, 1024]},
        volume={"voxel_size": 0.025})
    single, n_single = sharding_ranks.tier_costs(cfg, None, cuda_device)
    res = spawn(sharding_ranks.tier_costs_rank, 2, backend="gloo",
                device="cuda", init_file=str(tmp_path / "rendezvous"),
                timeout_s=300, args=(cfg,))
    assert n_single == 3 and [n for _, n in res] == [3, 3]
    for got, ref in zip(res[0][0], single):
        # a rank's slice launches with the whole table's pixel split, so
        # its candidates get the single-process launch's bits
        assert got.shape == ref.shape and np.array_equal(got, ref)
    assert all(np.array_equal(a, b) for a, b in zip(res[0][0], res[1][0]))


@pytest.mark.gpu
@pytest.mark.parametrize("interp", ["nearest", "trilinear"])
def test_brick_eval_dense_layout_matches_plain(cuda_device, interp):
    """The dense volume (volume.brick_fusion false): the same field as a
    dense [X, Y, Z] volume read through layout (1, Y, Z), one voxel a
    'brick' of row stride 1. The kernel against its plain version, and
    bitwise its own result on the brick-major copy (the same windows)."""
    params, pix, base, tsdf_bm, layout, table = brick_volume_inputs(
        1024, 4800, 17, interp)
    b, BY, BZ = layout
    X = tsdf_bm.shape[0] // (BY * BZ) * b
    dense = np.ascontiguousarray(tsdf_bm.reshape(
        X // b, BY, BZ, b, b, b).transpose(0, 3, 1, 4, 2, 5).reshape(-1, 1))
    dense_layout = (1, BY * b, BZ * b)
    params, pix, base, tsdf_bm, dense, table = (
        torch.from_numpy(a).to(cuda_device)
        for a in (params, pix, base, tsdf_bm, dense, table))
    before = be.brick_eval_volume.launches
    out = be.brick_eval_volume(params, pix, base, dense, dense_layout, table,
                               interp=interp)
    torch.cuda.synchronize()
    assert be.brick_eval_volume.launches == before + 1
    ref = be.brick_eval_volume_reference(params, pix, base, dense,
                                         dense_layout, table, interp=interp)
    assert torch.equal(out >= 1e6, ref >= 1e6)
    keep = out < 1e6
    d = (out - ref).abs()[keep]
    assert d.max().item() < 5e-3 and d.mean().item() < 1e-4
    assert torch.equal(out, be.brick_eval_volume(
        params, pix, base, tsdf_bm, layout, table, interp=interp))


@pytest.mark.gpu
def test_hash_table_grad_dense_grid_matches_plain(cuda_device):
    """The DenseGrid table at synthetic_bench.yaml's widths (desired 200:
    dense levels 16^3, 59^3, 218^3, 800^3, ~522.6 M rows, 4.2 GB): row
    indices and row * 2 stay below 2^31 in the kernel's uint32 arithmetic,
    level 0 (4,096 rows) is privatized; against the plain version, rows no
    point touched exactly zero."""
    from remixfusion_tpu_torch.models.encodings import DenseGridEncoding
    from remixfusion_tpu_torch.ops import hash_enc as he

    enc = DenseGridEncoding(4, 2, 16, 200)
    assert not any(enc.hashed) and 2 * enc.table_size < 2 ** 31
    assert he.privatized_rows(enc) == enc.offsets[1] == 4096
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((151040, 3), generator=gen, device=cuda_device)
    g = torch.randn((151040, 8), generator=gen, device=cuda_device)
    out = he.hash_table_grad(enc, x, g, enc.table_size)
    ref = he.hash_table_grad_reference(enc, x, g, enc.table_size)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(out == 0, ref == 0)


def ray_points(n_rays, n_samples, seed):
    """Ray-major samples as a render batch orders them: n_samples points
    along each of n_rays rays through the unit cube."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.1, 0.9, (n_rays, 1, 3))
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.sort(rng.uniform(0.0, 0.4, (n_rays, n_samples, 1)), axis=1)
    return (o + t * d).reshape(-1, 3).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n_rays,n_samples", [(2048, 74), (512, 9)])
def test_hash_table_grad_ray_ordered_matches_plain(cuda_device, n_rays,
                                                   n_samples):
    """Ray-ordered points (2048 rays x 74 samples: the render backward at
    the bench widths), so neighbouring lanes share rows: the shared-memory
    level 0 and the run-combined levels both carry repeated rows."""
    from remixfusion_tpu_torch.ops import hash_enc as he

    enc, _, _ = hash_grad_inputs(1, 5)
    assert he.privatized_rows(enc) == enc.offsets[1]
    x = ray_points(n_rays, n_samples, 7)
    rng = np.random.default_rng(8)
    g = (1e-3 * rng.standard_normal((x.shape[0], 32))).astype(np.float32)
    x, g = torch.from_numpy(x).to(cuda_device), torch.from_numpy(g).to(
        cuda_device)
    out = he.hash_table_grad(enc, x, g, enc.table_size)
    ref = he.hash_table_grad_reference(enc, x, g, enc.table_size)
    torch.cuda.synchronize()
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= 1e-5 * scale
    assert torch.equal(out == 0, ref == 0)


def sphere_scene(enc, device):
    """A scene on the CPU and its copy on `device`: random decoders over a
    global grid holding a 0.9 m sphere's truncated SDF and smooth colours
    (weights on the half x < 2.55), with the render settings of a tiny
    config. Returns (config, bound, cpu scene, device scene)."""
    from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
    from remixfusion_tpu_torch.utils.convert import scene_from_numpy, \
        scene_to_numpy

    cfg = {
        "grid": {"enc": enc, "hash_size": 16, "voxel_sdf": 0.02},
        "pos": {"enc": "OneBlob", "n_bins": 16},
        "decoder": {"geo_feat_dim": 15, "hidden_dim": 32, "num_layers": 2,
                    "num_layers_color": 2, "hidden_dim_color": 32},
        "mapping": {"pose_scale": 0.01},
        "globalV": {"base_resolution": 64},
        "training": {"c_trunc": 0.25, "trunc": 0.05, "n_range_d": 21,
                     "n_samples_d": 11, "range_d": 0.2, "perturb": 1},
        "cam": {"near": 0.0, "far": 5.0},
        "data": {"sc_factor": 1, "translation": 0},
    }
    bound = np.array([[0.0, 4.0]] * 3, np.float32)
    cpu = SceneRepresentation(cfg, bound, 16, device="cpu",
                              generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    with torch.no_grad():
        for p in cpu.decoder_res.parameters():
            p.copy_(torch.tensor(rng.uniform(-0.15, 0.15, tuple(p.shape)),
                                 dtype=torch.float32))
        R = cpu.gbv_resolution
        w = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"),
                     -1) / R * 4.0
        d = np.linalg.norm(w - (2.0, 2.1, 1.9), axis=-1) - 0.9
        cpu.gbv[..., 0] = torch.tensor(np.clip(d / 0.25, -1, 1))
        cpu.gbv[..., 1:] = torch.tensor(0.5 + 0.45 * np.sin(w))
        cpu.gbw.copy_(torch.tensor(((w[..., 0] < 2.55)
                                    * (1 + rng.random((R, R, R))))))
    params, buffers = scene_to_numpy(cpu)
    card = scene_from_numpy(cfg, bound, 16, params, buffers, device=device)
    return cfg, bound, cpu, card


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_extract_mesh_on_card_matches_cpu(cuda_device, enc, tmp_path):
    """extract_mesh of one scene on the card and on the CPU: the SDF grid
    within 1e-4 (no TF32 or other device-only numerics in the queries),
    the same weight mask, vertex and face counts within 1%."""
    from remixfusion_tpu_torch.utils.mesh import extract_mesh

    cfg, bound, cpu, card = sphere_scene(enc, cuda_device)
    out = {}
    for name, scene in (("cpu", cpu), ("card", card)):
        info = {}
        v, f, _ = extract_mesh(scene, cfg, bound, voxel_size=0.04,
                               mesh_savepath=str(tmp_path / f"{name}.ply"),
                               info=info)
        out[name] = (v, f, info)
    (vc, fc, ic), (vg, fg, ig) = out["cpu"], out["card"]
    assert np.abs(ig["sdf"] - ic["sdf"]).max() <= 1e-4
    assert np.array_equal(ig["weight"] > 0, ic["weight"] > 0)
    assert len(fc) > 1000
    assert abs(len(vg) - len(vc)) <= 0.01 * len(vc)
    assert abs(len(fg) - len(fc)) <= 0.01 * len(fc)


@pytest.mark.gpu
def test_resume_on_card_is_bitwise(cuda_device, tmp_path):
    """A tiny run on the card saves its state mid-run; a fresh pipeline
    loads it with every array bitwise the file's and continues to the
    end."""
    import json

    from helpers import tiny_config
    from remixfusion_tpu_torch.slam import RemixFusionTorch

    def cfg(exp):
        return tiny_config(
            data={"output": str(tmp_path), "exp_name": exp,
                  "synthetic": {"n_frames": 12, "orbit_degrees": 25.0}},
            RO={"particle_iter_lens": 8, "depth_level": [4, 2, 1],
                "eval_mode": "pallas", "PST_size": [256, 128, 128],
                "init_size": 0.02, "count_search": 100},
            volume={"voxel_size": 0.025},
            mapping={"first_iters": 15, "iters": 2, "BA_iters": 2,
                     "keyframe_every": 2, "map_every": 2, "sample": 128},
            mesh={"vis": 0, "voxel_final": 0.1})

    slam = RemixFusionTorch(cfg("a"), device=cuda_device)
    slam.first_frame_mapping()
    for idx in range(1, 7):
        slam.step(idx, 12)
    path = str(tmp_path / "resume.npz")
    slam.save_state(path)
    state = tuple(t.clone() for t in slam.mv.state)
    del slam
    torch.cuda.empty_cache()

    slam2 = RemixFusionTorch(cfg("b"), device=cuda_device)
    slam2.load_state(path)
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    got = slam2.state_arrays()
    assert got.keys() == data.keys()
    for k, v in data.items():
        if v.dtype.kind == "U":
            assert json.loads(str(got[k])) == json.loads(str(v)), k
        else:
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
    assert all(torch.equal(a, b) for a, b in zip(slam2.mv.state, state))
    out = slam2.run(resume=True)
    assert out["tracked_frames"] == 5
    assert np.isfinite(slam2.est_c2w_data).all()
    assert out["ate_rmse_cm"] < 10.0


@pytest.mark.gpu
@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_render_rays_on_card_match_cpu(cuda_device, enc):
    """4,096 rays from inside the room towards the sphere, half of them
    depth-guided, rendered with the same perturbation draws on the card and
    on the CPU: rgb and depth within 1e-4."""
    _, _, cpu, card = sphere_scene(enc, cuda_device)
    rng = np.random.default_rng(5)
    n = 4096
    d = rng.normal(0, 0.25, (n, 3)) + (0.0, 0.05, 1.0)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = np.tile(np.float32([2.0, 2.0, 0.2]), (n, 1))
    td = np.where(rng.random(n) < 0.5, rng.uniform(0.6, 1.4, n), -1.0)
    td = td.astype(np.float32)[:, None]
    u = torch.rand(cpu.z_vals_shape(n), generator=torch.Generator()
                   .manual_seed(6))
    out = {}
    for name, scene, dev in (("cpu", cpu, "cpu"), ("card", card,
                                                    cuda_device)):
        with torch.no_grad():
            r = scene.render_rays(*(torch.from_numpy(a).to(dev)
                                    for a in (o, d, td)), u=u.to(dev))
        out[name] = (r["rgb_res_map"].cpu().numpy(),
                     r["depth_res_map"].cpu().numpy())
    (rgb_c, dep_c), (rgb_g, dep_g) = out["cpu"], out["card"]
    assert dep_c.max() > 0.5 and np.isfinite(rgb_c).all()
    assert np.abs(rgb_g - rgb_c).max() <= 1e-4
    assert np.abs(dep_g - dep_c).max() <= 1e-4


@pytest.mark.gpu
def test_image_metrics_on_card_match_cpu(cuda_device):
    """SSIM and the random-feature proxy (float64) and LPIPS with random
    weights of the converter's shapes (float32, no TF32) on the card and
    on the CPU."""
    from remixfusion_tpu_torch.utils import lpips, metrics

    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (96, 128, 3))
    gt[10:30, 20:60] = 0.0
    img = np.clip(gt + rng.normal(0, 0.08, gt.shape), 0, 1)
    map_c, s_c = metrics.ssim(img, gt, device="cpu")
    map_g, s_g = metrics.ssim(img, gt, device=cuda_device)
    assert np.abs(map_g - map_c).max() <= 1e-9 and abs(s_g - s_c) <= 1e-9
    rf_c = metrics.random_feature_perceptual(img, gt, device="cpu")
    rf_g = metrics.random_feature_perceptual(img, gt, device=cuda_device)
    assert abs(rf_g - rf_c) <= 1e-8 * rf_c
    params, in_ch = {}, 3
    for i, (out_ch, k, _s, _p) in enumerate(lpips.CONVS):
        params[f"conv{i}_w"] = rng.normal(
            0, 0.05, (out_ch, in_ch, k, k)).astype(np.float32)
        params[f"conv{i}_b"] = rng.normal(0, 0.01, out_ch).astype(np.float32)
        params[f"lin{i}_w"] = np.abs(rng.normal(0, 1, out_ch)).astype(
            np.float32)
        in_ch = out_ch
    lp_c = lpips.lpips(img, gt, device="cpu", net=lpips.LPIPS(params))
    lp_g = lpips.lpips(img, gt, device=cuda_device,
                       net=lpips.LPIPS(params).to(cuda_device))
    assert lp_c > 1e-3 and abs(lp_g - lp_c) <= 1e-4 * lp_c
