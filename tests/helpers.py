"""Shared test fixtures: a tiny full-schema config + synthetic scene."""

import numpy as np


def tiny_config(**overrides):
    """Full config-schema dict with miniature sizes for CPU tests."""
    cfg = {
        "dataset": "synthetic",
        "print_ape": 0,
        "data": {
            "downsample": 1, "sc_factor": 1, "translation": 0,
            "num_workers": 0, "exp_name": "test", "output": "/tmp/rmx_test",
            "datadir": "/tmp/none", "trainskip": 1,
            "synthetic": {
                "n_frames": 12, "room_size": 4.0, "sphere_radius": 0.6,
                "orbit_radius": 1.2, "orbit_degrees": 40.0,
            },
        },
        "globalV": {
            "use": 1, "base_resolution": 48, "n_levels": 1,
            "per_level_scale": 1, "n_features_per_level": 4,
        },
        "mapping": {
            "sample": 128, "first_mesh": False, "iters": 2, "BA_iters": 2,
            "lr_embed": 0.01, "lr_embed_res": 0.01, "lr_decoder": 0.01,
            "lr_rot": 5e-4, "lr_trans": 5e-4, "lr_pose": 5e-4,
            "keyframe_every": 2, "map_every": 2, "n_pixels": 0.05,
            "first_iters": 10, "optim_cur": False, "min_pixels_cur": 20,
            "map_accum_step": 1, "pose_accum_step": 1, "map_wait_step": 0,
            "filter_depth": False, "opt_pose": True, "clamp": 2.0,
            "pose_scale": 1.0, "save_ckpt": False,
            "bound": [[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]],
            "marching_cubes_bound": [[0.0, 4.0], [0.0, 4.0], [0.0, 4.0]],
        },
        "tracking": {"ignore_edge_W": 2, "ignore_edge_H": 2,
                     "const_speed": True},
        "RO": {
            "init_size": 0.02, "scaling_coefficient": 0.09,
            "particle_iter_lens": 4, "PST_path": "",
            "PST_size": [256, 128, 64], "count_search": 50,
            "fix_level_index": 0, "filter_weight": 2, "rgb_rose": 0,
            "rgb_rose_weight": 0.1, "save_volume": 0, "save_freq": 1000,
            "cut": 0, "cut_dist": 8.0, "sample_range": 0.0,
            "iterative_scale": False,
        },
        "grid": {"enc": "HashGrid", "tcnn_encoding": True, "hash_size": 12,
                 "voxel_color": 0.08, "voxel_sdf": 0.08},
        "pos": {"enc": "OneBlob", "n_bins": 8},
        "decoder": {"geo_feat_dim": 15, "hidden_dim": 32, "num_layers": 2,
                    "num_layers_color": 2, "hidden_dim_color": 32,
                    "tcnn_network": False},
        "cam": {
            "H": 48, "W": 64, "fx": 40.0, "fy": 40.0, "cx": 31.5, "cy": 23.5,
            "png_depth_scale": 1000.0, "crop_edge": 0, "near": 0.0,
            "far": 5.0, "depth_trunc": 100.0,
        },
        "training": {
            "rgb_weight": 5.0, "depth_weight": 0.1, "sdf_weight": 1000,
            "fs_weight": 10, "surface_weight": 0, "eikonal_weight": 0,
            "smooth_weight": 0.001, "smooth_pts": 8, "smooth_vox": 0.1,
            "smooth_margin": 0.05, "n_samples_d": 5, "range_d": 0.25,
            "n_range_d": 12, "n_importance": 0, "perturb": 1,
            "white_bkgd": False, "c_trunc": 0.25, "trunc": 0.06,
            "rot_rep": "quat", "rgb_missing": 0.0,
        },
        "mesh": {"resolution": 64, "vis": 500, "voxel_eval": 0.1,
                 "voxel_final": 0.1, "visualisation": False,
                 "mesh_bound_scale": 1.02, "only_final": 1, "render_img": 0},
        "volume": {
            "voxel_size": 0.05, "version": "center", "trunc": 0.06,
            "weight_threshold": 2.0, "weight_clamp": 1.0, "t_treshold": 1,
            "x_config": {"fix": 0, "len": 2, "range": [0, 1]},
            "y_config": {"fix": 0, "len": 2, "range": [0, 1]},
            "z_config": {"fix": 0, "len": 2, "range": [0, 1]},
            "first_len": 2, "second_len": 2, "third_len": 2,
            "more_angel_t": 20,
        },
        "video": {"save": False, "save_freq": 20},
    }

    def merge(dst, src):
        for k, v in src.items():
            if isinstance(v, dict) and isinstance(dst.get(k), dict):
                merge(dst[k], v)
            else:
                dst[k] = v

    merge(cfg, overrides)
    return cfg


def map_round_state(enc, device, seed=3):
    """A mapping round's state on `device` at tiny_config sizes: a scene
    whose global grid holds a 0.9 m sphere's truncated SDF (its mirror
    refreshed) under random decoders, its Mapper, a keyframe store of
    three keyframes and the round's inputs. (mapper, inputs): inputs holds
    the arguments map_step_dev / ba_step_dev take besides n_iters, n_cur
    and the draws, and `n_cur`, two current-frame budgets of different
    buckets."""
    import torch

    from remixfusion_tpu_torch.mapping.keyframe import DeviceKeyFrameStore
    from remixfusion_tpu_torch.mapping.mapper import Mapper
    from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation

    cfg = tiny_config(grid={"enc": enc})
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    num_kf = 8
    scene = SceneRepresentation(
        cfg, bound, num_kf, device=device,
        generator=torch.Generator(device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    with torch.no_grad():
        for p in scene.decoder_res.parameters():
            p.copy_(torch.tensor(rng.uniform(-0.15, 0.15, tuple(p.shape)),
                                 **f32))
        R = scene.gbv_resolution
        w = np.stack(np.meshgrid(*[np.arange(R)] * 3, indexing="ij"),
                     -1) / R * 4.0
        d = np.linalg.norm(w - (2.0, 2.1, 1.9), axis=-1) - 0.9
        scene.gbv[..., 0] = torch.tensor(np.clip(d / 0.25, -1, 1), **f32)
        scene.gbv[..., 1:] = torch.tensor(0.5 + 0.45 * np.sin(w), **f32)
        scene.gbw.fill_(1.0)
    scene.refresh_gbq()
    mapper = Mapper(cfg, scene)
    cam = cfg["cam"]
    H, W = cam["H"], cam["W"]
    v, u = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    dirs = np.stack([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"],
                     np.ones_like(u, np.float64)], -1).reshape(-1, 3)
    dep = rng.uniform(0.8, 2.6, (H, W))
    dep[rng.random((H, W)) < 0.05] = 0.0  # a few invalid pixels
    rgb = rng.random((H, W, 3))
    n_kf, per_kf = 3, 256
    store = DeviceKeyFrameStore(num_kf, per_kf, cam["depth_trunc"], device)
    idx = rng.integers(0, H * W, n_kf * per_kf)
    store.rays[:n_kf * per_kf] = torch.tensor(np.concatenate(
        [dirs[idx], rgb.reshape(-1, 3)[idx], dep.reshape(-1)[idx, None]],
        -1), **f32)
    store.frame_ids = [0, 2, 4]
    poses = np.tile(np.eye(4), (num_kf, 1, 1))
    for k in range(num_kf):
        a = 0.05 * k
        poses[k, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                            [-np.sin(a), 0, np.cos(a)]]
        poses[k, :3, 3] = (2.0 + 0.05 * k, 2.0, 0.4)
    kf_poses = torch.tensor(poses, **f32)
    for k in range(n_kf + 1):
        scene.rba.update_init_pose(k, kf_poses[k])
    sample = cfg["mapping"]["sample"]
    inputs = dict(kf_store=store, n_kf=n_kf,
                  dirs_flat=torch.tensor(dirs, **f32),
                  dep=torch.tensor(dep, **f32), rgb=torch.tensor(rgb, **f32),
                  kf_poses=kf_poses, cur_kf_id=n_kf,
                  n_cur=(sample // 4, cfg["mapping"]["min_pixels_cur"]))
    return mapper, inputs
