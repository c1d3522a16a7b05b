"""remixfusion_tpu_torch — the PyTorch/CUDA port of remixfusion_tpu.

The port runs on an NVIDIA GPU; the JAX package `remixfusion_tpu` stays
beside it as the reference each module is held against. This package never
imports JAX nor anything of `remixfusion_tpu`: it keeps its own copies of
the numpy-only pieces it needs.

Present slices: the online SLAM loop of RemixFusionTorch —
  - tracking + local TSDF fusion (ROTracker with the hand-written
    `brick_eval` CUDA kernel, or the plain gather and brick eval modes;
    the brick-major moving volume with host brick selection, reusable for
    volume.sel_reuse frames, or the dense volume with frustum-tiled
    fusion; re-centering);
  - the mapping rounds: global keyframe grid, residual field (CPGrid,
    Triplane, HashGrid or DenseGrid — both with the hand-written
    `hash_table_grad` CUDA kernel — or a parameter-free Frequency,
    SphericalHarmonics or Identity encoding) and decoders, RBA bundle
    adjustment, the one-round-late pose write-back;
  - the end of run: the final trajectory and its full and RO-only ATE,
    the checkpoint, mesh.ply (the residual field queried on the dense mesh
    grid on the device, marching tetrahedra in host C++ built with g++
    into build/host/) and mesh_cull_occlusion.ply; tools/eval_recon scores
    the mesh;
  - the real-sensor path: the eleven dataset loaders (datasets/loaders.py)
    with the port's own image I/O (utils/imageio.py: PNG decoded with zlib
    and a host C++ unfilter, OpenCV's resize and undistort arithmetic;
    JPEG through OpenCV), the tracker's per-pixel ray shift
    (RO.sample_range), print_ape, and the capture tools
    (tools/preprocess.py, tools/check_data.py, tools/write_layout.py);
  - the large-scale path: the multi-room corridor building
    (datasets/synthetic.py SyntheticLargeDataset, dataset
    'synthetic_large'), Kinect-class sensor noise (utils/noise.py,
    data.synthetic.sensor_noise) and mid-run resume (mapping.state_every
    writes resume.npz; RemixFusionTorch.load_state then
    run(resume=True), or run_torch.py --resume);
  - rendering and evaluation: render_frame / render_img (the mesh.vis
    comparison figure and ATE line), tools/rendering_eval with the image
    metrics (utils/metrics.py: PSNR, SSIM, the random-feature proxy;
    utils/lpips.py: LPIPS-AlexNet from an npz), the figures drawn by
    utils/plot.py, and the tools: core/traj.py, tools/eval_ate's
    pose_evaluation, tools/live_viewer.py (viz.live), tools/viz.py,
    tools/rgb2video.py.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device=None):
    """The torch.device entry points run on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for (explicitly or by default) and no
    card is present — there is no silent CPU fallback."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "remixfusion_tpu_torch runs on a CUDA device and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def host_to_device(array, device):
    """numpy array -> tensor on `device`. CUDA copies go through pinned
    memory without blocking, so an upload never waits for queued kernels."""
    import numpy as np
    import torch

    t = torch.from_numpy(np.ascontiguousarray(array))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
