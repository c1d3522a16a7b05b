"""The port's config loader (its own YAML subset parser) against PyYAML +
the JAX package's inherit_from loader, for every file under configs/; and
static checks that the port never imports JAX or the JAX package and runs
without PyYAML (the GPU host need not have either)."""

import ast
import copy
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import yaml

from remixfusion_tpu.config import load_config as jax_load_config
from remixfusion_tpu_torch.config import load_config, parse_yaml

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, ROOT) for p in
                 glob.glob(os.path.join(ROOT, "configs", "*", "*.yaml")))
PORT_FILES = sorted(
    glob.glob(os.path.join(ROOT, "remixfusion_tpu_torch", "**", "*.py"),
              recursive=True)
    + [os.path.join(ROOT, f) for f in ("chip_smoke.py", "run_torch.py",
                                       "rendering_eval_torch.py")])
# the modules of the rendering and tools slice, each checked by name below
RENDER_SLICE = ("utils/metrics.py", "utils/lpips.py", "utils/plot.py",
                "core/traj.py", "tools/eval_ate.py", "tools/rendering_eval.py",
                "tools/live_viewer.py", "tools/viz.py", "tools/rgb2video.py")
# the scale-out slice: spawned ranks import these, and never JAX
PARALLEL = ("parallel/__init__.py", "parallel/launch.py",
            "parallel/sharding.py", "parallel/dryrun.py")


@pytest.mark.parametrize("path", CONFIGS)
def test_config_matches_pyyaml(path, monkeypatch):
    monkeypatch.chdir(ROOT)
    with open(path) as f:
        text = f.read()
    assert parse_yaml(text) == yaml.safe_load(text)
    assert load_config(path) == jax_load_config(path)


def test_parser_scalars_follow_yaml_1_1():
    doc = ("a: 1e-6\nb: 1.0e-06\nc: [x, {k: 2}]\nd: yes\ne: ~\nf: 'it''s'\n"
           "g:\n- [1, 2]\n- -3\nh: {u: 1,\n    v: [0.5, .5]}\n")
    assert parse_yaml(doc) == yaml.safe_load(doc)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    assert len(PORT_FILES) > 10
    for rel in RENDER_SLICE + PARALLEL:
        assert os.path.join(ROOT, "remixfusion_tpu_torch", rel) in PORT_FILES
    for path in PORT_FILES:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "remixfusion_tpu", "yaml"), (
                path, mod)


def test_port_imports_no_image_library_at_module_level():
    """OpenCV, PIL, imageio and matplotlib may be missing on the card's
    host: the port imports cv2 only where a JPEG is read or written,
    imageio only where a frame or video may be encoded with it, PIL only in
    tools/rgb2video's GIF writer (inside the function), and matplotlib
    nowhere."""
    gif_writer = os.path.join(ROOT, "remixfusion_tpu_torch", "tools",
                              "rgb2video.py")
    for path in PORT_FILES:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for mod in names:
                assert mod.split(".")[0] not in ("cv2", "PIL", "imageio",
                                                 "matplotlib"), (path, mod)
        for mod in _imports(path):
            assert mod.split(".")[0] != "matplotlib", (path, mod)
            assert mod.split(".")[0] != "PIL" or path == gif_writer, (path,
                                                                     mod)


def test_port_runs_without_jax_or_pyyaml():
    """Import every port module (the rendering and scale-out slices' by
    name too) and load a config in a process where jax, the JAX package,
    yaml, cv2, PIL, imageio and matplotlib cannot be imported."""
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'yaml', 'remixfusion_tpu', 'cv2',\n"
        "          'PIL', 'imageio', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        "import remixfusion_tpu_torch as p\n"
        "names = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    names.add(m.name)\n"
        f"for rel in {RENDER_SLICE + PARALLEL!r}:\n"
        "    name = 'remixfusion_tpu_torch.' + rel[:-3].replace('/', '.')\n"
        "    name = name.removesuffix('.__init__')\n"
        "    assert name in names, name\n"
        "import rendering_eval_torch\n"
        "from remixfusion_tpu_torch.config import load_config\n"
        "cfg = load_config('configs/Synthetic/synthetic_bench.yaml')\n"
        "assert cfg['RO']['eval_mode'] == 'pallas'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


SYNTHETIC = [p for p in CONFIGS if p.startswith(os.path.join("configs",
                                                             "Synthetic"))]


@pytest.mark.parametrize("path", SYNTHETIC)
def test_synthetic_config_dataset_builds(path, monkeypatch):
    """Every configs/Synthetic/*.yaml builds its dataset through the port's
    factory (n_frames cut to 40): the orbit room or the corridor building,
    with its sensor noise, the same class, poses and noise settings as the
    JAX factory's."""
    from remixfusion_tpu.datasets.factory import get_dataset as jax_get
    from remixfusion_tpu_torch.datasets import get_dataset

    monkeypatch.chdir(ROOT)
    cfg = load_config(path)
    cfg["data"].setdefault("synthetic", {})["n_frames"] = 40
    ds, ref = get_dataset(copy.deepcopy(cfg)), jax_get(copy.deepcopy(cfg))
    assert type(ds).__name__ == type(ref).__name__
    assert len(ds) == len(ref) == 40
    assert ds.sensor_noise == ref.sensor_noise
    assert ds.room_dims == ref.room_dims
    assert all(np.array_equal(a, b) for a, b in zip(ds.poses, ref.poses))


def test_gather_mode_config_raises_naming_it(monkeypatch):
    """corridor_v25g.yaml (RO.eval_mode gather) is ported: its tracker
    scores candidates with the exact gather on a float32 track view; the
    config with tsdf_interp trilinear raises ValueError naming gather
    before any volume is built, as the JAX tracker refuses it."""
    from remixfusion_tpu_torch.slam import RemixFusionTorch
    from remixfusion_tpu_torch.tracking import rotracker

    monkeypatch.chdir(ROOT)
    cfg = load_config("configs/Synthetic/corridor_v25g.yaml")
    assert cfg["dataset"] == "synthetic_large"
    monkeypatch.setattr(rotracker.pst_mod, "load_pst", lambda _p, sizes: {
        c: np.zeros((7, 8, 6), np.float32) for c in range(3)})
    tt = rotracker.ROTracker(cfg, 480, 640, np.eye(3, dtype=np.float32),
                             (400, 160, 400), 0.025, (10, 16, 40), "cpu")
    assert (tt.eval_mode, tt.track_dtype) == ("gather", "float32")
    cfg["RO"]["tsdf_interp"] = "trilinear"
    with pytest.raises(ValueError, match="'gather'"):
        RemixFusionTorch(cfg, device="cpu")
