"""The port's scripts in scripts/torch/: the shell scripts parse, name only
the port (remixfusion_tpu_torch, run_torch.py, rendering_eval_torch.py),
and every module or script they run exists and accepts every flag they
pass; eval_ate.sh and mesh_eval.sh run on a tiny port run's files; and
scripts/torch/ab_eval.py prints the line scripts/ab_eval.py prints on the
same run directory (both sample with seed 0; tests/test_torch_mesh.py
holds the marching and the sampling bitwise)."""

import glob
import io
import os
import re
import runpy
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch
import yaml

from helpers import tiny_config
from remixfusion_tpu_torch.slam import RemixFusionTorch
from remixfusion_tpu_torch.tools.eval_ate import evaluate_ate
from torch_env import child_env

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TORCH_SCRIPTS = os.path.join(ROOT, "scripts", "torch")
SHELL = sorted(os.path.basename(p)
               for p in glob.glob(os.path.join(TORCH_SCRIPTS, "*.sh")))
ORIGINALS = ("run_real.sh", "eval_ate.sh", "mesh_eval.sh",
             "mesh_cull_est.sh", "mesh_cull_gt.sh", "rendering.sh")
_HELP = {}


def _env():
    return child_env(PYTHONPATH=ROOT)


def _commands(text):
    """(module or script, [flags]) of every python command of a script:
    comments dropped, continuation lines joined, NAME=(...) arrays
    expanded where "${NAME[@]}" is passed."""
    text = "\n".join(ln for ln in text.splitlines()
                     if not ln.lstrip().startswith("#"))
    text = re.sub(r"\\\n\s*", " ", text)
    for name, body in re.findall(r"(\w+)=\(([^)]*)\)", text):
        text = text.replace(f'"${{{name}[@]}}"', body)
    for m in re.finditer(r"\bpython3? +(?:-u +)?(?:-m +(\S+)|(\S+\.py))"
                         r"([^\n]*)", text):
        target = m.group(1) or m.group(2).strip('"').split("/")[-1]
        yield target, re.findall(r"(?<![\w-])--[A-Za-z_]+", m.group(3))


def _help(target):
    """--help of a module (python -m) or a root script, run once."""
    if target not in _HELP:
        argv = (["-m", target] if not target.endswith(".py")
                else [os.path.join(ROOT, target)])
        out = subprocess.run([sys.executable, *argv, "--help"], cwd=ROOT,
                             env=_env(), capture_output=True, text=True,
                             timeout=120)
        assert out.returncode == 0, (target, out.stderr[-2000:])
        _HELP[target] = out.stdout
    return _HELP[target]


def test_every_original_script_has_a_port():
    assert sorted(ORIGINALS) == SHELL
    assert os.path.exists(os.path.join(TORCH_SCRIPTS, "ab_eval.py"))


@pytest.mark.parametrize("name", SHELL)
def test_shell_script_parses(name):
    out = subprocess.run(["bash", "-n", os.path.join(TORCH_SCRIPTS, name)],
                         capture_output=True, text=True, timeout=30)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("name", SHELL)
def test_script_names_only_the_port(name):
    with open(os.path.join(TORCH_SCRIPTS, name)) as f:
        text = f.read()
    assert not re.search(r"remixfusion_tpu(?!_torch)", text), name
    assert not re.search(r"(?<![\w/])(run|rendering_eval)\.py", text), name
    assert not re.search(r"import yaml", text), name  # the port's loader
    targets = [t for t, _ in _commands(text)]
    assert targets, name
    for t in targets:
        assert (t.startswith("remixfusion_tpu_torch.")
                or t in ("run_torch.py", "rendering_eval_torch.py")), t


@pytest.mark.parametrize("name", SHELL)
def test_script_flags_exist_in_the_port_tools(name):
    """Every module a script runs exists, and its argparse names every
    flag the script passes (an unknown flag would make argparse exit 2
    under set -e)."""
    with open(os.path.join(TORCH_SCRIPTS, name)) as f:
        commands = list(_commands(f.read()))
    for target, flags in commands:
        text = _help(target)
        for flag in flags:
            assert re.search(rf"(?<![\w-]){flag}\b", text), (name, target,
                                                             flag)


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A whole tiny port run (12 frames) written as run_torch.py writes
    it, its config as a YAML file and the GT poses."""
    tmp = tmp_path_factory.mktemp("scripts")
    cfg = tiny_config(data={"output": str(tmp), "exp_name": "ab"})
    cfg_path = tmp / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg, default_flow_style=None))
    slam = RemixFusionTorch(cfg, device="cpu")
    slam.run()
    run_dir = tmp / "ab"
    np.save(run_dir / "gt_poses.npy", slam.pose_gt)
    return {"cfg": str(cfg_path), "dir": run_dir}


def _run_script(name, *args):
    out = subprocess.run(["bash", os.path.join(TORCH_SCRIPTS, name),
                          *map(str, args)], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, (name, out.stderr[-4000:])
    return out.stdout


def test_eval_ate_sh_on_a_port_run(port_run):
    d = port_run["dir"]
    out = _run_script("eval_ate.sh", d / "all_poses.npy", d / "gt_poses.npy")
    est, gt = np.load(d / "all_poses.npy"), np.load(d / "gt_poses.npy")
    ref = evaluate_ate({float(i): gt[i] for i in range(len(est))},
                       {float(i): est[i] for i in range(len(est))})
    line = next(ln for ln in out.splitlines() if ln.startswith("rmse:"))
    assert line == f"rmse: {ref['rmse'] * 100} cm"


def test_mesh_eval_sh_on_a_port_run(port_run):
    """The culled mesh scored against the run's uncut mesh, which holds
    it: every reconstructed sample lies on the reference (the tool's 200k
    samples, ICP and 3 seeds; a tiny run's mesh against the analytic GT
    leaves most samples far from it, where each KD-tree query is slow)."""
    d = port_run["dir"]
    out = _run_script("mesh_eval.sh", d / "mesh_cull_occlusion.ply",
                      d / "mesh.ply", 0.05)
    vals = {k: float(v) for k, v in (ln.split(": ") for ln in
                                     out.splitlines() if ": " in ln)}
    assert set(vals) == {"accuracy_cm", "completion_cm",
                         "accuracy_ratio_pct", "completion_ratio_pct", "f1"}
    assert all(np.isfinite(v) for v in vals.values())
    assert vals["accuracy_ratio_pct"] > 99.0 and vals["accuracy_cm"] < 1.0
    assert vals["completion_cm"] > vals["accuracy_cm"]
    assert 0.0 < vals["f1"] <= 1.0


def _main_output(path, cfg_path):
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(path)["main"](cfg_path)
    return [ln for ln in buf.getvalue().splitlines()
            if not ln.startswith("Mesh is saved")]


def test_ab_eval_prints_the_jax_line(port_run):
    """scripts/torch/ab_eval.py and scripts/ab_eval.py on the same port
    run: the same acc / comp / ratios / F1 / ATE digits."""
    cfg = port_run["cfg"]
    got = _main_output(os.path.join(TORCH_SCRIPTS, "ab_eval.py"), cfg)
    ref = _main_output(os.path.join(ROOT, "scripts", "ab_eval.py"), cfg)
    assert len(got) == 1 and got == ref, (got, ref)
    assert got[0].startswith("ab: ate_rmse_cm=")
