"""How far the JAX mapper's bf16 query mirror moves its map-step loss.

    JAX_PLATFORMS=cpu python scripts/gbq_loss_gap.py

The JAX hot path reads the explicit global grid through `gbq`, a bf16
mirror laid out for the TPU (scene_rep.query_gbvw_fast); its cold paths and
the reference read the float32 grid (query_gbv). The PyTorch port reads
the mirror's values on the same hot path (models/scene_rep.query_gbq).
This script measures what the mirror's rounding is worth on one tiny
mapping round (tests/helpers.tiny_config: three keyframes fused into the
48^3 grid, one map-step batch of 128 + n_cur rays with fixed draws): the
weighted map loss and its parts through the mirror and through the float32
grid, and their relative gaps: what a read of the float32 grid on the hot
path would cost against the JAX package (the port's own cases are the
[gbq] tests, tests/test_torch_gbq.py and the lockstep tests). CPU only;
imports the JAX package alone.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

from helpers import tiny_config  # noqa: E402
from remixfusion_tpu.datasets import get_dataset  # noqa: E402
from remixfusion_tpu.mapping.mapper import Mapper  # noqa: E402
from remixfusion_tpu.models.scene_rep import SceneRepresentation  # noqa: E402

PARTS = ("rgb_res_loss", "depth_res_loss", "sdf_res_loss", "fs_res_loss")


def main():
    jax.config.update("jax_platforms", "cpu")
    cfg = tiny_config()
    ds = get_dataset(cfg)
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    scene = SceneRepresentation(cfg, bound, 8)
    params, buffers = scene.init(jax.random.PRNGKey(0))
    mapper = Mapper(cfg, scene, params)
    K = jnp.asarray(ds.K())
    for i in (0, 2, 4):
        f = ds[i]
        buffers = mapper.integrate_keyframe(
            buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]), K,
            jnp.asarray(f["c2w"]), bound)
    assert buffers.gbq is not None
    f = ds[4]
    rng = np.random.default_rng(0)
    n = cfg["mapping"]["sample"] + mapper.current_ray_budget(2)
    idx = rng.integers(0, ds.H * ds.W, n)
    rays = np.concatenate(
        [f["direction"].reshape(-1, 3)[idx], f["rgb"].reshape(-1, 3)[idx],
         f["depth"].reshape(-1)[idx, None]], -1).astype(np.float32)
    ro, rd = Mapper.rays_to_world_np(
        rays, np.tile(np.asarray(f["c2w"], np.float32)[None], (n, 1, 1)))
    key = jax.random.PRNGKey(1)

    @jax.jit
    def loss(b):
        ret = scene.mapping_losses(params, b, key, jnp.asarray(ro),
                                   jnp.asarray(rd), jnp.asarray(rays[:, 3:6]),
                                   jnp.asarray(rays[:, 6:7]))
        total = mapper._weighted_loss(ret, True, params, b, key)
        return total, {k: ret[k] for k in PARTS}

    (lq, pq), (lf, pf) = loss(buffers), loss(buffers._replace(gbq=None))
    print(f"map loss: bf16 mirror {float(lq):.8g}  float32 grid "
          f"{float(lf):.8g}  relative gap {abs(float(lq) / float(lf) - 1):.3e}")
    for k in PARTS:
        a, b = float(pq[k]), float(pf[k])
        print(f"  {k}: {a:.8g} vs {b:.8g}  relative gap "
              f"{abs(a / b - 1) if b else 0.0:.3e}")


if __name__ == "__main__":
    main()
