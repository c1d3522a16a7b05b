"""Carry state across from the JAX package to the port, and back.

The JAX package's state goes across as numpy arrays:
  - the brick-major local volume (VolumeState: tsdf, weight, color, origin);
  - the scene model: SceneParams (hash_table — one [T, F] table, the
    CPGrid or Triplane dict of tables, or None for a parameter-free
    encoding —, decoder {sdf_net, color_net: {w<i>}},
    rba {w<i>, b<i>}) and SceneBuffers (gbv, gbw, rba: init_c2w, init_r,
    init_t, and the bf16 query mirror gbq or None). JAX stores a layer's
    weight [in, out] (h @ w), nn.Linear [out, in], so weights are
    transposed on the way. The mirror does not go across as rows: the port
    scene gets one, rounded from the converted gbv, exactly when the
    buffers carry one.
The PST tables are regenerated bitwise from their seeds and the config is
shared, so neither needs converting.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from remixfusion_tpu_torch.models.scene_rep import SceneRepresentation
from remixfusion_tpu_torch.ops.tsdf import VolumeState


def volume_state_from_numpy(tsdf, weight, color, origin,
                            device) -> VolumeState:
    """JAX VolumeState arrays (tsdf [NB, b^3], weight [NB, b^3], color
    [NB, b^3, 3], origin [3]) -> the port's VolumeState on `device`."""
    def t(a, ndim):
        a = np.asarray(a, np.float32)
        if a.ndim != ndim:
            raise ValueError(f"expected a {ndim}-d array, got {a.shape}")
        return torch.tensor(a, device=device)

    out = VolumeState(t(tsdf, 2), t(weight, 2), t(color, 3), t(origin, 1))
    if out.weight.shape != out.tsdf.shape \
            or out.color.shape != out.tsdf.shape + (3,) \
            or out.origin.shape != (3,):
        raise ValueError("inconsistent volume state shapes")
    return out


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _get_opt(obj, name):
    return (obj.get(name) if isinstance(obj, Mapping)
            else getattr(obj, name, None))


@torch.no_grad()
def _copy(dst: torch.Tensor, src, transpose: bool = False):
    a = np.asarray(src, np.float32)
    if transpose:
        a = a.T
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"shape {a.shape} does not fit {tuple(dst.shape)}")
    dst.copy_(torch.tensor(a))


def _mlp_from(mlp, d):
    for i, lin in enumerate(mlp.layers):
        _copy(lin.weight, d[f"w{i}"], transpose=True)
        if lin.bias is not None:
            _copy(lin.bias, d[f"b{i}"])


def _mlp_to(mlp):
    out = {}
    for i, lin in enumerate(mlp.layers):
        out[f"w{i}"] = lin.weight.detach().cpu().numpy().T.copy()
        if lin.bias is not None:
            out[f"b{i}"] = lin.bias.detach().cpu().numpy().copy()
    return out


def load_scene_numpy(scene: SceneRepresentation, params, buffers):
    """Copy JAX SceneParams / SceneBuffers (numpy arrays, as NamedTuples
    or dicts) into a port scene of the same configuration. The scene holds
    a bf16 query mirror, rounded from gbv, exactly when the buffers' gbq is
    not None (JAX's oct-packed rows or scene_to_numpy's marker; only its
    presence is read)."""
    table = _get(params, "hash_table")
    if scene.hash_table is None or table is None:
        if scene.hash_table is not None or table is not None:
            raise ValueError("one side's encoding has no table")
    elif isinstance(scene.hash_table, torch.nn.ParameterDict):
        if set(table) != set(scene.hash_table):
            raise ValueError("the encoding's tables do not match")
        for k, p in scene.hash_table.items():
            _copy(p, table[k])
    else:
        _copy(scene.hash_table, table)
    dec = _get(params, "decoder")
    _mlp_from(scene.decoder_res.sdf_net, dec["sdf_net"])
    _mlp_from(scene.decoder_res.color_net, dec["color_net"])
    _mlp_from(scene.rba.mlp, _get(params, "rba"))
    _copy(scene.gbv, _get(buffers, "gbv"))
    _copy(scene.gbw, _get(buffers, "gbw"))
    if _get_opt(buffers, "gbq") is None:
        scene.gbq = None
    else:
        scene.refresh_gbq()
    rb = _get(buffers, "rba")
    for name in ("init_c2w", "init_r", "init_t"):
        _copy(getattr(scene.rba, name), _get(rb, name))
    return scene


def scene_from_numpy(config, bound, num_kf: int, params, buffers,
                     device="cpu") -> SceneRepresentation:
    """The port's scene model on `device` holding the JAX SceneParams /
    SceneBuffers (as numpy)."""
    scene = SceneRepresentation(config, bound, num_kf, device=device)
    return load_scene_numpy(scene, params, buffers)


def scene_to_numpy(scene: SceneRepresentation):
    """(params, buffers) as dicts of numpy arrays in the JAX layout (gbv
    and gbw None for a scene that holds no grid); buffers' gbq is True
    when the scene holds a bf16 query mirror, else None: a marker, as the
    mirror is gbv's rounding and load_scene_numpy rounds it anew."""
    if scene.hash_table is None:
        table = None
    elif isinstance(scene.hash_table, torch.nn.ParameterDict):
        table = {k: p.detach().cpu().numpy().copy()
                 for k, p in scene.hash_table.items()}
    else:
        table = scene.hash_table.detach().cpu().numpy().copy()
    params = {"hash_table": table,
              "decoder": {"sdf_net": _mlp_to(scene.decoder_res.sdf_net),
                          "color_net": _mlp_to(scene.decoder_res.color_net)},
              "rba": _mlp_to(scene.rba.mlp)}
    grid = scene.gbv is not None
    buffers = {"gbv": scene.gbv.cpu().numpy().copy() if grid else None,
               "gbw": scene.gbw.cpu().numpy().copy() if grid else None,
               "gbq": None if scene.gbq is None else True,
               "rba": {n: getattr(scene.rba, n).cpu().numpy().copy()
                       for n in ("init_c2w", "init_r", "init_t")}}
    return params, buffers
