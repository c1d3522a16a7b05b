"""Port parity of the scene model: decoders, RBA, the encoders, the scene
queries, rendering and the mapping losses (remixfusion_tpu_torch.models)
against the JAX package on the CPU, on tests/helpers.tiny_config sizes.

The JAX model's parameters and buffers go across as numpy
(utils/convert.scene_from_numpy). jax.random draws cannot be replayed in
torch, so the JAX side's uniform draws are computed from its keys here and
handed to the port's draw arguments. The JAX buffers carry no bf16 query
mirror (gbq=None): both packages then read the float32 grid; the render
and loss case also runs with JAX's default buffers, mirror included, and a
port scene converted from them (holding its own mirror).

Tolerances: forwards within 1e-5 (float32, different summation orders in
the small matmuls); losses at rtol 1e-4; gradients within 1e-3 of the
largest gradient entry of the same tensor."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_config
from remixfusion_tpu.core import pose as jpose
from remixfusion_tpu.datasets import get_dataset
from remixfusion_tpu.mapping.mapper import Mapper as JMapper
from remixfusion_tpu.models import encodings as jenc
from remixfusion_tpu.models.scene_rep import SceneRepresentation as JScene
from remixfusion_tpu_torch.core import pose as tpose
from remixfusion_tpu_torch.models import encodings as tenc
from remixfusion_tpu_torch.utils.convert import scene_from_numpy, \
    scene_to_numpy

torch.set_num_threads(1)
NUM_KF = 8


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


_BUILT = {}


def build(enc="HashGrid", n_frames=3, mirror=False):
    """A JAX scene with a few keyframes fused into its grid (built once per
    module), with its bf16 query mirror or without (mirror), and a fresh
    port copy of it."""
    if (enc, n_frames) not in _BUILT:
        _BUILT[enc, n_frames] = _build_jax(enc, n_frames)
    cfg, ds, js, params, buffers = _BUILT[enc, n_frames]
    if not mirror:
        buffers = buffers._replace(gbq=None)
    ts = scene_from_numpy(cfg, np.asarray(cfg["mapping"]["bound"]), NUM_KF,
                          _np_tree(params), _np_tree(buffers))
    return cfg, ds, js, params, buffers, ts


def _build_jax(enc, n_frames):
    cfg = tiny_config(grid={"enc": enc})
    ds = get_dataset(cfg)
    bound = np.asarray(cfg["mapping"]["bound"], np.float32)
    js = JScene(cfg, bound, NUM_KF)
    params, buffers = js.init(jax.random.PRNGKey(0))
    jm = JMapper(cfg, js, params)
    K = jnp.asarray(ds.K())
    for i in range(n_frames):
        f = ds[2 * i]
        buffers = jm.integrate_keyframe(
            buffers, jnp.asarray(f["depth"]), jnp.asarray(f["rgb"]), K,
            jnp.asarray(f["c2w"]), bound)
    for k in range(3):
        buffers = buffers._replace(rba=js.rba.update_init_pose(
            buffers.rba, k, jnp.asarray(ds[2 * k]["c2w"])))
    buffers = buffers._replace(gbv_tm=None, gbw_tm=None)
    return cfg, ds, js, params, buffers


def frame_rays(ds, frame, n, seed):
    rng = np.random.default_rng(seed)
    f = ds[frame]
    idx = rng.choice(ds.H * ds.W, n, replace=False)
    rays = np.concatenate(
        [f["direction"].reshape(-1, 3)[idx], f["rgb"].reshape(-1, 3)[idx],
         f["depth"].reshape(-1)[idx, None]], -1).astype(np.float32)
    c2w = np.asarray(f["c2w"], np.float32)
    rays_d = (rays[:, :3] @ c2w[:3, :3].T).astype(np.float32)
    rays_o = np.broadcast_to(c2w[:3, 3], rays_d.shape).astype(np.float32)
    return rays, rays_o, rays_d


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def close_scaled(a, b, frac):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(a).max(), 1e-12)
    assert np.abs(a - b).max() <= frac * scale, (np.abs(a - b).max(), scale)


def test_pose_maps_match_jax():
    rng = np.random.default_rng(0)
    aa = rng.normal(size=(64, 3)).astype(np.float32)
    aa[0] = 0.0
    R_j = np.asarray(jax.jit(jpose.axis_angle_to_matrix)(jnp.asarray(aa)))
    R_t = tpose.axis_angle_to_matrix(t(aa)).numpy()
    np.testing.assert_allclose(R_t, R_j, atol=1e-6)
    np.testing.assert_allclose(
        tpose.matrix_to_axis_angle(t(R_j)).numpy(),
        np.asarray(jax.jit(jpose.matrix_to_axis_angle)(jnp.asarray(R_j))),
        atol=2e-6)
    tr = rng.normal(size=(64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tpose.at_to_c2w(t(aa), t(tr)).numpy(),
        np.asarray(jax.jit(jpose.at_to_c2w)(jnp.asarray(aa),
                                            jnp.asarray(tr))),
        atol=1e-6)


def test_decoder_rba_oneblob_match_jax():
    cfg, ds, js, params, buffers, ts = build(n_frames=1)
    rng = np.random.default_rng(1)
    n = 200
    emb = rng.normal(size=(n, js.input_ch)).astype(np.float32)
    pos = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    ex = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    epos_j = np.asarray(jax.jit(lambda p: js.embedpos_fn(None, p))(
        jnp.asarray(pos)))
    epos_t = ts.embedpos_fn(None, t(pos)).numpy()
    np.testing.assert_allclose(epos_t, epos_j, atol=1e-5)
    # decoders with weights large enough to matter (the zero-init output
    # layers would hide a mismatch)
    dec = jax.tree_util.tree_map(
        lambda w: w * 1e3 if w.shape[-1] <= 16 else w, params.decoder)
    params = params._replace(decoder=dec)
    ts = scene_from_numpy(cfg, np.asarray(cfg["mapping"]["bound"]), NUM_KF,
                          _np_tree(params), _np_tree(buffers))
    out_j = np.asarray(jax.jit(js.decoder_res)(
        params.decoder, jnp.asarray(emb), jnp.asarray(epos_j),
        jnp.asarray(ex[:, :1]), jnp.asarray(ex[:, 1:])))
    with torch.no_grad():
        out_t = ts.decoder_res(t(emb), t(epos_j), t(ex[:, :1]),
                               t(ex[:, 1:])).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    # RBA with weights of a trained scale
    rba = {k: np.asarray(v) * (1e3 if k.startswith("w") else 1e2)
           for k, v in params.rba.items()}
    ts = scene_from_numpy(cfg, np.asarray(cfg["mapping"]["bound"]), NUM_KF,
                          _np_tree(params._replace(rba=rba)),
                          _np_tree(buffers))
    ids = np.arange(NUM_KF)
    P_j = np.asarray(jax.jit(js.rba)(
        jax.tree_util.tree_map(jnp.asarray, rba), buffers.rba,
        jnp.asarray(ids)))
    with torch.no_grad():
        P_t = ts.rba(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(P_t, P_j, atol=1e-5)
    np.testing.assert_allclose(P_t[0], np.asarray(buffers.rba.init_c2w[0]),
                               atol=1e-6)


def test_cpgrid_matches_jax():
    je = jenc.CPGridEncoding(n_levels=4, base_resolution=48,
                             desired_resolution=200)
    te = tenc.CPGridEncoding(4, 48, 200)
    assert te.resolutions == je.resolutions and te.channels == je.channels
    pj = je.init(jax.random.PRNGKey(0))
    pt = {k: torch.tensor(np.asarray(v), requires_grad=True)
          for k, v in pj.items()}
    rng = np.random.default_rng(2)
    x = rng.uniform(-0.1, 1.1, (3000, 3)).astype(np.float32)
    g = rng.normal(size=(3000, je.out_dim)).astype(np.float32)
    out_j, gj = jax.jit(lambda p: (
        je(p, jnp.asarray(x)),
        jax.vjp(lambda q: je(q, jnp.asarray(x)), p)[1](jnp.asarray(g))[0]))(
            pj)
    xt = t(x)
    out_t = te(pt, xt)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    (out_t * t(g)).sum().backward()
    for k in pj:
        # both round the table cotangent to bf16 once; sums in another
        # order may round one entry to the neighbouring bf16 value
        close_scaled(np.asarray(gj[k]), pt[k].grad.numpy(), 1e-2)


def test_scene_queries_match_jax():
    cfg, ds, js, params, buffers, ts = build()
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.05, 1.05, (500, 3)).astype(np.float32)
    ref = [np.asarray(a) for a in jax.jit(lambda p: (
        js.query_gbv(buffers.gbv, p), js.query_gbw(buffers.gbw, p),
        js.query_sdf_res(params, buffers, p),
        js.query_color_sdf(params, buffers, p),
        js.query_color_sdf(params, buffers, p, clamp=True)))(
            jnp.asarray(pts))]
    with torch.no_grad():
        np.testing.assert_allclose(ts.query_gbv(t(pts)).numpy(), ref[0],
                                   atol=1e-6)
        np.testing.assert_allclose(ts.query_gbw(t(pts)).numpy(), ref[1],
                                   atol=1e-5)
        np.testing.assert_allclose(ts.query_sdf_res(t(pts)).numpy(), ref[2],
                                   atol=1e-5)
        for i, clamp in ((3, False), (4, True)):
            np.testing.assert_allclose(
                ts.query_color_sdf(t(pts), clamp=clamp).numpy(), ref[i],
                atol=1e-5)


@pytest.mark.parametrize("mirror", [False, True], ids=["f32", "gbq"])
@pytest.mark.parametrize("clamp", [False, True])
def test_render_and_losses_match_jax(clamp, mirror):
    cfg, ds, js, params, buffers, ts = build(mirror=mirror)
    assert (ts.gbq is None) == (buffers.gbq is None) == (not mirror)
    rays, ro, rd = frame_rays(ds, 2, 96, 4)
    key = jax.random.PRNGKey(5)
    S = cfg["training"]["n_range_d"] + cfg["training"]["n_samples_d"]
    u = np.asarray(jax.random.uniform(key, (96, S)))

    def jloss(p, o, d):
        ret = js.mapping_losses(p, buffers, key, o, d,
                                jnp.asarray(rays[:, 3:6]),
                                jnp.asarray(rays[:, 6:7]), clamp=clamp)
        return sum(ret[k] * w for k, w in zip(
            ("rgb_res_loss", "depth_res_loss", "sdf_res_loss",
             "fs_res_loss"), (5.0, 0.1, 1000.0, 10.0))), ret

    (lj, retj), gj = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(ro), jnp.asarray(rd))
    ro_t, rd_t = t(ro).requires_grad_(True), t(rd).requires_grad_(True)
    ret = ts.mapping_losses(ro_t, rd_t, t(rays[:, 3:6]), t(rays[:, 6:7]),
                            clamp=clamp, u=t(u))
    for k in ("rgb_res_loss", "depth_res_loss", "sdf_res_loss",
              "fs_res_loss"):
        np.testing.assert_allclose(float(ret[k].detach()), float(retj[k]),
                                   rtol=1e-4,
                                   atol=1e-9)
    np.testing.assert_allclose(ret["depth_res"].detach().numpy(),
                               np.asarray(retj["depth_res"]), atol=1e-4)
    loss = sum(ret[k] * w for k, w in zip(
        ("rgb_res_loss", "depth_res_loss", "sdf_res_loss", "fs_res_loss"),
        (5.0, 0.1, 1000.0, 10.0)))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-4)
    close_scaled(np.asarray(gj[0].hash_table), ts.hash_table.grad.numpy(),
                 1e-3)
    for net in ("sdf_net", "color_net"):
        mlp = getattr(ts.decoder_res, net)
        for i, lin in enumerate(mlp.layers):
            close_scaled(np.asarray(gj[0].decoder[net][f"w{i}"]).T,
                         lin.weight.grad.numpy(), 1e-3)
    close_scaled(np.asarray(gj[1]), ro_t.grad.numpy(), 1e-3)
    close_scaled(np.asarray(gj[2]), rd_t.grad.numpy(), 1e-3)


def test_smoothness_matches_jax():
    cfg, ds, js, params, buffers, ts = build(n_frames=1)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    u = (t(jax.random.uniform(k1, (3,))),
         t(np.asarray(jax.random.uniform(k2, (1, 1, 1, 3))).reshape(3)))
    tr = cfg["training"]
    args = (tr["smooth_pts"], tr["smooth_vox"], tr["smooth_margin"])
    tab = np.asarray(jax.random.normal(key, params.hash_table.shape)) * 0.1
    params = params._replace(hash_table=jnp.asarray(tab))
    sj, gj = jax.jit(jax.value_and_grad(
        lambda p: js.smoothness(p, buffers, key, *args)))(params)
    with torch.no_grad():
        ts.hash_table.copy_(t(tab))
    st = ts.smoothness(*args, u=u)
    st.backward()
    np.testing.assert_allclose(float(st.detach()), float(sj), rtol=1e-4)
    close_scaled(np.asarray(gj.hash_table), ts.hash_table.grad.numpy(), 1e-3)


@pytest.mark.parametrize("enc", ["HashGrid", "CPGrid"])
def test_converter_round_trips(enc):
    cfg, ds, js, params, buffers, ts = build(enc=enc, n_frames=1)
    p2, b2 = scene_to_numpy(ts)
    jp, jb = _np_tree(params), _np_tree(buffers)
    for name in ("hash_table", "decoder", "rba"):
        la = jax.tree_util.tree_leaves(getattr(jp, name))
        lb = jax.tree_util.tree_leaves(p2[name])
        assert len(la) == len(lb) > 0
        for a, b in zip(la, lb):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(b2["gbv"], jb.gbv)
    np.testing.assert_array_equal(b2["gbw"], jb.gbw)
    for n in ("init_c2w", "init_r", "init_t"):
        np.testing.assert_array_equal(b2["rba"][n], getattr(jb.rba, n))
