"""The map and BA steps around their CUDA-graph bodies, on the CPU, where
the bodies run eagerly (tests/test_torch_gpu.py holds the replays against
eager runs on a card):

  - no step is served by replays on the CPU (`Mapper.graph_hit` all 0);
  - a step that draws from its generator gives exactly the losses of the
    same step fed the same numbers through `draws`, drawn in the order the
    graphed bodies keep: the sampler's g_idx and c_idx, z_u [N, S], then
    the smoothness offset and jitter;
  - every step calls map_loss / ba_loss, _step and the scene's
    mapping_losses and smoothness once, through the instance, with
    draw=None: the attributes a caller may wrap."""

import copy

import pytest
import torch

from helpers import map_round_state

torch.set_num_threads(1)


def _round_inputs(inputs, ba=False):
    args = {k: v for k, v in inputs.items() if k != "n_cur"}
    if ba:
        del args["kf_poses"]
    return args


def _draws(mapper, inputs, n_cur, n_iters, gen, smooth):
    """The draws of n_iters steps, in the generator order of the steps."""
    scene = mapper.scene
    store = inputs["kf_store"]
    n_rays = inputs["dirs_flat"].shape[0]
    out = []
    for _ in range(n_iters):
        d = {"g_idx": torch.randint(0, inputs["n_kf"] * store.R,
                                    (mapper.sample,), generator=gen),
             "c_idx": torch.randint(0, n_rays, (n_cur,), generator=gen)}
        d["z_u"] = torch.rand(scene.z_vals_shape(mapper.sample + n_cur),
                              generator=gen)
        if smooth:
            d["smooth_u"] = scene.smoothness_draws(gen)
        out.append(d)
    return out


@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_steps_run_eagerly_on_cpu(enc):
    mapper, inputs = map_round_state(enc, "cpu")
    gen = torch.Generator().manual_seed(5)
    n_cur = inputs["n_cur"][0]
    mapper.map_step_dev(**_round_inputs(inputs), n_iters=2, n_cur=n_cur,
                        generator=gen)
    mapper.ba_step_dev(**_round_inputs(inputs, ba=True), n_iters=2,
                       n_cur=n_cur, generator=gen)
    assert mapper.graph_hit == [0, 0, 0, 0]
    counts = mapper.scene.graphs
    assert (counts.calls, counts.replays) == (6, 0)


@pytest.mark.parametrize("enc", ["CPGrid", "HashGrid"])
def test_generator_steps_match_fed_draws(enc):
    base, inputs = map_round_state(enc, "cpu")
    drawn, fed = copy.deepcopy(base), copy.deepcopy(base)
    for n_cur in inputs["n_cur"]:
        seed = 1000 + n_cur
        gen = torch.Generator().manual_seed(seed)
        want = drawn.map_step_dev(**_round_inputs(inputs), n_iters=3,
                                  n_cur=n_cur, generator=gen)
        want_ba, _ = drawn.ba_step_dev(**_round_inputs(inputs, ba=True),
                                       n_iters=3, n_cur=n_cur,
                                       generator=gen)
        gen = torch.Generator().manual_seed(seed)
        got = fed.map_step_dev(
            **_round_inputs(inputs), n_iters=3, n_cur=n_cur,
            draws=_draws(fed, inputs, n_cur, 3, gen, True))
        got_ba, _ = fed.ba_step_dev(
            **_round_inputs(inputs, ba=True), n_iters=3, n_cur=n_cur,
            draws=_draws(fed, inputs, n_cur, 3, gen, False))
        assert torch.equal(got, want)
        assert torch.equal(got_ba, want_ba)


def test_steps_call_their_hooks_through_the_instance():
    mapper, inputs = map_round_state("CPGrid", "cpu")
    scene = mapper.scene
    calls = []

    def wrap(obj, name, draw_at=None):
        orig = getattr(obj, name)

        def hook(*a, **k):
            if draw_at is not None:
                draw = a[draw_at] if len(a) > draw_at else k.get("draw")
                assert draw is None
            calls.append(name)
            return orig(*a, **k)

        setattr(obj, name, hook)

    wrap(mapper, "map_loss", draw_at=3)
    wrap(mapper, "ba_loss", draw_at=2)
    wrap(mapper, "_step")
    wrap(scene, "mapping_losses")
    wrap(scene, "smoothness")
    gen = torch.Generator().manual_seed(9)
    n_cur = inputs["n_cur"][1]
    mapper.map_step_dev(**_round_inputs(inputs), n_iters=3, n_cur=n_cur,
                        generator=gen)
    assert calls == ["map_loss", "mapping_losses", "smoothness",
                     "_step"] * 3
    calls.clear()
    mapper.ba_step_dev(**_round_inputs(inputs, ba=True), n_iters=3,
                       n_cur=n_cur, generator=gen)
    assert calls == ["ba_loss", "mapping_losses", "_step"] * 3
