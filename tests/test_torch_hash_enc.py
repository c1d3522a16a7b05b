"""Port parity of the hash-grid encoding (remixfusion_tpu_torch.ops.hash_enc
and models.encodings.HashGridEncoding) against the JAX package on the CPU.

The port computes the f32 table gradient (tiny-cuda-nn's and the JAX
`hash_impl: xla` path's); the TPU Pallas kernel rounds its one-hot matmul
operands to bf16. Both JAX paths run here, the Pallas kernel in interpret
mode as tests/test_hash_pallas.py runs it. On the CPU the port's
hash_table_grad is its plain version (the CUDA kernel is held against that
plain version on the card, tests/test_torch_gpu.py and chip_smoke.py).

Tolerances, relative to the largest entry of the reference gradient:
forward 1e-6 absolute; table gradient 1e-5 of the XLA path (float32 sums
in another order) and 6e-3 of the Pallas path (its bf16 operand rounding,
~0.4% per contribution); d x 1e-5. Corner rows are compared bit for bit,
points include coordinates outside [0, 1] (negative corners wrap through
uint32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from remixfusion_tpu.models.encodings import HashGridEncoding as JHash
from remixfusion_tpu.ops.pallas.hash_enc import corner_indices_weights
from remixfusion_tpu_torch.models.encodings import HashGridEncoding
from remixfusion_tpu_torch.ops import hash_enc as he

torch.set_num_threads(1)

# mixed dense + hashed levels (the test_hash_pallas.py encoder), and a
# 2^16-row hashed level of the bench widths' kind
ENCODERS = {
    "mixed": dict(n_levels=6, level_dim=2, base_resolution=4,
                  log2_hashmap_size=10, desired_resolution=96),
    "hashed_2_16": dict(n_levels=3, level_dim=2, base_resolution=16,
                        log2_hashmap_size=16, desired_resolution=200),
}


def _case(name, n=1500, seed=0):
    kw = ENCODERS[name]
    rng = np.random.default_rng(seed)
    x = rng.uniform(-0.2, 1.2, (n, 3)).astype(np.float32)
    je = JHash(hash_impl="xla", **kw)
    te = HashGridEncoding(**kw)
    table = rng.uniform(-1e-4, 1e-4, (je.table_size, 2)).astype(np.float32)
    g = rng.standard_normal((n, je.out_dim)).astype(np.float32)
    return kw, je, te, x, table, g


@pytest.mark.parametrize("name", list(ENCODERS))
def test_layout_indices_and_forward_match_jax(name):
    kw, je, te, x, table, _ = _case(name)
    assert te.offsets == je.offsets and te.resolutions == je.resolutions
    assert te.hashed == je.hashed and te.table_size == je.table_size
    if name == "hashed_2_16":
        assert any(s == 1 << 16 for s in np.diff(te.offsets))
    assert (x < 0).any() and (x > 1).any()
    # jitted, as in the JAX programs: XLA contracts x * scale + 0.5 into
    # one rounding, which the port reproduces (its trilinear weights are
    # fused differently, so they are held through the forward)
    idx = jax.jit(lambda p: corner_indices_weights(je, p)[0])(
        jnp.asarray(x))
    corner, frac = he.positions(te, torch.from_numpy(x))
    offs = np.asarray(je.offsets[:-1])
    for c, (row, _, _) in enumerate(he.corners(te, corner, frac)):
        np.testing.assert_array_equal(row.numpy(), np.asarray(idx[c]) + offs)
    out_j = np.asarray(je(jnp.asarray(table), jnp.asarray(x)))
    out_t = te(torch.from_numpy(table), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", list(ENCODERS))
def test_table_grad_and_dx_match_jax(name):
    kw, je, te, x, table, g = _case(name, seed=1)
    jp = JHash(hash_impl="pallas", **kw)

    def grads(enc):
        f = jax.jit(jax.grad(
            lambda t, xx: jnp.sum(enc(t, xx) * jnp.asarray(g)),
            argnums=(0, 1)))
        return [np.asarray(a) for a in f(jnp.asarray(table),
                                         jnp.asarray(x))]

    dt_x, dx_x = grads(je)
    dt_p, _ = grads(jp)
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table).requires_grad_(True)
    (te(tt, xt) * torch.from_numpy(g)).sum().backward()
    dt = tt.grad.numpy()
    # the wrapper's CPU path is the plain version
    np.testing.assert_array_equal(
        he.hash_table_grad(te, torch.from_numpy(x), torch.from_numpy(g),
                           te.table_size).numpy(), dt)
    scale = np.abs(dt_x).max()
    assert np.abs(dt - dt_x).max() <= 1e-5 * scale
    assert np.abs(dt - dt_p).max() <= 6e-3 * scale
    untouched = dt_x == 0
    assert untouched.any()
    np.testing.assert_array_equal(dt == 0, untouched)
    assert (dt_p[untouched] == 0).all()
    assert np.abs(xt.grad.numpy() - dx_x).max() <= 1e-5 * np.abs(dx_x).max()


def test_backward_skips_what_needs_no_gradient():
    """Map steps differentiate the table only; BA steps x only."""
    kw, je, te, x, table, g = _case("mixed", n=64, seed=2)
    xt = torch.from_numpy(x)
    tt = torch.from_numpy(table).requires_grad_(True)
    (te(tt, xt) * torch.from_numpy(g)).sum().backward()
    assert tt.grad is not None and xt.grad is None
    xt = torch.from_numpy(x).requires_grad_(True)
    tt = torch.from_numpy(table)
    (te(tt, xt) * torch.from_numpy(g)).sum().backward()
    assert xt.grad is not None and tt.grad is None


def test_hash_table_grad_validates_inputs():
    kw, je, te, x, table, g = _case("mixed", n=8)
    with pytest.raises(ValueError):
        he.hash_table_grad(te, torch.from_numpy(x), torch.from_numpy(g[:4]),
                           te.table_size)
    with pytest.raises(TypeError):
        he.hash_table_grad(te, torch.from_numpy(x).double(),
                           torch.from_numpy(g), te.table_size)


@pytest.mark.parametrize("kw,want", [
    (dict(n_levels=16, base_resolution=16, log2_hashmap_size=16,
          desired_resolution=200), 4096),
    (ENCODERS["mixed"], 64),
    (dict(n_levels=4, base_resolution=20, log2_hashmap_size=16), 8000),
    (dict(n_levels=4, base_resolution=21, log2_hashmap_size=16), 0),
    (dict(n_levels=16, base_resolution=32, log2_hashmap_size=19), 0),
    (dict(n_levels=4, base_resolution=16, log2_hashmap_size=10), 1024)])
def test_privatized_levels_fit_shared_memory(kw, want):
    """The rows the table-gradient kernel accumulates in shared memory:
    level 0's (the table's first rows, dense or hashed) where they fit one
    CTA's share of an H100 SM at 3 CTAs per SM (67,968 B: 8,496 rows), else
    none (4,096 rows, 32,768 B, at the bench widths)."""
    enc = HashGridEncoding(**kw)
    assert he.privatized_rows(enc) == want
    if want:
        assert want == enc.offsets[1]
