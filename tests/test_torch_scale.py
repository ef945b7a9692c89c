"""The port's scale workload (``repro_torch.data.scale``) against the
live JAX package's (``repro.data.scale``) on the CPU: the mixing matrix
bit for bit, a block from the reference's own ``jax.random`` draws within
1e-6, and the generator's contract as ``tests/test_mesh_lanes.py`` holds
the reference's (shape, dtype, determinism and blocking, shared latents,
the width check).  The two packages' streams differ by design (the port
draws from ``torch.Generator``s seeded on the host), so whole arrays are
not compared across packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import scale as jscale
from repro_torch.core import autoencoder as tae
from repro_torch.core import training as ttraining
from repro_torch.data import scale as tscale
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("n_latent,n_features,party",
                         [(8, 16, 0), (8, 16, 7), (4, 6, 1), (5, 3, 2)])
def test_party_mix_matches_reference(n_latent, n_features, party):
    want = np.asarray(jscale._party_mix(n_latent, n_features, party))
    got = tscale._party_mix(n_latent, n_features, party)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("noise", [0.5, 0.0])
def test_party_block_on_the_reference_draws(noise):
    seed, b, party, rows, n_latent, n_features = 3, 2, 1, 512, 8, 16
    kz = jax.random.fold_in(jax.random.PRNGKey(seed), b)
    ke = jax.random.fold_in(kz, party + 1)
    mix = jscale._party_mix(n_latent, n_features, party)
    want = jscale._party_block(kz, ke, mix, n_rows=rows, n_latent=n_latent,
                               n_features=n_features, noise=noise)
    z = np.asarray(jax.random.normal(kz, (rows, n_latent)))
    e = np.asarray(jax.random.normal(ke, (rows, n_features)))
    got = tscale._party_block(torch.as_tensor(z), torch.as_tensor(e),
                              torch.as_tensor(np.asarray(mix)), noise)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_scale_party_shape_dtype_residency():
    x = tscale.make_scale_party(1000, n_features=6, n_latent=4, seed=3,
                                device="cpu")
    assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
    assert tuple(x.shape) == (1000, 6) and x.dtype == torch.float32
    # approximately standardized by construction
    assert abs(float(x.mean())) < 0.1
    assert 0.7 < float(x.std()) < 1.3


def test_scale_party_deterministic_and_blocked():
    kw = dict(n_features=5, block_rows=256, device="cpu")
    a = tscale.make_scale_party(700, seed=1, **kw)
    b = tscale.make_scale_party(700, seed=1, **kw)
    assert torch.equal(a, b)
    c = tscale.make_scale_party(700, seed=2, **kw)
    assert float((a - c).abs().max()) > 0.1
    # a slab is the blocks over it, sliced: the same bits
    for lo, hi in [(0, 350), (350, 700), (200, 600), (256, 512)]:
        assert torch.equal(tscale.make_scale_party(
            700, seed=1, rows=(lo, hi), **kw), a[lo:hi])


def test_scale_parties_share_latents():
    """With zero noise, party p's feature j and party p+1's feature j-1
    read the same latent mix: one shared z per row."""
    kw = dict(n_features=4, n_latent=4, noise=0.0, seed=5, device="cpu")
    p0 = tscale.make_scale_party(300, party=0, **kw)
    p1 = tscale.make_scale_party(300, party=1, **kw)
    np.testing.assert_allclose(p0[:, 1].numpy(), p1[:, 0].numpy(),
                               rtol=1e-6)
    assert float((p0 - p1).abs().max()) > 0.1


def test_scale_lanes_shapes_and_training():
    lanes = tscale.make_scale_lanes(512, 2, n_features=6, widths=[6, 8, 4],
                                    seeds=(0, 1), device="cpu")
    assert len(lanes) == 4
    assert all(tuple(lane.data["x"].shape) == (512, 6) for lane in lanes)
    assert [lane.seed for lane in lanes] == [0, 1, 100, 101]
    assert tscale.lane_bytes(lanes) == 4 * 512 * 6 * 4
    rs = ttraining.train_lanes(lanes, tae.make_masked_recon_loss(True),
                               batch_size=128, max_epochs=2, patience=2)
    assert len(rs) == 4
    for r in rs:
        assert r.epochs_run >= 1 and np.isfinite(r.train_loss).all()


def test_scale_lanes_take_init_params_as_arrays():
    from repro.core import autoencoder as jae
    inits = [jax.tree.map(np.asarray, jae.init_autoencoder(
        jax.random.fold_in(jax.random.PRNGKey(7001), p), [6, 8, 4]))
        for p in range(2)]
    lanes = tscale.make_scale_lanes(64, 2, n_features=6, widths=[6, 8, 4],
                                    init_params=inits, device="cpu")
    for lane, want in zip(lanes, inits):
        for a, b in zip(tree_leaves(lane.params),
                        jax.tree.leaves(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_scale_lanes_width_mismatch_rejected():
    with pytest.raises(ValueError, match="must equal n_features"):
        tscale.make_scale_lanes(64, 2, n_features=6, widths=[5, 8, 4],
                                device="cpu")


def test_reference_widths_default():
    lanes = tscale.make_scale_lanes(64, 1, n_features=16, device="cpu")
    enc = lanes[0].params["enc"]
    assert tuple(enc["w0"].shape) == (16, 32)
    assert tuple(enc["w1"].shape) == (32, 64)
    jl = jscale.make_scale_lanes(64, 1, n_features=16)
    assert [tuple(np.shape(x)) for x in tree_leaves(lanes[0].params)] == \
        [tuple(np.shape(x)) for x in _jax_leaves_in_port_order(jl[0].params)]


def _jax_leaves_in_port_order(tree):
    if isinstance(tree, dict):
        return [x for k in tree for x in _jax_leaves_in_port_order(tree[k])]
    return [jnp.asarray(tree)]
