"""The plain reference against the port's CPU path at small shapes, with
masked diagonal tiles and ragged edge tiles; the configurations' own
descriptions against the port's configs; the control's rounding."""

import numpy as np
import pytest
import torch

from benchmark import arch
from benchmark.reference import fit as ref_fit
from benchmark.reference import nngp

from conftest import SEED, configs, small_config


def _x(n, shape, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, *shape), generator=g)


def _cfg(name):
    cfg = arch.load_config(name)
    return cfg["recursion"], cfg["tree"], tuple(cfg["image_shape"])


@pytest.mark.parametrize("name", configs())
def test_reference_against_the_port(name):
    """Each configuration's reference against the port's Gram, at its own
    image shape and its small size (``small/configs/<name>.json``)."""
    from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
    rec, tree, shape = _cfg(name)
    sizes = small_config(name)
    n, b = int(sizes["n"]), int(sizes["batch_size"])
    x = _x(n, shape)
    k = gram_device(rec.build_model(tree), x, batch_size=b, device="cpu")
    idx = torch.arange(n)
    want = rec.entries(tree, x, idx, idx)
    err = float((k.double() - want).abs().max() / want.abs().max())
    assert err < 2e-6


@pytest.mark.parametrize("name", [
    c for c in configs() if hasattr(arch.load_config(c)["recursion"],
                                    "block")])
def test_the_masked_diagonal_is_the_variance(name):
    """Each image against itself is its variance: the entries' mask where
    row and column name the same image is the block's."""
    rec, tree, shape = _cfg(name)
    n = int(small_config(name)["n"])
    x = _x(n, shape)
    idx = torch.arange(n)
    want = rec.entries(tree, x, idx, idx)
    assert torch.allclose(want.diagonal(), rec.block(
        tree, x, x, torch.eye(n, dtype=torch.bool)).diagonal(), rtol=0)


@pytest.mark.parametrize("name", [
    c for c in configs() if arch.load_config(c).get("port_config")])
def test_description_builds_the_ports_config(name):
    from cnn_gp_tpu_torch import configs as port_configs
    from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
    cfg = arch.load_config(name)
    x = _x(5, tuple(cfg["image_shape"]), seed=4)
    got = gram_device(cfg["recursion"].build_model(cfg["tree"]), x,
                      batch_size=3, device="cpu")
    want = gram_device(port_configs.load(cfg["port_config"]).initial_model,
                       x, batch_size=3, device="cpu")
    assert torch.equal(got, want)


def test_learnable_leaves_in_walk_order():
    from cnn_gp_tpu_torch.convert import leaf_items
    rec, tree, _ = _cfg("convnet_gp")
    items = leaf_items(rec.build_model(tree, learnable=True))
    assert np.allclose(np.log([float(p.detach()) for _, p in items]),
                       ref_fit.initial_raw(rec, tree))
    assert len(items) == 16


def test_round_tf32():
    t = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -9])
    got = nngp.round_tf32(t)
    assert got.tolist() == [1.0, 1.0, 1.0 + 2 ** -9, 1.0 + 2 ** -10,
                            -3.0 - 2 ** -9]


def test_reference_fit_against_the_ports():
    """The reference's value and gradient against the port's exact tiled
    NMLL at the same leaves (the same objective, two implementations)."""
    from cnn_gp_tpu_torch.fit import nmll_value_and_grad_tiled
    from benchmark.drivers.fit import labels
    rec, tree, shape = _cfg("convnet_gp")
    x = _x(12, shape, seed=5)
    y = labels(SEED, 1, 12, 10, "cpu")[0]
    raw = ref_fit.initial_raw(rec, tree)
    loss, g = ref_fit.value_and_grad(rec, tree, x, y, raw, b=5)
    model = rec.build_model(tree, learnable=True)
    loss_p, g_p = nmll_value_and_grad_tiled(model, x, y, batch_size=5,
                                            device="cpu")
    assert abs(loss - loss_p) / abs(loss) < 1e-5
    leaves = np.exp(raw)
    g_port = np.array(list(g_p.values()), np.float64) * leaves
    assert np.max(np.abs(g_port - g) / np.abs(g).max()) < 1e-3
