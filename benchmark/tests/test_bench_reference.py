"""The plain reference against the port's CPU path at small shapes, with
masked diagonal tiles and ragged edge tiles; the configurations' own
descriptions against the port's configs; the control's rounding."""

import numpy as np
import pytest
import torch

from benchmark import arch, program
from benchmark.reference import fit as ref_fit
from benchmark.reference import nngp

from conftest import SEED


def _x(n, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((n, 1, 28, 28), generator=g)


@pytest.mark.parametrize("name, n, b", [("convnet_gp", 10, 4),
                                        ("resnet32", 7, 3)])
def test_reference_against_the_port(name, n, b):
    from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
    tree = arch.load_config(name)["tree"]
    x = _x(n)
    k = gram_device(program.build_model(tree), x, batch_size=b,
                    device="cpu")
    idx = torch.arange(n)
    want = nngp.entries(tree, x, idx, idx)
    err = float((k.double() - want).abs().max() / want.abs().max())
    assert err < 2e-6
    # the masked diagonal: each image against itself is its variance
    assert torch.allclose(want.diagonal(), nngp.block(
        tree, x, x, torch.eye(n, dtype=torch.bool)).diagonal(), rtol=0)


@pytest.mark.parametrize("name", ["convnet_gp", "resnet32"])
def test_description_builds_the_ports_config(name):
    from cnn_gp_tpu_torch import configs
    from cnn_gp_tpu_torch.parallel.device_pipeline import gram_device
    cfg = arch.load_config(name)
    x = _x(5, seed=4)
    got = gram_device(program.build_model(cfg["tree"]), x, batch_size=3,
                      device="cpu")
    want = gram_device(configs.load(cfg["port_config"]).initial_model, x,
                       batch_size=3, device="cpu")
    assert torch.equal(got, want)


def test_learnable_leaves_in_walk_order():
    from cnn_gp_tpu_torch.convert import leaf_items
    tree = arch.load_config("convnet_gp")["tree"]
    items = leaf_items(program.build_model(tree, learnable=True))
    assert np.allclose(np.log([float(p.detach()) for _, p in items]),
                       ref_fit.initial_raw(tree))
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
    tree = arch.load_config("convnet_gp")["tree"]
    x = _x(12, seed=5)
    y = labels(SEED, 1, 12, 10, "cpu")[0]
    raw = ref_fit.initial_raw(tree)
    loss, g = ref_fit.value_and_grad(tree, x, y, raw, b=5)
    model = program.build_model(tree, learnable=True)
    loss_p, g_p = nmll_value_and_grad_tiled(model, x, y, batch_size=5,
                                            device="cpu")
    assert abs(loss - loss_p) / abs(loss) < 1e-5
    leaves = np.exp(raw)
    g_port = np.array(list(g_p.values()), np.float64) * leaves
    assert np.max(np.abs(g_port - g) / np.abs(g).max()) < 1e-3
