"""The port's remaining configs (cifar10, mnist_paper_residual_cnn_gp,
mnist_as_tf_16k, mnist_as_tf_mini) and its fake-dataset writer, against
the JAX package's on the same numpy inputs, on the CPU: attributes and
ranges, a Gram tile within 1e-5 of value scale, the plain path (no
megakernel), the pieces the residual config leans on (an empty
Sequential inside a Sum, the even-kernel trick), the writer's bytes and
the loader's splits."""

import filecmp
import os
import types

import numpy as np
import pytest
import torch

import cnn_gp_tpu as G
import configs as jconfigs
from cnn_gp_tpu.data import DatasetFromConfig as JDataset
from cnn_gp_tpu.ops.boxfilter import box_filter_2d as jbox
from cnn_gp_tpu_torch import configs, kernels
from cnn_gp_tpu_torch.data import DatasetFromConfig
from cnn_gp_tpu_torch.ops import megakernel
from cnn_gp_tpu_torch.ops.boxfilter import box_filter_2d, same_padding
from cnn_gp_tpu_torch.scripts import make_fake_dataset
from scripts import make_fake_dataset as jmake

NEW = ["cifar10", "mnist_paper_residual_cnn_gp", "mnist_as_tf_16k",
       "mnist_as_tf_mini"]
ATTRS = ("dataset_name", "model_name", "transforms", "epochs",
         "in_channels", "out_channels")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the ResNet tiles run many small ops, and
    several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", NEW)
def test_config_attributes_and_ranges_equal_jax(name):
    t, j = configs.load(name), jconfigs.load(name)
    for attr in ATTRS:
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in ("train_range", "validation_range", "test_range"):
        assert list(getattr(t, attr)) == list(getattr(j, attr)), attr
    assert configs.image_shape(t) == jconfigs.image_shape(j)
    assert t.initial_model.layers() == j.initial_model.layers()
    extra = {a for a in vars(j) if not a.startswith("_")} - {
        a for a in vars(t) if not a.startswith("_")}
    # the port's configs carry every attribute of JAX's (its imported
    # classes and helpers aside)
    assert extra <= {"G", "Conv2d", "ReLU", "Sequential", "Sum",
                     "resnet32_trunk"}, extra
    if name == "cifar10":
        assert t.kernel_batch_size == j.kernel_batch_size == 350
    if name == "mnist_paper_residual_cnn_gp":
        assert (t.var_weight, t.var_bias) == (j.var_weight, j.var_bias)


@pytest.mark.parametrize("name", NEW)
def test_new_configs_take_the_plain_path(name):
    """All four are ResNets (the residual one also sums branches and has
    an even kernel): megakernel.match accepts none of them."""
    assert megakernel.match(configs.load(name).initial_model) is None


def _tile(name, n_x, n_z, seed):
    t, j = configs.load(name), jconfigs.load(name)
    rng = np.random.RandomState(seed)
    shape = configs.image_shape(t)
    x = rng.rand(n_x, *shape).astype(np.float32)
    z = rng.rand(n_z, *shape).astype(np.float32)
    mask = np.arange(n_x)[:, None] == 1 + np.arange(n_z)[None, :]
    want = np.asarray(j.initial_model(x, z, same=False, diag_mask=mask))
    with torch.no_grad():
        got = t.initial_model(x, z, same=False, diag_mask=mask).numpy()
    return got, want


@pytest.mark.parametrize("name", ["cifar10", "mnist_paper_residual_cnn_gp",
                                  "mnist_as_tf_mini"])
def test_config_tile_matches_jax(name):
    """A 3x4 tile (one same-example entry on a shifted diagonal) within
    1e-5 of value scale of JAX's: cifar10 at 3x32x32 (three channels into
    the readout's in_channel_multiplier=4), the residual config at 28x28
    (eight Sum blocks, k = 4 "same"), the ResNet-32 of mnist_as_tf_mini
    (and of mnist_as_tf_16k, the same model)."""
    got, want = _tile(name, 3, 4, seed=len(name))
    assert got.shape == want.shape == (3, 4)
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-5 * np.abs(want).max()


def test_rehearsal_configs_share_the_mnist_as_tf_model():
    base = configs.load("mnist_as_tf").initial_model
    assert configs.load("mnist_as_tf_16k").initial_model is base
    assert configs.load("mnist_as_tf_mini").initial_model is base


def test_empty_sequential_in_sum_is_the_identity():
    """Sum([Sequential(), branch]) adds the incoming patch unchanged, as
    JAX's Sequential and Sum do (cnn_gp_tpu/kernels.py:305-340)."""
    rng = np.random.RandomState(0)
    x = rng.rand(3, 1, 12, 12).astype(np.float32)
    z = rng.rand(2, 1, 12, 12).astype(np.float32)
    conv = dict(kernel_size=3, var_weight=2.0, var_bias=0.5)
    t_id = kernels.Sequential(kernels.Sum([kernels.Sequential(),
                                           kernels.Sequential()]),
                              kernels.Conv2d(12, padding=0))
    t_one = kernels.Sequential(kernels.Conv2d(12, padding=0))
    with torch.no_grad():
        two = t_id(x, z, same=False).numpy()
        one = t_one(x, z, same=False).numpy()
    # the readout is linear in the patch (its var_bias is 0): twice K_1
    np.testing.assert_allclose(two, 2 * one, rtol=1e-6)
    t_res = kernels.Sequential(
        kernels.Sum([kernels.Sequential(), kernels.Sequential(
            kernels.Conv2d(**conv), kernels.ReLU())]),
        kernels.Conv2d(12, padding=0))
    j_res = G.Sequential(
        G.Sum([G.Sequential(), G.Sequential(G.Conv2d(**conv), G.ReLU())]),
        G.Conv2d(12, padding=0))
    with torch.no_grad():
        got = t_res(x, z, same=False).numpy()
    want = np.asarray(j_res(x, z, same=False))
    assert np.abs(got - want).max() < 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("k", [2, 4, 6])
def test_even_kernel_same_padding_matches_jax(k):
    """The even-kernel "same" trick is asymmetric (lo, hi) padding:
    (k/2 - 1, k/2) at 28x28, summed as JAX sums it."""
    assert same_padding(k) == (k // 2 - 1, k // 2)
    x = np.random.RandomState(k).rand(2, 3, 28, 28).astype(np.float32)
    pad = same_padding(k)
    got = box_filter_2d(torch.from_numpy(x), k, 1, pad).numpy()
    want = np.asarray(jbox(x, k, 1, pad))
    assert got.shape == want.shape == (2, 3, 28, 28)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    conv = kernels.Conv2d(k, padding="same")
    assert conv.even_trick and conv.pad_lo_hi == pad


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("kind,hard", [("mnist", False), ("mnist", True),
                                       ("cifar10", False), ("cifar10", True)])
def test_fake_dataset_writer_bytes_equal_jax(tmp_path, kind, hard, capsys):
    """The port's writer and JAX's write the same files, byte for byte
    (n_train 13 gives CIFAR an uneven first batch of 5 and four of 2)."""
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    args = [kind, str(ours), "13", "6"] + (["--hard"] if hard else [])
    make_fake_dataset.main(args)
    getattr(jmake, f"make_{kind}")(str(theirs), 13, 6, hard=hard)
    names = _files(ours)
    assert names == _files(theirs) and len(names) in (4, 6)
    match, mismatch, errors = filecmp.cmpfiles(ours, theirs, names,
                                               shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    assert f"wrote fake {'MNIST' if kind == 'mnist' else 'CIFAR-10'}" in (
        capsys.readouterr().out)


@pytest.mark.parametrize("name", ["mnist_as_tf_mini", "cifar10"])
def test_dataset_splits_equal_jax_on_written_files(tmp_path, name):
    """DatasetFromConfig on the writer's files: the config's dataset and
    channels with its ranges cut to the small pool, split as JAX splits."""
    cfg = configs.load(name)
    kind = "mnist" if cfg.dataset_name == "MNIST" else "cifar10"
    make_fake_dataset.main([kind, str(tmp_path), "40", "12", "--hard"])
    small = types.SimpleNamespace(
        dataset_name=cfg.dataset_name, in_channels=cfg.in_channels,
        transforms=cfg.transforms, train_range=range(0, 30),
        validation_range=list(range(30, 40)) + list(range(0, 2)),
        test_range=range(40, 52))
    got, want = DatasetFromConfig(str(tmp_path), small), JDataset(
        str(tmp_path), small)
    for split in ("train", "validation", "test"):
        g, w = getattr(got, split), getattr(want, split)
        np.testing.assert_array_equal(g.images, np.asarray(w.images))
        np.testing.assert_array_equal(g.labels, np.asarray(w.labels))
    assert got.train.images.shape == (30,) + configs.image_shape(cfg)
    assert len(got.validation) == 12 and len(got.test) == 12
    assert got.train.images.dtype == np.float32
