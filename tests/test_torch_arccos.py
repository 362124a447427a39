"""Port arccos ReLU transform (cnn_gp_tpu_torch.ops.arccos) against the JAX
package's on the same patches, in both relu_impl forms and both acos
implementations, with and without a same-example mask."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cnn_gp_tpu
import cnn_gp_tpu_torch
from cnn_gp_tpu.ops import arccos as jarc
from cnn_gp_tpu_torch.ops import arccos as tarc


def test_acos_f32_matches_jax_on_grid():
    x = np.linspace(-1.0, 1.0, 200001, dtype=np.float32)
    got = tarc.acos_f32(torch.from_numpy(x)).numpy()
    want = np.asarray(jarc.acos_f32(jnp.asarray(x)))
    assert np.abs(got.astype(np.float64) - want).max() <= 1e-7
    assert np.abs(got - np.arccos(x.astype(np.float64))).max() < 5e-7


def test_acos_f32_endpoints():
    got = tarc.acos_f32(torch.tensor([-1.0, 0.0, 1.0])).numpy()
    np.testing.assert_allclose(got, [np.pi, np.pi / 2, 0.0], atol=1e-7)


def _arrays(nx, ny, diag, seed, w=4, h=5):
    r = np.random.RandomState(seed)
    xx = r.rand(nx, w, h).astype(np.float32) + 0.3
    yy = r.rand(ny, w, h).astype(np.float32) + 0.3
    if diag:
        xy = (r.rand(nx, w, h).astype(np.float32) - 0.5) * np.sqrt(xx * yy)
    else:
        lim = np.sqrt(xx[:, None] * yy[None])
        xy = (r.rand(nx, ny, w, h).astype(np.float32) - 0.5) * 2 * lim
    return xy.astype(np.float32), xx, yy


# (nx, ny, same, diag, mask kind)
PATCHES = [
    (6, 9, False, False, None),
    (6, 9, False, False, "global"),     # off-diagonal tile, partial mask
    (8, 8, True, False, None),          # same block => eye mask
    (8, 8, False, False, "eye"),        # explicit mask on a diagonal tile
    (7, 7, False, True, None),          # diag, different examples
    (7, 7, True, True, None),           # diag of a same block
]


@pytest.mark.parametrize("nx,ny,same,diag,mask_kind", PATCHES)
@pytest.mark.parametrize("relu_impl", ["fast", "reference"])
@pytest.mark.parametrize("acos_impl", ["poly", "exact"])
def test_relu_transform_matches_jax(nx, ny, same, diag, mask_kind,
                                    relu_impl, acos_impl):
    if same:
        # a same block has identical row and column variances
        xy, xx, _ = _arrays(nx, ny, diag, seed=nx)
        yy = xx
    else:
        xy, xx, yy = _arrays(nx, ny, diag, seed=nx)
    mask = None
    if mask_kind == "global":
        mask = (3 + np.arange(nx))[:, None] == np.arange(ny)[None, :]
    elif mask_kind == "eye":
        mask = np.eye(nx, ny, dtype=bool)
    jkp = cnn_gp_tpu.KernelPatch(
        jnp.asarray(xy), jnp.asarray(xx), jnp.asarray(yy), same, diag,
        None if mask is None else jnp.asarray(mask))
    tkp = cnn_gp_tpu_torch.KernelPatch(
        torch.from_numpy(xy), torch.from_numpy(xx), torch.from_numpy(yy),
        same, diag, None if mask is None else torch.from_numpy(mask))
    with cnn_gp_tpu.settings.override(relu_impl=relu_impl,
                                      acos_impl=acos_impl):
        want = jarc.relu_transform(jkp)
    with cnn_gp_tpu_torch.settings.override(relu_impl=relu_impl,
                                            acos_impl=acos_impl):
        got = tarc.relu_transform(tkp)
    for g, w in ((got.xy, want.xy), (got.xx, want.xx), (got.yy, want.yy)):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() / np.abs(w).max() < 1e-5
    if mask is not None:
        # same-example entries equal xx' exactly
        i, j = np.nonzero(mask)
        np.testing.assert_array_equal(got.xy.numpy()[i, j],
                                      got.xx.numpy()[i])
