"""Carry models and fitted parameters across from the JAX package.

* ``from_jax_model(m)`` rebuilds a ``cnn_gp_tpu`` model tree as the
  port's tree.  It reads class names and attributes only, so it never
  imports jax.
* ``load_leaves(model, path_or_dict)`` / ``save_leaves(model, path)`` use
  the format of ``cnn_gp_tpu/fit.py::save_leaves``: an ``.npz`` of the
  model's array leaves keyed the way ``jax.tree_util.keystr`` names their
  pytree paths, e.g. ``[<flat index 0>][0].var_weight`` for the first
  layer of a ``Sequential``.  A missing, extra or mis-shaped leaf is
  refused.
* ``finite_params_from_jax(net, params)`` loads the parameters that the
  JAX package's ``FiniteNet.init`` draws into the port's ``FiniteNet``,
  so both compute the same networks.
"""

from __future__ import annotations

import copy
import os
from typing import List, Tuple

import numpy as np
import torch
from torch import nn

from .kernels import Conv2d, Mixture, NNGPKernel, ReLU, Sequential, Sum

__all__ = ["from_jax_model", "leaf_items", "load_leaves", "save_leaves",
           "finite_params_from_jax"]


def from_jax_model(m) -> NNGPKernel:
    """The port's counterpart of a ``cnn_gp_tpu`` model tree."""
    kind = type(m).__name__
    if kind == "Sequential":
        return Sequential(*[from_jax_model(c) for c in m.mods])
    if kind == "Sum":
        return Sum([from_jax_model(c) for c in m.mods])
    if kind == "Mixture":
        return Mixture([from_jax_model(c) for c in m.mods],
                       np.asarray(m.logit, np.float32))
    if kind == "ReLU":
        return ReLU()
    if kind == "Conv2d":
        return Conv2d(
            m.kernel_size, stride=m.stride,
            padding="same" if m.even_trick else m.padding,
            dilation=m.dilation,
            var_weight=float(np.asarray(m.var_weight)),
            var_bias=float(np.asarray(m.var_bias)),
            in_channel_multiplier=m.in_channel_multiplier,
            out_channel_multiplier=m.out_channel_multiplier,
            learnable=m.learnable)
    raise TypeError(f"no port counterpart for {kind}")


def leaf_items(model) -> List[Tuple[str, nn.Parameter]]:
    """(key, parameter) pairs in the JAX package's pytree order, keyed as
    ``jax.tree_util.keystr`` names them there."""
    items = []

    def walk(m, prefix):
        if isinstance(m, (Sequential, Sum, Mixture)):
            for i, child in enumerate(m.mods):
                walk(child, f"{prefix}[<flat index 0>][{i}]")
            if isinstance(m, Mixture):
                items.append((f"{prefix}[<flat index 1>]", m.logit))
        elif isinstance(m, Conv2d) and m.learnable:
            items.append((f"{prefix}.var_weight", m.var_weight))
            items.append((f"{prefix}.var_bias", m.var_bias))

    walk(model, "")
    return items


def save_leaves(model, path: str) -> None:
    """Write the model's array leaves in the JAX package's format."""
    items = leaf_items(model)
    if not items:
        raise ValueError("model has no array leaves to save (construct "
                         "layers with learnable=True)")
    np.savez(path, **{k: p.detach().cpu().numpy() for k, p in items})


def load_leaves(model, source):
    """A copy of ``model`` with its leaves set from ``source`` (an ``.npz``
    path or a dict of arrays).  The architecture and learnable flags must
    match what was saved."""
    if isinstance(source, (str, os.PathLike)):
        with np.load(source) as data:
            saved = {k: data[k] for k in data.files}
    else:
        saved = {k: np.asarray(v) for k, v in source.items()}
    new = copy.deepcopy(model)
    for k, p in leaf_items(new):
        if k not in saved:
            raise ValueError(
                f"no saved value for leaf {k}: the saved model's "
                f"architecture/learnable flags differ from this one "
                f"(saved leaves: {sorted(saved)})")
        a = saved.pop(k)
        if a.shape != tuple(p.shape):
            raise ValueError(f"leaf {k}: saved shape {a.shape} != model "
                             f"shape {tuple(p.shape)}")
        with torch.no_grad():
            p.copy_(torch.as_tensor(a, dtype=p.dtype))
    if saved:
        raise ValueError(
            f"saved leaves this model does not have: {sorted(saved)} "
            f"(architecture/learnable flags differ)")
    return new


def finite_params_from_jax(net, params, device="cpu"):
    """Load JAX ``FiniteNet.init`` parameters into the port's ``net``.

    ``params`` is one JAX parameter pytree (nested tuples of ``{"w", "b"}``
    arrays), loaded as S = 1, or a list of them, stacked into S networks
    in that order.  Returns ``net``."""
    draws = params if isinstance(params, list) else [params]
    return net._load_jax(draws, device)
