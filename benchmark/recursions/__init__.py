"""The covariance recursions a configuration may name.

A configuration file names its recursion with ``"recursion": "<r>"``
(``"diagonal"`` where it names none), and ``recursions/<r>.py`` holds
everything that depends on how that recursion represents the covariance:

    parse(node) -> tree                       the configuration's model
    gram_work(tree, shape, n, b, peaks)       an ``arch.Work`` a Gram call
    build_model(tree, learnable=False)        the program's model, built
                                              with its DSL
    entries(tree, images, rows, cols,         the plain reference's
            dtype=torch.float64,              K[rows][:, cols], an entry
            rounding=None)                    masked where row and column
                                              name the same image

and, where it supports a fit cell, the fit hooks (``FIT_HOOKS``):

    fit_step_work(tree, shape, n, b, peaks)   an ``arch.Work`` an exact step
    block(tree, x, z, mask=None, leaves=None, the reference's K(x, z);
          dtype=torch.float64,                ``leaves``, (var_weight,
          rounding=None)                      var_bias) pairs of tensors
                                              in ``leaves``' order, take
                                              the configuration's place
                                              for gradients
                                              (``reference/fit.py``)
    leaves(tree)                              the learnable leaves' values,
                                              in the order ``block`` and
                                              the program's model take them

``arch.Work``, ``arch.tiles`` and ``peaks`` stay shared.  A recursion's
module is found by its name alone, so a configuration with a new
recursion is added by files.
"""

from __future__ import annotations

import importlib
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT = "diagonal"
FIT_HOOKS = ("fit_step_work", "block", "leaves")
_NAME = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


def load(name: str):
    """``recursions/<name>.py``, imported."""
    if not _NAME.fullmatch(name):
        raise ValueError(f"a recursion's name is a Python identifier, "
                         f"not {name!r}")
    path = os.path.join(HERE, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"the configuration names the recursion {name!r}, and "
            f"{path} does not exist")
    return importlib.import_module(f"{__name__}.{name}")


def require_fit(rec) -> None:
    """Raise unless ``rec`` gives every fit hook: a fit cell never falls
    back to another recursion's."""
    missing = [h for h in FIT_HOOKS if not hasattr(rec, h)]
    if missing:
        raise ValueError(
            f"the recursion {rec.__name__.rsplit('.', 1)[-1]!r} "
            f"({rec.__file__}) has no fit hooks {missing}: it cannot run "
            f"a fit cell")
