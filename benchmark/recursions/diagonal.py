"""The reference paper's recursion: one covariance per pixel position and
pair of images (``xy`` [nx, nz, W, H], each side's variances ``xx``
[nx, W, H]), over ``conv``, ``relu``, ``seq`` and ``sum`` nodes.  Every
hook is the module that already held it: the tree and the counts in
``arch.py``, the model in ``program.py``, the reference in
``reference/nngp.py``."""

from __future__ import annotations

from .. import arch, program
from ..reference import nngp

parse = arch.parse
gram_work = arch.gram_work
build_model = program.build_model
entries = nngp.entries

fit_step_work = arch.fit_step_work
block = nngp.block


def leaves(tree):
    """var_weight and var_bias of each conv, in walk order."""
    return [v for cv in arch.convs(tree) for v in (cv.var_weight,
                                                     cv.var_bias)]
