"""Kernel-patch value type: one block of an NNGP Gram matrix.

PyTorch counterpart of ``cnn_gp_tpu/kernel_patch.py``: the same canonical
layout (``xy: [Nx, Ny, W, H]``, ``xx: [Nx, W, H]``, ``yy: [Ny, W, H]``;
diag: ``xy: [N, W, H]``), the optional global-index ``diag_mask [Nx, Ny]``
that lets one code path serve diagonal and off-diagonal Gram tiles, and
the ``+``/``*`` algebra that ``Sum`` and ``Mixture`` use.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

__all__ = ["KernelPatch"]


@dataclasses.dataclass(frozen=True)
class KernelPatch:
    """One block of the kernel matrix, plus row/column variances.

    Attributes:
      xy: cross second moments ``[Nx, Ny, W, H]`` (``[N, W, H]`` if diag).
      xx: row variances ``[Nx, W, H]``.
      yy: column variances ``[Ny, W, H]``.
      same: rows and columns index the same underlying examples.
      diag: only the blockwise diagonal ``k(x_i, y_i)`` is tracked.
      diag_mask: optional ``[Nx, Ny]`` bool; True iff row ``i`` and column
        ``j`` are the same global example.  ``None`` means "derive from
        ``same``" (identity block => eye mask).
    """

    xy: torch.Tensor
    xx: torch.Tensor
    yy: torch.Tensor
    same: bool = False
    diag: bool = False
    diag_mask: Optional[torch.Tensor] = None

    @property
    def nx(self) -> int:
        return self.xx.shape[0]

    @property
    def ny(self) -> int:
        return self.yy.shape[0]

    @property
    def spatial(self):
        return tuple(self.xy.shape[-2:])

    def resolve_diag_mask(self) -> Optional[torch.Tensor]:
        """The effective [Nx, Ny] same-example mask, or None if not
        ``same`` (a ``same`` non-diag block is an identity block)."""
        if self.diag:
            return None
        if self.diag_mask is not None:
            return self.diag_mask
        if self.same:
            return torch.eye(self.nx, self.ny, dtype=torch.bool,
                             device=self.xy.device)
        return None

    # -- elementwise algebra (drives Sum / Mixture) ------------------------
    def _zipmap(self, other, op):
        if isinstance(other, KernelPatch):
            assert self.same == other.same and self.diag == other.diag
            return KernelPatch(
                op(self.xy, other.xy), op(self.xx, other.xx),
                op(self.yy, other.yy), self.same, self.diag,
                self.diag_mask if self.diag_mask is not None
                else other.diag_mask)
        return KernelPatch(
            op(self.xy, other), op(self.xx, other), op(self.yy, other),
            self.same, self.diag, self.diag_mask)

    def __add__(self, other):
        if isinstance(other, (int, float)) and other == 0:  # sum() support
            return self
        return self._zipmap(other, torch.add)

    def __radd__(self, other):
        return self.__add__(other)

    def __mul__(self, other):
        return self._zipmap(other, torch.mul)

    def __rmul__(self, other):
        return self.__mul__(other)
