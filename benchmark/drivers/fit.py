"""Fit cells: whole calls of the program's type-II ML fit,
``fit_large``, each from the configuration's hyperparameters with every
conv's ``var_weight`` and ``var_bias`` learnable.

Traffic parameters (``traffic/<name>.json``): ``grad``, ``steps_per_call``,
``checked_steps``, ``image_sets`` (each call fits the next of that many
sets of images and labels drawn from the seed), ``classes`` and
``jitter``.  Cell sizes (``workloads/<cell>.json``): ``n``, ``batch_size``
and the ``limits``.

The configuration's recursion has to give the fit hooks
(``recursions.FIT_HOOKS``); the driver refuses one that does not.

What the check compares, on one call of the window drawn from the seed,
against the plain reference's first ``checked_steps`` steps from the same
images, labels and leaves (``reference/fit.py`` on the recursion's
``block``, float64):

* ``loss_gap``: the largest |L - L_ref| / |L_ref| of the losses the call
  returns for those steps;
* ``grad_gap``: the first gradient as the optimiser got it, read from its
  state after one step (Adam's first moment is (1 - beta1) g), by the
  worst leaf: ||g| - |g_ref|| against the larger of |g_ref| and the median
  leaf's;
* ``change_gap``: the change of the leaves over those steps, up to the
  iterate the next step starts from (the optimiser's leaves after each
  step, with the steps the overshoot guard dropped replayed from the
  losses), measured as ``grad_gap`` is, leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's.

The optimiser's state is read through ``torch.optim``'s step post-hook,
which records each Adam step's leaves and first moments (16 scalars).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from .. import arch, peaks, program, recursions
from ..reference import fit as ref_fit
from .gram import images

BETA1 = ref_fit.BETAS[0]


def labels(seed: int, sets: int, n: int, classes: int, device) -> np.ndarray:
    """[sets, n, classes] +-1 one-hot targets of labels drawn from the
    seed (on the device, one call), on the host as the fit takes them."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    lab = torch.randint(0, classes, (sets, n), generator=gen, device=device)
    y = -torch.ones((sets, n, classes), dtype=torch.float32, device=device)
    y.scatter_(2, lab[..., None], 1.0)
    return y.cpu().numpy()


def gap(got: np.ndarray, want: np.ndarray, keep=None) -> float:
    """By the worst leaf: ||got| - |want|| over the larger of |want| and
    the median leaf's |want|."""
    got, want = np.abs(got), np.abs(want)
    if keep is not None:
        got, want = got[keep], want[keep]
    scale = np.maximum(want, np.median(want))
    out = float(np.max(np.abs(got - want) / scale))
    return out if math.isfinite(out) else float("inf")


def replay(raw0, losses, steps, after):
    """The raw leaves step ``steps`` starts from: the guard of the fit
    replayed on its losses, each accepted step's leaves taken from the
    optimiser (``after``, in order)."""
    raw, best, best_raw = raw0, math.inf, raw0
    taken = iter(after)
    for loss in losses[:steps]:
        if loss < best:
            best, best_raw = loss, raw
        if not math.isfinite(loss) or loss > best + ref_fit.BACKTRACK_TOL * abs(best):
            raw = best_raw
        else:
            raw = next(taken)
    return raw


class Driver:
    def __init__(self, cell: dict, seed: int, group):
        self.cell, self.seed, self.group = cell, seed, group
        sizes, mix = cell["sizes"], cell["mix"]
        self.n, self.b = int(sizes["n"]), int(sizes["batch_size"])
        self.mix = mix
        self.sets = int(mix["image_sets"])
        self.steps = int(mix["steps_per_call"])
        self.rec, self.tree = cell["cfg"]["recursion"], cell["cfg"]["tree"]
        recursions.require_fit(self.rec)
        self.shape = tuple(cell["cfg"]["image_shape"])
        self.limits = sizes["limits"]
        self.kept = []
        self._steps = None

    def _record(self, opt, args, kwargs) -> None:
        """After each Adam step: its leaves and first moments."""
        if self._steps is None:
            return
        ps = [p for g in opt.param_groups for p in g["params"]]
        self._steps.append((
            np.array([float(p.detach()) for p in ps]),
            np.array([float(opt.state[p]["exp_avg"]) if p in opt.state
                      else 0.0 for p in ps])))

    def setup(self) -> None:
        dev = self.group.device
        self.x = images(self.seed, self.sets, self.n, self.shape, dev)
        self.y = labels(self.seed, self.sets, self.n,
                        int(self.mix["classes"]), dev)
        self.model = self.rec.build_model(self.tree, learnable=True)
        self.fit = program.entries()["fit_large"]
        self._hook = register_optimizer_step_post_hook(self._record)
        # one step: the Gram's tiles, the host algebra, the VJP sweep
        self._fit(0, 1)

    def _fit(self, s: int, steps: int):
        return self.fit(self.model, self.x[s], self.y[s], steps=steps,
                        grad=self.mix["grad"], batch_size=self.b,
                        jitter=float(self.mix["jitter"]),
                        device=self.group.device)

    def call(self, k: int):
        self._steps = []
        _, losses = self._fit(k % self.sets, self.steps)
        steps, self._steps = self._steps, None
        return losses, steps

    def keep(self, k: int, out) -> None:
        losses, steps = out
        self.kept.append((k, k % self.sets, np.asarray(losses), steps))

    def samples(self):
        return self.kept

    def release(self) -> None:
        self._hook.remove()
        self.model = self.fit = None

    def check(self, parts):
        kept = parts[0]
        k, s, losses, steps = kept[
            np.random.default_rng(self.seed).integers(len(kept))]
        m = int(self.mix["checked_steps"])
        ref = ref_fit.follow(self.rec, self.tree, self.x[s], self.y[s],
                             steps=m, jitter=float(self.mix["jitter"]),
                             b=self.b)
        raw0 = ref_fit.initial_raw(self.rec, self.tree)
        loss_gap = float(np.max(np.abs(losses[:m] - ref["losses"])
                                / np.abs(ref["losses"])))
        grad0 = steps[0][1] / (1 - BETA1)
        moved = np.abs(ref["grad0"]) >= 1e-3 * np.median(np.abs(ref["grad0"]))
        change = replay(raw0, losses, m, [p for p, _ in steps]) - raw0
        numbers = {
            "loss_gap": loss_gap if math.isfinite(loss_gap) else float("inf"),
            "grad_gap": gap(grad0, ref["grad0"]),
            "change_gap": gap(change, ref["starts"][m] - raw0, moved)}
        checks = {key: {"value": v, "limit": self.limits[key]}
                  for key, v in numbers.items()}
        bad = any(c["value"] > c["limit"] for c in checks.values())
        return checks, int(bad)

    def work_per_call(self) -> arch.Work:
        return self.rec.fit_step_work(self.tree, self.shape, self.n,
                                      self.b, peaks) * self.steps

    def units_per_call(self) -> int:
        return self.steps

    def tiles_per_call(self) -> int:
        return 2 * self.steps * len(arch.tiles(self.n, self.b))

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"fit_step_s": window_s / (calls * self.steps)}
