"""Gram cells: whole symmetric Gram calls K(x, x) through one of the
program's Gram-level entries.

Traffic parameters (``traffic/<name>.json``): ``entry``
(``gram_device``: the Gram as one card tensor; ``compute_gram_sharded``:
the tile grid dealt over the cell's ranks, every rank reassembling the
whole Gram into a host array allocated once in set-up), ``image_sets``
(each call takes the next of that many sets of images drawn from the
seed, so nothing keyed on the inputs can be reused), and for the sharded
entry ``tiles_per_round_per_device``.  Cell sizes
(``workloads/<cell>.json``): ``n`` images, ``batch_size`` (the tile
side), ``sample_rows`` / ``sample_cols`` and the ``limits``.

What the check compares, from every call of the window on every rank:
the first diagonal tile (the same-example mask), the last diagonal tile
(ragged where the tile side does not divide n), and a block of
``sample_rows`` x ``sample_cols`` entries at rows and columns drawn from
the seed, with its mirror.  ``gram_rel_err`` is the largest |K - K_ref|
over those entries against the largest |K_ref|, the reference (the
configuration's recursion's ``entries``, float64; ``reference/nngp.py``
for the diagonal one) recomputed from the same images;
``asymmetric_entries`` counts mirrored entries that differ at all.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arch, peaks, program


def positions(n: int, b: int, rows: int, cols: int, seed: int) -> dict:
    """The entries a call is checked on, as global (row, column) index
    arrays: two diagonal tiles and a seeded block."""
    rng = np.random.default_rng(seed)
    last = ((n - 1) // b) * b
    return {"first": np.arange(0, min(b, n)),
            "last": np.arange(last, n),
            "rows": np.sort(rng.choice(n, min(rows, n), replace=False)),
            "cols": np.sort(rng.choice(n, min(cols, n), replace=False))}


def take(k, pos: dict) -> dict:
    """The checked entries of a Gram (a card tensor or a host array)."""
    blocks = {"first": (pos["first"], pos["first"]),
              "last": (pos["last"], pos["last"]),
              "block": (pos["rows"], pos["cols"]),
              "mirror": (pos["cols"], pos["rows"])}
    out = {}
    for key, (r, c) in blocks.items():
        if isinstance(k, np.ndarray):
            out[key] = k[np.ix_(r, c)].copy()
        else:
            ri = torch.as_tensor(r, device=k.device)
            ci = torch.as_tensor(c, device=k.device)
            out[key] = k[ri[:, None], ci[None, :]].cpu().numpy()
    return out


def reference(rec, tree, images: torch.Tensor, pos: dict,
              dtype=torch.float64, rounding=None) -> dict:
    """The same entries from the plain reference of the recursion
    ``rec``."""
    def ent(r, c):
        return rec.entries(tree, images,
                           torch.as_tensor(r, device=images.device),
                           torch.as_tensor(c, device=images.device), dtype,
                           rounding).double().cpu().numpy()
    block = ent(pos["rows"], pos["cols"])
    return {"first": ent(pos["first"], pos["first"]),
            "last": ent(pos["last"], pos["last"]),
            "block": block, "mirror": block.T}


def rel_err(got: dict, want: dict) -> float:
    scale = max(float(np.abs(w).max()) for w in want.values())
    err = max(float(np.abs(got[k].astype(np.float64) - want[k]).max())
              for k in want)
    return err / scale if np.isfinite(err) else float("inf")


def asymmetric(got: dict) -> int:
    return int((got["block"] != got["mirror"].T).sum()
               + (got["first"] != got["first"].T).sum()
               + (got["last"] != got["last"].T).sum())


def images(seed: int, sets: int, n: int, shape, device) -> torch.Tensor:
    """[sets, n, C, W, H] images uniform in [0, 1), drawn on the device in
    one call from the seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((sets, n, *shape), generator=gen, device=device)


class Driver:
    def __init__(self, cell: dict, seed: int, group):
        self.cell, self.seed, self.group = cell, seed, group
        sizes, mix = cell["sizes"], cell["mix"]
        self.n, self.b = int(sizes["n"]), int(sizes["batch_size"])
        self.sets = int(mix["image_sets"])
        self.entry = mix["entry"]
        self.rec, self.tree = cell["cfg"]["recursion"], cell["cfg"]["tree"]
        self.shape = tuple(cell["cfg"]["image_shape"])
        self.limits = sizes["limits"]
        self.pos = positions(self.n, self.b, sizes["sample_rows"],
                             sizes["sample_cols"], seed)
        self.kept = []

    def setup(self) -> None:
        dev = self.group.device
        self.x = images(self.seed, self.sets, self.n, self.shape, dev)
        self.model = self.rec.build_model(self.tree)
        entries = program.entries()
        if self.entry == "gram_device":
            fn = entries["gram_device"]
            self._call = lambda x, out=None: fn(
                self.model, x, batch_size=self.b, device=dev)
            warm = 2 * self.b + self.n % self.b
        else:
            fn = entries["compute_gram_sharded"]
            self.mesh = entries["make_mesh"](device=dev)
            per_round = int(self.cell["mix"]["tiles_per_round_per_device"])
            self._call = lambda x, out=None: fn(
                self.model, x, batch_size=self.b, mesh=self.mesh, out=out,
                progress=False, tiles_per_round_per_device=per_round)
            warm = 2 * self.group.size * self.b + self.n % self.b
            # the host out every call reassembles into, its pages touched
            self.out = np.zeros((self.n, self.n), np.float32)
        # every tile shape of the cell: diagonal, off-diagonal, ragged
        self._call(self.x[0, :min(warm, self.n)])

    def call(self, k: int):
        x = self.x[k % self.sets]
        if self.entry == "gram_device":
            return self._call(x)
        return self._call(x, self.out)

    def keep(self, k: int, out) -> None:
        self.kept.append((k, k % self.sets, take(out, self.pos)))

    def samples(self):
        return self.kept

    def release(self) -> None:
        self.model = self._call = None
        self.out = None

    def check(self, parts):
        """(numbers compared with their limits, failed calls) over every
        rank's kept entries; the reference runs on this rank's device."""
        refs = {s: reference(self.rec, self.tree, self.x[s], self.pos)
                for s in sorted({s for part in parts for _, s, _ in part})}
        errs, asym, failed = [], 0, set()
        for part in parts:
            for k, s, got in part:
                e, a = rel_err(got, refs[s]), asymmetric(got)
                errs.append(e)
                asym += a
                if e > self.limits["gram_rel_err"] or a > 0:
                    failed.add(k)
        return ({"gram_rel_err": {"value": max(errs),
                                  "limit": self.limits["gram_rel_err"]},
                 "asymmetric_entries": {"value": asym, "limit": 0}},
                len(failed))

    def work_per_call(self) -> arch.Work:
        return self.rec.gram_work(self.tree, self.shape, self.n, self.b,
                                  peaks)

    def units_per_call(self) -> int:
        return self.work_per_call().entries

    def tiles_per_call(self) -> int:
        return len(arch.tiles(self.n, self.b))

    def end_to_end(self, calls: int, window_s: float) -> dict:
        return {"gram_entries_per_s": calls * self.units_per_call()
                / window_s}
