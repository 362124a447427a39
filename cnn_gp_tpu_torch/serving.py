"""Posterior persistence and serving: solve once, predict from any process.

PyTorch counterpart of ``cnn_gp_tpu/serving.py``, with the same ``.npz``
format: a file written by either package loads in the other.  The solved
GP posterior is O(N) objects -- weights ``alpha`` [N, C], Jacobi
equilibration scalings ``s`` [N] and the training inputs -- saved once
(``save_posterior``) and served by ``GPPredictor`` on a card:

* **means/classification**: ``K(z, X) @ alpha`` by tile-regeneration
  sweeps (``parallel.device_large.make_scores_fn``): no solve, no stored
  Gram, nothing O(N^2);
* **variances**: after one solve-free rebuild of the factor
  (``prepare_variances``: reassemble the equilibrated Gram from the stored
  inputs and scalings on the card and factor it), posterior variances per
  query block.

The artifact is a flat .npz (float32 inputs, float64 posterior) with a
format version and the kernel settings snapshot recorded for provenance.
The optional on-disk factor cache (``prepare_variances(factor_cache=dir)``)
has the JAX package's files (``l.npy``, ``diags.npy``, ``meta.json``) with
``n_devices`` the rank count (1 without a mesh), so a cache written by
either package loads in the other at the same rank or device count.  With
``prepare_variances(mesh=)`` the factor is row-sharded over the ranks
(``parallel.chol_dist.ShardedFactor``) and each rank writes and reads
only its rows of ``l.npy``; the directory must be one that every rank
sees.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

from . import settings

__all__ = ["save_posterior", "load_posterior", "GPPredictor", "Posterior"]

FORMAT_VERSION = 1
_FACTOR_CACHE_VERSION = 2   # the JAX package's: meta with model_sha256


@dataclasses.dataclass
class Posterior:
    """A solved GP posterior: everything needed to serve new queries."""
    train_x: np.ndarray                 # [N, C, H, W] float32
    alpha: np.ndarray                   # [N, n_classes] float64
    scalings: Optional[np.ndarray]      # [N] float64 (None: means only)
    jitter_raw: float                   # provenance; folded into scalings
    config_name: str
    settings_snapshot: str              # kernel settings at solve time

    @property
    def n(self) -> int:
        return len(self.train_x)


def save_posterior(path, *, train_x, alpha, scalings=None,
                   jitter_raw: float = 0.0, config_name: str = "") -> str:
    """Persist a solved posterior to ``path``.

    ``scalings`` (``1/sqrt(diag K + jitter_raw)``) is optional but needed
    later for variance serving: the equilibrated factor is rebuilt from
    it.  Returns the final path (``.npz`` appended if missing, as
    ``np.savez`` does)."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    train_x = np.asarray(train_x, np.float32)
    alpha = np.asarray(alpha, np.float64)
    if alpha.ndim != 2:
        raise ValueError(f"alpha must be [N, n_classes], got shape "
                         f"{alpha.shape}")  # fail here, not at serve time
    if len(train_x) != len(alpha):
        raise ValueError(f"train_x/alpha length mismatch: "
                         f"{len(train_x)} vs {len(alpha)}")
    arrays = {
        "format_version": np.int64(FORMAT_VERSION),
        "train_x": train_x,
        "alpha": alpha,
        "jitter_raw": np.float64(jitter_raw),
        "config_name": np.str_(config_name),
        "settings_snapshot": np.str_(repr(settings.snapshot())),
    }
    if scalings is not None:
        scalings = np.asarray(scalings, np.float64)
        if scalings.shape != (len(train_x),):
            raise ValueError(f"scalings shape {scalings.shape} != "
                             f"({len(train_x)},)")
        arrays["scalings"] = scalings
    np.savez(path, **arrays)
    return path


def load_posterior(path) -> Posterior:
    with np.load(str(path), allow_pickle=False) as z:
        version = int(z["format_version"])
        if version > FORMAT_VERSION:
            raise ValueError(f"posterior format {version} is newer than "
                             f"this library's {FORMAT_VERSION}")
        return Posterior(
            train_x=z["train_x"],
            alpha=z["alpha"],
            scalings=z["scalings"] if "scalings" in z.files else None,
            jitter_raw=float(z["jitter_raw"]),
            config_name=str(z["config_name"]),
            settings_snapshot=str(z["settings_snapshot"]),
        )


class GPPredictor:
    """Serve a persisted posterior on ``device``: means immediately,
    variances after a solve-free factor rebuild.

    ``batch_size`` is the Gram tile size of the regeneration sweeps.

    Construction refuses a posterior whose recorded settings snapshot
    differs from the process's ``settings.snapshot()``: alpha was solved
    against THAT kernel, and regenerating ``K(z, X)`` under another one
    (e.g. exact vs poly arccos) silently shifts near-tie classifications.
    Pass ``allow_settings_mismatch=True`` after deliberately matching the
    numerics."""

    def __init__(self, model, posterior: Posterior, batch_size: int = 128,
                 allow_settings_mismatch: bool = False, *, device):
        current = repr(settings.snapshot())
        if (not allow_settings_mismatch and posterior.settings_snapshot
                and posterior.settings_snapshot != current):
            raise ValueError(
                f"posterior was solved under kernel-lowering settings "
                f"{posterior.settings_snapshot} but this process has "
                f"{current}; align cnn_gp_tpu_torch.settings (or pass "
                f"allow_settings_mismatch=True)")
        self.model = model
        self.posterior = posterior
        self.batch_size = batch_size
        self.device = device
        self._factor = None
        self._var_ctx = None
        self._scores_fn = None

    def scores(self, z) -> np.ndarray:
        """Posterior mean scores ``K(z, X_train) @ alpha`` per class, by
        tile-regeneration sweeps (nothing O(N^2) resident).  The training
        set and weights go to the card once, on the first call."""
        if self._scores_fn is None:
            from .parallel.device_large import make_scores_fn
            self._scores_fn = make_scores_fn(
                self.model, self.posterior.train_x,
                self.posterior.alpha.astype(np.float32),
                batch_size=self.batch_size, device=self.device)
        return self._scores_fn(np.asarray(z, np.float32))

    def classify(self, z) -> np.ndarray:
        return np.argmax(self.scores(z), axis=1)

    def prepare_variances(self, block: int = 2048,
                          factor_cache: Optional[str] = None,
                          write_cache: bool = True, mesh=None) -> None:
        """Rebuild the factor from the stored training set and scalings:
        assembly and blocked Cholesky on the card, no solve (the posterior
        is already solved).  Required once per process before
        :meth:`variances`.

        ``factor_cache`` (opt-in) names a directory holding the factor as
        an O(N^2) float32 file: when present and matching this posterior,
        model, geometry and settings, the factor is loaded instead of
        rebuilt; when absent, it is written after the rebuild
        (``write_cache=False`` disables that).  A cache that is present but
        does not match is refused, never quietly rebuilt.

        ``mesh`` (a rank group on this predictor's device) row-shards the
        factor over the ranks; every rank calls this with the same
        arguments, and rank 0 decides whether the cache is loaded."""
        from .parallel.device_large import rebuild_factor

        p = self.posterior
        if p.scalings is None:
            raise ValueError("posterior was saved without scalings; "
                             "variance serving needs them (save_posterior"
                             "(..., scalings=...))")
        if factor_cache and self._try_load_factor_cache(factor_cache, block,
                                                        mesh):
            return
        factor, x_all, s_dev = rebuild_factor(
            self.model, p.train_x, p.scalings, batch_size=self.batch_size,
            block=block, device=self.device, mesh=mesh)
        self._factor = factor
        # pin the settings at rebuild time: the variance sweeps must whiten
        # cross-columns of the SAME kernel the factor holds
        self._var_ctx = (x_all, s_dev, settings.snapshot())
        if factor_cache and write_cache:
            self._write_factor_cache(factor_cache)

    def _cache_meta(self, block: int, n_devices: int = 1) -> dict:
        """Identity of a factor cache, as the JAX package writes it: the
        posterior content (scalings and training-set digest), the model's
        array leaves (keyed and ordered as the JAX pytree flattens them),
        the factor geometry and the settings snapshot."""
        from .convert import leaf_items

        p = self.posterior
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(p.scalings).tobytes())
        h.update(np.ascontiguousarray(p.train_x).tobytes())
        mh = hashlib.sha256()
        for key, v in leaf_items(self.model):
            mh.update(key.encode())
            mh.update(np.ascontiguousarray(
                v.detach().cpu().numpy()).tobytes())
        return {
            "version": _FACTOR_CACHE_VERSION,
            "n": p.n,
            "block": int(block),
            "batch_size": int(self.batch_size),
            "n_devices": int(n_devices),
            "posterior_sha256": h.hexdigest(),
            "model_sha256": mh.hexdigest(),
            "settings_snapshot": repr(settings.snapshot()),
        }

    def _cache_state(self, path, block: int, n_devices: int):
        """None when no cache is at ``path``, True when it matches, else
        the error that refuses it."""
        meta_p = os.path.join(path, "meta.json")
        if not os.path.exists(meta_p):
            return None
        with open(meta_p) as fh:
            meta = json.load(fh)
        want = self._cache_meta(block, n_devices)
        if meta != want:
            bad = [k for k in want if meta.get(k) != want[k]]
            return (f"factor cache at {path} does not match this posterior/"
                    f"geometry (mismatched: {bad}); delete it or pass the "
                    f"matching block/batch_size/mesh")
        return True

    def _try_load_factor_cache(self, path, block: int, mesh=None) -> bool:
        """Load a factor cache; False if absent.  Raises on a present but
        mismatched one.  With ``mesh`` rank 0's verdict holds on every
        rank, and each rank reads only its rows."""
        import torch

        from .parallel.chol_dist import CardFactor, ShardedFactor
        from .parallel.mesh import agree

        state = None
        if mesh is None or mesh.rank == 0:
            state = self._cache_state(path, block,
                                      1 if mesh is None else mesh.size)
        if mesh is not None:
            state = agree(state, mesh)
        if state is None:
            return False
        if state is not True:
            raise ValueError(state)
        p = self.posterior
        if mesh is None:
            f = CardFactor(p.n, block, pad_to=self.batch_size,
                           device=self.device)
        else:
            f = ShardedFactor(mesh, p.n, block, pad_to=self.batch_size)
        l_mm = np.lib.format.open_memmap(os.path.join(path, "l.npy"),
                                         mode="r")
        if l_mm.shape != (f.n_pad, f.n_pad):
            raise ValueError(f"factor cache shape {l_mm.shape} != computed "
                             f"n_pad {f.n_pad}")
        l = f._upload_rows(lambda r0, r1: l_mm[r0:r1])
        # the diagonal blocks the solves use are the stored diag stack
        diags = torch.from_numpy(np.load(os.path.join(path, "diags.npy"))
                                 ).to(f.device)
        if mesh is None:
            bs = f.block
            for kb in range(f.n_pad // bs):
                l[kb * bs:(kb + 1) * bs, kb * bs:(kb + 1) * bs] = \
                    torch.tril(diags[kb])
            f.l = l
        else:
            f.l_loc, f.diags = l, diags
        self._factor = f
        x_all = torch.as_tensor(np.asarray(p.train_x, np.float32),
                                device=f.device).contiguous()
        s_dev = torch.as_tensor(np.asarray(p.scalings, np.float32),
                                device=f.device)
        self._var_ctx = (x_all, s_dev, settings.snapshot())
        return True

    def _write_factor_cache(self, path) -> None:
        """Persist the live factor: the [n_pad, n_pad] lower triangle
        copied to a memmapped .npy in bounded row blocks (never a second
        whole host copy), the diagonal-block stack, and the identity
        metadata.  A sharded factor's rank 0 creates ``l.npy``, each rank
        writes its rows, and rank 0 writes ``meta.json`` last, once every
        rank is done."""
        from .parallel.mesh import barrier

        f = self._factor
        mesh = getattr(f, "mesh", None)
        root = mesh is None or mesh.rank == 0
        l_p = os.path.join(path, "l.npy")
        if root:
            os.makedirs(path, exist_ok=True)
            np.lib.format.open_memmap(l_p, mode="w+", dtype=np.float32,
                                      shape=(f.n_pad, f.n_pad))
        if mesh is None:
            l, r0, r1 = f.l, 0, f.n_pad
        else:
            barrier(mesh)
            l, r0, r1 = f.l_loc, f.r0, f.r1
        l_mm = np.lib.format.open_memmap(l_p, mode="r+")
        for a in range(r0, r1, 4096):
            b = min(a + 4096, r1)
            l_mm[a:b] = l[a - r0:b - r0].cpu().numpy()
        l_mm.flush()
        del l_mm
        if mesh is not None:
            barrier(mesh)
        if root:
            np.save(os.path.join(path, "diags.npy"),
                    f.diag_blocks().cpu().numpy())
            meta = self._cache_meta(f.block, 1 if mesh is None
                                    else mesh.size)
            with open(os.path.join(path, "meta.json"), "w") as fh:
                json.dump(meta, fh)
        if mesh is not None:
            barrier(mesh)

    def variances(self, z) -> np.ndarray:
        """GP posterior variances ``k_zz - k_zx (K + jr I)^-1 k_xz``
        through the rebuilt factor, per bounded query block (float64
        oracle: ``ops.solve.predictive_variance``; float32 accumulation
        floor ~eps32 * k_zz).  Empty-split safe."""
        from .parallel.device_large import variances_from_factor

        if self._factor is None:
            raise RuntimeError("call prepare_variances() once before "
                               "variances()")
        x_all, s_dev, snap = self._var_ctx
        return variances_from_factor(
            self._factor, self.model, x_all, s_dev,
            np.asarray(z, np.float32), self.batch_size, self.posterior.n,
            snap)
