"""Each fault a cell can have, planted in the program underneath a whole
run (the card's look skipped, the CPU at a small size), makes
``correct`` come out false; the control, the reference one precision
below in the program's place, reads above every cell's limits."""

from unittest import mock

import pytest
import torch

from benchmark import control, harness

from conftest import SEED, cells, small, spec_with_x4


def _tile_bodies():
    import cnn_gp_tpu_torch.parallel.device_pipeline as dp
    import cnn_gp_tpu_torch.parallel.gram as gram
    return [(dp, dp._tile_body), (gram, gram._tile_body)]


def unchanged(drv):
    """The call returns its output as it found it: gram_device's an
    unwritten (zero) Gram, the sharded entry's host out untouched."""
    import cnn_gp_tpu_torch.parallel.device_pipeline as dp
    import cnn_gp_tpu_torch.parallel.gram_sharded as gs
    mock.patch.object(dp, "gram_device", lambda model, x, **kw: torch.zeros(
        (len(x), len(x)))).start()
    mock.patch.object(gs, "compute_gram_sharded",
                      lambda model, x, out=None, **kw: out).start()


def half_left_out(drv):
    """Every other tile of the grid left out (zero)."""
    for mod, real in _tile_bodies():
        def body(model, spec, x_all, z_all, i0, j0, b, *a, real=real):
            blk = real(model, spec, x_all, z_all, i0, j0, b, *a)
            return blk if (i0 // b + j0 // b) % 2 == 0 else blk * 0
        mock.patch.object(mod, "_tile_body", body).start()


def altered(drv):
    """One answer of every tile altered by 1e-4 where it is produced."""
    for mod, real in _tile_bodies():
        def body(*a, real=real):
            blk = real(*a).clone()
            if blk.shape[0] > 1 and blk.shape[1] > 2:
                blk[1, 2] *= 1 + 1e-4
            return blk
        mock.patch.object(mod, "_tile_body", body).start()


def no_exchange(drv):
    """The all_gather left out: each rank keeps only its own blocks."""
    import torch.distributed as dist

    def gather(tensors, tensor, group=None, async_op=False):
        for t in tensors:
            t.zero_()
        tensors[dist.get_rank(group)].copy_(tensor)
    mock.patch.object(dist, "all_gather", gather).start()


def adam_unchanged(drv):
    """An optimiser step that leaves the leaves as they were."""
    mock.patch.object(torch.optim.Adam, "step",
                      lambda self, closure=None: None).start()


def half_batch(drv):
    """Half of the training set left out, the loss and gradient of the
    rest scaled to the whole."""
    from cnn_gp_tpu_torch import fit_lib
    real = fit_lib.nmll_value_and_grad_tiled

    def vg(model, x, y, *a, **kw):
        h = len(x) // 2
        loss, g = real(model, x[:h], y[:h], *a, **kw)
        return 2 * loss, {k: 2 * v for k, v in g.items()}
    mock.patch.object(fit_lib, "nmll_value_and_grad_tiled", vg).start()


def loss_altered(drv):
    """The loss altered by 1% where it is produced."""
    from cnn_gp_tpu_torch import fit_lib
    real = fit_lib.nmll_value_and_grad_tiled

    def vg(*a, **kw):
        loss, g = real(*a, **kw)
        return loss * 1.01, g
    mock.patch.object(fit_lib, "nmll_value_and_grad_tiled", vg).start()


# the faults each driver's cells can have, and those of a cell on
# several ranks besides
FAULTS = {"gram": (unchanged, half_left_out, altered),
          "fit": (adam_unchanged, half_batch, loss_altered)}
ACROSS_RANKS = {"gram": (no_exchange,)}


def _cases():
    spec = spec_with_x4()
    out = []
    for c in cells():
        cell = harness.load_cell(c, spec)
        kind = cell["mix"]["driver"]
        faults = FAULTS[kind] + (ACROSS_RANKS.get(kind, ())
                                 if int(cell["chips"]) > 1 else ())
        out += [(c, f) for f in faults]
    return out


CASES = _cases()


@pytest.mark.parametrize("cell, fault", CASES,
                         ids=[f"{c}-{f.__name__}" for c, f in CASES])
def test_a_fault_makes_the_run_incorrect(cell, fault):
    spec = spec_with_x4()
    try:
        run = harness.run_world(cell, SEED, 0.2, False, device="cpu",
                                overrides=small(cell), faults=fault,
                                spec=spec)
    finally:
        mock.patch.stopall()
    line = harness.result_line(spec, run, False, "cpu")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] >= 1


@pytest.mark.parametrize("cell", cells())
def test_the_sound_run_is_correct(cell):
    spec = spec_with_x4()
    run = harness.run_world(cell, SEED + 1, 0.2, False, device="cpu",
                            overrides=small(cell), spec=spec)
    line = harness.result_line(spec, run, False, "cpu")
    assert line["correct"] is True, line["checks"]


@pytest.mark.parametrize("cell", cells("gram"))
def test_the_control_fails_the_limits(cell):
    """The reference in TF32 in the program's place reads above the cell's
    limit; a Gram entry's error does not grow with the cell's size."""
    limits = harness.load_cell(cell, spec_with_x4())["sizes"]["limits"]
    numbers = control.readings(cell, SEED, "cpu", small(cell),
                               spec_with_x4())["control"]
    assert numbers["gram_rel_err"] > limits["gram_rel_err"], numbers


@pytest.mark.parametrize("cell", cells("fit"))
def test_the_fit_control_stands_apart_at_a_small_size(cell):
    """A fit's TF32 errors grow with N (the Gram's conditioning), so at a
    test's size the control reads under the cell's limits, which were set
    at its own size; it still reads far above the sound run there, and
    each planted fault reads above a limit."""
    spec = spec_with_x4()
    limits = harness.load_cell(cell, spec)["sizes"]["limits"]
    run = harness.run_world(cell, SEED, 0.2, False, device="cpu",
                            overrides=small(cell), spec=spec)
    sound = {k: c["value"] for k, c in run["checks"].items()}
    got = control.readings(cell, SEED, "cpu", small(cell), spec)
    assert got["control"]["loss_gap"] > 10 * sound["loss_gap"]
    assert got["control"]["grad_gap"] > 10 * sound["grad_gap"]
    for fault in ("half_batch", "altered"):
        assert got[fault]["loss_gap"] > limits["loss_gap"], got[fault]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells("fit"))
def test_the_fit_control_fails_the_limits_at_the_cells_size(cell):
    """On the card, at the cell's own size: the control fails a limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    limits = harness.load_cell(cell)["sizes"]["limits"]
    got = control.readings(cell, SEED, torch.device("cuda"))
    for name, numbers in got.items():
        assert any(numbers[k] > limits[k] for k in numbers), (name, numbers)
