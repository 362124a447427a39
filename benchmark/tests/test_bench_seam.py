"""The covariance recursion a configuration names: the present cells take
their tree, counts, model and reference from the diagonal one, and the
work each cell's calls are counted at holds to the last bit the values
it read before the recursion had a module of its own."""

import pytest
import torch

from benchmark import arch, harness, peaks, program, recursions
from benchmark.recursions import diagonal
from benchmark.reference import nngp

from conftest import SEED, spec_with_x4

# (operations, bound seconds, entries) of one call at each cell's own
# sizes, as ``arch.gram_work`` / ``arch.fit_step_work`` counted them
WORK = {
    "convnet_gp.gram_card": (39027397378048, 0.5824984683291162,
                             135266304),
    # at its tile of 400 (200 before: 17314993178624, 0.2584327340093143,
    # 34372864, as test_bench_counts still holds)
    "resnet32.gram_card": (17717969178624, 0.2644473011734925, 35172864),
    "convnet_gp.gram_card_x4": (87583765585920, 1.3072203818795005,
                                303562752),
    # four exact steps a call
    "convnet_gp.fit_exact": (8288596156416, 0.12371039039426864, 9437184),
}
FIT_STEP = (2072149039104, 0.03092759759856716, 2359296)


def _driver(cell):
    c = harness.load_cell(cell, spec_with_x4())
    group = harness.Group(0, 1, torch.device("cpu"))
    return c, harness.driver(c["mix"]["driver"]).Driver(c, SEED, group)


@pytest.mark.parametrize("cell", sorted(WORK))
def test_the_work_of_a_call_is_the_recorded_one(cell):
    c, drv = _driver(cell)
    w = drv.work_per_call()
    assert (w.ops, w.bound_s, w.entries) == WORK[cell]
    if c["mix"]["driver"] == "fit":
        s = c["cfg"]["recursion"].fit_step_work(
            drv.tree, drv.shape, drv.n, drv.b, peaks)
        assert (s.ops, s.bound_s, s.entries) == FIT_STEP


@pytest.mark.parametrize("name", sorted({c.split(".")[0] for c in WORK}))
def test_the_present_configurations_take_the_diagonal(name):
    cfg = arch.load_config(name)
    assert cfg["recursion"] is diagonal
    assert cfg["tree"] == arch.parse(cfg["model"])


def test_the_diagonal_binds_the_modules_that_held_it():
    assert diagonal.parse is arch.parse
    assert diagonal.gram_work is arch.gram_work
    assert diagonal.fit_step_work is arch.fit_step_work
    assert diagonal.build_model is program.build_model
    assert diagonal.entries is nngp.entries
    assert diagonal.block is nngp.block
    recursions.require_fit(diagonal)


def test_a_recursion_name_is_an_identifier():
    with pytest.raises(ValueError, match="identifier"):
        recursions.load("../arch")
    with pytest.raises(FileNotFoundError, match="no_such_recursion.py"):
        recursions.load("no_such_recursion")
