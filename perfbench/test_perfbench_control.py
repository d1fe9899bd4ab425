"""The check that decides ``correct`` must fail wrong output.

On the CPU, at a small configuration, a run of each traffic kind drives
the whole cell (program, traffic, reference, comparison) with the timed
path broken underneath by each fault the cell can have, and ``correct``
comes out false; the same run unbroken comes out true.  On the card
(``cuda`` marker), the control, the program with its lower-precision
paths switched on (int8 vocoder, TF32), at the cell's own size, comes out
false on three seeds."""

import pytest

from perfbench import harness
from perfbench.test_perfbench_harness import small_run


def correct(out) -> bool:
    return out.failed == 0 and all(v <= lim for v, lim in
                                   out.checks.values())


@pytest.mark.parametrize("cell", ["wg512-offline-b32",
                                  "wg512-serve-poisson"])
def test_an_unbroken_small_run_is_correct(cell):
    assert correct(small_run(cell))


@pytest.mark.parametrize("cell", ["wg512-offline-b32",
                                  "wg512-serve-poisson"])
@pytest.mark.parametrize("fault", ["answer", "state"])
def test_a_broken_inference_run_is_not_correct(cell, fault):
    assert not correct(small_run(cell, fault=fault))


def test_an_unbroken_small_training_run_is_correct():
    assert correct(small_run("wg512-train-dp4"))


@pytest.mark.parametrize("fault", ["train_state", "half_batch",
                                   "no_exchange", "gradient"])
def test_a_broken_training_run_is_not_correct(fault):
    assert not correct(small_run("wg512-train-dp4", fault=fault))


@pytest.fixture
def cards():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    harness.set_cache_dirs()
    return torch.cuda.device_count()


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["wg512-offline-b32",
                                  "wg512-serve-poisson",
                                  "wg512-train-dp4"])
@pytest.mark.parametrize("seed", [4000000011, 4000000012, 4000000013])
def test_the_control_is_not_correct_on_the_card(cards, cell, seed):
    import time

    c, cfg = harness.load_cell(cell)
    if cards < c["chips"]:
        pytest.skip(f"needs {c['chips']} cards")
    ctx = harness.Context(cell, c, cfg, seed, 8.0, False,
                          time.perf_counter(), control=True)
    assert not correct(harness.run_cell(ctx))
