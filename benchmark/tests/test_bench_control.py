"""The controls: the reference one precision below the configuration's,
put in the program's place, comes out not correct.  At the tiny size on
the CPU here; ``test_control_on_card`` runs the cells' own sizes on the
chip (``python3 -m pytest benchmark/tests -m cuda``)."""

import pytest
import torch

from benchmark import control, harness
from benchmark.tests.tiny import ROOT, tiny_root

SEEDS = (2 ** 31 + 3, 5)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(4)
    return tiny_root(tmp_path_factory.mktemp("control"))


@pytest.mark.parametrize("seed", SEEDS)
def test_serve_control_fails(root, seed):
    cell = harness.Cell("vgl-serve-c1", root)
    out = control.serve_control(cell, seed, 1, torch.device("cpu"))
    limit = cell.config["limits"]["frame_rmse"]
    assert out["control"] > limit and out["altered"] > limit


@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_runs(root, seed):
    """At the tiny size the control's gaps are small (one layer a block,
    widths of 32-64); that it fails the limits is read at the cell's size on
    the card (``test_control_on_card``).  The planted faults fail here too."""
    cell = harness.Cell("vl-train-b1", root)
    out = control.train_control(cell, seed, torch.device("cpu"))
    limits = cell.config["limits"]
    assert all(0 < v < float("inf") for v in out["control"].values()), out["control"]
    assert out["unchanged"]["change_gap"] > limits["change_gap"]
    assert out["altered"]["loss_gap"] > limits["loss_gap"]


@pytest.mark.cuda
def test_control_on_card(card):
    """The served clip's control at the cell's size.  The VL step's control
    fails its limits on half the seeds read so far (PERF.md, open question)."""
    cell = harness.Cell("vgl-serve-c1", ROOT)
    assert control.serve_control(cell, SEEDS[0], 1, card)["control"] > \
        cell.config["limits"]["frame_rmse"]
