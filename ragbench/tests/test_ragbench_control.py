"""The control, the reference one precision below the configuration's (TF32
for the fp32 scores) put in the program's place, must come out not
correct: at a tiny size on the CPU, and at the cell's own size on the
card (``-m cuda``), where the program on the same seeds comes out
correct."""
import pytest

from ragbench import run as R
from ragbench.cell import load_cell, manifest

CELLS = [w["name"] for w in manifest()["workloads"]]


def fails(ctl, limits):
    return [k for k, lim in limits.items()
            if k in ctl and lim["limit"] is not None and ctl[k] > lim["limit"]]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_a_limit_at_a_tiny_size(name):
    cell = load_cell(name, tiny=True)
    _, ctl = R.run(cell, 2 ** 31 + 3, 1.5, False, device="cpu",
                   control=True)
    assert fails(ctl, cell.limits), ctl


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_where_the_program_passes_on_the_card(card, name):
    cell = load_cell(name)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        out, ctl = R.run(cell, seed, 8.0, False, device="cuda",
                         control=True)
        assert out["correct"], out["checks"]
        assert fails(ctl, cell.limits), ctl
