"""A run with the timed path broken underneath comes out not correct, one
run for each fault a serving cell can have, on the CPU at a small size
with the kernels' plain versions (the look for a card is skipped); the
same run unbroken comes out correct under the same limits: an answer
altered where it is produced (each detection of a request's first frame
names the class the program ranks last at its box), and half of the batch
left out (the network runs the first half and its heads stand in for the
rest). One card, so no exchange between chips to leave out; no cell
trains."""

import pytest
import torch

from port_bench import faults
from port_bench.tests._small import SERVE_CELLS, SIZES, run_small, small_cell


SERVE_FAULTS = {"none": None, **faults.SERVING}


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
@pytest.mark.parametrize("name", SERVE_CELLS)
def test_serving_fault_is_not_correct(name, fault, monkeypatch):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    if SERVE_FAULTS[fault]:
        SERVE_FAULTS[fault](monkeypatch.setattr)
    checks, numbers = run_small(small_cell(name, img_size=SIZES[name]))
    ok = all(c["ok"] for c in checks.values())
    assert ok == (fault == "none"), numbers
