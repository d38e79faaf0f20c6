"""On the card (marker `cuda`; skips without one): each cell at a reduced
size gives a correct run whose line names the card, and the control put
in the program's place does not.  On the chip:
`python -m pytest benchmark/tests/test_bench_cuda.py -m cuda -q`."""

import pytest

import control
import run

SMALL = {
    "cf21_mc.hover_b32768": dict(lanes=1024, warmup_ticks=6),
    "cf21_swarm_certified.serve_b256": dict(chunk_ticks=10),
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_on_the_card(cuda, cell):
    import torch
    out = run.run_cell(run.cell_plan(cell), 2**31 + 11, 1.0, False, "cuda",
                       overrides=SMALL[cell])
    assert out["correct"] is True, out["checks"]
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    [(_, correct, checks)] = control.readings(
        run.cell_plan(cell), [13], 1.0, "control", "cuda",
        overrides=SMALL[cell])
    assert correct is False, checks
