"""The frozen counts: K1-K4's operations equal `chip_smoke.flops_of`'s at
B=4096, N=50, and their bytes the documented shapes' (the bounds of the
port's kernel table)."""

import pytest

import counts

K = ("prep_condense2", "kkt_sweep_c2", "corrector_sweep_c2", "expand2")


@pytest.mark.parametrize("kernel", K)
def test_operations_match_chip_smoke(kernel):
    import chip_smoke
    assert counts.flops(kernel, 4096, 50) == chip_smoke.flops_of(
        kernel, 4096, 50)


@pytest.mark.parametrize("kernel,bound_ms", [
    ("prep_condense2", 0.107), ("kkt_sweep_c2", 0.090),
    ("corrector_sweep_c2", 0.059), ("expand2", 0.032)])
def test_bounds_match_the_kernel_table(kernel, bound_ms):
    assert counts.roofline_s(kernel, 4096, 50) * 1e3 == pytest.approx(
        bound_ms, abs=6e-4)


def test_tick_operations():
    # about 5.9 M operations a lane a tick at N=50 and 8 iterations
    per_lane = counts.tick_flops(1, 50, 8)
    assert 5.8e6 < per_lane < 6.1e6
    assert counts.tick_flops(8192, 50, 8) == pytest.approx(8192 * per_lane)
