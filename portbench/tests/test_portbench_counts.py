"""portbench.counts, the frozen work counts, against chip_smoke.py's
(which the count was copied from) for the same arguments."""

import pytest

import chip_smoke
from portbench import counts

CASES = [
    # segments, samples, pixels, slots, counts, table, env_bytes, escapes
    (44_000_000, 16_588_800, 2_073_600, 0, (48, 7), False, 19_219_200, 11_000_000),
    (3_100_000, 692_224, 692_224, 1, (48, 7), False, None, 0),
    (5_000, 1_000, 1_000, 2, (4, 1), True, None, 0),
    (0, 0, 1, 0, (0, 0), False, 48, 0),
]


@pytest.mark.parametrize("case", CASES)
def test_trace_bound_is_chip_smokes(case):
    seg, samples, pixels, slots, c, table, env_bytes, escapes = case
    assert counts.trace_bound(seg, samples, pixels, slots, c, table=table, env_bytes=env_bytes,
                              escapes=escapes) == chip_smoke.trace_bound(
        seg, samples, pixels, slots, c, table=table, env_bytes=env_bytes, escapes=escapes)


@pytest.mark.parametrize("case", [(2_000_000, 262_144, 262_144, 1, (48, 7)),
                                  (16_000_000, 2_073_600, 2_073_600, 1, (48, 7)),
                                  (100, 10, 10, 3, (1, 0))])
def test_grad_kernel_bounds_are_chip_smokes(case):
    assert counts.grad_kernel_bounds(*case) == chip_smoke.grad_kernel_bounds(*case)


def test_peaks_and_operation_counts_are_chip_smokes():
    names = ("PEAK_FP32_FLOPS", "PEAK_BYTES_PER_S", "OPS_SPHERE", "OPS_CUBOID", "OPS_BOUNCE",
             "OPS_CAMERA", "ADJOINT", "OPS_ENV")
    assert {n: getattr(counts, n) for n in names} == {n: getattr(chip_smoke, n) for n in names}
    assert counts.bound(1e9, 1e3) == chip_smoke.bound(1e9, 1e3)
    assert counts.bound(1.0, 1e9)[1] == "bytes"
