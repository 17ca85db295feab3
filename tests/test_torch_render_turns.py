"""The host side of the forward kernel's measurements, on the CPU:
render_turns.py's checkout check, chip_smoke.ptxas_report on the kernel's
two-argument template names, and chip_smoke.trace_bound's environment
mode with the escapes it counts (chip_smoke.escaped_samples)."""

import os
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
try:
    import chip_smoke
    import render_turns
finally:
    sys.path.remove(REPO)

from tpt_torch import CameraConfig, demo_scene
from tpt_torch.camera import camera_matrices
from tpt_torch.kernels import trace as K


def test_render_turns_refuses_a_checkout_without_the_port(tmp_path):
    with pytest.raises(SystemExit) as exc:
        render_turns.main([str(tmp_path)])
    assert exc.value.code == 2


def test_ptxas_report_names_each_instantiation():
    log = "".join(
        f"ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124trace_progressive_"
        f"kernelIL{a}EL{b}EEEvPKfS2_' for 'sm_90a'\n"
        f"    {k * 8} bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        f"ptxas info    : Used {64 + k} registers, used 1 barriers\n"
        for k, (a, b) in enumerate((("b0", "b0"), ("b1", "b0"), ("b0", "b1"))))
    log += ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_124probe_elementwise_"
            "kernelILi1EEEvPKfS2_lPf' for 'sm_90a'\nptxas info    : Used 16 registers\n")
    report = chip_smoke.ptxas_report(log)
    assert list(report) == ["trace_progressive_kernel<false,false>",
                            "trace_progressive_kernel<true,false>",
                            "trace_progressive_kernel<false,true>", "probe_elementwise_kernel<1>"]
    assert report["trace_progressive_kernel<false,true>"] == (
        "66 registers, 0/0 bytes spill stores/loads, 16 bytes stack")


def test_trace_bound_of_the_environment_mode():
    """The environment mode writes no slots, reads the table once and adds
    OPS_ENV for each escape."""
    counts, segments, samples, pixels, escapes = (48, 7), 1000, 400, 100, 150
    env_bytes = 6 * 258 ** 2 * 48
    slots_ms, _ = chip_smoke.trace_bound(segments, samples, pixels, 4, counts)
    env_ms, by = chip_smoke.trace_bound(segments, samples, pixels, 0, counts,
                                        env_bytes=env_bytes, escapes=escapes)
    ops = segments * (24 * 48 + 27 * 7 + 110) + samples * 80 + escapes * chip_smoke.OPS_ENV
    nbytes = chip_smoke.scene_bytes(counts, False) + pixels * 24 + env_bytes
    assert env_ms == max(ops / 67e12, nbytes / 3.35e12) * 1e3
    assert by == ("operations" if ops / 67e12 > nbytes / 3.35e12 else "bytes")
    assert slots_ms != env_ms


def test_escaped_samples_counts_the_slots_with_a_direction():
    miss_dir = torch.zeros(3, 3, 2, 2)
    miss_dir[0, :, 0, 0] = torch.tensor([0.0, 0.0, -1.0])
    miss_dir[2, :, 1, 0] = torch.tensor([0.6, 0.0, 0.8])
    miss_dir[2, :, 1, 1] = torch.tensor([0.0, 1.0, 0.0])
    assert chip_smoke.escaped_samples(miss_dir) == 3


def test_a_slot_holds_a_unit_direction_exactly_when_its_path_escaped():
    """escaped_samples' premise on the plain slot mode: an escape stores its
    unit direction and throughput, every other end and the masked frame
    leave the slot zero."""
    torch.set_num_threads(1)
    cam = CameraConfig()
    ip, iv, _ = camera_matrices(cam, 24, 16)
    res = K.trace_progressive(demo_scene().build(), ip, iv, 3, cam.focal_length,
                              cam.aperture_diameter, width=24, height=16, ray_depth=13, spp=2,
                              n_frames=3, n_valid=2)
    escaped = res.miss_dir.ne(0).any(dim=1)
    n = chip_smoke.escaped_samples(res.miss_dir)
    assert n == int(escaped.sum()) and 0 < n < 2 * 2 * 24 * 16
    assert not escaped[4:].any()
    norm = res.miss_dir.norm(dim=1)
    assert torch.allclose(norm[escaped], torch.ones(n), atol=1e-5)
    assert (res.miss_thr.ne(0).any(dim=1) == escaped).all()
