"""The CUDA fused evaluate+assemble kernel against its plain version.

Needs a card (``gpu`` marker; skipped without one).  The fixtures are
``chip_smoke.fixtures()``: one small problem per kernel specialisation.
Float64 must agree at rtol = atol = 1e-9; float32 within 1e-4·max|ref|
per output, since the kernel's warp reductions sum in another order than
the plain version.  Also on the card: the chunked route (rows wider than
one shared-memory tile), pose_b == pose_a on part of the slots, and equal
bits from two launches.  The file imports neither jax nor rsba_tpu, so it
also runs on a machine without them (from the repo root):

    python -m pytest --noconftest -o addopts= tests/test_torch_kernel_gpu.py
"""
import pytest
import torch

import chip_smoke
from rsba_tpu_torch.problem import synthetic

FIXTURES = ["rs_slerp_huber", "rs_nlerp", "gs_distortion",
            "flagship_slerp_dist_huber", "rs_lerp_aa_cauchy",
            "rs_slerp_soft_l1"]


def test_fixture_names_match_chip_smoke():
    assert FIXTURES == list(chip_smoke.fixtures())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
@pytest.mark.parametrize("name", FIXTURES)
def test_cuda_kernel_matches_plain_version(name, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.make_ba_problem(dtype=dtype, device="cuda",
                                   **chip_smoke.fixtures()[name])
    if dtype == torch.float64:
        chip_smoke.compare(name, ba, rtol=1e-9, atol=1e-9)
    else:
        chip_smoke.compare(name, ba, rel_to_max=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["chunked", "same_pose"])
def test_cuda_kernel_routes(route):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    if route == "chunked":
        ba = synthetic.make_ba_problem(dtype=torch.float64, device="cuda",
                                       **chip_smoke.chunked_fixture())
        chip_smoke.compare(route, ba, rtol=1e-9, atol=1e-9)
    else:
        ba = synthetic.make_ba_problem(
            dtype=torch.float64, device="cuda",
            **chip_smoke.fixtures()["flagship_slerp_dist_huber"])
        chip_smoke.compare(route, ba, rtol=1e-9, atol=1e-9,
                           edit=chip_smoke.same_pose_on_some_slots)


@pytest.mark.gpu
def test_two_launches_give_equal_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    ba = synthetic.make_ba_problem(
        dtype=torch.float32, device="cuda",
        **chip_smoke.fixtures()["flagship_slerp_dist_huber"])
    chip_smoke.check_equal_bits(ba)
