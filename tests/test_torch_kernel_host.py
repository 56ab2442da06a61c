"""The fused kernel's CUDA source, built as plain C++, against its plain
PyTorch version.

``csrc/fused_evaluate_assemble.cu`` keeps its per-slot arithmetic (the
hand-derived Jacobians), the row prologue and the row write-out
``__host__ __device__``; without ``__CUDACC__`` it compiles to a
sequential loop that fills the same seven outputs.  Here ``g++`` builds
it into a temporary directory and ``kernels.fused._run`` calls it on CPU
tensors: every ``chip_smoke.fixtures()`` problem in float64 must match
``fused_evaluate_assemble_reference`` at rtol = atol = 1e-9, and so must
the flagship with pose_b == pose_a on part of its slots (the route where
J_b joins J_a).  The warp reductions and the shared-memory tile exist
only in the CUDA build and are checked on a card
(tests/test_torch_kernel_gpu.py).
"""
import ctypes
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from rsba_tpu_torch.kernels import build, fused
from rsba_tpu_torch.problem import synthetic

FIXTURES = ["rs_slerp_huber", "rs_nlerp", "gs_distortion",
            "flagship_slerp_dist_huber", "rs_lerp_aa_cauchy",
            "rs_slerp_soft_l1"]
CASES = [(n, False) for n in FIXTURES] + [("flagship_slerp_dist_huber", True)]


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel source as C++")
    out = tmp_path_factory.mktemp("fused_host") / "libfused_host.so"
    src = build.CSRC_DIR / "fused_evaluate_assemble.cu"
    proc = subprocess.run(
        [gxx, "-x", "c++", "-O1", "-shared", "-fPIC", "-o", str(out),
         str(src)], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    return ctypes.CDLL(str(out))


def test_cases_cover_chip_smoke_fixtures():
    assert FIXTURES == list(chip_smoke.fixtures())


@pytest.mark.parametrize("name,same_pose", CASES,
                         ids=[n + ("+same_pose" if s else "")
                              for n, s in CASES])
def test_host_build_matches_plain_version(host_lib, name, same_pose):
    ba = synthetic.make_ba_problem(dtype=torch.float64, device="cpu",
                                   **chip_smoke.fixtures()[name])
    _, _, _, inp = chip_smoke.kernel_inputs(ba)
    if same_pose:
        inp = chip_smoke.same_pose_on_some_slots(inp)
        assert float(inp[7].min()) == 0.0 and float(inp[7].max()) == 1.0
    model, loss = ba.problem.model, ba.problem.loss
    ref = fused.fused_evaluate_assemble_reference(*inp, model=model,
                                                  loss=loss)
    out = fused._run(host_lib, 0, *inp, model, loss)
    assert set(out) == set(ref)
    for k, want in ref.items():
        assert torch.isfinite(out[k]).all(), k
        torch.testing.assert_close(out[k], want, rtol=1e-9, atol=1e-9,
                                   msg=lambda m, k=k: f"{k}: {m}")
