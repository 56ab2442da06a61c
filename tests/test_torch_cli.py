"""The port's CLI runner, ``python -m rsba_tpu_torch.cli.run``.

``main`` is called in-process with ``--device cpu``: a config preset with
JSONL, PLY and the full report, the in-repo BAL sample, a video preset
through the banded engine, a checkpointed run resumed from its directory
(the history continues), ``--check-gradients``, ``--debug-nans``,
``--profile-dir``, the sharded runs (``--shard`` on one CPU rank, its
fallback to the flat solver, its PLY, and ``--multihost`` over two
processes), and the default device, which is the card.  One
subprocess covers the console entry's argument errors, and one the
package boundary: importing every module of the port loads neither
``jax`` nor ``orbax`` nor ``rsba_tpu``.
"""
import json
import os
import pathlib
import pkgutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import rsba_tpu_torch
from rsba_tpu_torch.cli import run as cli_run

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = str(pathlib.Path(REPO) / "benchmarks" / "data" / "bal_ring12.txt.gz")


def run_main(capsys, *argv) -> tuple:
    rc = cli_run.main(["--device", "cpu", *argv])
    return rc, capsys.readouterr().out


def last_json(stdout: str) -> dict:
    for line in reversed(stdout.strip().splitlines()):
        if line.startswith("{"):
            return json.loads(line)
    raise AssertionError(f"no JSON line in output:\n{stdout}")


def test_cli_gs_small(tmp_path, capsys):
    jsonl = tmp_path / "iters.jsonl"
    ply = tmp_path / "cloud.ply"
    rc, out = run_main(
        capsys, "--config=gs_small", "--scale=0.05", "--max-iterations=15",
        f"--jsonl={jsonl}", f"--ply={ply}", "--full-report",
        "--check-gradients")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
    assert rec["final_rmse_px"] < 0.8
    assert (rec["solver"], rec["evaluator"], rec["dtype"], rec["device"]) \
        == ("dense", "torch-flat+device_loop", "f64", "cpu")
    assert set(rec) >= {"problem", "final_cost", "final_rmse_inlier_px",
                        "iterations", "wall_s"}
    assert "Solver Report" in out
    records = [json.loads(x) for x in jsonl.read_text().splitlines()]
    assert len(records) == rec["iterations"] >= 1
    lines = ply.read_text().splitlines()
    assert lines[0] == "ply" and lines[2] == "element vertex 254"


def test_cli_video_preset_takes_the_banded_engine(capsys):
    rc, out = run_main(capsys, "--config=rs_video_linear", "--scale=0.02",
                       "--max-iterations=25", "--dtype=f32")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
    assert (rec["solver"], rec["evaluator"], rec["dtype"]) == (
        "banded_schur", "torch+device_loop", "f32")
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        cli_run.main(["--device", "cpu", "--config=rs_video_linear",
                      "--scale=0.02", "--evaluator=cuda"])


def test_cli_bal_file(capsys):
    rc, out = run_main(capsys, f"--bal={SAMPLE}", "--max-iterations=40")
    assert rc == 0, out[-2000:]
    rec = last_json(out)
    assert rec["problem"] == SAMPLE and rec["solver"] == "dense_schur"
    assert rec["termination"] == "CONVERGENCE"
    assert rec["final_rmse_inlier_px"] < 0.8
    assert "6000 observations, 12 poses, 500 points" in out


def test_cli_checkpoint_and_resume(tmp_path, capsys):
    ckpt = tmp_path / "ckpt"
    base = ["--config=gs_small", "--scale=0.05", f"--checkpoint-dir={ckpt}"]
    rc, out = run_main(capsys, *base, "--max-iterations=3",
                       f"--jsonl={tmp_path / 'first.jsonl'}")
    assert rc == 2 and last_json(out)["termination"] == "NO_CONVERGENCE"
    n1 = len((tmp_path / "first.jsonl").read_text().splitlines())
    assert (ckpt / "history.json").exists()
    rc, out = run_main(capsys, *base, "--resume",
                       f"--jsonl={tmp_path / 'all.jsonl'}")
    assert rc == 0, out[-2000:]
    assert f"resumed from checkpoint step {n1}" in out
    assert f"{n1} prior iteration records" in out
    its = [json.loads(x)["iteration"]
           for x in (tmp_path / "all.jsonl").read_text().splitlines()]
    assert its == list(range(len(its))) and len(its) > n1
    # --resume with nothing to resume from starts afresh
    rc, out = run_main(capsys, "--config=gs_small", "--scale=0.05",
                       f"--checkpoint-dir={tmp_path / 'empty'}", "--resume")
    assert rc == 0 and "resumed" not in out


def test_cli_debug_nans_and_profile(tmp_path, capsys):
    rc, out = run_main(capsys, "--config=gs_small", "--scale=0.05",
                       "--debug-nans", f"--profile-dir={tmp_path / 'prof'}")
    assert rc == 0, out[-2000:]
    assert last_json(out)["evaluator"] == "torch-flat"     # the host loop
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]
    # a non-finite cost raises at once
    from rsba_tpu_torch.problem import synthetic
    from rsba_tpu_torch.solver import SolverOptions, lm
    ba = synthetic.config1_gs_small(scale=0.05, device="cpu")
    fns = cli_run._raise_on_non_finite(lm.make_solver_fns(
        ba.problem, SolverOptions(linear_solver="dense")))
    assert "raw" not in fns
    bad = ba.params0.replace(points=ba.params0.points * float("nan"))
    with pytest.raises(FloatingPointError, match="non-finite cost"):
        fns["prepare"](bad)
    aux = fns["prepare"](ba.params0)
    fns["solve_step"](aux, 1e4)
    with pytest.raises(FloatingPointError, match="non-finite step"):
        fns["solve_step"](aux, float("nan"))


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def test_cli_multihost_two_processes():
    """tests/test_multihost.py's counterpart: two CPU processes over a
    localhost coordinator, one gloo world, the banded sharded engine; both
    ranks print the same final cost, rank 0 alone the report."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "rsba_tpu_torch.cli.run", "--device=cpu",
         "--config=rs_video_linear", "--scale=0.02", "--max-iterations=25",
         "--shard", "--multihost", f"--coordinator=localhost:{port}",
         "--num-processes=2", f"--process-id={i}"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="2"))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i}:\n{out[-3000:]}"
        assert f"multihost: process {i}/2" in out
    costs = [line.split("final cost ")[1] for out in outs
             for line in out.splitlines() if "final cost " in line]
    assert len(costs) == 2 and costs[0] == costs[1], costs
    rec = last_json(outs[0])
    assert (rec["solver"], rec["evaluator"], rec["termination"]) == (
        "banded_schur", "torch-sharded", "CONVERGENCE")
    assert "{" not in outs[1]                    # rank 1 prints no record


def test_cli_shard_on_the_cpu_takes_one_rank(capsys):
    rc, out = run_main(capsys, "--config=rs_video_linear", "--scale=0.02",
                       "--max-iterations=25", "--shard")
    assert rc == 0, out[-2000:]
    assert "[sharded over 1 ranks, gloo]" in out
    assert "rank 0 of 1: final cost" in out
    rec = last_json(out)
    assert rec["termination"] == "CONVERGENCE"
    assert (rec["solver"], rec["evaluator"]) == ("banded_schur",
                                                 "torch-sharded")
    assert rec["final_rmse_inlier_px"] < 0.8


def test_cli_shard_falls_back_to_the_flat_solver(capsys):
    """gs_bal's optimizable intrinsics have no window layout: ``auto``
    falls back to the flat landmark-sharded iterative_schur, as in the
    reference."""
    rc, out = run_main(capsys, "--config=gs_bal", "--scale=0.04",
                       "--linear-solver=auto", "--shard")
    assert rc == 0, out[-2000:]
    assert "window layout unavailable" in out
    rec = last_json(out)
    assert (rec["solver"], rec["evaluator"], rec["termination"]) == (
        "iterative_schur", "torch-flat-sharded", "CONVERGENCE")


@pytest.mark.parametrize("argv", [
    ["--config=rs_video_linear", "--scale=0.02", "--max-iterations=25"],
    ["--config=gs_bal", "--scale=0.04"]], ids=["banded", "flat"])
def test_cli_shard_ply_keeps_the_point_order(tmp_path, capsys, argv):
    """The PLY of a sharded solve lists the points in the problem's own
    order (the flat engine's repartition undone by restore_points): each
    lies near its ground truth."""
    from rsba_tpu_torch.problem import synthetic
    ply = tmp_path / "cloud.ply"
    rc, out = run_main(capsys, *argv, "--shard", f"--ply={ply}")
    assert rc == 0, out[-2000:]
    name = argv[0].split("=")[1]
    scale = float(argv[1].split("=")[1])
    gt = synthetic.CONFIGS[name](scale=scale, dtype=torch.float64,
                                 device="cpu").params_gt.points.numpy()
    lines = ply.read_text().splitlines()
    start = lines.index("end_header") + 1
    pts = np.array([[float(v) for v in x.split()[:3]]
                    for x in lines[start:start + gt.shape[0]]])
    err = np.linalg.norm(pts - gt, axis=1)
    assert np.median(err) < 0.05 * np.linalg.norm(gt - gt.mean(0),
                                                  axis=1).mean()


@pytest.mark.parametrize("argv", [
    ["--coordinator", "localhost:1234"], ["--num-processes", "2"],
    ["--process-id", "0"]], ids=["coordinator", "num_processes",
                                 "process_id"])
def test_cli_multihost_arguments_without_multihost_are_unused(capsys, argv):
    """As in the reference, the coordinator, process count and id are
    read only with --multihost: without it the run is the plain one."""
    rc, out = run_main(capsys, "--config=gs_small", "--scale=0.05", *argv)
    assert rc == 0, out[-2000:]
    assert "sharded" not in out and "multihost" not in out
    assert last_json(out)["evaluator"] == "torch-flat+device_loop"


def test_cli_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli_run.main(["--config=gs_small", "--scale=0.05"])


def test_cli_console_entry_rejects_bad_arguments():
    r = subprocess.run(
        [sys.executable, "-m", "rsba_tpu_torch.cli.run", "--config=nonsense"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 2
    assert "invalid choice" in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "rsba_tpu_torch.cli.run", "--help"],
        capture_output=True, text=True, timeout=120, cwd=REPO)
    assert r.returncode == 0
    for word in ("--device", "takes the place of", "torch.profiler",
                 "one rank per visible card", "f32 on the card"):
        assert word in " ".join(r.stdout.split()), word


def test_import_of_every_module_leaves_jax_out():
    """Every module under rsba_tpu_torch, imported in a fresh interpreter,
    leaves jax, flax, orbax and rsba_tpu out of ``sys.modules``."""
    names = sorted(m.name for m in pkgutil.walk_packages(
        rsba_tpu_torch.__path__, "rsba_tpu_torch."))
    for need in ("rsba_tpu_torch.cli.run", "rsba_tpu_torch.io.bal",
                 "rsba_tpu_torch.utils.checkpoint",
                 "rsba_tpu_torch.utils.roofline",
                 "rsba_tpu_torch.pipeline.session",
                 "rsba_tpu_torch.geometry.epipolar",
                 "rsba_tpu_torch.geometry.triangulate",
                 "rsba_tpu_torch.solver.p3p", "rsba_tpu_torch.solver.pnp",
                 "rsba_tpu_torch.solver.ransac",
                 "rsba_tpu_torch.solver.covariance",
                 "rsba_tpu_torch.solver.gradient_check",
                 "rsba_tpu_torch.tools.pipeline_gpu",
                 "rsba_tpu_torch.dist", "rsba_tpu_torch.dist.mesh",
                 "rsba_tpu_torch.dist.partition",
                 "rsba_tpu_torch.dist.launch",
                 "rsba_tpu_torch.dist.banded_sharded",
                 "rsba_tpu_torch.dist.sharded", "rsba_tpu_torch.entry",
                 "rsba_tpu_torch.tools.dist_gpu"):
        assert need in names
    code = (
        "import sys, importlib; sys.path.insert(0, sys.argv[1]); "
        "[importlib.import_module(n) for n in sys.argv[2:]]; "
        "import rsba_tpu_torch; rsba_tpu_torch.SfmSession; "
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'orbax', 'rsba_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-I", "-c", code, REPO, *names],
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
