"""The benchmark's arithmetic and its manifest, on the CPU."""
import json
import re
import statistics

import pytest

from portbench import manifest, roofline, stats
from portbench.record import Run
from portbench.run import read_metric


def test_kernel_bound_at_config_4_shapes():
    """Config 4's window grid: NR = 1096 rows, W = 11, L = 10, G = 112."""
    flops = roofline.slot_flops(True, "slerp", True, True)
    assert flops == 1830
    b = roofline.kernel_bound(1096, 11, 10, 112, 4, 910_092, flops)
    assert b["bytes_in"] == 31_810_340
    assert b["bytes_out"] == 105_404_512
    assert b["flops"] == 910_092 * 1830
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] == pytest.approx((31_810_340 + 105_404_512)
                                         / 3.35e12)


def test_slot_flops_of_the_other_models():
    assert roofline.slot_flops(True, "nlerp", False, False) == \
        290 + 300 + 40 + 135 + 0 + 27 + 144 + 364
    assert roofline.slot_flops(False, "slerp", False, False) == \
        0 + 165 + 40 + 105 + 0 + 27 + 72 + 112


def test_union_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7), (10.0, 11.0)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.union_length([]) == 0.0
    assert stats.idle_pct(4.0, 16.0) == pytest.approx(75.0)
    assert stats.idle_pct(1.0, 0.0) is None
    g = stats.gaps(iv, -1.0, 12.0)
    assert g == [(4.0, 10.0), (-1.0, 0.0), (2.0, 3.0), (11.0, 12.0)]
    assert stats.gaps([(0.0, 5.0)], 1.0, 4.0) == []


def test_percentile_is_nearest_rank():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == 90
    assert stats.percentile(v[::-1], 90) == 90
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11], 90) == 10
    with pytest.raises(ValueError):
        stats.percentile([], 90)


def test_window_rate_and_per_item():
    assert stats.rate(120, 40.0) == 3.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
    assert stats.per_item(3.0, 0) is None
    assert stats.per_item(3.0, 2) == 1.5


def test_spread_uses_statistics_quartiles():
    v = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == pytest.approx((q3 - q1) / q2)


def test_readers_on_a_synthetic_run():
    run = Run(kind="solve", setup_s=12.5, window_s=10.0,
              peak_window_bytes=2**30)
    run.solves = [{"wall_s": 0.5, "capture_s": 0.1, "attempts": 20,
                   "cg_iters": 1000, "plan_s": 0.2, "ok": True}] * 4
    assert read_metric("solve_s", run) == 2.5
    assert read_metric("setup_s", run) == 12.5
    assert read_metric("peak_mem_gib", run) == 1.0
    assert read_metric("capture_ms.solve", run) == pytest.approx(100.0)
    assert read_metric("plan_ms.solve", run) == pytest.approx(200.0)
    assert read_metric("attempts_per_solve", run) == 20
    assert read_metric("cg_iters_per_solve", run) == 1000
    assert read_metric("fused_evaluate_assemble_roofline", run) is None
    run.trace = {"busy_s": 1.0, "window_s": 4.0,
                 "ops": {"void fused_kernel<float, 1>(Args<float>, int, int)":
                         [8, 0.002], "other": [3, 1.0]}}
    run.counters["fused_bound_s"] = 0.0000625
    assert read_metric("fused_evaluate_assemble_roofline", run) == pytest.approx(25.0)
    assert read_metric("device_idle_pct.solve", run) == pytest.approx(75.0)
    frames = Run(kind="session", window_s=20.0)
    frames.frames = [{"wall_s": w / 1e3, "capture_s": 0.01,
                      "stages": {"register": 0.1, "ba": 0.2 if w > 50 else 0}}
                     for w in range(1, 101)]
    assert read_metric("frames_per_s", frames) == 5.0
    assert read_metric("frame_p90_ms", frames) == pytest.approx(90.0)
    assert read_metric("register_ms_per_frame", frames) == pytest.approx(100.0)
    assert read_metric("ba_ms_per_frame", frames) == pytest.approx(100.0)
    assert read_metric("capture_ms.session", frames) == pytest.approx(10.0)


BENCH = manifest.load()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
LINE = re.compile(r"[^\n\t]{1,200}")


def test_manifest_names_units_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.fullmatch(n) and manifest.valid_name(n), n
    for m in metrics:
        assert UNIT.fullmatch(m["unit"]) and manifest.valid_unit(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (manifest.BENCH / "metrics" / f"{m['name']}.py").exists()
    assert not manifest.valid_name("a b") and not manifest.valid_unit("µs")
    assert not manifest.valid_unit("tokens per second")
    for c in BENCH["configs"]:
        assert LINE.fullmatch(c["source"]) and LINE.fullmatch(c["why"])
        with open(manifest.ROOT / c["file"]) as f:
            cfg = json.load(f)
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["source"] == c["source"]
    for w in BENCH["workloads"]:
        assert LINE.fullmatch(w["why"]) and w["chips"] in (1, 4)
        manifest.config(BENCH, w["config"])
        assert manifest.traffic(w["traffic"])["kind"] in ("solve", "session")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        got = [m["name"] for m in manifest.metrics_of(BENCH, w["name"],
                                                      False)]
        assert "setup_s" in got and len(got) >= 2
        layers = manifest.metrics_of(BENCH, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in got, (w["name"], m["name"])
    for m in BENCH["per_layer"]:
        assert LINE.fullmatch(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


class _Event:
    def __init__(self, name, on_card, start_us, end_us, annotation=False):
        import torch
        self._n, self._a, self._b, self._u = name, start_us, end_us, annotation
        self._d = (torch.autograd.DeviceType.CUDA if on_card
                   else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._a * 1000)

    def duration_ns(self):
        return int((self._b - self._a) * 1000)

    def is_user_annotation(self):
        return self._u


def test_trace_summary_reads_busy_share_ops_and_labelled_gaps():
    from types import SimpleNamespace

    from portbench.trace import Tracer
    ev = [_Event("portbench.window", False, 0, 100),
          _Event("portbench.window", True, 0, 100, annotation=True),
          _Event("portbench.plan", False, 0, 40),
          _Event("portbench.solve", False, 40, 100),
          _Event("portbench.solve", True, 40, 100, annotation=True),
          _Event("void fused_kernel<float, 1>(Args<float>, int, int)", True,
                 45, 55),
          _Event("void fused_kernel<float, 1>(Args<float>, int, int)", True,
                 60, 70),
          _Event("gemm", True, 50, 65), _Event("gemm", True, 90, 120),
          _Event("aten::mm", False, 44, 46)]
    t = Tracer(True)
    t.done = True
    t._prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    s = t.summary()
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["busy_s"] == pytest.approx(35e-6)          # 45-70 and 90-100
    assert s["ops"]["gemm"] == pytest.approx([2, 25e-6])
    assert s["device_ops"][0][0] == "gemm"
    assert [g[0] for g in s["idle_gaps"]] == ["plan", "solve"]
    assert s["idle_gaps"][0][1] == pytest.approx(45e-6)
    assert s["idle_gaps"][1][1] == pytest.approx(20e-6)
