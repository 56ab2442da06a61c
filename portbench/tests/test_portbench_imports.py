"""What the benchmark's process loads: never JAX nor the JAX package, and,
in the reference, nothing of the program."""
import subprocess
import sys

from portbench import manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "rsba_tpu")

_PROBE = """
import importlib, importlib.util, sys
from pathlib import Path
mods = {mods!r}
for m in mods:
    importlib.import_module(m)
for path in sorted(Path({metrics!r}).glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_modules(mods, metrics=True) -> set:
    code = _PROBE.format(mods=mods, metrics=str(manifest.BENCH / "metrics"
                                                if metrics else "/nonexistent"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=manifest.ROOT, timeout=300,
                         check=True)
    return set(out.stdout.split())


def test_harness_loads_no_jax_nor_the_jax_package():
    """The harness, every traffic kind and metric reader, and the program
    modules a run drives: top-level names compared whole."""
    loaded = _top_level_modules([
        "portbench.run", "portbench.trace", "portbench.tools.faults",
        "portbench.kinds.solve", "portbench.kinds.session",
        "rsba_tpu_torch.solver.lm", "rsba_tpu_torch.solver.lm_device",
        "rsba_tpu_torch.pipeline", "rsba_tpu_torch.kernels.fused"])
    assert "rsba_tpu_torch" in loaded and "portbench" in loaded
    assert not loaded & set(FORBIDDEN), loaded & set(FORBIDDEN)
    assert "benchmarks" not in loaded and "bench" not in loaded


def test_reference_imports_nothing_of_the_program():
    loaded = _top_level_modules(["portbench.reference.geometry",
                                 "portbench.reference.generator",
                                 "portbench.reference.lsq",
                                 "portbench.roofline", "portbench.stats"],
                                metrics=False)
    assert "rsba_tpu_torch" not in loaded
    assert not loaded & set(FORBIDDEN)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run
    for name in list(sys.modules):
        if name.split(".")[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "rsba_tpu_torch_x.y", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "rsba_tpu.solver", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert run.forbidden_modules() == ["jaxlib", "rsba_tpu"]
