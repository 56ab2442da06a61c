"""The benchmark of ``rsba_tpu_torch`` on one NVIDIA H100 (see run.py)."""
import time

#: when the process began the benchmark: set-up is timed from here
T_START = time.perf_counter()
