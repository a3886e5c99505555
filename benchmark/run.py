"""Run one benchmark cell of the PyTorch and CUDA port on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints the run's result as one JSON line, the last of standard output,
and each number its correctness check compared, beside its limit, as the
last lines of standard error. Exits non-zero, with no result, without
enough CUDA devices.
"""

import os
import sys
import time


def _process_age_s():
    """Seconds since this process started (Linux), 0 where unknown."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


if __name__ == "__main__":
    PROCESS_T0 = time.perf_counter() - _process_age_s()
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark import harness

    harness.fix_cache_dirs()
    sys.exit(harness.main(process_t0=PROCESS_T0))
