"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`, this folder and
the port (`zprize_tpu_torch`). The set-up's clock starts here, before
anything is imported. See `harness.py`."""

import time

T_START = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, ROOT)
    from portbench import harness
    sys.exit(harness.main(sys.argv[1:], T_START, ROOT))
