"""Run one cell of the port's benchmark on the CUDA cards of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of `workloads` in
BENCHMARK.json. With --trace 0 the result carries the cell's end-to-end
metrics, with --trace 1 its per-layer metrics. The last line of standard
output is the result, one JSON object; the numbers compared with the plain
reference, each with its limit, are the last lines of standard error.
Without a card, or with fewer than the cell asks for, it exits with 3 and
prints no result.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent

# every build and kernel cache of the run at a fixed path inside the checkout
CACHE = ROOT / ".bench_cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    from perfbench import harness

    sys.exit(harness.main(sys.argv[1:], ROOT, T_START))
