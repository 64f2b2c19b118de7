"""`control.py` with the SwinIR faults (`faults_swinir.py`) beside the
others, for the limits of `swinir.enhanced_b1`:

    python3 perfbench/control_swinir.py --workload swinir.enhanced_b1 --seconds <s>
        --program-seeds 1,2,... --control-seeds 101,... --faults bias_left_out,...
        --fault-seeds 201,...

The arguments and the JSON lines are control.py's.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from perfbench import control, faults, faults_swinir

    faults.FAULTS.update(faults_swinir.FAULTS)
    sys.exit(control.main())
