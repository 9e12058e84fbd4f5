"""Run one cell of the benchmark once, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(``python3 -m benchmark.run`` takes the same arguments.) The last line of
standard output is the run's result as one JSON object; see
``benchmark/harness.py``.
"""

import os
import sys

if __name__ == "__main__":
    _root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if sys.path and os.path.abspath(sys.path[0] or ".") == \
            os.path.dirname(os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, _root)
    from benchmark import harness
    sys.exit(harness.main())
