"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the result as the last line of
standard output; see ``portbench/harness.py``."""

import sys
from pathlib import Path

sys.path[0] = str(Path(__file__).resolve().parent.parent)  # the checkout, not portbench/

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
