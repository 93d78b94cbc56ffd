"""Run one cell of the port's benchmark once (`harness/runner.py`):

    python portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds `jpeg_decoder_tpu_torch`.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness.runner import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
