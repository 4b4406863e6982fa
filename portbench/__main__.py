"""python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>"""

import time

T0 = time.monotonic()

from portbench.cli import main  # noqa: E402

raise SystemExit(main(t_start=T0))
