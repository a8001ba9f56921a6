import time

T_START = time.perf_counter()

import sys  # noqa: E402

from port_bench.run import main, process_age  # noqa: E402

sys.exit(main(t_start=T_START, age=process_age()))
