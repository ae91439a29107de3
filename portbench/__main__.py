import time

T_START = time.perf_counter()  # setup_s counts from here

import sys  # noqa: E402

from portbench.run import main  # noqa: E402

sys.exit(main(t_start=T_START))
