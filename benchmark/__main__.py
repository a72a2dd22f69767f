import time

T_START = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402

from benchmark.run import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
