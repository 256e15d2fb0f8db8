"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> \
        --seconds <run_seconds> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the
cell asks for. The last line of standard output is the result's JSON
object; without a device, or with a forbidden module loaded, the exit
code is not 0 and no result is printed. See ``README.md`` beside this
file.
"""
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    import sys
    from pathlib import Path

    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent / "src")]
    from pbcore.runner import main

    sys.exit(main(sys.argv[1:], T_START))
