#!/usr/bin/env python3
"""Where a long script's time goes, phase by phase: run a command, print
each line of its standard output with the seconds since the start in
front, and write the seconds of each phase to a file.

    python3 scripts/stamp_lines.py --summary FILE -- python3 chip_smoke.py

A phase is what the lines ``phase N ...`` name, as ``chip_smoke.py``
prints them.  The time between two lines goes to the phase of the later
line (a phase prints what it found after the work), and a line that names
no phase belongs to the last phase named.  The summary lists each phase's
seconds in the order of the numbers, then the total.  The command's
standard error passes through; the exit code is the command's.
"""

import argparse
import re
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--summary", required=True,
                    help="file for each phase's seconds")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    command = args.command[1:] if args.command[:1] == ["--"] else \
        args.command
    t0 = last = time.perf_counter()
    seconds, phase = {}, "start"
    proc = subprocess.Popen(command, stdout=subprocess.PIPE, text=True,
                            bufsize=1)
    for line in proc.stdout:
        now = time.perf_counter()
        named = re.match(r"phase (\d+)\b", line)
        if named:
            phase = int(named.group(1))
        seconds[phase] = seconds.get(phase, 0.0) + now - last
        last = now
        print(f"{now - t0:9.3f} {line}", end="", flush=True)
    rc = proc.wait()
    end = time.perf_counter()
    seconds[phase] = seconds.get(phase, 0.0) + end - last
    order = sorted(seconds, key=lambda p: (isinstance(p, int), p))
    with open(args.summary, "w") as f:
        for p in order:
            f.write(f"phase {p}: {seconds[p]:.3f} s\n")
        f.write(f"total: {end - t0:.3f} s, rc {rc}\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
