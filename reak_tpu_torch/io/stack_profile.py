"""Wall-clock profile of a Python script by sampling its main thread's stack.

    python3 -m reak_tpu_torch.io.stack_profile OUT.json SCRIPT [ARGS...]

runs SCRIPT as ``__main__`` (its ``sys.argv`` is SCRIPT and ARGS) while a
thread reads the main thread's stack every ``EVERY`` seconds (each reading
standing for the time since the one before), and writes to
OUT.json, most first, the seconds spent under each innermost line of
SCRIPT (``"line"``), under each chain of SCRIPT's frames, outermost first
(``"chain"``), and under each innermost frame of the ``reak_tpu_torch``
package (``"package"``).  The samples are the host's: time the host spends
waiting for the card counts against the line that waits.  OUT.json is
written every minute and at the end, also when SCRIPT raises or exits.
"""
from __future__ import annotations

import collections
import json
import os
import runpy
import sys
import threading
import time

EVERY = 0.2


def _frames(frame, script):
    """(SCRIPT's frames outermost first as ``function:line``, the innermost
    frame of the package as ``path:function:line`` or None)."""
    chain, package = [], None
    while frame is not None:
        code = frame.f_code
        if code.co_filename == script:
            chain.append(f"{code.co_name}:{frame.f_lineno}")
        elif (package is None and "reak_tpu_torch" in code.co_filename
              and code.co_filename != __file__):
            path = code.co_filename.split("reak_tpu_torch" + os.sep)[-1]
            package = f"{path}:{code.co_name}:{frame.f_lineno}"
        frame = frame.f_back
    return chain[::-1], package


def profile(out: str, script: str, args=(), every=None) -> None:
    """Run ``script`` with ``args`` under the sampler, a reading every
    ``every`` seconds (EVERY if None); write ``out``."""
    every = EVERY if every is None else every
    script = os.path.abspath(script)
    tallies = {k: collections.Counter() for k in ("line", "chain", "package")}
    main_id = threading.get_ident()
    done = threading.Event()

    def write():
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        with open(out, "w") as fh:
            json.dump({"every_s": every, **{k: c.most_common()
                                            for k, c in tallies.items()}},
                      fh, indent=0)

    def sample():
        last = written = time.perf_counter()
        while not done.wait(every):
            frame = sys._current_frames().get(main_id)
            # each sample stands for the time since the one before
            now = time.perf_counter()
            dt, last = now - last, now
            chain, package = _frames(frame, script)
            if chain:
                tallies["line"][chain[-1]] += dt
                tallies["chain"][" > ".join(chain)] += dt
            if package:
                tallies["package"][package] += dt
            if now - written > 60.0:
                write()
                written = now

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    argv = sys.argv
    sys.argv = [script, *args]
    try:
        runpy.run_path(script, run_name="__main__")
    finally:
        sys.argv = argv
        done.set()
        sampler.join()
        write()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    try:
        profile(argv[0], argv[1], argv[2:])
    except SystemExit as e:
        return e.code if isinstance(e.code, int) else (0 if e.code is None
                                                        else 1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
