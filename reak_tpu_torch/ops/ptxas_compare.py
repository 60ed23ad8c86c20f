"""ptxas' registers, stack frame and spills of every compile-time kernel
instance, in this checkout and in another, side by side.

    python3 -m reak_tpu_torch.ops.ptxas_compare OTHER [--out FILE]

OTHER is the root of another checkout of the repository (for example the
parent commit, unpacked with ``git archive`` into ``build/``).  The eighteen
libraries of the compile-time instances (K1/K5 at the chain widths the smoke
run drives, K2 and K4a-c at each bound, K3) are compiled from each
checkout's ``reak_tpu_torch/csrc`` with this checkout's nvcc flags (one
``nvcc`` a library, all started together; this checkout's come from
``_build``'s cache where they are built), and ``ptxas -v``'s report of each
kernel entry is compared.  Prints one JSON line, {"entries": {mangled
name, its anonymous namespace's hash taken out: {"this": ..., "other":
...}}, "differ": [...], "only_one": [...]}, and with ``--out`` writes it
there too; exits 1 where an entry differs or is built by one checkout only.
Needs ``nvcc``; no card.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

from reak_tpu_torch.ops import _build, _tile

# the K1/K5 chain widths (joints, dofs) the smoke run builds: the flagship
# arm in both types, planar_2link, the mixed chain and the 16-segment beam
KTE_WIDTHS = (((6, 6), "f32"), ((6, 6), "f64"), ((2, 2), "f64"),
              ((8, 6), "f64"), ((16, 16), "f64"))


def libraries() -> list:
    """The compile-time libraries, by ``_build`` name."""
    names = [_build.instance_library("kte_step", w, t) for w, t in KTE_WIDTHS]
    names += [_build.instance_library(k, bound, t)
              for k in ("pdip_whole", "riccati_bwd")
              for bound in _tile.INSTANCES for t in ("f32", "f64")]
    return names + ["chol_lanes"]


def entry_key(mangled: str) -> str:
    """A kernel entry's mangled name without the hash nvcc gives an
    anonymous namespace (it changes with the source's path)."""
    return re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_(\w+?_cu)_[0-9a-f]+",
                  r"<\1>", mangled)


def entries(report: str) -> dict:
    """{entry key: its stack and registers lines} of a ``ptxas -v``
    report."""
    lines = report.splitlines()
    out = {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line:
            name = entry_key(line.split("'")[1])
            out[name] = " | ".join(
                s.replace("ptxas info    :", "").strip()
                for s in lines[i + 2:i + 4])
    return out


def other_reports(other: Path, names) -> dict:
    """{library: ptxas report} of ``names`` built from the checkout
    ``other``'s sources."""
    csrc = other / "reak_tpu_torch" / "csrc"
    out_dir = _build.BUILD_DIR.parent / "ptxas_other"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        source, defines = _build._source_and_defines(name)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *defines, "-I", str(csrc),
               "-o", str(out_dir / f"lib{name}.so"), str(csrc / source.name)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    reports = {}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {other}'s {name}:\n{err}")
        reports[name] = err
    return reports


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    names = libraries()
    _build.build_all(names)
    this = {}
    for name in names:
        this.update(entries(_build.ptxas_report(name)))
    other = {}
    for report in other_reports(args.other.resolve(), names).values():
        other.update(entries(report))
    result = {"entries": {k: {"this": this.get(k), "other": other.get(k)}
                          for k in sorted(set(this) | set(other))},
              "differ": sorted(k for k in set(this) & set(other)
                               if this[k] != other[k]),
              "only_one": sorted(set(this) ^ set(other))}
    line = json.dumps(result)
    print(line)
    if args.out is not None:
        os.makedirs(args.out.parent, exist_ok=True)
        args.out.write_text(line + "\n")
    return 1 if result["differ"] or result["only_one"] else 0


if __name__ == "__main__":
    sys.exit(main())
