"""What the kernel probes in ``tools/`` share.

- ``start``: the command line ``[step ...] [--repo DIR]``, and the port of
  this checkout (or of DIR) on ``sys.path`` beside ``chip_smoke``;
- ``ptxas_report``: each kernel's registers, stack frame and spills from
  nvcc's ``-v`` report;
- ``print_sass``: SASS opcode counts by function (``cuobjdump -sass``);
- ``kernel_times``: device time a launch by kernel (``torch.profiler``);
- ``host_costs``: the host's cost of a call, piece by piece;
- ``sampled_clocks``: the SM clock and power while a step runs
  (``nvidia-smi``).

Imports torch, the port and ``chip_smoke`` only when called.
"""
from __future__ import annotations

import argparse
import contextlib
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def start(doc, steps, default, argv=None):
    """Parse ``[step ...] [--repo DIR]`` (steps from ``steps``, else
    ``default``; ``--repo`` with the time step only); put the port of this
    checkout, or of DIR (``DIR/src``, e.g. a ``git archive`` of an earlier
    commit unpacked into a git-ignored directory), and this checkout's
    root on ``sys.path``; print the card.  Returns the steps, the
    ``chip_smoke`` module and the card's ``nvidia-smi`` name and power
    limit."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("steps", nargs="*", help=f"any of {steps}")
    ap.add_argument("--repo", type=pathlib.Path, default=None,
                    help="time the port of this checkout instead")
    args = ap.parse_args(argv)
    chosen = args.steps or list(default)
    if set(chosen) - set(steps):
        ap.error(f"steps are {steps}, got {chosen}")
    if args.repo and chosen != ["time"]:
        ap.error("--repo times another checkout: the time step only")
    src = (args.repo.resolve() if args.repo else REPO) / "src"
    sys.path[:0] = [str(src), str(REPO)]
    import chip_smoke as cs
    _, smi = cs.phase_device()
    print(f"[probe] port from {src}")
    return chosen, cs, smi


def ptxas_report(log):
    """[(kernel, registers and shared memory, stack frame and spills)] for
    each kernel of nvcc's ``-v`` report."""
    out, entry, frame = [], None, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line:
            frame = line.strip()
        elif "Used" in line and entry:
            out.append((entry, line.split(":", 1)[1].strip(), frame))
            entry = None
    return out


def print_build(name, log, keep=lambda entry: True):
    """ptxas's report of the kernels of one library that ``keep``
    takes."""
    for entry, used, frame in ptxas_report(log):
        if keep(entry):
            print(f"[build] {name} {entry[:70]}: {used}; {frame}")


def print_sass(cs, library, keys):
    """Counts of the opcodes ``keys`` in each function of the library."""
    for name, ops in cs._sass_ops(library).items():
        counts = {k: ops.count(k) for k in keys if ops.count(k)}
        print(f"[sass] {name[:70]}: {counts}")


def kernel_times(label, fn, n=20,
                 name=lambda key: key.split("<")[0].split("::")[-1]):
    """Device time a launch of each kernel over ``n`` calls of ``fn``
    (``torch.profiler``), with its launches a call."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    parts = []
    for ev in prof.key_averages():
        total = getattr(ev, "device_time_total", 0.0)
        if ev.count and total:
            parts.append(f"{name(ev.key)} {total / ev.count:.2f} "
                         f"x{ev.count // n}")
    print(f"[profile] {label}: " + ", ".join(parts) + " (us a launch)")


def host_costs(label, pieces, n=2000):
    """Host clock over ``n`` calls of each piece of a call (a piece that
    launches cannot read below the kernel's device time, as the device
    falls behind)."""
    import torch
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):
            fn()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        print(f"[host] {label} {name}: "
              f"{(time.perf_counter() - t0) / n * 1e6:.2f} us a call")


@contextlib.contextmanager
def sampled_clocks():
    """The SM clock, its maximum and the power every 200 ms while the
    body runs, printed at its end."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
         "--format=csv,noheader", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    try:
        yield
    finally:
        proc.terminate()
        samples = proc.communicate(timeout=30)[0].split("\n")
        print(f"[time] SM clock, max, power during the timing: "
              f"{sorted(set(x for x in samples if x))[:6]} ... "
              f"({len(samples)} samples)")
