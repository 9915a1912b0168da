"""Quick probe of the port's RMSNorm and mLSTM-chunk kernels on one GPU.

    python3 tools/norm_mlstm_probe.py [build] [check] [time] [host]
                                      [profile] [sweep] [--repo DIR]

(no step: the first three).  A loop for the two kernels that is shorter than
``chip_smoke.py``'s full run:

- build — build both libraries (one nvcc each, in parallel); print
          ptxas's registers, stack frame and spills for every kernel
          instantiation, and each mLSTM kernel's SASS opcode counts;
- check — ``chip_smoke.check_rmsnorm`` and ``chip_smoke.check_mlstm_chunk``
          (every shape of the card checks, against the plain versions);
- time  — CUDA-event times (``chip_smoke._time_ms``, each shape twice) and
          device time alone (CUDA-graph replay, ``chip_smoke._device_ms``,
          twice) of RMSNorm at 1024 x 512 fp32 and 16384 x 2560 bf16
          beside ``F.rms_norm``, and of the mLSTM chunk at B 2, H 4, L 128,
          dh 64 fp32 fresh and at xlstm-1.3b's heads (B 1, H 4, L 128,
          dh 1024, bf16, with a state); each timed output held against the
          plain version at the kernel checks' tolerances; the SM clock and
          power during the timing (``nvidia-smi``);
- host  — the host's share of one mLSTM-chunk call at B 2, H 4, L 128,
          dh 64 fp32 (host clock over 2000 calls of each piece: the
          argument check, the casts, the plan, the allocations, the stream
          lookup, the ctypes launch alone, the whole wrapper);
- profile — ``torch.profiler`` over 20 calls of each timed shape: device
          time by kernel name;
- sweep — the same for the mLSTM chunk at B 1, H 4, L 128 with a state,
          dh 64 to 1024, fp32 and bf16.

``--repo DIR`` times the port of another checkout (``DIR/src``, e.g. a
``git archive`` of an earlier commit unpacked into a git-ignored
directory) with this checkout's timing helpers: ``time`` only, and a shape
that port's wrapper refuses is reported as refused.  Needs a CUDA device;
imports torch and the port only.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

STEPS = ("build", "check", "time", "host", "profile", "sweep")
DEFAULT_STEPS = STEPS[:3]


def probe_build():
    from repro_torch.kernels.mlstm_chunk import ops as mops
    from repro_torch.kernels.rmsnorm import ops as rops
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        logs = {name: job.result()[1] for name, job in
                (("rmsnorm", pool.submit(rops.load_library)),
                 ("mlstm_chunk", pool.submit(mops.load_library)))}
    for name, log in logs.items():
        entry = frame = None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "bytes stack frame" in line:
                frame = line.strip()
            elif "Used" in line and entry:
                print(f"[build] {name} {entry}: "
                      f"{line.split(':', 1)[1].strip()}; {frame}")
                entry = None
    _sass_by_function(mops)


def _sass_by_function(mops):
    """Instruction counts of each mLSTM kernel's SASS (``cuobjdump
    -sass``): shared (LDS/STS), generic (LD/ST), global (LDG/STG) loads
    and stores, fp32 and fp64 fmas, barriers."""
    import re
    import subprocess

    from repro_torch.kernels import build
    tool = pathlib.Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass",
                           str(build.library_path(mops.SOURCE))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    keys = ("LDS", "STS", "LD", "ST", "LDG", "STG", "FFMA", "DFMA", "DADD",
            "BAR", "F2F")
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        ops = [m.group(1).split(".")[0] for m in re.finditer(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?([A-Z][A-Z0-9_.]*)",
            part)]
        counts = {k: ops.count(k) for k in keys if ops.count(k)}
        print(f"[sass] {name[:60]}: {counts}")


def _rmsnorm_time(cs, torch):
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    F = torch.nn.functional
    for (N, d), dtype, iters in (((1024, 512), torch.float32, 2000),
                                 ((16384, 2560), torch.bfloat16, 200)):
        g = torch.Generator().manual_seed(700 + N)
        x = cs._randn((N, d), g).to("cuda", dtype)
        scale = cs._randn((d,), g, 0.1).to("cuda", dtype)
        weight = 1.0 + scale

        def kernel():
            return rmsnorm(x, scale)

        def library():
            return F.rms_norm(x, (d,), weight=weight, eps=1e-6)

        ok, err = cs._within(kernel(), rmsnorm_ref(x, scale),
                             cs.ATTN_TOL[dtype])
        if not ok:
            raise AssertionError(f"rmsnorm {N}x{d}: off the plain version "
                                 f"({err})")
        ev = [cs._time_ms(kernel, iters), cs._time_ms(library, iters),
              cs._time_ms(library, iters), cs._time_ms(kernel, iters)]
        dev = [cs._device_ms(kernel), cs._device_ms(library),
               cs._device_ms(library), cs._device_ms(kernel)]
        print(f"[time] rmsnorm N={N} d={d} {cs._dt(dtype)}: kernel "
              f"{ev[0]:.5f}/{ev[3]:.5f} ms, device alone "
              f"{dev[0]:.5f}/{dev[3]:.5f} ms; F.rms_norm "
              f"{ev[1]:.5f}/{ev[2]:.5f} ms, device alone "
              f"{dev[1]:.5f}/{dev[2]:.5f} ms (max abs err {err:.3e})")


def _mlstm_time(cs, torch):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    for (B, H, L, dh), dtype, state, iters in (
            ((2, 4, 128, 64), torch.float32, False, 500),
            (cs.XLSTM_HEAD, torch.bfloat16, True, 200)):
        args = cs._mlstm_inputs(B, H, L, dh, dtype, 900 + dh, state=state)
        label = (f"mlstm_chunk B={B} H={H} L={L} dh={dh} {cs._dt(dtype)} "
                 f"{'with a state' if state else 'fresh'}")
        try:
            got = mlstm_chunk(*args)
        except ValueError as exc:
            print(f"[time] {label}: refused ({exc})")
            continue
        cs._mlstm_compare(label, got, mlstm_chunk_ref(*args),
                          cs.MLSTM_TOL[dtype], *cs._mlstm_witness(args))
        ev = [cs._time_ms(lambda: mlstm_chunk(*args), iters)
              for _ in range(2)]
        dev = [cs._device_ms(lambda: mlstm_chunk(*args)) for _ in range(2)]
        print(f"[time] {label}: kernel {ev[0]:.5f}/{ev[1]:.5f} ms, device "
              f"alone {dev[0]:.5f}/{dev[1]:.5f} ms")


def _mlstm_host(cs, torch):
    import time

    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import ops
    args = cs._mlstm_inputs(2, 4, 128, 64, torch.float32, 900, state=False)
    q, k, v, i_pre, f_pre, C0, n0, m0 = args
    dev = q.device
    lib, _ = ops.load_library()
    p = ops.plan(*q.shape)
    h = torch.empty_like(q)
    C1, n1, m1 = (torch.empty_like(t) for t in (C0, n0, m0))
    scratch = torch.empty(p.scratch_floats, device=dev)
    stream = build.current_stream(dev)

    def launch():
        return lib.mlstm_chunk_launch(ops.pack(p, [
            t.data_ptr() for t in (q, k, v, i_pre, f_pre, C0, n0, m0, h, C1,
                                   n1, m1)], scratch.data_ptr(), False),
            stream)

    pieces = {
        "check": lambda: ops.check(*args, kernel=True),
        "casts": lambda: [
            t if t.dtype is torch.float32 and t.is_contiguous()
            else t.float().contiguous() for t in (i_pre, f_pre, C0, n0, m0)],
        "plan": lambda: ops.plan(*q.shape),
        "allocations": lambda: (torch.empty_like(q),
                                *(torch.empty_like(t) for t in (C0, n0, m0)),
                                torch.empty(p.scratch_floats, device=dev)),
        "stream": lambda: build.current_stream(dev),
        "device context": lambda: build.on_device(dev),
        "ctypes launch": launch,
        "wrapper": lambda: ops.mlstm_chunk(*args),
    }
    for name, fn in pieces.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(2000):
            fn()
            if i % 100 == 99:
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        print(f"[host] mlstm_chunk {name}: "
              f"{(time.perf_counter() - t0) / 2000 * 1e6:.2f} us a call")


def _profile(cs, torch):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    for (N, d), dtype in (((1024, 512), torch.float32),
                          ((16384, 2560), torch.bfloat16)):
        g = torch.Generator().manual_seed(700 + N)
        x = cs._randn((N, d), g).to("cuda", dtype)
        scale = cs._randn((d,), g, 0.1).to("cuda", dtype)
        _kernel_times(torch, f"rmsnorm {N}x{d} {cs._dt(dtype)}",
                      lambda: rmsnorm(x, scale))
    for shape, dtype, state in (((2, 4, 128, 64), torch.float32, False),
                                (cs.XLSTM_HEAD, torch.bfloat16, True)):
        args = cs._mlstm_inputs(*shape, dtype, 900 + shape[3], state=state)
        _kernel_times(torch, f"mlstm_chunk {shape} {cs._dt(dtype)}",
                      lambda: mlstm_chunk(*args))


def _kernel_times(torch, label, fn, n=20):
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
            name = ev.key.split("<")[0].split("::")[-1]
            parts.append(f"{name} {total / ev.count:.2f}")
    print(f"[profile] {label}: " + ", ".join(parts) + " (us a launch)")


def _sweep(cs, torch):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 256, 512, 1024):
            args = cs._mlstm_inputs(1, 4, 128, dh, dtype, 950 + dh,
                                    state=True)
            _kernel_times(torch, f"B=1 H=4 L=128 dh={dh} {cs._dt(dtype)}",
                          lambda a=args: mlstm_chunk(*a))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("steps", nargs="*", help=f"any of {STEPS}")
    ap.add_argument("--repo", type=pathlib.Path, default=None,
                    help="time the port of this checkout instead")
    args = ap.parse_args(argv)
    steps = args.steps or list(DEFAULT_STEPS)
    if set(steps) - set(STEPS):
        ap.error(f"steps are {STEPS}, got {steps}")
    src = (args.repo.resolve() if args.repo else REPO) / "src"
    if args.repo and steps != ["time"]:
        ap.error("--repo times another checkout: the time step only")
    sys.path[:0] = [str(src), str(REPO)]
    import torch

    import chip_smoke as cs
    name, smi = cs.phase_device()
    print(f"[probe] port from {src}")
    if "build" in steps:
        probe_build()
    if "check" in steps:
        print(f"[check] rmsnorm worst {cs.check_rmsnorm():.3e}")
        print(f"[check] mlstm_chunk worst {cs.check_mlstm_chunk():.3e}")
    if "time" in steps:
        import subprocess
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        try:
            _rmsnorm_time(cs, torch)
            _mlstm_time(cs, torch)
        finally:
            smi.terminate()
            samples = smi.communicate(timeout=30)[0].split("\n")
        print(f"[time] SM clock, max, power during the timing: "
              f"{sorted(set(x for x in samples if x))[:6]} ... "
              f"({len(samples)} samples)")
    if "host" in steps:
        _mlstm_host(cs, torch)
    if "profile" in steps:
        _profile(cs, torch)
    if "sweep" in steps:
        _sweep(cs, torch)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
