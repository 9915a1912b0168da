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

import concurrent.futures
import sys

import probe_common

STEPS = ("build", "check", "time", "host", "profile", "sweep")
#: the mLSTM kernels' SASS counts: shared (LDS/STS), generic (LD/ST),
#: global (LDG/STG) loads and stores, fp32 and fp64 fmas, barriers
SASS_KEYS = ("LDS", "STS", "LD", "ST", "LDG", "STG", "FFMA", "DFMA", "DADD",
             "BAR", "F2F")


def probe_build(cs):
    from repro_torch.kernels import build
    from repro_torch.kernels.mlstm_chunk import ops as mops
    from repro_torch.kernels.rmsnorm import ops as rops
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        logs = {name: job.result()[1] for name, job in
                (("rmsnorm", pool.submit(rops.load_library)),
                 ("mlstm_chunk", pool.submit(mops.load_library)))}
    for name, log in logs.items():
        probe_common.print_build(name, log)
    probe_common.print_sass(cs, build.library_path(mops.SOURCE), SASS_KEYS)


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

    probe_common.host_costs("mlstm_chunk", {
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
    })


def _profile(cs, torch):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    for (N, d), dtype in (((1024, 512), torch.float32),
                          ((16384, 2560), torch.bfloat16)):
        g = torch.Generator().manual_seed(700 + N)
        x = cs._randn((N, d), g).to("cuda", dtype)
        scale = cs._randn((d,), g, 0.1).to("cuda", dtype)
        probe_common.kernel_times(f"rmsnorm {N}x{d} {cs._dt(dtype)}",
                                  lambda: rmsnorm(x, scale))
    for shape, dtype, state in (((2, 4, 128, 64), torch.float32, False),
                                (cs.XLSTM_HEAD, torch.bfloat16, True)):
        args = cs._mlstm_inputs(*shape, dtype, 900 + shape[3], state=state)
        probe_common.kernel_times(f"mlstm_chunk {shape} {cs._dt(dtype)}",
                                  lambda: mlstm_chunk(*args))


def _sweep(cs, torch):
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    for dtype in (torch.float32, torch.bfloat16):
        for dh in (64, 128, 256, 512, 1024):
            args = cs._mlstm_inputs(1, 4, 128, dh, dtype, 950 + dh,
                                    state=True)
            probe_common.kernel_times(
                f"B=1 H=4 L=128 dh={dh} {cs._dt(dtype)}",
                lambda a=args: mlstm_chunk(*a))


def main(argv=None) -> int:
    steps, cs, smi = probe_common.start(__doc__, STEPS, STEPS[:3], argv)
    import torch
    if "build" in steps:
        probe_build(cs)
    if "check" in steps:
        print(f"[check] rmsnorm worst {cs.check_rmsnorm():.3e}")
        print(f"[check] mlstm_chunk worst {cs.check_mlstm_chunk():.3e}")
    if "time" in steps:
        with probe_common.sampled_clocks():
            _rmsnorm_time(cs, torch)
            _mlstm_time(cs, torch)
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
