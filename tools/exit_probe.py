"""Quick probe of the port's exit-confidence kernels on one GPU.

    python3 tools/exit_probe.py [build] [check] [time] [host] [profile]
                                [sweep] [--repo DIR]

(no step: the first three).  A loop for the exit kernels that is shorter
than ``chip_smoke.py``'s full run:

- build — build the library; print ptxas's registers, shared memory and
          spills for every kernel, and each kernel's SASS opcode counts
          (tensor-core HMMA / HGMMA, FFMA, shared loads, TMA and bulk
          copies, barriers);
- check — ``chip_smoke.check_exit_confidence`` (every card case, against
          the plain version);
- time  — ``chip_smoke._time_exit_confidence`` at the shapes of
          ``chip_smoke.EXIT_TIMED`` (the classifier's, the qwen3-4b head
          in fp32 and in bf16 at N 8, 4, 2, 1): CUDA events in turns
          with the plain version, device time alone (CUDA-graph replay),
          ``torch.matmul(hn, w_out)`` alone beside them, each timed output
          held against the plain version; the SM clock and power during the timing
          (``nvidia-smi``);
- host  — the host's share of one call at the classifier's shape (host
          clock over 2000 calls of each piece: the argument check, the
          plan, the allocation, the stream lookup, the packing, the ctypes
          launch alone, the output views, the whole wrapper);
- profile — ``torch.profiler`` over 20 calls of each timed shape: device
          time a launch by kernel name;
- sweep — device time alone with other rings (``ops.KC``'s k chunk and
          ``ops.STAGES``, 2 to ``ops.MAX_STAGES`` where they fit), each
          output held against the plain version: the qwen3-4b head at N 8
          in both dtypes, and short chunks (N 8, V 151936, d 16 and 128
          in bf16, 16 and 64 in fp32).

``--repo DIR`` times the port of another checkout (``DIR/src``, e.g. a
``git archive`` of an earlier commit unpacked into a git-ignored
directory) with this checkout's timing helpers: ``time`` only.  Needs a
CUDA device; imports torch and the port only.
"""
from __future__ import annotations

import sys

import probe_common

STEPS = ("build", "check", "time", "host", "profile", "sweep")
SASS_KEYS = ("HMMA", "HGMMA", "LDSM", "FFMA", "LDS", "LDG", "UTMALDG",
             "UBLKCP", "BAR", "MUFU")


def probe_build(cs):
    from repro_torch.kernels import build
    from repro_torch.kernels.exit_confidence import ops
    probe_common.print_build("exit_confidence", ops.load_library()[1])
    probe_common.print_sass(cs, build.library_path(ops.SOURCE), SASS_KEYS)


def _inputs(cs, shape, dtype):
    h, scale, w = cs._exit_inputs(max(shape[0], 8), *shape[1:], seed=100,
                                  dtype=dtype)
    return h[:shape[0]].contiguous(), scale, w


def _host(cs, torch):
    from repro_torch.kernels import build
    from repro_torch.kernels.exit_confidence import ops
    h, scale, w = cs._exit_inputs(8, 128, 10, seed=100)
    dev = h.device
    lib, _ = ops.load_library()
    N, d, V = 8, 128, 10
    index = torch.cuda.current_device()
    p = ops.launch_plan(N, d, V, 4, True, index)
    buf = torch.empty(p.scratch_words, device=dev)
    stream = build.current_stream(dev)
    packed = ops.pack(p, (h.data_ptr(), scale.data_ptr(), w.data_ptr()),
                      buf.data_ptr(), False, 1e-6, 1.0)
    probe_common.host_costs("exit_confidence", {
        "check": lambda: ops.check(h, scale, w, kernel=True),
        "plan": lambda: ops.launch_plan(N, d, V, 4, ops.rows_aligned(
            V, 4, w.data_ptr()), index),
        "allocation": lambda: torch.empty(p.scratch_words, device=dev),
        "stream": lambda: build.current_stream(dev),
        "device context": lambda: build.on_device(dev),
        "pack": lambda: ops.pack(p, (h.data_ptr(), scale.data_ptr(),
                                     w.data_ptr()), buf.data_ptr(), False,
                                 1e-6, 1.0),
        "ctypes launch": lambda: lib.exit_confidence_launch(packed, stream),
        "output views": lambda: buf[:4 * N].view(4, N).unbind(0)[1].view(
            torch.int32),
        "wrapper": lambda: ops.exit_confidence(h, scale, w),
    })


def _profile(cs):
    import re

    from repro_torch.kernels.exit_confidence.ops import exit_confidence

    def name(key):
        m = re.search(r"exit_\w+(<[^>]*>)?", key)
        return m.group(0) if m else key[:40]

    for label, shape, dtype, _ in cs.EXIT_TIMED:
        h, scale, w = _inputs(cs, shape, dtype)
        probe_common.kernel_times(f"{label} {tuple(shape)}",
                                  lambda: exit_confidence(h, scale, w),
                                  name=name)
        del h, scale, w


def _sweep(cs, torch):
    from repro_torch.kernels.exit_confidence import ops
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    bf16, fp32 = torch.bfloat16, torch.float32
    d, v = cs.QWEN3_4B_HEAD[1:]
    keep = dict(ops.KC), ops.STAGES
    try:
        for dtype, shape, kcs in (
                (bf16, (8, d, v), (64, 128, 256)),
                (fp32, (8, d, v), (32, 64, 128)),
                (bf16, (8, 128, v), (256,)), (bf16, (8, 16, v), (256,)),
                (fp32, (8, 64, v), (128,)), (fp32, (8, 16, v), (128,))):
            h, scale, w = _inputs(cs, shape, dtype)
            want = exit_confidence_ref(h, scale, w)
            item = h.element_size()
            for kc in kcs:
                for stages in range(2, ops.MAX_STAGES + 1):
                    ops.KC[item], ops.STAGES = kc, stages
                    ops.plan.cache_clear()
                    ops.launch_plan.cache_clear()
                    p = ops.plan(*shape, item, True, 1)
                    if p.smem > 227 * 1024:
                        continue
                    p = ops.launch_plan(*shape, item, True,
                                        torch.cuda.current_device())
                    errs, same = cs._exit_errors(
                        ops.exit_confidence(h, scale, w), want)
                    dev = cs._device_ms(lambda: ops.exit_confidence(h, scale,
                                                                    w))
                    print(f"[sweep] {cs._dt(dtype)} N,d,V={shape} kc {p.kc} "
                          f"{stages} stages (the plan's: {keep[1]}), "
                          f"{p.blocks} blocks, smem {p.smem}: device alone "
                          f"{dev:.5f} ms (max abs err {max(errs):.3e}, pred "
                          f"equal {same})")
            del h, scale, w, want
    finally:
        ops.KC.update(keep[0])
        ops.STAGES = keep[1]
        ops.plan.cache_clear()
        ops.launch_plan.cache_clear()


def main(argv=None) -> int:
    steps, cs, smi = probe_common.start(__doc__, STEPS, STEPS[:3], argv)
    import torch
    if "build" in steps:
        probe_build(cs)
    if "check" in steps:
        worst = cs.check_exit_confidence()
        print(f"[check] exit_confidence worst {worst:.3e}")
    if "time" in steps:
        with probe_common.sampled_clocks():
            cs._time_exit_confidence()
    if "host" in steps:
        _host(cs, torch)
    if "profile" in steps:
        _profile(cs)
    if "sweep" in steps:
        _sweep(cs, torch)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
