"""Quick probe of the port's two attention kernels on one GPU.

    python3 tools/attention_probe.py [build] [flash] [decode] [time]

(no argument: all four).  A loop for redesigning the kernels that is
shorter than ``chip_smoke.py``'s full run:

- build  — build both libraries (one nvcc each, in parallel); print the
           registers of the bf16 flash kernels and of the decode partial
           kernel at qwen3-4b's heads, every ptxas line that says it
           serialised ``wgmma`` (C7512-C7514), and the flash library's SASS
           counts (HGMMA, HMMA, FFMA);
- flash  — the flash kernel against its plain version at bf16 shapes from
           dh 16 to qwen3-4b's heads (causal, not causal, windows,
           window 0, ragged S);
- decode — the decode kernels at split 128 and 256 against the plain
           version (ragged rows, a ring, an empty row, small heads,
           window 8), bf16 and fp32;
- time   — CUDA-event times (``chip_smoke._time_ms``) of decode attention
           at B 8 with S 1024, 2048 and 4096, B 1 with S 1024 and B 2 with
           S 256, both splits, each also as device time alone (graph
           replay, ``chip_smoke._device_ms``), and of flash attention at
           B 1, H 32, KV 8, S 2048, dh 128, bf16, causal, each beside SDPA
           and its bound.

It raises on a disagreement beyond the kernel checks' tolerances (bf16
2e-2, fp32 2e-5).  Needs a CUDA device; imports torch and the port only.
"""
from __future__ import annotations

import concurrent.futures
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

import probe_common  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import bounds, build  # noqa: E402
from repro_torch.kernels.decode_attention import ops as dops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import \
    decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    flash_attention_ref  # noqa: E402


def probe_build():
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        logs = {name: job.result()[1] for name, job in
                (("flash", pool.submit(fops.load_library)),
                 ("decode", pool.submit(dops.load_library)))}
    for name, log in logs.items():
        probe_common.print_build(name, log, lambda entry: (
            "flash_attention_tc" in entry
            or "decode_partialItLi128ELi4E" in entry))
        for line in log.splitlines():
            if re.search(r"\(C751[234]\)", line):
                print(f"[build] {line.strip()[:300]}")
    sass = cs._sass_counts(build.library_path(fops.SOURCE))
    print(f"[build] flash SASS {sass}")


def probe_flash():
    cases = [((1, 1, 1, 64, dh), True, None) for dh in (16, 32, 64, 128)]
    for dh in (16, 32, 64, 128):
        cases += [((2, 4, 2, 200, dh), False, None),
                  ((1, 4, 2, 300, dh), True, 16)]
    cases += [((1, 32, 8, 2048, 128), True, None),
              ((1, 32, 8, 2048, 128), True, 128),
              ((1, 32, 8, 2047, 128), True, None),
              ((1, 32, 8, 2048, 128), False, None),
              ((2, 4, 2, 64, 32), True, 0)]
    for i, ((B, H, KV, S, dh), causal, window) in enumerate(cases):
        q, k, v = cs._attn_inputs(B, H, KV, S, dh, torch.bfloat16, seed=i)
        got = fops.flash_attention(q, k, v, causal=causal, window=window)
        ok, err = cs._within(got, flash_attention_ref(
            q, k, v, causal=causal, window=window), 2e-2)
        print(f"[flash] B={B} H={H} KV={KV} S={S} dh={dh} causal {causal} "
              f"window {window}: max abs err {err:.3e}")
        if not ok:
            raise AssertionError("flash attention disagrees with its plain "
                                 "version")


def probe_decode():
    cases = [(8, 1024, {}), (1, 256, {}), (4, 4096, {"ring": True}),
             (4, 1000, {"empty_row": True}), (3, 33, {"heads": (6, 1, 64)}),
             (1, 64, {"heads": (8, 8, 16)}), (2, 40, {"heads": (4, 2, 32)}),
             (2, 300, {"heads": (16, 1, 128)})]
    for dtype in (torch.bfloat16, torch.float32):
        for split in (128, 256):
            for window in (None, 8):
                for B, S, mk in cases:
                    args = cs._decode_inputs(B, S, dtype, seed=3, **mk)
                    got = dops.launch(*args, window=window,
                                      softmax_scale=None, split=split)
                    ok, err = cs._within(got, decode_attention_ref(
                        *args, window=window), cs.ATTN_TOL[dtype])
                    if not ok:
                        raise AssertionError(
                            f"decode attention B={B} S={S} {mk} {dtype} "
                            f"split {split} window {window}: max abs err "
                            f"{err}")
            print(f"[decode] {cs._dt(dtype)} split {split}: "
                  f"{2 * len(cases)} cases within {cs.ATTN_TOL[dtype]:g}")


def probe_time():
    H, KV, dh = cs.QWEN3_4B_ATTN
    for B, S in ((8, 1024), (8, 2048), (8, 4096), (1, 1024), (2, 256)):
        g = torch.Generator().manual_seed(200 + S)
        q, k, v = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
                   for shape in ((B, H, dh), (B, KV, S, dh), (B, KV, S, dh)))
        sp = torch.arange(S, dtype=torch.int32,
                          device="cuda").expand(B, S).contiguous()
        cur = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        for split in (128, 256):
            t = [cs._time_ms(lambda: dops.launch(
                q, k, v, sp, cur, window=None, softmax_scale=None,
                split=split), 200) for _ in range(2)]
            dev = cs._device_ms(lambda: dops.launch(
                q, k, v, sp, cur, window=None, softmax_scale=None,
                split=split))
            print(f"[time] decode B={B} S={S} split {split}: "
                  f"{t[0]:.5f}/{t[1]:.5f} ms, device time alone (graph "
                  f"replay) {dev:.5f} ms")
        t = [cs._time_ms(lambda: cs._sdpa(q, k, v, sp, cur), 200)
             for _ in range(2)]
        print(f"[time] decode B={B} S={S} sdpa {t[0]:.5f}/{t[1]:.5f} ms, "
              f"bound {bounds.decode_attention(B, H, KV, S, dh, 2)[0]:.6f}")
    q, k, v = cs._attn_inputs(1, H, KV, 2048, dh, torch.bfloat16, seed=5)
    t = [cs._time_ms(lambda: fops.flash_attention(q, k, v), 20)
         for _ in range(2)]
    sd = [cs._time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20) for _ in range(2)]
    bound = bounds.flash_attention(1, H, KV, 2048, dh, 2, True, None)[0]
    print(f"[time] flash B=1 H={H} KV={KV} S=2048 dh={dh} bf16 causal: "
          f"{t[0]:.5f}/{t[1]:.5f} ms, sdpa {sd[0]:.5f}/{sd[1]:.5f} ms, "
          f"bound {bound:.6f}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe needs a GPU")
    print(f"[device] {torch.cuda.get_device_name(0)}; " + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    steps = {"build": probe_build, "flash": probe_flash,
             "decode": probe_decode, "time": probe_time}
    for name in argv or list(steps):
        steps[name]()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
