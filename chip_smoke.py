"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. device   — require a CUDA device; print its name, count, power limit and
              the fp32 matmul precision (TF32 is switched off);
2. build    — build the five CUDA kernels from the sources in this
              checkout, one ``nvcc`` per source, all started together, and
              print each one's ptxas summary;
3. kernel   — hold each kernel against its plain PyTorch version on the
              card: the exit kernel at the classifier path's shapes, a
              ragged several-slab vocab, the qwen3-4b exit head in fp32 and
              bf16 and exact ties; the decode-attention kernel at the decode
              path's shapes in bf16 and fp32 with ragged positions,
              unwritten slots, a ring, a window and a row with no valid slot;
              RMSNorm, flash attention and the mLSTM chunk at the JAX kernel
              tests' sweeps and the kernel benchmark's shapes in fp32 and
              bf16 (RMSNorm also at qwen3-4b's width; flash attention also
              with a window and no causal mask, window 0, a ragged S and
              qwen3-4b's heads; the mLSTM chunk fresh and with a state, and
              two chunks chained);
4. timing   — CUDA-event times of each kernel and its plain version beside
              the bound, and of its library call where one PyTorch call
              computes the same function (``scaled_dot_product_attention``
              for both attention kernels, ``rms_norm``); for RMSNorm, flash
              attention and the mLSTM chunk this is their main path, the
              kernel entry point at ``benchmarks/bench_kernels.py``'s shapes
              (plus one larger shape each for the first two), with the
              launch counts set to 0 before it and read after, and each
              output held against its plain version on the same inputs;
5. serve    — ``Service`` -> ``device-kernel`` on the anytime classifier at
              full width (random weights from seed 0), 120 requests from 8
              clients on the wall clock with two stacked device windows, with
              a check that every stage dispatch went through the exit kernel;
6. decode   — ``Service`` -> ``device-kernel`` (mode "decode") on qwen3-4b
              at full width (bf16, random weights from seed 0, 36 layers in
              3 stages): a pool of 16 sequences warmed by batched decode
              steps, the kernel route against the plain route per stage
              (bf16, and elementwise on fp32 copies),
              stage WCETs per batch bucket, then 96 one-token requests from 8
              clients over two length buckets, with a check that every
              stage dispatch launched the decode kernel once per layer and
              the exit kernel once, and the peak device memory of the 96
              requests;
7. launcher — the token-loop launcher ``repro_torch.launch.serve`` with
              speculation, 24 tokens; then its components again at a
              confidence target that mixes depths, with a check that the
              discarded speculative depths left the committed cache
              unwritten;
8. report   — one ``{"kernels": [...]}`` line, then the result line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import io
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

SRC = pathlib.Path(__file__).resolve().parent / "src"

CONF_ATOL = 1e-5     # the JAX package's own kernel tests: conf 1e-5,
STAT_ATOL = 1e-4     # max_logit / lse 1e-4, pred exact
# tests/test_kernels.py's tolerances (atol = rtol) for decode attention,
# flash attention, RMSNorm and the mLSTM chunk (bf16 8e-2, two chunks
# chained 2e-4)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
MLSTM_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-2}
MLSTM_CHAINED_TOL = 2e-4
# the most an fp32 mLSTM h may differ from the plain version in float64,
# in units of the tolerance, on a row whose normaliser cancels
# (``_mlstm_compare``)
MLSTM_KAPPA_CAP = 16.0

QWEN3_4B_HEAD = (8, 2560, 151936)   # rows, d_model, vocab of qwen3-4b
QWEN3_4B_ATTN = (32, 8, 128)        # query heads, KV heads, head dim
BATCH_BUCKETS = (1, 2, 4, 8)
LEN_BUCKETS = (256, 1024)           # the decode path's KV slot counts


def _import_port():
    if not (SRC / "repro_torch").is_dir():
        raise RuntimeError(f"{SRC / 'repro_torch'} not found: run this script "
                           "from a checkout of the repository")
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))


def phase_device() -> tuple:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py needs a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {name} x{torch.cuda.device_count()} "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi.splitlines()[0])
    print(f"[device] float32 matmul precision: "
          f"{torch.get_float32_matmul_precision()}, "
          f"matmul tf32 {torch.backends.cuda.matmul.allow_tf32}")
    return name, smi.splitlines()[0]


def _ptxas_summary(log: str) -> str:
    """ptxas's -v report of one library in a line: the kernels compiled,
    their register range, the most shared memory and any spills."""
    regs, smem, spills = [], [0], []
    for line in log.splitlines():
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split()[0]))
            if "smem" in line:
                smem.append(int(line.split("bytes smem")[0].split()[-1]))
        elif "spill stores" in line:
            spills += [int(part.split()[0]) for part in line.split(",")
                       if "spill" in part]
    if not regs:
        return "already built"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"up to {max(smem)} bytes static smem, "
            f"{'no spills' if not any(spills) else f'spills {spills}'}")


KERNELS = ("exit_confidence", "decode_attention", "rmsnorm",
           "flash_attention", "mlstm_chunk")


def phase_build() -> None:
    """Build every kernel library at once (one nvcc per source)."""
    mods = {name: importlib.import_module(f"repro_torch.kernels.{name}.ops")
            for name in KERNELS}
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(mods)) as pool:
        jobs = {name: pool.submit(mod.load_library)
                for name, mod in mods.items()}
        logs = {name: job.result()[1] for name, job in jobs.items()}
    print(f"[build] {len(logs)} kernels: {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        print(f"[build] {name}: {_ptxas_summary(log)}")


def _exit_inputs(n, d, v, seed, *, ties=(), dtype=torch.float32):
    """h (n, d), scale (d,), w_out (d, v) on the card in ``dtype``, from
    ``seed``.

    ``ties``: column indices that get the same one-hot column e_0 of
    ``w_out`` with h[:, 0] raised, so they share the largest logit exactly
    (one nonzero product: every summation order gives the same value) and
    the first of them is the argmax."""
    g = torch.Generator().manual_seed(seed)
    h = torch.randn(n, d, generator=g)
    scale = 0.1 * torch.randn(d, generator=g)
    w = 0.02 * torch.randn(d, v, generator=g)
    if ties:
        h[:, 0] = 4.0
        scale[0] = 0.0
        for c in ties:
            w[:, c] = 0.0
            w[0, c] = 1.0
    return tuple(t.to("cuda", dtype) for t in (h, scale, w))


def check_exit_confidence(verbose: bool = True) -> float:
    """Kernel against plain version at the path's shapes, a ragged vocab,
    the qwen3-4b head (fp32 at N 8, bf16 at every batch bucket, as the
    decode path launches it) and exact ties.  Returns the largest abs error of
    conf / max_logit / lse; raises on any disagreement."""
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    d, v = QWEN3_4B_HEAD[1:]
    cases = [(f"path N={n}", (n, 128, 10), {}) for n in BATCH_BUCKETS]
    cases += [("ragged N=13 V=1000", (13, 128, 1000), {}),
              ("qwen3-4b head", QWEN3_4B_HEAD, {})]
    # the decode path's batch buckets at the qwen3-4b head, rows of one
    # bf16 input (one 0.78 GB w_out serves them all)
    cases += [(f"qwen3-4b head bf16 N={n}", (n, d, v),
               {"dtype": torch.bfloat16, "head_rows": True})
              for n in sorted(BATCH_BUCKETS, reverse=True)]
    cases += [("ragged bf16 N=13 V=1000", (13, 128, 1000),
               {"dtype": torch.bfloat16}),
              ("ragged bf16 N=3 V=1001 (no 16-byte rows)", (3, 128, 1001),
               {"dtype": torch.bfloat16}),
              ("ties in slab + across", (13, 128, 1000),
               {"ties": (100, 200, 700)}),
              ("ties across slabs", (13, 128, 1000), {"ties": (300, 900)}),
              ("ties bf16 in slab", (13, 128, 1000),
               {"ties": (100, 200, 700), "dtype": torch.bfloat16}),
              ("ties bf16 across slabs", (13, 128, 3000),
               {"ties": (300, 1500, 2900), "dtype": torch.bfloat16})]
    worst = 0.0
    head = None
    for i, (label, (n, d, v), kw) in enumerate(cases):
        if kw.get("head_rows"):
            if head is None:
                head = _exit_inputs(max(BATCH_BUCKETS), d, v, seed=i,
                                    dtype=kw["dtype"])
            h, scale, w = head
            h = h[:n].contiguous()
        else:
            h, scale, w = _exit_inputs(n, d, v, seed=i, **kw)
        got = exit_confidence(h, scale, w)
        torch.cuda.synchronize()
        want = exit_confidence_ref(h, scale, w)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in
                zip((got[0], got[2], got[3]), (want[0], want[2], want[3]))]
        same_pred = bool(torch.equal(got[1], want[1]))
        if verbose:
            print(f"[kernel] exit_confidence {label} (N={n}, d={d}, V={v}): "
                  f"conf {errs[0]:.3e} max_logit {errs[1]:.3e} "
                  f"lse {errs[2]:.3e} pred {'equal' if same_pred else 'DIFFER'}")
        if kw.get("ties") and not bool((got[1] == kw["ties"][0]).all()):
            raise AssertionError(f"{label}: kernel argmax {got[1].tolist()} "
                                 f"is not the first tied column "
                                 f"{kw['ties'][0]}")
        if not same_pred or errs[0] > CONF_ATOL or errs[1] > STAT_ATOL \
                or errs[2] > STAT_ATOL:
            raise AssertionError(f"exit_confidence {label}: kernel disagrees "
                                 f"with the plain version: errors {errs}, "
                                 f"pred equal {same_pred}")
        worst = max(worst, *errs)
    return worst


def _within(got, want, tol):
    """``|got - want| <= tol + tol * |want|`` everywhere (the form of the
    JAX package's kernel tests), and the largest abs error."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    return bool((err <= tol + tol * want.abs()).all()), float(err.max())


def _within_rows(got, want, tol):
    """Per batch row, ``max |got - want| <= tol + tol * max |want|``: the
    bf16 tolerance taken against each row's scale.  A stage is 12 layers of
    bf16 arithmetic whose residual sums cancel, so an element's error
    follows the size of its summands, not of the result.  Returns (ok,
    largest abs error, elements outside the elementwise bound)."""
    got, want = got.float().flatten(1), want.float().flatten(1)
    err = (got - want).abs()
    scale = want.abs().amax(1)
    ok = bool((err.amax(1) <= tol + tol * scale).all())
    n_out = int((err > tol + tol * want.abs()).sum())
    return ok, float(err.max()), n_out


def _decode_inputs(B, S, dtype, seed, *, heads=QWEN3_4B_ATTN, ring=False,
                   empty_row=False):
    """q, k, v, slot_pos, cur_pos on the card, from ``seed``.

    Row b holds positions 0..len_b-1 (ragged lengths in [1, S], the other
    slots unwritten, -1) and decodes at cur_pos = len_b - 1.  ``ring``: row
    b has run P_b in (S, 2S] tokens through S slots, so slot j holds
    position j + S where j < P_b - S (non-monotonic slot_pos), at cur_pos
    P_b - 1.  ``empty_row``: row 0 has no written slot."""
    H, KV, dh = heads
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, dh, generator=g)
    k = torch.randn(B, KV, S, dh, generator=g)
    v = torch.randn(B, KV, S, dh, generator=g)
    slots = torch.arange(S, dtype=torch.int32).expand(B, S).clone()
    if ring:
        P = torch.randint(S + 1, 2 * S + 1, (B,), generator=g,
                          dtype=torch.int32)
        slot_pos = torch.where(slots < (P - S)[:, None], slots + S, slots)
        cur = P - 1
    else:
        lens = torch.randint(1, S + 1, (B,), generator=g, dtype=torch.int32)
        slot_pos = torch.where(slots < lens[:, None], slots, -1)
        cur = lens - 1
    if empty_row:
        slot_pos[0] = -1
    return (q.to("cuda", dtype), k.to("cuda", dtype), v.to("cuda", dtype),
            slot_pos.to(torch.int32).cuda().contiguous(),
            cur.to(torch.int32).cuda())


def check_decode_attention(verbose: bool = True) -> float:
    """Kernel against plain version at the decode path's shapes (B 1, 2,
    4, 8; qwen3-4b's heads; both length buckets) in bf16 and fp32, with
    ragged positions and unwritten slots, a ring, window 8 and a row with
    no valid slot, plus smaller head dims and GQA ratios.  Returns the
    largest abs error; raises on any disagreement."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    cases = [(f"path B={b} S={s}", b, s, {}, {})
             for s in LEN_BUCKETS for b in BATCH_BUCKETS]
    cases += [("ring B=4 S=256", 4, 256, {"ring": True}, {}),
              ("window 8 B=8 S=1024", 8, 1024, {}, {"window": 8}),
              ("ring + window 8 B=2 S=256", 2, 256, {"ring": True},
               {"window": 8}),
              ("empty row B=4 S=256", 4, 256, {"empty_row": True}, {}),
              ("S=1000 (not a chunk multiple)", 3, 1000, {}, {}),
              ("H4 KV2 dh64 (reduced qwen3)", 4, 40,
               {"heads": (4, 2, 64)}, {}),
              ("H6 KV1 dh64", 3, 33, {"heads": (6, 1, 64)}, {}),
              ("H8 KV8 dh16", 1, 64, {"heads": (8, 8, 16)}, {}),
              ("H4 KV2 dh32", 2, 40, {"heads": (4, 2, 32)}, {}),
              ("H16 KV1 dh128 (two head groups)", 2, 300,
               {"heads": (16, 1, 128)}, {})]
    worst = 0.0
    i = 0
    for dtype in (torch.bfloat16, torch.float32):
        tol = ATTN_TOL[dtype]
        for label, B, S, mk, kw in cases:
            i += 1
            args = _decode_inputs(B, S, dtype, seed=i, **mk)
            got = decode_attention(*args, **kw)
            torch.cuda.synchronize()
            want = decode_attention_ref(*args, **kw)
            torch.cuda.synchronize()
            ok, err = _within(got, want, tol)
            if mk.get("empty_row") and bool(got[0].ne(0).any()):
                raise AssertionError(f"decode_attention {label}: the row "
                                     "with no valid slot is not all zeros")
            if verbose:
                print(f"[kernel] decode_attention {label} "
                      f"{str(dtype).removeprefix('torch.')}: max abs err "
                      f"{err:.3e} (tol {tol:g})")
            if not ok or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"decode_attention {label} {dtype}: "
                                     f"kernel disagrees with the plain "
                                     f"version (max abs err {err})")
            worst = max(worst, err)
    return worst


def _randn(shape, g, scale=1.0):
    return scale * torch.randn(shape, generator=g)


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_rmsnorm(verbose: bool = True) -> float:
    """Kernel against plain version at ``tests/test_kernels.py``'s sweep
    (N, d of (8, 32), (37, 64), (256, 128), (5, 256)), the kernel
    benchmark's 1024 x 512, qwen3-4b's width 2560 and widths that take the
    scalar path, in fp32 and bf16 (scale in x's dtype, and fp32 scale with
    bf16 x).  Returns the largest abs error; raises on any disagreement."""
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    shapes = [(8, 32), (37, 64), (256, 128), (5, 256), (1024, 512),
              (37, 2560), (8, 2560), (13, 99), (6, 100)]
    worst = 0.0
    for i, ((N, d), dtype, scale_fp32) in enumerate(
            [(sh, dt, False) for dt in (torch.float32, torch.bfloat16)
             for sh in shapes]
            + [((37, 2560), torch.bfloat16, True),
               ((13, 100), torch.bfloat16, True)]):
        g = torch.Generator().manual_seed(300 + i)
        x = _randn((N, d), g).to("cuda", dtype)
        scale = _randn((d,), g, 0.1).to(
            "cuda", torch.float32 if scale_fp32 else dtype)
        got = rmsnorm(x, scale)
        torch.cuda.synchronize()
        want = rmsnorm_ref(x, scale)
        torch.cuda.synchronize()
        tol = ATTN_TOL[dtype]
        ok, err = _within(got, want, tol)
        if verbose:
            print(f"[kernel] rmsnorm N={N} d={d} {_dt(dtype)}"
                  f"{' (fp32 scale)' if scale_fp32 else ''}: max abs err "
                  f"{err:.3e} (tol {tol:g})")
        if not ok or got.dtype != dtype or got.shape != x.shape \
                or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"rmsnorm N={N} d={d} {dtype}: kernel "
                                 "disagrees with the plain version (max abs "
                                 f"err {err})")
        worst = max(worst, err)
    return worst


def _attn_inputs(B, H, KV, S, dh, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return tuple(_randn(shape, g).to("cuda", dtype)
                 for shape in ((B, H, S, dh), (B, KV, S, dh), (B, KV, S, dh)))


def check_flash_attention(verbose: bool = True) -> float:
    """Kernel against plain version at ``tests/test_kernels.py``'s sweep
    (four shapes x causal / not / causal with window 16), the kernel
    benchmark's shape, no causal mask with window 8, window 0 (rows with
    no visible key all zeros),
    ragged S, qwen3-4b's heads (H 32, KV 8, dh 128) and more than 8 query
    heads per KV head, in fp32 and bf16.  Returns the largest abs error;
    raises on any disagreement."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    sweep = [(1, 2, 2, 32, 16), (2, 4, 2, 64, 32), (1, 8, 1, 128, 64),
             (2, 6, 2, 48, 32)]
    cases = [(sh, {"causal": c, "window": w}) for sh in sweep
             for c, w in ((True, None), (False, None), (True, 16))]
    cases += [((1, 4, 2, 256, 64), {"causal": True, "window": None}),
              ((2, 4, 2, 64, 32), {"causal": False, "window": 8}),
              ((1, 4, 2, 100, 64), {"causal": False, "window": 8}),
              ((2, 4, 2, 64, 32), {"causal": True, "window": 0}),
              ((1, 4, 1, 64, 16), {"causal": False, "window": 0}),
              ((2, 4, 2, 1000, 64), {"causal": True, "window": None}),
              ((1, 3, 3, 77, 128), {"causal": True, "window": 20}),
              ((1, 32, 8, 512, 128), {"causal": True, "window": None}),
              ((1, 32, 8, 300, 128), {"causal": False, "window": None}),
              ((2, 16, 1, 40, 64), {"causal": True, "window": None})]
    worst = 0.0
    i = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[dtype]
        for (B, H, KV, S, dh), kw in cases:
            i += 1
            q, k, v = _attn_inputs(B, H, KV, S, dh, dtype, seed=400 + i)
            got = flash_attention(q, k, v, **kw)
            torch.cuda.synchronize()
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            ok, err = _within(got, want, tol)
            label = (f"B={B} H={H} KV={KV} S={S} dh={dh} causal "
                     f"{kw['causal']} window {kw['window']} {_dt(dtype)}")
            # causal with window 0 leaves no key visible; without the
            # causal mask only the last position sees none
            no_key = got if kw["causal"] else got[:, :, -1]
            if kw["window"] == 0 and bool(no_key.ne(0).any()):
                raise AssertionError(f"flash_attention {label}: a row with "
                                     "no visible key is not all zeros")
            if verbose:
                print(f"[kernel] flash_attention {label}: max abs err "
                      f"{err:.3e} (tol {tol:g})")
            if not ok or got.dtype != dtype or got.shape != q.shape \
                    or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"flash_attention {label}: kernel "
                                     "disagrees with the plain version (max "
                                     f"abs err {err})")
            worst = max(worst, err)
    return worst


def _mlstm_inputs(B, H, L, dh, dtype, seed, *, state):
    """q, k, v in ``dtype``; gates and state fp32, on the card.  ``state``:
    C0, n0 of 0.1 N(0, 1) and m0 = 0; else the fresh state (zeros, m0 =
    -1e30).  f_pre is raised by 2, as the JAX kernel tests raise it."""
    g = torch.Generator().manual_seed(seed)
    q, k, v = (_randn((B, H, L, dh), g).to("cuda", dtype) for _ in range(3))
    i_pre = _randn((B, H, L), g).cuda()
    f_pre = (_randn((B, H, L), g) + 2.0).cuda()
    if state:
        C0 = _randn((B, H, dh, dh), g, 0.1).cuda()
        n0 = _randn((B, H, dh), g, 0.1).cuda()
        m0 = torch.zeros(B, H, device="cuda")
    else:
        C0 = torch.zeros(B, H, dh, dh, device="cuda")
        n0 = torch.zeros(B, H, dh, device="cuda")
        m0 = torch.full((B, H), -1e30, device="cuda")
    return q, k, v, i_pre, f_pre, C0, n0, m0


def _mlstm_compare(label, got, want, tol, h64=None, kappa=None,
                   verbose=True) -> float:
    """Hold one mLSTM chunk's (h, C1, n1, m1) from the kernel against the
    plain version's.  C1, n1 and m1, and a bf16 h, are held elementwise at
    ``tol``.  An fp32 h is held against ``h64``, the plain version in
    float64 on the same inputs, at ``tol (1 + |h64|)`` times its row's
    condition number ``kappa`` (``mlstm_chunk_condition``; 1 where not
    given) capped at ``MLSTM_KAPPA_CAP``: where a row's normaliser cancels,
    any fp32 summation order moves h by more than ``tol``, the plain
    version's too (printed beside the kernel's: each one's largest error
    against float64 in units of ``tol (1 + |h64|)``).  Returns the largest
    abs error against the plain version; raises on any disagreement."""
    checks = {"h": _within(got[0], want[0], tol)}
    note = ""
    if h64 is not None:
        unscaled = tol + tol * h64.abs()
        scale = 1.0 if kappa is None else kappa.clamp(
            max=MLSTM_KAPPA_CAP)[..., None]
        err = (got[0].double() - h64).abs()
        checks["h"] = (bool((err <= unscaled * scale).all()), checks["h"][1])
        plain = (want[0].double() - h64).abs()
        note = (f" (against float64, in units of {tol:g} (1 + |h|): kernel "
                f"{float((err / unscaled).max()):.3f}, plain "
                f"{float((plain / unscaled).max()):.3f}"
                + ("" if kappa is None else
                   f"; row condition up to {float(kappa.max()):.1f}") + ")")
    for name, a, b in zip(("C1", "n1", "m1"), got[1:], want[1:]):
        checks[name] = _within(a, b, tol)
    bad = [name for (name, (ok, _)), a, b in zip(checks.items(), got, want)
           if not ok or a.dtype != b.dtype or a.shape != b.shape
           or not bool(torch.isfinite(a).all())]
    errs = [e for _, e in checks.values()]
    if verbose:
        print(f"[kernel] mlstm_chunk {label}: max abs err h {errs[0]:.3e}"
              f"{note} C1 {errs[1]:.3e} n1 {errs[2]:.3e} m1 {errs[3]:.3e} "
              f"(tol {tol:g})")
    if bad:
        raise AssertionError(f"mlstm_chunk {label}: kernel disagrees with "
                             f"the plain version on {bad} (max abs errs "
                             f"{errs})")
    return max(errs)


def _mlstm_witness(args):
    """For fp32 ``args``: h of the plain version in float64 and each row's
    condition number (``_mlstm_compare``'s arguments); else (None, None)."""
    from repro_torch.kernels.mlstm_chunk.ref import (mlstm_chunk_condition,
                                                     mlstm_chunk_ref)
    if args[0].dtype != torch.float32:
        return None, None
    q, k, _, i_pre, f_pre, _, n0, m0 = args
    return (mlstm_chunk_ref(*(t.double() for t in args))[0],
            mlstm_chunk_condition(q, k, i_pre, f_pre, n0, m0))


def check_mlstm_chunk(verbose: bool = True) -> float:
    """Kernel against plain version at ``tests/test_kernels.py``'s sweep
    ((1, 2, 8, 8), (2, 4, 16, 16), (2, 2, 32, 32)), the kernel benchmark's
    B 2, H 4, L 128, dh 64 and a ragged L 100, fresh (m0 = -1e30) and with
    a state, in fp32 and bf16 (bf16 8e-2), then two kernel chunks chained
    against the plain version chained (2e-4; h against the plain version
    chained in float64, unscaled), each as ``_mlstm_compare`` holds it.
    Returns the largest abs error; raises on any disagreement."""
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    shapes = [(1, 2, 8, 8), (2, 4, 16, 16), (2, 2, 32, 32), (2, 4, 128, 64),
              (1, 2, 100, 64)]
    worst = 0.0
    i = 0
    for dtype in (torch.float32, torch.bfloat16):
        for B, H, L, dh in shapes:
            for state in (False, True):
                i += 1
                args = _mlstm_inputs(B, H, L, dh, dtype, 500 + i,
                                     state=state)
                got = mlstm_chunk(*args)
                torch.cuda.synchronize()
                want = mlstm_chunk_ref(*args)
                torch.cuda.synchronize()
                label = (f"B={B} H={H} L={L} dh={dh} {_dt(dtype)} "
                         f"{'with a state' if state else 'fresh'}")
                worst = max(worst, _mlstm_compare(
                    label, got, want, MLSTM_TOL[dtype],
                    *_mlstm_witness(args), verbose=verbose))
    # two chunks chained, from a fresh state
    B, H, L, dh = 2, 4, 64, 64
    full = _mlstm_inputs(B, H, 2 * L, dh, torch.float32, 600, state=False)
    outs = []
    for fn, cast in ((mlstm_chunk, lambda t: t),
                     (mlstm_chunk_ref, lambda t: t),
                     (mlstm_chunk_ref, lambda t: t.double())):
        q, k, v, i_pre, f_pre, C0, n0, m0 = (cast(t) for t in full)
        halves = [tuple(t[:, :, j * L:(j + 1) * L].contiguous()
                        for t in (q, k, v, i_pre, f_pre)) for j in (0, 1)]
        h1, C1, n1, m1 = fn(*halves[0], C0, n0, m0)
        h2, C2, n2, m2 = fn(*halves[1], C1, n1, m1)
        outs.append((torch.cat([h1, h2], 2), C2, n2, m2))
    torch.cuda.synchronize()
    worst = max(worst, _mlstm_compare(
        f"two chunks of L={L} chained (B={B} H={H} dh={dh} fp32)", outs[0],
        outs[1], MLSTM_CHAINED_TOL, outs[2][0], verbose=verbose))
    return worst


def _time_ms(fn, iters: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _sdpa(q, k, v, slot_pos, cur_pos):
    """The library call that computes decode attention's function: one
    ``scaled_dot_product_attention`` with the same per-row mask and GQA
    (timed here as a yardstick; the port never calls it)."""
    mask = ((slot_pos >= 0) & (slot_pos <= cur_pos[:, None]))[:, None, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)[:, :, 0]


def _time_pair(kernel, plain, iters):
    """Plain, kernel, kernel, plain: the lower of each pair (ms)."""
    p1 = _time_ms(plain, iters)
    k1 = _time_ms(kernel, iters)
    k2 = _time_ms(kernel, iters)
    p2 = _time_ms(plain, iters)
    return (k1, k2), (p1, p2)


def phase_timing() -> dict:
    """Kernel, plain version (and library call) timed in turns; each beside
    its bound from ``repro_torch.kernels.bounds`` (HBM bytes or fp32
    flops at the published H100 SXM peaks)."""
    from repro_torch.kernels import bounds
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.kernels.exit_confidence.ref import exit_confidence_ref
    out = {}
    for label, shape, dtype, iters in (
            ("path", (8, 128, 10), torch.float32, 2000),
            ("qwen3-4b head", QWEN3_4B_HEAD, torch.float32, 50),
            ("qwen3-4b head bf16", QWEN3_4B_HEAD, torch.bfloat16, 50)):
        h, scale, w = _exit_inputs(*shape, seed=100, dtype=dtype)
        ks, ps = _time_pair(lambda: exit_confidence(h, scale, w),
                            lambda: exit_confidence_ref(h, scale, w), iters)
        bound, by = bounds.exit_confidence(*shape,
                                           itemsize=h.element_size())
        out[label] = dict(shape=list(shape), dtype=str(dtype), ms=min(ks),
                          plain_ms=min(ps), bound_ms=bound, bound_by=by,
                          library_ms=None)
        print(f"[timing] exit_confidence {label} N,d,V={shape}: kernel "
              f"{ks[0]:.5f}/{ks[1]:.5f} ms, plain {ps[0]:.5f}/{ps[1]:.5f} "
              f"ms, bound {bound:.6f} ms ({by})")
        del h, scale, w
    for S in (1024, 4096):
        B = 8
        g = torch.Generator().manual_seed(200 + S)
        H, KV, dh = QWEN3_4B_ATTN
        q, k, v = (torch.randn(shape, generator=g).to("cuda", torch.bfloat16)
                   for shape in ((B, H, dh), (B, KV, S, dh), (B, KV, S, dh)))
        slot_pos = torch.arange(S, dtype=torch.int32,
                                device="cuda").expand(B, S).contiguous()
        cur = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
        args = (q, k, v, slot_pos, cur)
        ks, ps = _time_pair(lambda: decode_attention(*args),
                            lambda: decode_attention_ref(*args), 200)
        lib = [_time_ms(lambda: _sdpa(*args), 200) for _ in range(2)]
        lib_err = float((_sdpa(*args).float()
                         - decode_attention(*args).float()).abs().max())
        # every slot is valid here, so the function needs the whole cache
        bound, by = bounds.decode_attention(B, H, KV, S, dh, itemsize=2)
        out[f"decode S={S}"] = dict(
            shape=[B, H, KV, S, dh], dtype="torch.bfloat16", ms=min(ks),
            plain_ms=min(ps), bound_ms=bound, bound_by=by,
            library_ms=min(lib))
        print(f"[timing] decode_attention B={B} H={H} KV={KV} S={S} "
              f"dh={dh} bf16: kernel {ks[0]:.5f}/{ks[1]:.5f} ms, plain "
              f"{ps[0]:.5f}/{ps[1]:.5f} ms, sdpa {lib[0]:.5f}/{lib[1]:.5f} "
              f"ms (max abs diff to the kernel {lib_err:.3e}), bound "
              f"{bound:.6f} ms ({by})")
    return out


def _timed_row(label, ks, ps, lib, bound, by, shape, dtype, err,
               lib_err=None):
    print(f"[timing] {label}: kernel {ks[0]:.5f}/{ks[1]:.5f} ms (max abs "
          f"err to the plain version {err:.3e}), plain "
          f"{ps[0]:.5f}/{ps[1]:.5f} ms, library "
          + (f"{lib[0]:.5f}/{lib[1]:.5f} ms (max abs diff to the kernel "
             f"{lib_err:.3e})" if lib else "none")
          + f", bound {bound:.6f} ms ({by})")
    return dict(shape=list(shape), dtype=str(dtype), ms=min(ks),
                plain_ms=min(ps), bound_ms=bound, bound_by=by,
                library_ms=min(lib) if lib else None, max_abs_err=err)


def phase_kernel_entry() -> dict:
    """The kernel entry point of RMSNorm, flash attention and the mLSTM
    chunk, as ``benchmarks/bench_kernels.py`` drives the JAX package's:
    each kernel at that script's shape (and one larger shape for the first
    two) timed in turns with its plain version, beside its bound and its
    library call.  The launch counts are set to 0 before and read after;
    each kernel must have launched.  Each output is held against the plain
    version's on the same inputs, at the tolerances of the kernel checks
    (``_mlstm_compare`` for the mLSTM chunk), and checked for shape, dtype
    and finite values."""
    from repro_torch.kernels import bounds
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.kernels.mlstm_chunk.ops import mlstm_chunk
    from repro_torch.kernels.mlstm_chunk.ref import mlstm_chunk_ref
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    F = torch.nn.functional
    fns = (rmsnorm, flash_attention, mlstm_chunk)
    for fn in fns:
        fn.launches = 0
    out = {}

    def held(label, y, want, like):
        """y against the plain version's ``want`` at the kernel checks'
        tolerance; returns the largest abs error."""
        ok, err = _within(y, want, ATTN_TOL[like.dtype])
        if not ok or y.shape != like.shape or y.dtype != like.dtype \
                or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"kernel entry {label}: output "
                                 f"{tuple(y.shape)} {y.dtype} is not finite, "
                                 f"not shaped as {tuple(like.shape)} "
                                 f"{like.dtype} or off the plain version "
                                 f"(max abs err {err})")
        return err

    for label, (N, d), dtype, iters in (
            ("rmsnorm", (1024, 512), torch.float32, 2000),
            ("rmsnorm qwen3-4b width", (16384, 2560), torch.bfloat16, 200)):
        g = torch.Generator().manual_seed(700 + N)
        x = _randn((N, d), g).to("cuda", dtype)
        scale = _randn((d,), g, 0.1).to("cuda", dtype)
        weight = 1.0 + scale                  # the library call's weight
        ks, ps = _time_pair(lambda: rmsnorm(x, scale),
                            lambda: rmsnorm_ref(x, scale), iters)
        lib = [_time_ms(lambda: F.rms_norm(x, (d,), weight=weight, eps=1e-6),
                        iters) for _ in range(2)]
        y = rmsnorm(x, scale)
        err = held(label, y, rmsnorm_ref(x, scale), x)
        lib_err = float((F.rms_norm(x, (d,), weight=weight, eps=1e-6).float()
                         - y.float()).abs().max())
        bound, by = bounds.rmsnorm(N, d, x.element_size())
        out[label] = _timed_row(f"{label} N={N} d={d} {_dt(dtype)}", ks, ps,
                                lib, bound, by, (N, d), dtype, err, lib_err)
        del x, scale, weight, y
    for label, (B, H, KV, S, dh), dtype, iters in (
            ("flash_attention", (1, 4, 2, 256, 64), torch.float32, 500),
            ("flash_attention qwen3-4b heads", (1, 32, 8, 2048, 128),
             torch.bfloat16, 10)):
        q, k, v = _attn_inputs(B, H, KV, S, dh, dtype, seed=800 + S)
        ks, ps = _time_pair(lambda: flash_attention(q, k, v),
                            lambda: flash_attention_ref(q, k, v), iters)
        lib = [_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters)
            for _ in range(2)]
        y = flash_attention(q, k, v)
        err = held(label, y, flash_attention_ref(q, k, v), q)
        lib_err = float((F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True).float()
            - y.float()).abs().max())
        bound, by = bounds.flash_attention(B, H, KV, S, dh, q.element_size(),
                                           causal=True, window=None)
        out[label] = _timed_row(
            f"{label} B={B} H={H} KV={KV} S={S} dh={dh} causal "
            f"{_dt(dtype)}", ks, ps, lib, bound, by, (B, H, KV, S, dh),
            dtype, err, lib_err)
        del q, k, v, y
    B, H, L, dh = 2, 4, 128, 64
    args = _mlstm_inputs(B, H, L, dh, torch.float32, 900, state=False)
    ks, ps = _time_pair(lambda: mlstm_chunk(*args),
                        lambda: mlstm_chunk_ref(*args), 500)
    label = f"B={B} H={H} L={L} dh={dh} fp32 fresh"
    err = _mlstm_compare(f"{label} (kernel entry)", mlstm_chunk(*args),
                         mlstm_chunk_ref(*args), MLSTM_TOL[torch.float32],
                         *_mlstm_witness(args))
    bound, by = bounds.mlstm_chunk(B, H, L, dh, 4)
    out["mlstm_chunk"] = _timed_row(f"mlstm_chunk {label}", ks, ps, None,
                                    bound, by, (B, H, L, dh), torch.float32,
                                    err)
    launches = {fn.__name__: fn.launches for fn in fns}
    print(f"[timing] kernel entry launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"kernel entry: a kernel never launched: "
                             f"{launches}")
    out["launches"] = launches
    return out


def phase_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.launch.kernel import KernelStageFns
    from repro_torch.models import init_params, stage_forward
    from repro_torch.serving import (ServeSpec, Service, closed_loop_stream,
                                     profile_batched_stages,
                                     profile_host_overhead)
    from repro_torch.training import DifficultyDataset

    cfg = get_config("anytime-classifier")
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    test = DifficultyDataset(num_classes=cfg.vocab_size,
                             seed=0).sample(600, seed=999)
    sample = {"features": test["inputs"]["features"][:1]}
    sfns = KernelStageFns(cfg, (1, 2, 4, 8))

    # each stage's fused output against the plain stage_forward, bucket 8
    h = sfns.pad(params, [{"features": test["inputs"]["features"][i:i + 1]}
                          for i in range(8)], 8)[0]
    hp = h
    for s in range(cfg.num_stages):
        h, pred, conf = sfns.call(s, params, h)
        hp, logits, conf_p = stage_forward(cfg, params, s, hp)
        torch.cuda.synchronize()
        if not (torch.isfinite(h).all() and torch.isfinite(conf).all()):
            raise AssertionError(f"stage {s}: non-finite output")
        h_err = float((h - hp).abs().max())
        err = float((conf - conf_p).abs().max())
        if h_err > CONF_ATOL or err > CONF_ATOL \
                or not torch.equal(pred.long(), logits.argmax(-1)):
            raise AssertionError(f"stage {s}: fused stage disagrees with "
                                 f"stage_forward (h err {h_err}, conf err "
                                 f"{err})")
        print(f"[serve] stage {s} fused vs plain: h err {h_err:.3e}, "
              f"pred equal, conf err {err:.3e}")

    tm, mat = profile_batched_stages(cfg, params, sfns, sample, n_runs=30)
    host_overhead = profile_host_overhead(device="cuda")
    print(f"[serve] stage WCETs (s) [stage x bucket 1,2,4,8]: "
          f"{np.array2string(mat, precision=6)}; host overhead "
          f"{host_overhead * 1e6:.1f} us")
    wcet = float(mat[:, 0].max())
    d_lo, d_hi = 4.0 * wcet, 14.0 * wcet
    stream = closed_loop_stream(test["inputs"], test["labels"], n_clients=8,
                                d_lo=d_lo, d_hi=d_hi, n_requests=120, seed=1)
    spec = ServeSpec(policy="rtdeepiot",
                     policy_args={"predictor": "exp",
                                  "prior_curve": [0.5, 0.7, 0.85]},
                     executor="device-kernel", clock="wall", source="stream",
                     host_overhead=host_overhead, pipeline_depth=3)
    svc = Service.from_spec(spec, cfg=cfg, params=params, time_model=tm,
                            stage_fns=sfns, labels=test["labels"])

    exit_confidence.launches = 0
    res = svc.run(stream)
    launches = exit_confidence.launches

    ex = svc.executor
    preds = [r.prediction for r in svc.responses if not r.missed]
    checks = {
        "120 responses": len(svc.responses) == 120,
        "hidden-state cache empty": ex.cache_stats()["live"] == 0,
        "two stacked windows": ex.max_inflight == 2,
        "some request served": len(preds) > 0,
        "every pred in [0, 10)": all(0 <= p < cfg.vocab_size for p in preds),
        "exit kernel launched once per dispatch":
            res.n_dispatches > 0 and launches == res.n_dispatches,
    }
    lat = float(np.mean([r.latency for r in svc.responses]))
    print(f"[serve] deadlines U[{d_lo * 1e3:.3f}, {d_hi * 1e3:.3f}] ms; "
          f"accuracy {res.accuracy:.4f} miss rate {res.miss_rate:.4f} "
          f"mean depth {res.mean_depth:.4f} mean latency {lat * 1e3:.4f} ms "
          f"dispatches {res.n_dispatches} exit-kernel launches {launches}")
    print(f"[serve] device_time_stats {json.dumps(ex.device_time_stats())}")
    print(f"[serve] cache_stats {ex.cache_stats()}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"serve phase failed: {failed}")
    return dict(launches=launches, n_dispatches=res.n_dispatches)


def _qwen3_pool(cfg, params):
    """16 sequences warmed by batched decode steps: eight of lengths in
    [32, 240] in 256-slot caches, eight in [300, 1000] in 1024-slot caches.

    Each group of eight runs through all stages one position at a time
    (every row at the same position) up to its longest length; then every
    slot beyond a row's own length is marked unwritten (-1).  Returns one
    dict per sequence: its per-stage cache (one row), length, slot count
    and next token, all on the card."""
    from repro_torch.models import (init_decode_cache, slice_decode_cache,
                                    stage_decode_step)
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(1)
    pool = []
    for slots, (lo, hi) in zip(LEN_BUCKETS, ((32, 240), (300, 1000))):
        lens = torch.from_numpy(rng.integers(lo, hi + 1, 8).astype(np.int32))
        cache = init_decode_cache(cfg, 8, slots, device="cuda")
        n = int(lens.max())
        tokens = torch.randint(cfg.vocab_size, (n + 1, 8), generator=g,
                               dtype=torch.int32).cuda()
        t0 = time.perf_counter()
        for t in range(n):
            h = tokens[t]
            cur = torch.full((8,), t, dtype=torch.int32, device="cuda")
            for s in range(cfg.num_stages):
                h, cache[s] = stage_decode_step(cfg, params, s, cache[s], h,
                                                cur, inplace=True)
        torch.cuda.synchronize()
        lens_d = lens.cuda()
        for st in cache:
            for layer in st:
                layer["slot_pos"].masked_fill_(
                    layer["slot_pos"] >= lens_d[:, None], -1)
        print(f"[decode] warmed 8 sequences of lengths {lens.tolist()} in "
              f"{slots}-slot caches: {n} batched steps in "
              f"{time.perf_counter() - t0:.1f} s")
        for i in range(8):
            # the token at position len_i is the one each request decodes
            pool.append(dict(
                cache=[slice_decode_cache(st, i) for st in cache],
                length=int(lens[i]), slots=slots,
                token=tokens[int(lens[i]), i:i + 1].clone()))
    return pool


def _decode_batch(seqs):
    """Token rows and cur_pos (the sequences' lengths) of ``seqs``."""
    h = torch.cat([seq["token"] for seq in seqs])
    cur = torch.tensor([seq["length"] for seq in seqs],
                       dtype=torch.int32, device="cuda")
    return h, cur


def phase_decode_serve() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.exit_confidence.ops import exit_confidence
    from repro_torch.launch.kernel import KernelDecodeStageFns
    from repro_torch.models import (concat_decode_caches, embed_one,
                                    init_params, stage_decode_step)
    from repro_torch.models.attention import apply_gqa_step
    from repro_torch.models.exits import apply_exit, confidence_from_logits
    from repro_torch.serving import (Request, ServeSpec, Service,
                                     profile_host_overhead)
    from repro_torch.serving.batch.batcher import BatchTimeModel

    cfg = get_config("qwen3-4b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[decode] qwen3-4b: {n_params} params "
          f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.3f}"
          f" GB {cfg.dtype}), initialised in {time.perf_counter() - t0:.1f} s"
          f" (set-up)")
    layers = [len(st) for st in params["stages"]]
    sfns = KernelDecodeStageFns(cfg, BATCH_BUCKETS)
    pool = _qwen3_pool(cfg, params)
    long_seqs = [seq for seq in pool if seq["slots"] == 1024]

    # the kernel route against the plain route, batch 8, ragged positions.
    # h and the caches are bf16: the kernel tests' bf16 tolerance (per row
    # against the row's scale for a whole stage, see _within_rows; the same
    # check on fp32 copies is held elementwise, _route_check_fp32)
    tol = ATTN_TOL[torch.bfloat16]
    exit_p = [{"ln": params["exits"][s]["ln"].float(),
               "w_out": params["exit_shared"]["w_out"].float()}
              for s in range(cfg.num_stages)]
    h, cur = _decode_batch(long_seqs)
    # first one layer from one input, where the routes differ only in the
    # attention call: held elementwise
    x = embed_one(cfg, params["embed"], h)
    cache0 = concat_decode_caches([seq["cache"][0][:1] for seq in long_seqs])
    ys = [apply_gqa_step(cfg, params["stages"][0][0]["mixer"], x,
                         cache=cache0[0], cur_pos=cur, decode_attn=route)[0]
          for route in ("kernel", "plain")]
    torch.cuda.synchronize()
    ok, err = _within(*ys, tol)
    if not ok:
        raise AssertionError(f"decode layer 0: kernel route disagrees with "
                             f"the plain route (max abs err {err})")
    print(f"[decode] layer 0 kernel vs plain attention route (B 8): max abs "
          f"err {err:.3e}, elementwise within atol = rtol = {tol}")
    # then each stage, both routes starting from the same hidden state
    for s in range(cfg.num_stages):
        caches = [seq["cache"][s] for seq in long_seqs]
        hk, ck, pred, conf = sfns.call(s, params, h,
                                       concat_decode_caches(caches), cur,
                                       inplace=True)
        hp, cp = stage_decode_step(cfg, params, s,
                                   concat_decode_caches(caches), h, cur,
                                   decode_attn="plain", inplace=True)
        # the plain exit in fp32 from the same rows, as the kernel computes
        logits = apply_exit(cfg, exit_p[s], hk.float()[:, None])[:, 0]
        conf_p = confidence_from_logits(logits)
        torch.cuda.synchronize()
        h_ok, h_err, h_out = _within_rows(hk, hp, tol)
        kv = [_within_rows(a[k], b[k], tol) for a, b in zip(ck, cp)
              for k in ("k", "v")]
        kv_ok = all(ok for ok, _, _ in kv)
        kv_err = max(e for _, e, _ in kv)
        kv_out = sum(n for _, _, n in kv)
        c_err = float((conf - conf_p).abs().max())
        same_slots = all(torch.equal(a["slot_pos"], b["slot_pos"])
                         for a, b in zip(ck, cp))
        if not (torch.isfinite(hk).all() and torch.isfinite(conf).all()):
            raise AssertionError(f"decode stage {s}: non-finite output")
        if not (h_ok and kv_ok and same_slots) or c_err > CONF_ATOL \
                or not torch.equal(pred.long(), logits.argmax(-1)):
            raise AssertionError(
                f"decode stage {s}: kernel route disagrees with the plain "
                f"route (h err {h_err}, {h_out} elements out; cache err "
                f"{kv_err}, {kv_out} out; slot_pos equal {same_slots}; conf "
                f"err {c_err}; |h| up to {float(hp.float().abs().max())})")
        print(f"[decode] stage {s} kernel vs plain route (B 8, positions "
              f"{cur.tolist()}): h max abs err {h_err:.3e} (|h| up to "
              f"{float(hp.float().abs().max()):.3e}; {h_out} of "
              f"{hp.numel()} elements outside atol = rtol = {tol} "
              f"elementwise), cache max abs err {kv_err:.3e} ({kv_out} of "
              f"{sum(a[k].numel() for a in cp for k in ('k', 'v'))} "
              f"outside); slot_pos equal, conf err {c_err:.3e}, pred equal")
        h = hk
    _route_check_fp32(cfg, params, sfns, long_seqs)

    # stage WCETs per (stage, batch bucket) at length 1024: CUDA events
    # around what a dispatch does (cache concatenation and the stage)
    n_runs = 15
    mat = np.zeros((cfg.num_stages, len(BATCH_BUCKETS)))
    for bi, b in enumerate(BATCH_BUCKETS):
        seqs = long_seqs[:b]
        h, cur = _decode_batch(seqs)
        for s in range(cfg.num_stages):
            ts = np.zeros(n_runs)
            for i in range(n_runs + 1):
                start, stop = (torch.cuda.Event(enable_timing=True)
                               for _ in range(2))
                start.record()
                cache = concat_decode_caches([seq["cache"][s]
                                              for seq in seqs])
                out = sfns.call(s, params, h, cache, cur, inplace=True)
                stop.record()
                stop.synchronize()
                if i:                                 # the first is warm-up
                    ts[i - 1] = start.elapsed_time(stop) / 1e3
            mat[s, bi] = np.percentile(ts, 99.0)
            h = out[0]
    # run every (stage, bucket) once at the 256-slot count too, so the
    # service's warm-up finds every shape already run
    short = next(seq for seq in pool if seq["slots"] == 256)
    sfns.warmup(params, {"h": short["token"], "cache": short["cache"],
                         "cur_pos": torch.tensor([short["length"]],
                                                 dtype=torch.int32,
                                                 device="cuda")})
    tm = BatchTimeModel.from_profile(mat, BATCH_BUCKETS)
    host_overhead = profile_host_overhead(device="cuda")
    print(f"[decode] stage WCETs (s) [stage x bucket 1,2,4,8] at 1024 "
          f"slots: {np.array2string(mat, precision=6)}; host overhead "
          f"{host_overhead * 1e6:.1f} us")

    # 96 one-token requests from 8 closed-loop clients, sequences in turn
    wcet = float(mat[:, 0].max())
    d_lo, d_hi = 4.0 * wcet, 14.0 * wcet
    rng = np.random.default_rng(1)
    t_client = np.zeros(8)
    stream = []
    for j in range(96):
        c = int(np.argmin(t_client))
        rel = float(rng.uniform(d_lo, d_hi))
        seq = pool[j % len(pool)]
        inputs = {"h": seq["token"], "cache": seq["cache"],
                  "cur_pos": torch.tensor([seq["length"]], dtype=torch.int32,
                                          device="cuda")}
        stream.append((float(t_client[c]),
                       Request(inputs, rel, sample=j, client=c,
                               seq_len=seq["slots"])))
        t_client[c] += rel
    stream.sort(key=lambda p: p[0])
    spec = ServeSpec(policy="rtdeepiot",
                     policy_args={"predictor": "exp",
                                  "prior_curve": [0.5, 0.7, 0.85]},
                     executor="device-kernel",
                     executor_args={"mode": "decode",
                                    "len_buckets": list(LEN_BUCKETS)},
                     clock="wall", source="stream",
                     host_overhead=host_overhead, pipeline_depth=3)
    svc = Service.from_spec(spec, cfg=cfg, params=params, time_model=tm,
                            stage_fns=sfns)

    decode_attention.launches = 0
    exit_confidence.launches = 0
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = svc.run(stream)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    attn_launches = decode_attention.launches
    exit_launches = exit_confidence.launches

    ex = svc.executor
    per_stage = {int(s): n for s, n in sorted(ex.stage_dispatches.items())}
    want_attn = sum(layers[s] * n for s, n in per_stage.items())
    preds = [r.prediction for r in svc.responses if not r.missed]
    checks = {
        "96 responses": len(svc.responses) == 96,
        "hidden-state cache empty": ex.cache_stats()["live"] == 0,
        "some request served": len(preds) > 0,
        "every pred a token id": all(0 <= p < cfg.vocab_size for p in preds),
        "dispatches counted per stage":
            sum(per_stage.values()) == res.n_dispatches > 0,
        "decode kernel launched once per layer of each dispatched stage":
            attn_launches == want_attn,
        "exit kernel launched once per dispatch":
            exit_launches == res.n_dispatches,
    }
    lat = float(np.mean([r.latency for r in svc.responses]))
    print(f"[decode] deadlines U[{d_lo * 1e3:.3f}, {d_hi * 1e3:.3f}] ms; "
          f"miss rate {res.miss_rate:.4f} mean depth {res.mean_depth:.4f} "
          f"mean latency {lat * 1e3:.4f} ms; dispatches per stage "
          f"{per_stage} (layers per stage {layers}); decode-kernel launches "
          f"{attn_launches} (want {want_attn}); exit-kernel launches "
          f"{exit_launches} (want {res.n_dispatches})")
    print(f"[decode] device_time_stats {json.dumps(ex.device_time_stats())}")
    print(f"[decode] cache_stats {ex.cache_stats()}")
    print(f"[decode] peak device memory over the 96 requests "
          f"{peak / 1e9:.3f} GB (max_memory_allocated; {mem_before / 1e9:.3f}"
          f" GB allocated before them: weights and the pool)")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"decode serve phase failed: {failed}")
    return dict(attn_launches=attn_launches, exit_launches=exit_launches,
                n_dispatches=res.n_dispatches, wcet=mat.tolist(),
                peak_bytes=peak)


def _to_fp32(tree):
    """A copy of a tree of tensors with every floating leaf in fp32 (the
    int32 ``slot_pos`` stays as it is)."""
    if isinstance(tree, dict):
        return {k: _to_fp32(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_fp32(v) for v in tree]
    return tree.float() if tree.is_floating_point() else tree


def _route_check_fp32(cfg, params, sfns, seqs):
    """Each stage's kernel route against its plain route on fp32 copies of
    the params and of the pool's caches, batch 8, ragged positions.  In
    fp32 the two routes differ only in the attention's summation order, so
    h, the new caches and conf must agree elementwise within the fp32
    tolerance (2e-5), with identical preds: the witness that the bf16
    check's per-row form covers rounding, not a fault of the kernel."""
    from repro_torch.models import concat_decode_caches, stage_decode_step
    from repro_torch.models.exits import apply_exit, confidence_from_logits
    tol = ATTN_TOL[torch.float32]
    p32 = _to_fp32(params)
    h, cur = _decode_batch(seqs)
    for s in range(cfg.num_stages):
        caches = [_to_fp32(seq["cache"][s]) for seq in seqs]
        hk, ck, pred, conf = sfns.call(s, p32, h, concat_decode_caches(caches),
                                       cur, inplace=True)
        hp, cp = stage_decode_step(cfg, p32, s, concat_decode_caches(caches),
                                   h, cur, decode_attn="plain", inplace=True)
        logits = apply_exit(cfg, {**p32["exits"][s], **p32["exit_shared"]},
                            hk[:, None])[:, 0]
        conf_p = confidence_from_logits(logits)
        torch.cuda.synchronize()
        if hk.dtype != torch.float32 or ck[0]["k"].dtype != torch.float32:
            raise AssertionError(f"decode stage {s} fp32: the route ran in "
                                 f"{hk.dtype} / {ck[0]['k'].dtype}")
        h_ok, h_err = _within(hk, hp, tol)
        kv = [_within(a[k], b[k], tol) for a, b in zip(ck, cp)
              for k in ("k", "v")]
        kv_ok = all(ok for ok, _ in kv)
        kv_err = max(e for _, e in kv)
        c_err = float((conf - conf_p).abs().max())
        same_slots = all(torch.equal(a["slot_pos"], b["slot_pos"])
                         for a, b in zip(ck, cp))
        same_pred = torch.equal(pred.long(), logits.argmax(-1))
        if not (h_ok and kv_ok and same_slots and same_pred) \
                or c_err > CONF_ATOL:
            raise AssertionError(
                f"decode stage {s} fp32: kernel route disagrees with the "
                f"plain route elementwise (h err {h_err}, cache err "
                f"{kv_err}, slot_pos equal {same_slots}, conf err {c_err}, "
                f"pred equal {same_pred})")
        print(f"[decode] stage {s} kernel vs plain route in fp32 (B 8): h "
              f"max abs err {h_err:.3e} (|h| up to "
              f"{float(hp.abs().max()):.3e}), cache max abs err "
              f"{kv_err:.3e}, all elementwise within atol = rtol = {tol}; "
              f"slot_pos equal, conf err {c_err:.3e}, pred equal")
        h = hk
        del caches, ck, cp
    del p32
    torch.cuda.empty_cache()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def phase_launcher() -> dict:
    """The token-loop launcher with speculation on the card: 24 tokens of
    the reduced qwen3-4b, as ``python -m repro_torch.launch.serve --tokens
    24 --pipeline`` runs it."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch import serve
    decode_attention.launches = 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        met = serve.main(["--tokens", "24", "--pipeline", "--device",
                          "cuda"])
    launches = decode_attention.launches
    text = buf.getvalue()
    print("\n".join(f"[launcher] {line}" for line in text.splitlines()
                    if line.strip() and not line.startswith("token ")))
    depths = [r["depth"] for r in met.per_request]
    n_stages = get_config("qwen3-4b").reduced().num_stages
    hist = np.bincount(depths, minlength=n_stages + 1)[1:].tolist()
    print(f"[launcher] depth histogram from the service's records {hist}; "
          f"decode-kernel launches {launches}")
    if launches == 0 or sum(hist) != 24 or met.n_requests != 24:
        raise AssertionError(f"launcher: {launches} decode-kernel launches, "
                             f"depth histogram {hist}")
    return dict(launches=launches, depth_hist=hist)


def phase_launcher_mixed() -> dict:
    """The launcher's speculative token loop at a confidence target that
    mixes depths: the median stage-1 confidence of a run that stops every
    token at stage 1.  Built from the launcher's own components, as its
    ``main`` builds them, so the committed cache can be read afterwards.
    Checks that speculative deeper steps were discarded and that the
    committed cache holds, per stage, exactly the positions of the tokens
    whose chosen depth ran that stage: a discarded depth left no slot
    written (slot_pos -1, k and v zero)."""
    import argparse
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.launch import serve
    from repro_torch.models import init_decode_cache, init_params
    from repro_torch.serving import Service
    cfg = get_config("qwen3-4b").reduced()
    n_stages = len(cfg.stage_boundaries())
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cuda")
    B, tokens = 4, 24

    def run(target):
        args = argparse.Namespace(conf_target=target, pipeline=True,
                                  tokens=tokens)
        records = []

        def advance(task, out):
            records.append((task.sample, task.executed, task.last_confidence))
            return out.logits[-1].argmax(-1).to(torch.int32)
        svc = Service.from_spec(
            serve.build_spec(args, n_stages),
            steps=serve.make_steps(cfg, n_stages), params=params,
            cache=init_decode_cache(cfg, B, slots=tokens + 1, device="cuda"),
            tok=torch.zeros(B, dtype=torch.int32, device="cuda"),
            advance=advance)
        svc.run()
        svc.close()
        return svc.executor, records

    target = float(np.median([r[2] for r in run(0.0)[1]]))
    decode_attention.launches = 0
    ex, records = run(target)
    launches = decode_attention.launches
    depths = {t: d for t, d, _ in records}
    hist = np.bincount(list(depths.values()),
                       minlength=n_stages + 1)[1:].tolist()
    discarded = ex.speculated - ex.spec_hits
    stray = 0
    for s, st in enumerate(ex.cache):
        ran = torch.tensor([t for t in range(tokens) if depths[t] > s],
                           dtype=torch.long)
        want = torch.full((B, tokens + 1), -1, dtype=torch.int32)
        want[:, ran] = ran.to(torch.int32)
        for layer in st:
            written = layer["k"].ne(0).any(-1).any(1).cpu()   # (B, slots)
            stray += int((layer["slot_pos"].cpu() != want).sum())
            stray += int((written != (want >= 0)).sum())
    print(f"[launcher] conf target {target:.6f} (median stage-1 "
          f"confidence): depth histogram {hist}, {discarded} speculative "
          f"deeper steps discarded, {ex.spec_hits} consumed; decode-kernel "
          f"launches {launches}; committed cache entries that disagree "
          f"with the chosen depths: {stray}")
    if sorted(depths) != list(range(tokens)) or sum(hist) != tokens \
            or discarded == 0 or launches == 0 or stray:
        raise AssertionError(f"launcher at a mixed target: depths {hist}, "
                             f"{discarded} discarded, {launches} launches, "
                             f"{stray} stray cache entries")
    return dict(launches=launches, depth_hist=hist, discarded=discarded)


NEW_KERNELS = ("rmsnorm", "flash_attention", "mlstm_chunk")


def check_new_kernels() -> tuple:
    """The three kernels that only the kernel entry point runs, held
    against their plain versions; returns ({name: largest abs error},
    {name: launches made by the checks})."""
    fns = {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{name}.ops"), name) for name in NEW_KERNELS}
    for fn in fns.values():
        fn.launches = 0
    errs = {"rmsnorm": check_rmsnorm(),
            "flash_attention": check_flash_attention(),
            "mlstm_chunk": check_mlstm_chunk()}
    return errs, {name: fn.launches for name, fn in fns.items()}


def main() -> int:
    name, smi = phase_device()
    _import_port()
    phase_build()
    exit_err = check_exit_confidence()
    attn_err = check_decode_attention()
    new_errs, check_launches = check_new_kernels()
    timing = phase_timing()
    entry = phase_kernel_entry()
    serve = phase_serve()
    decode = phase_decode_serve()
    launcher = phase_launcher()
    mixed = phase_launcher_mixed()

    def numbers(key, table=timing):
        return {k: table[key][k] for k in
                ("shape", "dtype", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms")}

    kernels = [{
        "name": "exit_confidence", "route": "cuda",
        "source": "src/repro_torch/kernels/exit_confidence/exit_confidence.cu",
        "replaces": "src/repro/kernels/exit_confidence/kernel.py:70",
        "launches": decode["exit_launches"], "max_abs_err": exit_err,
        **numbers("qwen3-4b head bf16"),
        "launches_by_path": {"classifier serve": serve["launches"],
                             "decode serve": decode["exit_launches"]},
        "classifier_path": numbers("path"),
        "qwen3_4b_head_fp32": numbers("qwen3-4b head"),
    }, {
        "name": "decode_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/decode_attention/"
                  "decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:62",
        "launches": decode["attn_launches"], "max_abs_err": attn_err,
        **numbers("decode S=1024"),
        "launches_by_path": {"decode serve": decode["attn_launches"],
                             "launcher": launcher["launches"],
                             "launcher, mixed depths": mixed["launches"]},
        "s4096": numbers("decode S=4096"),
    }]
    larger = {"rmsnorm": "rmsnorm qwen3-4b width",
              "flash_attention": "flash_attention qwen3-4b heads"}
    for kname, line in (("rmsnorm", 23), ("flash_attention", 89),
                        ("mlstm_chunk", 73)):
        row = {
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/{kname}/{kname}.cu",
            "replaces": f"src/repro/kernels/{kname}/kernel.py:{line}",
            "launches": entry["launches"][kname],
            "max_abs_err": max(new_errs[kname],
                               *(entry[key]["max_abs_err"] for key in
                                 (kname, larger.get(kname)) if key)),
            **numbers(kname, entry),
            "launches_by_path": {"kernel checks": check_launches[kname],
                                 "timing": entry["launches"][kname]}}
        if kname in larger:
            row["larger_shape"] = numbers(larger[kname], entry)
        kernels.append(row)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
