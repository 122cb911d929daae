"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the script on its own (exit code 1, and no
result line):
  1. build   - nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
               csrc`` (all sources at once) and Triton compiles its four
               (registers and spills read from the compiled kernels);
  2. kernels - each hand-written kernel against its plain PyTorch version on
               the card, in bf16 and fp32 (relative error to the largest
               output below 2e-2 and 2e-5, the JAX kernel tests' bounds; in
               bf16 also element by element: the four Triton kernels within
               one bf16 rounding, |a-b| <= 2^-7 |b| + 1e-3, the two
               attention kernels within |a-b| <= 2^-6 |b| + 2^-5 rms(row)),
               at the JAX kernel tests' shapes and at the served models' own
               shapes (each of the three head layouts); the fp32 wkv kernel
               to 1e-4 (output and final state), the JAX wkv tests' bound, at
               their shapes, a ragged T, the served prefill with prompt
               lengths and the decode step in place on a nonzero state;
  3. matmul  - the GEMM op path (``repro_torch.kernels.matmul.ops``, which no
               served model calls): first every op against its plain version
               at the JAX kernel tests' shapes (bf16 2e-2, fp32 and fp8 2e-5,
               int8 1e-4 relative to the largest output, and element by
               element, ``gemm_excess``) and the fp8 op's NaNs beyond e4m3's
               range in exactly the plain version's places; then, with every
               launch count set to 0, the path itself: gpt3-175b's four
               layer GEMMs at full width (QKV 12288->36864, out 12288->12288,
               FFN up 12288->49152, down 49152->12288) at M=8 (the decode
               batch of 8 slots) and M=4096 (a prefill wave of 8 x 512)
               through matmul (bf16, fp32), matmul_fp8 and matmul_int8, each
               output held to its plain version as above, and the counts
               read just after, per path: the 16 bf16 and e4m3 GEMMs on the
               TMA + wgmma kernel (matmul_wgmma) with one split-K reduction
               (matmul_reduce) for each GEMM its split plan splits, the 8
               fp32 ones on matmul.cu (none on its mma.sync path), 8
               matmul_int8, no other kernel; the reduction bit for bit
               against its plain version; the per-element check is shown to
               fail two mutants made from the plain product (a dropped
               k-step, a transposed tile of B); then the e4m3 probe: native
               e4m3 wgmma, promoted into fp32 every 128 of K or every
               instruction, at the same gpt3 shapes against the fp8 checks,
               beside ``torch._scaled_mm``'s own errors;
  4. serve   - four served paths, one model each, random weights from a
               seeded torch.Generator: qwen3-1.7b (full width and depth;
               rmsnorm, silu_mul), stablelm-1.6b (full width and depth;
               layernorm, silu_mul, partial RoPE, d_head 64), gpt3-175b
               (full width cut to 8 of 96 layers; layernorm, gelu,
               sinusoidal positions, 96 heads) and rwkv6-7b (full width and
               depth, attention-free; layernorm, wkv). Each serves 16 greedy
               requests of 16-48 new tokens on 8 slots through the port's
               Engine: one whole-batch prefill of prompts of unequal
               lengths, then each freed slot refilled by a batch-1 prefill
               and insert. Every kernel's launch count is set to 0 just
               before each serve and read just after, split into the
               prefill and the decode phase: each kernel of that model's
               path must be above 0, and each phase must show exactly its
               steps' launches (9 prefills: one wave, 8 refills); then the
               launches of one prefill and one decode step, a torch.profiler
               breakdown of the decode step, and the model's peak memory;
               each model and its cache are freed before the next is built;
  5. model   - each model at full width cut in depth (qwen3, stablelm and
               rwkv6 to 2 layers, gpt3 to 1), its prefill and decode logits
               on the card against the port's CPU path on a batch of two
               prompts of unequal lengths; for rwkv6 also the short prompt's
               state and token shifts after the padded wave against that
               prompt prefilled alone on the card;
  6. timing  - each kernel at the served models' shapes (the GEMMs at the
               matmul path's), beside its plain version, the one PyTorch call
               that computes the same function where there is one, and its
               bound on the card; for the bf16 and e4m3 GEMMs also the
               mma.sync kernel of matmul.cu on the same operands (the
               kernel these modes ran on before the wgmma one), for bf16 the
               port's mapper's predicted latency on its H100 preset and the
               wgmma kernel's time at the tile ``mapper_blocks`` picks.

The last lines are the ``{"kernels": [...]}`` summary, the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12     # H100 SXM dense bf16 tensor cores
INT8_FP8_TENSOR_OPS = 1979e12  # H100 SXM dense int8 and fp8 tensor cores
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
WKV_TOL = 1e-4
# (arch, layers served or None for all): the port's four served paths
SERVED = (("qwen3-1.7b", None), ("stablelm-1.6b", None), ("gpt3-175b", 8),
          ("rwkv6-7b", None))
# (arch, layers, prompt tokens, decode steps) of the card-vs-CPU check;
# gpt3's CPU side runs 2.4 G parameters in bf16, hence the short prompts
MODEL_CHECKS = (("qwen3-1.7b", 2, 64, 8), ("stablelm-1.6b", 2, 64, 8),
                ("gpt3-175b", 1, 16, 4), ("rwkv6-7b", 2, 64, 8))
SLOTS, MAX_LEN, N_REQUESTS = 8, 1024, 16
# new tokens per request: staggered, so that slots free in different rounds
# and the 8 requests past the first wave go through the per-slot refill
NEW_TOKENS = [16 + (7 * i) % 33 for i in range(N_REQUESTS)]

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:32",
    "layernorm": "src/repro/kernels/rmsnorm/kernel.py:48",
    "gelu": "src/repro/kernels/gelu/kernel.py:29",
    "silu_mul": "src/repro/kernels/gelu/kernel.py:43",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:71",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:61",
    "wkv": "src/repro/kernels/wkv/kernel.py:51",
    "matmul": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_wgmma": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_reduce": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_int8": "src/repro/kernels/matmul/kernel.py:86",
}
SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py"),
    "layernorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py"),
    "gelu": ("triton", "src/repro_torch/kernels/gelu/kernel.py"),
    "silu_mul": ("triton", "src/repro_torch/kernels/gelu/kernel.py"),
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu"),
    "wkv": ("cuda", "src/repro_torch/kernels/csrc/wkv.cu"),
    "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu"),
    "matmul_wgmma": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
    "matmul_reduce": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
    "matmul_int8": ("cuda", "src/repro_torch/kernels/csrc/matmul_int8.cu"),
}
# the GEMM path: gpt3-175b's layer GEMMs at full width (name, K, N), at the
# decode batch of 8 slots and a prefill wave of 8 x 512 rows
GPT3_GEMMS = (("qkv", 12288, 36864), ("out", 12288, 12288), ("ffn_up", 12288, 49152),
              ("ffn_down", 49152, 12288))
GEMM_ROWS = (SLOTS, 8 * 512)
GEMM_EDGES = ((128, 128, 128), (256, 512, 128), (100, 200, 50), (1, 300, 77), (513, 129, 257))
GEMM_MODES = ("bf16", "fp32", "fp8", "int8")
GEMM_TOL = {"bf16": 2e-2, "fp32": 2e-5, "fp8": 2e-5, "int8": 1e-4}


def require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel_err(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-9)).item()


def max_abs(a, b):
    return (a.float() - b.float()).abs().max().item()


def within_one_rounding(a, b):
    """Every element of bf16 `a` within one bf16 rounding of `b`."""
    a, b = a.float(), b.float()
    return bool(((a - b).abs() <= 2.0 ** -7 * b.abs() + 1e-3).all())


def attention_excess(a, b):
    """Largest |a - b| / (2^-6 |b| + 2^-5 rms(b's row)) over the elements of
    bf16 attention outputs, rows along the last axis (D); at most 1 passes.
    The plain version rounds each softmax weight to bf16 after normalising,
    the flash kernel before (relative to its running maximum), so the two
    weights of a key differ by up to 2^-8 of the weight, independently from
    key to key. Their effect on an output element is a sum of n such terms
    p_j v_j, whose spread is about 2^-8.3 of the row's rms (the rms of an
    output row is sqrt(sum p_j^2) too); 2^-5 of the rms is 7 of those
    spreads, above the largest of the 50 M outputs of gpt3's shape (about
    5.7). Each output is rounded once more on either side: one ulp apart is
    at most 2^-7 |b|. A dropped or doubled key tile moves a late row by a
    sizable share of its rms and fails by far; the relative error to the
    largest output (|v| of row 0, about 4) is blind to what late rows,
    whose entries are near 0.05, do."""
    a, b = a.float(), b.float()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    return ((a - b).abs() / (2.0 ** -6 * b.abs() + 2.0 ** -5 * rms)).max().item()


class Inputs:
    """Normal inputs on the card from one seeded generator."""

    def __init__(self, torch, seed):
        self.torch = torch
        self.gen = torch.Generator("cuda").manual_seed(seed)

    def __call__(self, shape, dtype):
        t = self.torch
        return t.randn(shape, generator=self.gen, device="cuda",
                       dtype=t.float32).to(dtype)


def phase_build(torch):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    seconds = _build.build(["flash_attention", "decode_attention", "wkv", "matmul",
                            "matmul_sm90", "matmul_int8"])
    for name, s in seconds.items():
        print(f"[build] {name}.cu: nvcc {s:.2f} s")
    print(f"[build] nvcc, all sources in parallel: {time.perf_counter() - t0:.2f} s")
    for name, log in _build.LOGS.items():
        for line in resource_usage(log):
            print(f"[build] {name}.cu {line}")
    # the wgmma kernel's shared memory is dynamic: ptxas does not see it
    import ctypes
    from repro_torch.kernels.matmul.kernel import E4M3_FORMS, TILES
    smem = _build.load("matmul_sm90").matmul_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 5, ctypes.c_int
    for mode, dtype, forms in ((0, torch.bfloat16, {"": 0}),
                               (1, torch.float8_e4m3fn, E4M3_FORMS)):
        for tile in TILES[dtype]:
            for form, f in forms.items():
                print(f"[build] matmul_sm90.cu {dtype} {form} tile {tile}: "
                      f"{smem(mode, f, *tile)} bytes of dynamic shared memory")
    from repro_torch.kernels.gelu.kernel import gelu_triton, silu_mul_triton
    from repro_torch.kernels.rmsnorm.kernel import layernorm_triton, rmsnorm_triton
    x = torch.ones((4, 12288), device="cuda", dtype=torch.bfloat16)
    w = x[0].float()
    for label, fn, args in (
            ("rmsnorm C=2048", rmsnorm_triton, (x[:, :2048], w[:2048])),
            ("rmsnorm C=128", rmsnorm_triton, (x[:, :128], w[:128])),
            ("layernorm C=2048", layernorm_triton, (x[:, :2048], w[:2048], w[:2048])),
            ("layernorm C=12288", layernorm_triton, (x, w, w)),
            ("gelu", gelu_triton, (x,)),
            ("silu_mul", silu_mul_triton, (x, x))):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        # registers and spills of the compiled kernel this launch ran
        print(f"[build] triton {label}: first launch incl. compile "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{getattr(fn.compiled, 'n_regs', 'unknown')} registers, "
              f"{getattr(fn.compiled, 'n_spills', 'unknown')} spills")


def resource_usage(log):
    """ptxas's registers, barriers and memory of each kernel of a build log
    (nvcc runs with -Xptxas -v), one line a kernel under its mangled name."""
    lines, fn, spills = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "bytes stack frame" in line:
            spills = line.strip()
        elif ": Used " in line and fn is not None:
            lines.append(f"{fn}: {line.split(': ', 1)[1].strip()}; {spills}")
            fn = None
    return lines


def kernel_cases(torch):
    """(kernel, label, kernel fn, plain fn, args, is_main_path) per case."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gelu.ref import gelu_ref, silu_mul_ref
    from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
    rnd = Inputs(torch, 0)
    cases = []
    for dt in (torch.float32, torch.bfloat16):
        for r, c, main in ((64, 256, False), (100, 512, False), (7, 1024, False),
                           (4096, 2048, True), (4096 * 16, 128, True)):
            cases.append(("rmsnorm", f"({r},{c})", KERNELS["rmsnorm"], rmsnorm_ref,
                          (rnd((r, c), dt), rnd((c,), torch.float32)), main))
        # rows off zero mean, gain and bias far from 1 and 0
        for r, c, main in ((90, 384, False), (64, 256, False), (7, 1024, False),
                           (33, 10000, False), (4096, 2048, True), (4096, 12288, True)):
            cases.append(("layernorm", f"({r},{c})", KERNELS["layernorm"], layernorm_ref,
                          ((rnd((r, c), torch.float32) * 3 + 1).to(dt),
                           rnd((c,), torch.float32) * 2, rnd((c,), torch.float32)), main))
        for label, x, main in (("(100,256)", rnd((100, 256), dt), False),
                               ("(4096,49152)", rnd((4096, 49152), dt), True),
                               ("(256,1024) |x|<=20", torch.linspace(
                                   -20, 20, 256 * 1024, device="cuda").reshape(
                                   256, 1024).to(dt), False)):
            cases.append(("gelu", label, KERNELS["gelu"], gelu_ref, (x,), main))
        for r, c, main in ((100, 256, False), (4096, 6144, True)):
            cases.append(("silu_mul", f"({r},{c})", KERNELS["silu_mul"], silu_mul_ref,
                          (rnd((r, c), dt), rnd((r, c), dt)), main))
        for b, hq, hkv, sq, sk, causal, window, cap, d, main in (
                (2, 4, 4, 128, 128, True, 0, 0.0, 64, False),
                (2, 8, 2, 130, 130, True, 0, 0.0, 64, False),
                (2, 4, 1, 64, 200, False, 0, 0.0, 64, False),
                (2, 4, 2, 128, 128, True, 32, 0.0, 64, False),
                (2, 4, 2, 96, 96, True, 0, 30.0, 64, False),
                (2, 4, 2, 70, 70, True, 0, 0.0, 32, False),
                (8, 16, 8, 512, 512, True, 0, 0.0, 128, True),
                (8, 32, 32, 512, 512, True, 0, 0.0, 64, True),
                (8, 96, 96, 512, 512, True, 0, 0.0, 128, True)):
            kw = dict(causal=causal, window=window, softcap=cap)
            cases.append(("flash_attention",
                          f"q({b},{hq},{sq},{d}) kv({b},{hkv},{sk},{d}) {kw}",
                          lambda *a, kw=kw: KERNELS["flash_attention"](*a, **kw),
                          lambda *a, kw=kw: attention_ref(*a, **kw),
                          (rnd((b, hq, sq, d), dt), rnd((b, hkv, sk, d), dt),
                           rnd((b, hkv, sk, d), dt)), main))
        for b, hkv, g, t, d, main in ((3, 2, 4, 128, 64, False), (3, 1, 8, 200, 64, False),
                                      (3, 4, 1, 64, 64, False), (SLOTS, 8, 2, MAX_LEN, 128, True),
                                      (SLOTS, 32, 1, MAX_LEN, 64, True),
                                      (SLOTS, 96, 1, MAX_LEN, 128, True)):
            lens = [t, max(1, t // 2), max(1, t // 3)] if b == 3 else decode_lengths(b, t)
            cases.append(("decode_attention", f"q({b},{hkv},{g},{d}) T={t} lengths={lens}",
                          KERNELS["decode_attention"], decode_attention_ref,
                          (rnd((b, hkv, g, d), dt), rnd((b, t, hkv, d), dt),
                           rnd((b, t, hkv, d), dt),
                           torch.tensor(lens, dtype=torch.int32, device="cuda")), main))
    return cases


def decode_lengths(b, t):
    """Mixed cache lengths of the main path: prompts of 128-512 tokens plus
    up to 48 generated, one slot at the full cache."""
    return [t] + [128 + (97 * i) % 417 for i in range(1, b)]


def prompt_lengths(b, t):
    """Prompt lengths of a served wave: 128-512 tokens, the longest t."""
    return [t] + [128 + (97 * i) % 385 for i in range(1, b)]


def wkv_inputs(torch, rnd, B, T, H, N, with_state):
    """r, k, v normal, w in (0.45, 0.95) as the JAX wkv tests draw them, a
    per-head u and, with_state, a nonzero initial state; all fp32."""
    f32 = torch.float32
    r, k, v = rnd((B, T, H, N), f32), rnd((B, T, H, N), f32), rnd((B, T, H, N), f32)
    w = torch.sigmoid(rnd((B, T, H, N), f32)) * 0.5 + 0.45
    return r, k, v, w, rnd((H, N), f32), rnd((B, H, N, N), f32) if with_state else None


def wkv_cases():
    """(B, T, H, N, lengths or None, nonzero state0, is_main_path): the JAX
    kernel tests' rows (u tiled over two heads) and their model-scan shape,
    a T that is no multiple of the kernel's 32-step chunk, and the served
    prefill (8 slots, 64 heads of 64, prompt lengths) and decode step."""
    return [(2, 96, 2, 32, None, False, False), (2, 64, 2, 32, None, False, False),
            (2, 100, 2, 32, None, False, False), (2, 64, 2, 32, None, True, False),
            (3, 77, 4, 64, [77, 40, 1], True, False),
            (SLOTS, 512, 64, 64, prompt_lengths(SLOTS, 512), False, True),
            (SLOTS, 1, 64, 64, None, True, True)]


def phase_wkv(torch, errs):
    """The wkv kernel against its plain version on the card, fp32: output
    and final state within 1e-4 of the plain version's largest, pads' outputs
    zero; with a nonzero state it updates that state in place, as the decode
    step does."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.wkv.ref import wkv_ref
    rnd = Inputs(torch, 4)
    for B, T, H, N, lens, with_state, main in wkv_cases():
        r, k, v, w, u, s0 = wkv_inputs(torch, rnd, B, T, H, N, with_state)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                         device="cuda")
        want_out, want_state = wkv_ref(r, k, v, w, u, s0, lengths)
        state_in = None if s0 is None else s0.clone()
        out, state = KERNELS["wkv"](r, k, v, w, u, state_in, lengths, state_out=state_in)
        torch.cuda.synchronize()
        label = f"({B},{T},{H},{N}) lengths={lens} state0={'nonzero' if with_state else 'zero'}"
        require(state_in is None or state is state_in, f"wkv {label}: state not in place")
        e_out, e_state = rel_err(out, want_out), rel_err(state, want_state)
        require(e_out < WKV_TOL and e_state < WKV_TOL, f"wkv {label}: rel_err out "
                f"{e_out:.3e}, state {e_state:.3e} (tol {WKV_TOL:g})")
        require(all(not out[b, n:].any() for b, n in enumerate(lens or [])),
                f"wkv {label}: a pad step has a nonzero output")
        print(f"[kernels] wkv              float32  {label}: rel_err out {e_out:.3e}, "
              f"state {e_state:.3e} (tol {WKV_TOL:g}) ok")
        if main:
            errs["wkv"] = max(errs.get("wkv", 0.0), max_abs(out, want_out),
                              max_abs(state, want_state))


def phase_kernels(torch):
    errs = {}
    for name, label, fn, plain, args, main in kernel_cases(torch):
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        dt = str(args[0].dtype).replace("torch.", "")
        err = rel_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name} {label}: {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(want.shape)} {want.dtype}")
        require(err < TOL[dt], f"{name} {label} {dt}: rel_err {err:.3e} >= {TOL[dt]}")
        line = f"[kernels] {name:16s} {dt:8s} {label}: rel_err {err:.3e} (tol {TOL[dt]:g})"
        if SOURCES[name][0] == "triton" and dt == "bfloat16":
            require(within_one_rounding(got, want),
                    f"{name} {label}: an element is off by more than one bf16 rounding")
        if SOURCES[name][0] == "cuda" and dt == "bfloat16":
            excess = attention_excess(got, want)
            line += f", per-element excess {excess:.3f} (<= 1)"
            require(excess <= 1, f"{line}: an element is off by more than "
                    "2^-6 |b| + 2^-5 rms(row)")
        print(f"{line} ok")
        if main and dt == "bfloat16":
            errs[name] = max(errs.get(name, 0.0), max_abs(got, want))
    phase_wkv(torch, errs)
    return errs


def gemm_excess(torch, got, want, a, b):
    """Largest |got - want| / (r |want| + 2^-16 (|a| @ |b|)) over the
    elements of a GEMM's output; at most 1 passes. a, b are the operands'
    values (dequantized for int8, e4m3 for fp8), |a| @ |b| taken in fp32;
    r = 2^-7 for a bf16 output (the two sides' roundings leave them at most
    one bf16 ulp apart), 0 for fp32. The fp32 sums of kernel and plain
    version differ by their order, about sqrt(K) 2^-24 of the partial sums,
    far below 2^-16 (|a| @ |b|). A kernel that drops one k-step or uses a
    tile of B transposed moves an element by a sum of ~16 products, ~4 at
    unit-normal operands, against 2^-16 (|a| @ |b|) = 0.12-0.48 at K =
    12288-49152 and one bf16 ulp of an output of ~100-400 (0.5-2), so it
    fails where the relative error to the largest output (~4.5 sqrt(K)) may
    not. NaNs count as agreeing here; their places are compared apart."""
    r = 2.0 ** -7 if got.dtype == torch.bfloat16 else 0.0
    got, want = got.float(), want.float()
    mag = a.float().nan_to_num().abs() @ b.float().nan_to_num().abs()
    den = (r * want.abs() + 2.0 ** -16 * mag).clamp_min(1e-30)
    return ((got - want).abs() / den).nan_to_num(0.0).max().item()


def gemm_case(torch, mode, a, b, tile=None):
    """One GEMM of the op path on fp32 operands a (M,K), b (K,N): the op's
    output (kernel on the card), the plain version's, and the operands'
    values as the kernel multiplies them. `tile` = (bm, bk, bn) or the op's
    default."""
    from repro_torch.kernels.matmul import ops
    from repro_torch.kernels.matmul.ref import (matmul_fp8_ref, matmul_int8_ref, matmul_ref,
                                                quantize_fp8, quantize_int8)
    kw = {} if tile is None else dict(zip(("bm", "bk", "bn"), tile))
    if mode in ("bf16", "fp32"):
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        a, b = a.to(dt), b.to(dt)
        return ops.matmul(a, b, **kw), matmul_ref(a, b), a, b
    if mode == "fp8":
        return ops.matmul_fp8(a, b, **kw), matmul_fp8_ref(a, b), quantize_fp8(a), quantize_fp8(b)
    (qa, sa), (qb, sb) = quantize_int8(a, 1), quantize_int8(b, 0)
    return ops.matmul_int8(a, b, **kw), matmul_int8_ref(a, b), qa * sa, qb * sb


def check_gemm(torch, mode, label, got, want, a, b):
    """Shape, dtype, NaN places, relative error and per-element excess of
    one GEMM against its plain version; returns (rel_err, excess)."""
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{mode} {label}: {tuple(got.shape)} {got.dtype} vs plain {tuple(want.shape)} "
            f"{want.dtype}")
    require(torch.equal(got.isnan(), want.isnan()), f"{mode} {label}: NaNs in other places "
            "than the plain version's")
    ok = ~want.isnan()
    err = rel_err(got[ok], want[ok]) if ok.any() else 0.0
    excess = gemm_excess(torch, got, want, a, b)
    line = (f"[matmul] {mode:4s} {label}: rel_err {err:.3e} (tol {GEMM_TOL[mode]:g}), "
            f"per-element excess {excess:.3f} (<= 1)")
    require(err < GEMM_TOL[mode] and excess <= 1, f"{line}: fails")
    print(f"{line} ok")
    return err, excess


def phase_matmul(torch):
    """The GEMM op path; returns ({kernel: launches in the path run},
    {mode: largest |kernel - plain| at the gpt3 shapes})."""
    from repro_torch import kernels as K
    rnd = Inputs(torch, 5)
    for mode in GEMM_MODES:
        for m, k, n in GEMM_EDGES:
            a, b = rnd((m, k), torch.float32), rnd((k, n), torch.float32)
            got, want, x, y = gemm_case(torch, mode, a, b, (128, 128, 128))
            check_gemm(torch, mode, f"({m},{k})x({k},{n}) blocks 128/128/128", got, want, x, y)
    # the fp8 op beyond e4m3's range: NaN where the reference's cast gives it
    a, b = rnd((70, 96), torch.float32), rnd((96, 130), torch.float32)
    a[3, 5], a[10, 0], a[11, 95], a[20, 20] = 500.0, float("inf"), -465.0, 464.0
    b[7, 9], b[0, 129], b[30, 30] = float("-inf"), 1e4, -448.0
    got, want, x, y = gemm_case(torch, "fp8", a, b)
    check_gemm(torch, "fp8", "(70,96)x(96,130) with 500, -465, 1e4, +-inf (NaN) and 464, "
               f"-448 (+-448), {int(want.isnan().sum())} NaNs", got, want, x, y)

    # fp32 on the SIMT kernel; every bf16 and e4m3 GEMM on the wgmma kernel,
    # with one reduction where its split plan splits K
    from repro_torch.kernels.matmul.kernel import select_tile, split_plan
    splits = sum(len(split_plan(M, n, k, select_tile(dt, min(256, M), min(512, k),
                                                     min(256, n)))) > 1
                 for M in GEMM_ROWS for _, k, n in GPT3_GEMMS
                 for dt in (torch.bfloat16, torch.float8_e4m3fn))
    expected = dict.fromkeys(K.KERNELS, 0)
    expected.update(matmul=len(GEMM_ROWS) * len(GPT3_GEMMS),
                    matmul_wgmma=2 * len(GEMM_ROWS) * len(GPT3_GEMMS), matmul_reduce=splits,
                    matmul_int8=len(GEMM_ROWS) * len(GPT3_GEMMS))
    errs = dict.fromkeys(GEMM_MODES, 0.0)
    t0 = time.perf_counter()
    K.reset_launches()
    for M in GEMM_ROWS:
        for name, k, n in GPT3_GEMMS:
            a, b = rnd((M, k), torch.float32), rnd((k, n), torch.float32)
            for mode in GEMM_MODES:
                got, want, x, y = gemm_case(torch, mode, a, b)
                check_gemm(torch, mode, f"gpt3-175b {name} ({M},{k})x({k},{n})", got, want, x, y)
                errs[mode] = max(errs[mode], max_abs(got, want))
                del got, want, x, y
            del a, b
    counts = K.launches()
    require(counts == expected, f"GEMM path launches {counts}, not {expected}")
    print(f"[matmul] path: {len(GPT3_GEMMS)} gpt3-175b GEMMs x M in {GEMM_ROWS} x "
          f"{GEMM_MODES} through repro_torch.kernels.matmul.ops in "
          f"{time.perf_counter() - t0:.1f} s; launches {json.dumps(counts)}")
    print(f"[matmul] paths: all {counts['matmul_wgmma']} bf16 and e4m3 GEMMs on the TMA + "
          f"wgmma kernel ({counts['matmul_reduce']} split-K reductions), none on mma.sync; "
          f"{counts['matmul']} fp32 on the SIMT kernel; {counts['matmul_int8']} int8")

    # the split-K reduction against its plain version: the same bits
    from repro_torch.kernels.matmul.ref import matmul_reduce_ref
    p = rnd((6, SLOTS, 12288), torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = K.KERNELS["matmul_reduce"](p, torch.empty((SLOTS, 12288), device="cuda",
                                                        dtype=dt))
        require(torch.equal(got, matmul_reduce_ref(p, dt)),
                f"matmul_reduce ({dt}) differs from its plain version")
    print("[matmul] matmul_reduce (6, 8, 12288) fp32 partials -> fp32 and bf16: equal to the "
          "plain version bit for bit")

    # the per-element check against two mutants of the plain bf16 product
    M, (name, k, n) = SLOTS, GPT3_GEMMS[1]
    a, b = rnd((M, k), torch.bfloat16), rnd((k, n), torch.bfloat16)
    want = torch.matmul(a.float(), b.float())
    drop = want - a[:, 4096:4112].float() @ b[4096:4112].float()
    bt = b.clone()
    bt[512:528, 32:48] = b[512:528, 32:48].t()
    for label, mutant in (("one k-step of 16 dropped", drop),
                          ("a 16x16 tile of B transposed", a.float() @ bt.float())):
        excess = gemm_excess(torch, mutant.bfloat16(), want.bfloat16(), a, b)
        print(f"[matmul] mutant of the bf16 {name} ({M},{k})x({k},{n}), {label}: rel_err "
              f"{rel_err(mutant.bfloat16(), want.bfloat16()):.3e}, per-element excess "
              f"{excess:.3f}")
        require(excess > 1, f"the per-element GEMM check passes a mutant: {label}")
    return counts, errs


def phase_e4m3_probe(torch):
    """Native e4m3 wgmma (m64n128k32) in its two promotion forms, a promotion
    into separate fp32 registers after every 128 of K ("native/128") and
    after every k32 instruction ("native/32"), at gpt3-175b's four GEMMs at
    M = 8 and 4096, each held to the fp8 checks (relative error below 2e-5,
    ``gemm_excess`` at most 1); ``_scaled_mm``'s own errors beside them for
    reference, not a gate. Returns {form: whether it passed every shape}."""
    from repro_torch.kernels.matmul.kernel import matmul_wgmma_cuda, select_tile
    from repro_torch.kernels.matmul.ref import matmul_ref, quantize_fp8
    f32, f8 = torch.float32, torch.float8_e4m3fn
    rnd, one = Inputs(torch, 11), torch.ones((), device="cuda")
    passed = {"native/128": True, "native/32": True}
    for M in GEMM_ROWS:
        for name, k, n in GPT3_GEMMS:
            a8 = quantize_fp8(rnd((M, k), f32))
            b8 = quantize_fp8(rnd((n, k), f32)).t()
            want = matmul_ref(a8, b8, out_dtype=f32)
            bm, bk, bn = select_tile(f8, min(256, M), min(512, k), min(256, n))
            shape = f"gpt3-175b {name} ({M},{k})x({k},{n})"
            for form in passed:
                got = matmul_wgmma_cuda(a8, b8, bm=bm, bk=bk, bn=bn, out_dtype=f32,
                                        e4m3_form=form)
                err, excess = rel_err(got, want), gemm_excess(torch, got, want, a8, b8)
                ok = err < GEMM_TOL["fp8"] and excess <= 1
                passed[form] &= ok
                print(f"[e4m3 probe] {form:10s} {shape}: rel_err {err:.3e} (tol 2e-05), "
                      f"per-element excess {excess:.3f} (<= 1): {'passes' if ok else 'fails'}")
                del got
            try:
                lib = torch._scaled_mm(a8, b8, scale_a=one, scale_b=one, out_dtype=f32)
                print(f"[e4m3 probe] _scaled_mm {shape}: rel_err {rel_err(lib, want):.3e}, "
                      f"per-element excess {gemm_excess(torch, lib, want, a8, b8):.3f} "
                      "(reference, not a gate)")
                del lib
            except RuntimeError as e:
                print(f"[e4m3 probe] _scaled_mm {shape}: refused ({str(e).splitlines()[0][:80]})")
            del a8, b8, want
            torch.cuda.empty_cache()
    print(f"[e4m3 probe] passes every shape: {json.dumps(passed)}")
    return passed


def served_config(arch, n_layers):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if n_layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=n_layers, name=f"{arch}-{n_layers}l")


def expected_launches(cfg, prefill):
    """Launches of each kernel in one prefill or one decode step of `cfg`:
    two norms per layer and the final one (q- and k-norm per layer with
    qk-norm are RMSNorms whatever `cfg.norm`), one MLP activation and one
    attention per layer; for RWKV6, one wkv per layer and no attention."""
    from repro_torch.kernels import KERNELS
    L = cfg.n_layers
    counts = dict.fromkeys(KERNELS, 0)
    counts[cfg.norm] += 2 * L + 1
    if cfg.attention_free:
        counts["wkv"] = L
        return counts
    counts["rmsnorm"] += 2 * L if cfg.qk_norm else 0
    counts["silu_mul" if cfg.mlp_gated else "gelu"] = L
    counts["flash_attention" if prefill else "decode_attention"] = L
    return counts


def phase_serve(torch, arch, n_layers):
    """Serve the 16-request schedule on one model; returns its launch counts
    (serve run, one prefill step, one decode step) and the first wave's
    prompt lengths. The model and its caches are freed on return."""
    from repro_torch import kernels as K
    from repro_torch.models import init_cache, init_params
    from repro_torch.serving import Engine, Request
    cfg = served_config(arch, n_layers)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    heads = (f"{cfg.d_model // cfg.rwkv_head_dim} RWKV6 heads of {cfg.rwkv_head_dim}"
             if cfg.attention_free else f"{cfg.n_heads} heads of {cfg.d_head}")
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{heads}, {n_params} parameters "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), random init on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator("cpu").manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    # a short warm-up serve, so the measured one excludes one-off set-up
    Engine(cfg, model, batch_size=2, max_len=64, device="cuda").run(
        [Request(uid=i, prompt=prompt(16), max_new_tokens=2) for i in range(3)])
    torch.cuda.synchronize()

    lens = torch.randint(128, 513, (N_REQUESTS,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=prompt(n), max_new_tokens=new)
            for i, (n, new) in enumerate(zip(lens, NEW_TOKENS))]
    eng = Engine(cfg, model, batch_size=SLOTS, max_len=MAX_LEN, device="cuda")
    prefill_counts = dict.fromkeys(K.KERNELS, 0)

    def admit_counted(requests):
        # through the class, not a bound method: `del eng` below frees the
        # engine (and its cache) at once, as no other name holds it
        before = K.launches()
        wave = Engine.admit_wave(eng, requests)
        for name, n in K.launches().items():
            prefill_counts[name] += n - before[name]
        return wave

    eng.admit_wave = admit_counted
    K.reset_launches()
    t0 = time.perf_counter()
    done = eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launches()
    require(len(done) == N_REQUESTS, f"served {len(done)} of {N_REQUESTS}")
    for r in done:
        require(r.done and len(r.output) == r.max_new_tokens,
                f"request {r.uid}: {len(r.output)} of {r.max_new_tokens} tokens, "
                f"done={r.done}")
        require(all(0 <= t < cfg.vocab_size for t in r.output),
                f"request {r.uid}: token outside the vocabulary")
    per_step = expected_launches(cfg, True), expected_launches(cfg, False)
    path = [name for name in K.KERNELS if any(step[name] for step in per_step)]
    for name in path:
        require(counts[name] > 0, f"{cfg.name}: kernel {name} of its path was "
                "not launched in the serve run")
    # one whole-batch prefill, then a batch-1 prefill per refilled slot; each
    # prefill and each decode round launches exactly one step's kernels
    prefills, st = 1 + N_REQUESTS - SLOTS, eng.stats
    seq = "wkv" if cfg.attention_free else "flash_attention"
    require(prefill_counts[seq] == prefills * cfg.n_layers,
            f"{prefill_counts[seq]} {seq} launches in the prefill phase, not the "
            f"{prefills} x {cfg.n_layers} of one wave and {prefills - 1} refills")
    for phase, got, n, step in (("prefill", prefill_counts, prefills, per_step[0]),
                                ("decode", {name: c - prefill_counts[name]
                                            for name, c in counts.items()},
                                 st["steps"], per_step[1])):
        require(got == {name: n * c for name, c in step.items()},
                f"{cfg.name}: {phase} phase launches {got}, not {n} x {step}")
    prompt_tokens = sum(lens)
    print(f"[serve] {cfg.name}: {N_REQUESTS} requests on {SLOTS} slots, prompts "
          f"{min(lens)}-{max(lens)} tokens ({prompt_tokens} in all), "
          f"{min(NEW_TOKENS)}-{max(NEW_TOKENS)} new tokens ({sum(NEW_TOKENS)} in "
          f"all); one whole-batch prefill and {prefills - 1} per-slot refills")
    print(f"[serve] {cfg.name}: prefill {st['prefill_s']:.4f} s, decode "
          f"{st['decode_s']:.4f} s over {st['steps']} rounds, wall {wall:.4f} s")
    print(f"[serve] {cfg.name}: {st['tokens_out']} tokens out: {eng.throughput():.2f} "
          f"tok/s (engine), decode {(st['tokens_out'] - N_REQUESTS) / st['decode_s']:.2f} "
          f"tok/s, prefill {prompt_tokens / st['prefill_s']:.2f} prompt tok/s")
    print(f"[serve] {cfg.name}: kernels of its path {path}, all launched; "
          f"launches in the serve run: {json.dumps(counts)}, of which in its "
          f"{prefills} prefills: {json.dumps(prefill_counts)}")
    del eng

    # launches of one prefill step and one decode step of the served model
    cache = init_cache(cfg, SLOTS, MAX_LEN, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 512), generator=gen).cuda()
    K.reset_launches()
    model.prefill(toks, cache)
    per_prefill = K.launches()
    K.reset_launches()
    model.decode_step(toks[:, 0], cache)
    per_decode = K.launches()
    torch.cuda.synchronize()
    require(per_prefill == per_step[0],
            f"{cfg.name}: launches per prefill step {per_prefill}")
    require(per_decode == per_step[1],
            f"{cfg.name}: launches per decode step {per_decode}")
    print(f"[serve] {cfg.name}: launches per prefill step {json.dumps(per_prefill)}, "
          f"per decode step {json.dumps(per_decode)}")
    profile_decode(torch, model, cache, toks[:, 0])
    print(f"[serve] {cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del model, cache
    torch.cuda.empty_cache()
    return counts, per_prefill, per_decode, lens[:SLOTS]


def profile_decode(torch, model, cache, tok, steps=5):
    """Where a decode step's time goes: host wall time per step, device
    time per step from a torch.profiler trace, and the kernels by device
    time. Device time sums the device-side events (kernels, copies) only:
    an ATen op's own device time is the time of the kernels it launched,
    so adding the two would count that time twice."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(2):
        model.decode_step(tok, cache)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        model.decode_step(tok, cache)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            model.decode_step(tok, cache)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type != torch.autograd.DeviceType.CPU]
    dev_us = sum(e.self_device_time_total for e in events) / steps
    n_kernels = sum(e.count for e in events) / steps
    print(f"[profile] decode step at {tok.shape[0]} slots: wall {wall_ms:.3f} ms "
          f"(no profiler), device busy {dev_us / 1e3:.3f} ms per step "
          f"({dev_us / 1e3 / wall_ms * 100:.1f}% of wall), {n_kernels:.0f} device "
          f"activities per step")
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]
    for e in top:
        print(f"[profile]   {e.self_device_time_total / steps / 1e3:8.4f} ms/step "
              f"{e.count / steps:6.1f}x  {e.key[:90]}")
    cpu_top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:8]
    for e in cpu_top:
        print(f"[profile]   host {e.self_cpu_time_total / steps / 1e3:8.4f} ms/step "
              f"{e.count / steps:6.1f}x  {e.key[:90]}")


def phase_model(torch, arch, n_layers, S, steps):
    """Full width, cut in depth: the card's logits against the port's CPU
    path on the same weights, two prompts of S and S*41/64 tokens."""
    from repro_torch.models import LM, init_cache, init_params
    cfg = served_config(arch, n_layers)
    gpu = init_params(cfg, seed=1, device="cuda")
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    gen = torch.Generator("cpu").manual_seed(2)
    B = 2
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    lens = torch.tensor([S, S * 41 // 64], dtype=torch.int32)
    T = 2 * S
    cg = init_cache(cfg, B, T, device="cuda")
    cc = init_cache(cfg, B, T, device="cpu")
    V = cfg.vocab_size
    t0 = time.perf_counter()
    lg, lc = gpu.prefill(toks.cuda(), cg, lens.cuda()).cpu(), cpu.prefill(toks, cc, lens)
    if cfg.attention_free:
        check_wave_state(torch, cfg, gpu, toks, lens, cg, lg)
    errs = [rel_err(lg[:, :V], lc[:, :V])]
    agree = [(lg[:, :V].argmax(-1) == lc[:, :V].argmax(-1)).float().mean().item()]
    for _ in range(steps):
        nxt = lc[:, :V].argmax(-1).int()        # teacher-force the CPU's tokens
        lg = gpu.decode_step(nxt.cuda(), cg).cpu()
        lc = cpu.decode_step(nxt, cc)
        require(torch.isfinite(lg[:, :V].float()).all(), "non-finite logits on the card")
        errs.append(rel_err(lg[:, :V], lc[:, :V]))
        agree.append((lg[:, :V].argmax(-1) == lc[:, :V].argmax(-1)).float().mean().item())
    tol = 2e-2
    print(f"[model] {cfg.name} (full width, {n_layers} layers, batch {B}, prompts "
          f"{lens.tolist()}) card vs CPU, rel_err of logits: prefill {errs[0]:.3e}, "
          f"decode max {max(errs[1:]):.3e} (tol {tol:g}: both bf16, kernels against "
          f"plain versions and another GEMM order); {time.perf_counter() - t0:.1f} s")
    print(f"[model] {cfg.name}: greedy token agreement over prefill + {steps} decode "
          f"steps: {statistics.mean(agree):.4f}")
    require(max(errs) < tol, f"{cfg.name}: card vs CPU logits rel_err "
            f"{max(errs):.3e} >= {tol}")
    del gpu, cpu, cg, cc
    torch.cuda.empty_cache()


def check_wave_state(torch, cfg, gpu, toks, lens, cache, logits):
    """On the card: the short prompt's state, token shifts and logits after
    the right-padded wave against that prompt prefilled alone (its pads must
    stay out of its state, ROADMAP.md C4), within 2e-2."""
    from repro_torch.models import init_cache
    n = int(lens[1])
    alone = init_cache(cfg, 1, n, device="cuda")
    want = gpu.prefill(toks[1:2, :n].cuda(), alone).cpu()
    V = cfg.vocab_size
    errs = {"logits": rel_err(logits[1:2, :V], want[:, :V])}
    errs.update({name: rel_err(cache[name][:, 1], alone[name][:, 0])
                 for name in ("state", "sx_t", "sx_c")})
    tol = 2e-2
    print(f"[model] {cfg.name}: prompt of {n} tokens in the wave padded to "
          f"{toks.shape[1]} against it prefilled alone on the card, rel_err "
          + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()) + f" (tol {tol:g})")
    require(max(errs.values()) < tol, f"{cfg.name}: the padded wave's state "
            f"departs from the prompt's own: {errs}")


def time_ms(torch, fn, iters=25, warmup=3):
    """Median device ms of `fn` over CUDA-event-timed runs. Before each run
    the L2 cache is flushed (the model's callers find their inputs cold) and
    the card is kept busy for ~1 ms, so that the host has enqueued all of
    `fn` before the start event fires and its launch overhead stays out of
    the time."""
    flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes, flops, rate):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / rate
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_timing(torch, counts, per_prefill, per_decode, errs, wave_lens):
    """Each kernel at the served shapes. The first shape timed for a kernel
    gives its row of the summary; every shape is kept in the row's
    ``shapes``. wkv's prefill is timed at the served rwkv6 wave's prompt
    lengths `wave_lens`. `counts` holds each kernel's launches in its path's
    run (the serve runs, the GEMM path for the two GEMM kernels)."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gelu.ref import gelu_ref, silu_mul_ref
    from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
    from repro_torch.kernels.wkv.ref import wkv_ref
    bf = torch.bfloat16
    rnd = Inputs(torch, 3)
    rows = {}

    def add(name, label, kernel, plain, library, nbytes, flops, rate, iters=25,
            plain_iters=25, **extra):
        ms = time_ms(torch, kernel, iters)
        plain_ms = time_ms(torch, plain, plain_iters)
        lib_ms = time_ms(torch, library, iters) if library is not None else None
        b_ms, b_by = bound(nbytes, flops, rate)
        lib_s = f"{lib_ms:.5f} ms" if lib_ms is not None else "none"
        print(f"[timing] {name:16s} {label}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library {lib_s}, bound {b_ms:.5f} ms ({b_by}), "
              f"{b_ms / ms * 100:.1f}% of bound")
        shape = {"shape": label, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                 "bound_by": b_by, "library_ms": lib_ms, **extra}
        if name in rows:
            rows[name]["shapes"].append(shape)
            return
        route, source = SOURCES[name]
        rows[name] = {"name": name, "route": route, "source": source,
                      "replaces": REPLACES[name], "launches": counts[name],
                      "max_abs_err": errs[name], **shape,
                      "launches_per_prefill_step": {a: c[name] for a, c in per_prefill.items()},
                      "launches_per_decode_step": {a: c[name] for a, c in per_decode.items()},
                      "shapes": [shape]}

    for R, C in ((4096, 2048), (4096 * 16, 128)):
        x, g = rnd((R, C), bf), rnd((C,), torch.float32)
        gb = g.to(bf)
        add("rmsnorm", f"x({R},{C}) bf16", lambda: KERNELS["rmsnorm"](x, g),
            lambda: rmsnorm_ref(x, g), lambda: F.rms_norm(x, (C,), gb, 1e-6),
            2 * R * C * 2 + C * 4, 4 * R * C, FP32_FLOPS)

    for R, C in ((4096, 2048), (4096, 12288)):
        x, g, b = rnd((R, C), bf), rnd((C,), torch.float32), rnd((C,), torch.float32)
        gb, bb = g.to(bf), b.to(bf)
        add("layernorm", f"x({R},{C}) bf16", lambda: KERNELS["layernorm"](x, g, b),
            lambda: layernorm_ref(x, g, b), lambda: F.layer_norm(x, (C,), gb, bb, 1e-5),
            2 * R * C * 2 + 2 * C * 4, 8 * R * C, FP32_FLOPS)

    R, C = 4096, 49152
    x = rnd((R, C), bf)
    add("gelu", f"x({R},{C}) bf16", lambda: KERNELS["gelu"](x), lambda: gelu_ref(x),
        lambda: F.gelu(x, approximate="tanh"), 2 * R * C * 2, 10 * R * C, FP32_FLOPS)
    del x

    for C in (6144, 5632):
        a, b = rnd((4096, C), bf), rnd((4096, C), bf)
        add("silu_mul", f"g,u(4096,{C}) bf16", lambda: KERNELS["silu_mul"](a, b),
            lambda: silu_mul_ref(a, b), None, 3 * 4096 * C * 2, 5 * 4096 * C, FP32_FLOPS)

    # (heads, kv-heads, d_head) of qwen3, stablelm and gpt3
    B, S, T = SLOTS, 512, MAX_LEN
    for Hq, Hkv, D in ((16, 8, 128), (32, 32, 64), (96, 96, 128)):
        q, k, v = rnd((B, Hq, S, D), bf), rnd((B, Hkv, S, D), bf), rnd((B, Hkv, S, D), bf)
        pairs = S * (S + 1) // 2
        add("flash_attention", f"q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) causal bf16",
            lambda: KERNELS["flash_attention"](q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   enable_gqa=True),
            2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D), 4 * D * B * Hq * pairs,
            BF16_TENSOR_FLOPS)
        del q, k, v

        G = Hq // Hkv
        lens_list = decode_lengths(SLOTS, T)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        qd = rnd((SLOTS, Hkv, G, D), bf)
        kd, vd = rnd((SLOTS, T, Hkv, D), bf), rnd((SLOTS, T, Hkv, D), bf)
        mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
        q_sdpa = qd.reshape(SLOTS, Hkv * G, 1, D)
        add("decode_attention", f"q({SLOTS},{Hkv},{G},{D}) kv({SLOTS},{T},{Hkv},{D}) "
            f"lengths={lens_list} bf16",
            lambda: KERNELS["decode_attention"](qd, kd, vd, lens),
            lambda: decode_attention_ref(qd, kd, vd, lens),
            lambda: F.scaled_dot_product_attention(q_sdpa, kd.transpose(1, 2),
                                                   vd.transpose(1, 2), attn_mask=mask,
                                                   enable_gqa=True),
            2 * (2 * SLOTS * Hkv * G * D + 2 * sum(lens_list) * Hkv * D) + 4 * SLOTS,
            4 * D * G * Hkv * sum(lens_list), BF16_TENSOR_FLOPS)
        del qd, kd, vd

    # wkv: the served rwkv6 wave's prefill (data-dependent: the steps of its
    # prompt lengths are counted, the output is written in full) and the
    # decode step in place; per step 5 fp32 operations a state element (an
    # FMA for r.S, a multiply and an FMA for the update) and 2 N for the
    # bonus dot r.(u*k), whose product with v_j is O(N) too
    H, N = 64, 64
    for T, with_state in ((max(wave_lens), False), (1, True)):
        r, k, v, w, u, s0 = wkv_inputs(torch, rnd, SLOTS, T, H, N, with_state)
        lens_t = torch.tensor(wave_lens, dtype=torch.int32, device="cuda") \
            if T > 1 else None
        steps = sum(wave_lens) if T > 1 else SLOTS
        state_bytes = SLOTS * H * N * N * 4 * (2 if with_state else 1)
        label = (f"r,k,v,w ({SLOTS},{T},{H},{N}) fp32 "
                 + (f"lengths={wave_lens}" if T > 1 else "state0 in place"))
        add("wkv", label, lambda: KERNELS["wkv"](r, k, v, w, u, s0, lens_t, state_out=s0),
            lambda: wkv_ref(r, k, v, w, u, s0, lens_t), None,
            4 * steps * H * N * 4 + SLOTS * T * H * N * 4 + state_bytes + H * N * 4,
            5 * steps * H * N * N + 2 * steps * H * N, FP32_FLOPS)
        del r, k, v, w, s0

    # the GEMM path: gpt3-175b's layer GEMMs at M = 8 and 4096; the kernels
    # at the op's tile (its default request clamped to the shape) on
    # pre-quantized operands (quantization is the op's tensor code, outside
    # the kernel, as in the TPU op). bf16 and e4m3 on the wgmma kernel, with
    # the mma.sync kernel of matmul.cu (which ran these modes before the
    # wgmma one) timed beside it at its default tile (128, 32, 128) on the
    # same operands; fp32 at M = 8 and FFN up at M = 4096 only. Plain
    # versions at M = 4096 take ~0.1 s a call, hence fewer runs there
    from repro_torch.core.hardware import nvidia_h100
    from repro_torch.core.mapper import matmul_perf
    from repro_torch.kernels.matmul.kernel import E4M3_FORM, split_plan, select_tile
    from repro_torch.kernels.matmul.ops import mapper_blocks
    from repro_torch.kernels.matmul.ref import (dequant_matmul_ref, matmul_reduce_ref,
                                                matmul_ref, quantize_fp8, quantize_int8)
    f32, f8 = torch.float32, torch.float8_e4m3fn
    one = torch.ones((), device="cuda")
    old_tile = (128, 32, 128)

    def library_or_none(fn, what):
        try:
            fn()
            torch.cuda.synchronize()
            return fn
        except RuntimeError as e:
            print(f"[timing] {what}: library call refused ({str(e).splitlines()[0][:100]})")
            return None

    for M in GEMM_ROWS:
        iters, plain_iters = (25, 25) if M == SLOTS else (10, 3)
        for gemm, Kd, N in GPT3_GEMMS:
            a32, b32 = rnd((M, Kd), f32), rnd((Kd, N), f32)
            shape = f"gpt3-175b {gemm} ({M},{Kd})x({Kd},{N})"
            ops2 = 2 * M * Kd * N
            request = (min(256, M), min(512, Kd), min(256, N))
            a, b = a32.to(bf), b32.to(bf)
            tile = select_tile(bf, *request)
            splits = len(split_plan(M, N, Kd, tile))
            mp = matmul_perf(nvidia_h100(), M, Kd, N)
            mtile = mapper_blocks(M, Kd, N)
            mapper_ms = time_ms(torch, lambda: KERNELS["matmul_wgmma"](
                a, b, bm=mtile[0], bk=mtile[1], bn=mtile[2]), iters)
            mapping = mp.mapping
            print(f"[mapper] {shape} bf16: nvidia_h100() predicts {mp.latency * 1e3:.5f} ms "
                  f"({mapping.bound}), subtile ({mapping.subtile_m}, {mapping.subtile_k}, "
                  f"{mapping.subtile_n}) -> mapper_blocks {mtile}: kernel {mapper_ms:.5f} ms "
                  f"(the op's tile {tile} below)")
            old_ms = time_ms(torch, lambda: KERNELS["matmul"](
                a, b, bm=old_tile[0], bk=old_tile[1], bn=old_tile[2]), iters)
            add("matmul_wgmma", f"{shape} bf16 tile {tile}, {splits} split(s) of K",
                lambda: KERNELS["matmul_wgmma"](a, b, bm=tile[0], bk=tile[1], bn=tile[2]),
                lambda: matmul_ref(a, b), lambda: torch.matmul(a, b),
                2 * (M * Kd + Kd * N + M * N), ops2, BF16_TENSOR_FLOPS, iters, plain_iters,
                mode="bf16", mma_sync_ms=old_ms, mapper_predicted_ms=mp.latency * 1e3,
                mapper_tile=list(mtile), mapper_tile_ms=mapper_ms)
            add("matmul", f"{shape} bf16 on mma.sync, tile {old_tile}",
                lambda: KERNELS["matmul"](a, b, bm=old_tile[0], bk=old_tile[1],
                                          bn=old_tile[2]),
                lambda: matmul_ref(a, b), lambda: torch.matmul(a, b),
                2 * (M * Kd + Kd * N + M * N), ops2, BF16_TENSOR_FLOPS, iters, plain_iters,
                mode="bf16")
            del a, b
            if M == SLOTS or gemm == "ffn_up":
                tile = select_tile(f32, *request)
                add("matmul", f"{shape} fp32 tile {tile}",
                    lambda: KERNELS["matmul"](a32, b32, bm=tile[0], bk=tile[1], bn=tile[2]),
                    lambda: matmul_ref(a32, b32), lambda: torch.matmul(a32, b32),
                    4 * (M * Kd + Kd * N + M * N), ops2, FP32_FLOPS, iters, plain_iters,
                    mode="fp32")
            a8, b8 = quantize_fp8(a32), quantize_fp8(b32).t().contiguous().t()
            tile = select_tile(f8, *request)
            splits = len(split_plan(M, N, Kd, tile))
            old_ms = time_ms(torch, lambda: KERNELS["matmul"](
                a8, b8, bm=old_tile[0], bk=old_tile[1], bn=old_tile[2], out_dtype=f32), iters)
            library = library_or_none(lambda: torch._scaled_mm(a8, b8, scale_a=one, scale_b=one,
                                                               out_dtype=f32), f"{shape} fp8")
            add("matmul_wgmma", f"{shape} e4m3 operands ({E4M3_FORM}), fp32 out, tile {tile}, "
                f"{splits} split(s) of K",
                lambda: KERNELS["matmul_wgmma"](a8, b8, bm=tile[0], bk=tile[1], bn=tile[2],
                                                out_dtype=f32),
                lambda: matmul_ref(a8, b8, out_dtype=f32), library,
                M * Kd + Kd * N + 4 * M * N, ops2, INT8_FP8_TENSOR_OPS, iters, plain_iters,
                mode="fp8", mma_sync_ms=old_ms)
            if M == SLOTS and gemm == "out":   # the e4m3 out GEMM's 3-way split
                p = rnd((splits, M, N), f32)
                add("matmul_reduce", f"{shape} e4m3 partials ({splits},{M},{N}) fp32 -> fp32",
                    lambda: KERNELS["matmul_reduce"](p, torch.empty((M, N), device="cuda")),
                    lambda: matmul_reduce_ref(p), lambda: torch.sum(p, 0),
                    4 * (splits + 1) * M * N, (splits - 1) * M * N, FP32_FLOPS, iters,
                    plain_iters)
                del p
            del a8, b8
            (qa, sa), (qb, sb) = quantize_int8(a32, 1), quantize_int8(b32, 0)
            qb = qb.t().contiguous().t()
            tile = select_tile(torch.int8, *request)
            add("matmul_int8", f"{shape} int8, fp32 out, tile {tile}",
                lambda: KERNELS["matmul_int8"](qa, qb, sa, sb, bm=tile[0], bk=tile[1],
                                               bn=tile[2]),
                lambda: dequant_matmul_ref(qa, qb, sa, sb),
                library_or_none(lambda: torch._int_mm(qa, qb) * sa * sb, f"{shape} int8"),
                M * Kd + Kd * N + 4 * (M + N) + 4 * M * N, ops2, INT8_FP8_TENSOR_OPS, iters,
                plain_iters, mode="int8")
            del qa, qb, a32, b32
            torch.cuda.empty_cache()
    return [rows[name] for name in SOURCES]


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script "
                         "runs on the card")
    import repro_torch  # noqa: F401  (fails here without the repository)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {torch.cuda.get_device_name(0)}")
    phase_build(torch)
    errs = phase_kernels(torch)
    gemm_counts, gemm_errs = phase_matmul(torch)
    probe = phase_e4m3_probe(torch)
    counts, per_prefill, per_decode, wave_lens = {}, {}, {}, {}
    for arch, n_layers in SERVED:
        run, per_prefill[arch], per_decode[arch], wave_lens[arch] = phase_serve(
            torch, arch, n_layers)
        counts = {name: counts.get(name, 0) + n for name, n in run.items()}
    print(f"[serve] launches summed over the {len(SERVED)} serve runs: "
          f"{json.dumps(counts)}")
    for check in MODEL_CHECKS:
        phase_model(torch, *check)
    # the GEMM kernels' launches are those of their path; no model calls them
    gemm_kernels = ("matmul", "matmul_wgmma", "matmul_reduce", "matmul_int8")
    by_mode = {"matmul": ("fp32",), "matmul_wgmma": ("bf16", "fp8"), "matmul_reduce": (),
               "matmul_int8": ("int8",)}
    for name in gemm_kernels:
        errs[name] = max((gemm_errs[m] for m in by_mode[name]), default=0.0)
    path_counts = {**counts, **{name: gemm_counts[name] for name in gemm_kernels}}
    rows = phase_timing(torch, path_counts, per_prefill, per_decode, errs,
                        wave_lens["rwkv6-7b"])
    for row in rows:
        if row["name"] in gemm_kernels:
            row["launches_in_serve_runs"] = counts[row["name"]]
            row["max_abs_err_by_mode"] = {m: gemm_errs[m] for m in by_mode[row["name"]]}
            if row["name"] == "matmul_wgmma":
                row["e4m3_probe_passes"] = probe
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"[env] whole run {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
