"""Pair this tree's backward kernels, train steps, decode attention and
decode steps with another tree's (a parent commit's) on one card.

    python3 chip_pair.py PARENT_DIR [PART ...]

PARENT_DIR holds the other tree as ``git archive`` gives it; PART is any of
``bwd``, ``train`` and ``decode`` (all three by default). Four worker
processes run in turns, PARENT_DIR, this tree, this tree, PARENT_DIR; each
imports its own tree's package and ``chip_smoke.py`` (whose helpers make the
inputs and time the calls), builds that tree's kernels into its own
``build/`` and, on the same seeded inputs:

  * the flash-attention backward on the TMA + wgmma kernel at D = 256,
    recurrentgemma-2b's train shape q (8,10,512,256) on one kv-head with its
    window of 2048 (which 512 tokens do not reach) and past its window, q
    (1,10,4096,256): both launches and each apart, and SDPA's backward
    beside them (``torch.autograd.grad`` of one call; the window as a band
    mask where it cuts); at D = 64 and 128, qwen3-1.7b's, qwen2-0.5b's and
    grok-1-314b's (softcap 30) shapes: the time and a hash of dq, dk, dv;
  * the wkv backward at rwkv6-7b's train shape (8, 512, 64, 64), from the
    chunked forward's segment states;
  * the chunked wkv forward at rwkv6-7b's served wave (8, 436, 64, 64, the
    wave's prompt lengths): the time and a hash of its output and state;
  * the LayerNorm backward (the tree's router ``rmsnorm/kernel.py::
    layernorm_bwd`` where it has one, else its ``KERNELS["layernorm_bwd"]``)
    at the trained rows of stablelm-1.6b (4096, 2048), gpt3-175b (4096, 12288),
    rwkv6-7b (4096, 4096) and whisper-tiny's decoder (4096, 384) and
    encoder (12000, 384), bf16: the time and a hash of dx, dg and db, which
    must be the same in a tree's two turns (the trees' kernels may differ);
  * train steps of stablelm-1.6b (whole), recurrentgemma-2b (whole) and
    rwkv6-7b (15 of 32 layers) as ``chip_smoke.py``'s [train] phase runs
    them, a second run's last two steps under torch.profiler: device ms a
    step (PART ``train``; the four items above are PART ``bwd``);
  * PART ``decode``: decode attention through the tree's op (the kernel that
    tree routes the call to) at the four served shapes with more than two
    query heads a kv-head, 8 slots over a cache of 1024 at the served
    lengths: granite-moe-3b-a800m's q (8,8,3,64), llama-3.2-vision-11b's
    (8,8,4,128), grok-1-314b's (8,8,6,128) under its softcap of 30 and
    recurrentgemma-2b's (8,1,10,256); then granite's and llama's decode
    step at full size, 8 slots after a prefill of 512 tokens, under
    torch.profiler (``chip_smoke.profile_decode``): device ms a step.

Each turn's numbers, then a summary (each number the mean of a tree's two
turns), the card's name and power limit, and last a JSON line of it all.
Exits 1 if a worker fails, if the hashes of the D = 64 and 128 backward or
of the served wave differ between the trees or from one turn to the next,
or if the LayerNorm backward's differ between a tree's two turns. Needs one
card; the train runs take up to ~73 GiB of it.
"""
import contextlib
import hashlib
import io
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# (label, B, Hq, Hkv, S, D, window, softcap, q scale)
FLASH_CASES = (("recurrentgemma-2b train", 8, 10, 1, 512, 256, 2048, 0.0, 1.0),
               ("recurrentgemma-2b past its window", 1, 10, 1, 4096, 256, 2048, 0.0, 1.0),
               ("qwen3-1.7b", 8, 16, 8, 512, 128, 0, 0.0, 1.0),
               ("qwen2-0.5b", 8, 14, 2, 512, 64, 0, 0.0, 1.0),
               ("grok-1-314b softcap 30", 8, 48, 8, 512, 128, 0, 30.0, 8.0))
SERVED_WAVE = (239, 347, 332, 238, 396, 273, 424, 436)   # rwkv6-7b's prompt lengths
TRAIN = (("stablelm-1.6b", None), ("recurrentgemma-2b", None), ("rwkv6-7b", 15))
# (label, R, C) of the LayerNorm backward at the trained rows, bf16
LN_BWD_ROWS = (("stablelm-1.6b", 4096, 2048), ("gpt3-175b", 4096, 12288),
               ("rwkv6-7b", 4096, 4096), ("whisper-tiny decoder", 4096, 384),
               ("whisper-tiny encoder", 12000, 384))
# (label, Hkv, G, D, softcap) of the served decode shapes at G > 2
DECODE_CASES = (("granite-moe-3b-a800m", 8, 3, 64, 0.0), ("llama-3.2-vision-11b", 8, 4, 128, 0.0),
                ("grok-1-314b softcap 30", 8, 6, 128, 30.0), ("recurrentgemma-2b", 1, 10, 256, 0.0))
DECODE_STEPS = ("granite-moe-3b-a800m", "llama-3.2-vision-11b")
PARTS = ("bwd", "train", "decode")
PROFILED = re.compile(r"\[train\] (\S+) profiled step (\d+): .*device ([\d.]+) ms")


def digest(torch, *tensors):
    """A hash of the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def decode_part(torch, C, res):
    """PART ``decode`` of a turn: the op's time at each of DECODE_CASES and
    the profiled decode step of each of DECODE_STEPS, into `res`."""
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.models import init_cache, init_params
    rnd = C.Inputs(torch, 30)
    lens_list = C.decode_lengths(C.SLOTS, C.MAX_LEN)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    for label, Hkv, G, D, cap in DECODE_CASES:
        q = rnd((C.SLOTS, Hkv, G, D), torch.bfloat16)
        k, v = (rnd((C.SLOTS, C.MAX_LEN, Hkv, D), torch.bfloat16) for _ in range(2))
        res["ms"][f"decode attention {label} q{tuple(q.shape)}"] = C.time_ms(
            torch, lambda: decode_attention(q, k, v, lens, softcap=cap))
        del q, k, v
    for arch in DECODE_STEPS:
        cfg = C.served_config(arch, None)
        model = init_params(cfg, seed=0, device="cuda")
        cache = init_cache(cfg, C.SLOTS, C.MAX_LEN, device="cuda")
        gen = torch.Generator("cuda").manual_seed(4)
        toks = torch.randint(0, cfg.vocab_size, (C.SLOTS, 512), generator=gen, device="cuda")
        fe = None
        if cfg.n_frontend_tokens:
            fe = torch.randn((C.SLOTS, cfg.n_frontend_tokens, cfg.d_model), generator=gen,
                             device="cuda").to(torch.bfloat16)
        model.prefill(toks, cache, frontend=fe)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            wall, device = C.profile_decode(torch, model, cache, toks[:, 0])
        print(buf.getvalue(), end="", flush=True)
        res["decode_step_ms"][arch] = {"wall": wall, "device": device}
        del model, cache
        torch.cuda.empty_cache()


def worker(tree, out, parts):
    """One turn in `tree`: every number of the module docstring's `parts`
    into the JSON file `out`."""
    sys.path.insert(0, str(tree))
    import torch
    import chip_smoke as C      # puts its tree's src first on sys.path
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    res = {"tree": str(tree), "ms": {}, "hash": {}, "own_hash": {}, "train_device_ms": {},
           "decode_step_ms": {}}
    if "decode" in parts:
        decode_part(torch, C, res)
    if "bwd" in parts:
        bwd_part(torch, C, res)
    if "train" in parts:
        for arch, layers in TRAIN:
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                C.phase_train(torch, arch, layers, 1e-5, "profile")
            text = buf.getvalue()
            print(text, end="", flush=True)
            res["train_device_ms"][arch] = [float(m.group(3)) for m in PROFILED.finditer(text)]
            torch.cuda.empty_cache()
    res["card"] = torch.cuda.get_device_name(0)
    Path(out).write_text(json.dumps(res))


def bwd_part(torch, C, res):
    """PART ``bwd`` of a turn: the flash and wkv backward and the served wkv
    wave, into `res`."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.wkv.kernel import segments
    rnd = C.Inputs(torch, 29)
    bwd = KERNELS["flash_attention_bwd_wgmma"]
    for label, B, Hq, Hkv, S, D, window, cap, qs in FLASH_CASES:
        kw = dict(causal=True, window=window, softcap=cap)
        q, k, v, o, do, lse = C.flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, True, window,
                                                 cap, qs)
        runs = {"both launches": lambda: bwd(q, k, v, o, do, lse, **kw),
                "dq launch": lambda: bwd(q, k, v, o, do, lse, **kw, phases=1),
                "dk/dv launch": lambda: bwd(q, k, v, o, do, lse, **kw, phases=2)}
        if D == 256:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            if window and window < S:
                out_ = F.scaled_dot_product_attention(
                    *leaves, attn_mask=C.band_mask(torch, S, window), enable_gqa=True)
            else:
                out_ = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            runs["SDPA backward"] = lambda: torch.autograd.grad(out_, leaves, do,
                                                                retain_graph=True)
        else:
            res["hash"][f"flash bwd {label}"] = digest(torch, *bwd(q, k, v, o, do, lse, **kw))
        for name, fn in runs.items():
            res["ms"][f"flash {label}: {name}"] = C.time_ms(torch, fn)
        del q, k, v, o, do, lse, runs
        torch.cuda.empty_cache()
    r, k, v, w, u, _, dout, _ = C.wkv_train_inputs(torch, rnd, 8, 512, False)
    s_seg = torch.empty((8, 64, segments(512), 64, 64), device="cuda")
    KERNELS["wkv_chunked"](r, k, v, w, u, s_seg=s_seg)
    res["ms"]["wkv_bwd rwkv6-7b train (8,512,64,64)"] = C.time_ms(
        torch, lambda: KERNELS["wkv_bwd"](r, k, v, w, u, s_seg, dout))
    del r, k, v, w, dout, s_seg
    r, k, v, w, u, s0 = C.wkv_inputs(torch, rnd, 8, max(SERVED_WAVE), 64, 64, False)
    lens = torch.tensor(SERVED_WAVE, dtype=torch.int32, device="cuda")
    res["hash"]["wkv_chunked served wave"] = digest(
        torch, *KERNELS["wkv_chunked"](r, k, v, w, u, s0, lens))
    res["ms"]["wkv_chunked rwkv6-7b served wave (8,436,64,64)"] = C.time_ms(
        torch, lambda: KERNELS["wkv_chunked"](r, k, v, w, u, s0, lens))
    del r, k, v, w
    torch.cuda.empty_cache()
    from repro_torch.kernels.rmsnorm import kernel as norm_kernels
    ln_bwd = getattr(norm_kernels, "layernorm_bwd", KERNELS["layernorm_bwd"])
    for label, R, Cw in LN_BWD_ROWS:
        x = rnd((R, Cw), torch.bfloat16) * 3 + 1.5
        g, dy = rnd((Cw,), torch.float32), rnd((R, Cw), torch.bfloat16)
        key = f"layernorm_bwd {label} ({R},{Cw})"
        res["own_hash"][key] = digest(torch, *ln_bwd(x, g, dy))
        res["ms"][key] = C.time_ms(torch, lambda: ln_bwd(x, g, dy))
        del x, g, dy
    torch.cuda.empty_cache()


def main():
    if len(sys.argv) >= 4 and sys.argv[1] == "--worker":
        worker(Path(sys.argv[2]).resolve(), sys.argv[3], sys.argv[4:])
        return
    parts = sys.argv[2:] or list(PARTS)
    if len(sys.argv) < 2 or any(p not in PARTS for p in parts):
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_pair: torch sees no CUDA device; this script runs on the card")
    parent = Path(sys.argv[1]).resolve()
    if not (parent / "chip_smoke.py").exists():
        raise SystemExit(f"chip_pair: {parent} holds no chip_smoke.py")
    trees = {"parent": parent, "this": ROOT}
    turns = []
    tmp = ROOT / "build" / "pair"      # listed in .gitignore
    tmp.mkdir(parents=True, exist_ok=True)
    for i, name in enumerate(("parent", "this", "this", "parent")):
        out = tmp / f"turn{i}.json"
        print(f"[pair] turn {i}: {name} ({trees[name]})", flush=True)
        done = subprocess.run([sys.executable, str(ROOT / "chip_pair.py"), "--worker",
                               str(trees[name]), str(out), *parts])
        if done.returncode != 0:
            raise SystemExit(f"chip_pair: the worker of turn {i} ({name}) failed")
        res = json.loads(out.read_text())
        turns.append((name, res))
        for key, ms in res["ms"].items():
            print(f"[pair] turn {i} {name}: {key} {ms:.5f} ms")
        for arch, ms in res["train_device_ms"].items():
            print(f"[pair] turn {i} {name}: {arch} train step device "
                  + " / ".join(f"{x:.3f}" for x in ms) + " ms (profiled steps)")
        for arch, ms in res["decode_step_ms"].items():
            print(f"[pair] turn {i} {name}: {arch} decode step device {ms['device']:.3f} ms, "
                  f"wall {ms['wall']:.3f} ms")
    summary = {"ms": {}, "train_device_ms": {}, "decode_step_ms": {}, "hash": {}}
    by = {name: [r for n, r in turns if n == name] for name in trees}
    for key in by["this"][0]["ms"]:
        pair = {name: statistics.mean(r["ms"][key] for r in rs) for name, rs in by.items()}
        summary["ms"][key] = pair
        print(f"[pair] {key}: parent {pair['parent']:.5f} ms, this tree {pair['this']:.5f} ms "
              f"({pair['this'] / pair['parent']:.3f}x the parent's time)")
    for arch in by["this"][0]["train_device_ms"]:
        pair = {name: statistics.mean(x for r in rs for x in r["train_device_ms"][arch])
                for name, rs in by.items()}
        summary["train_device_ms"][arch] = pair
        print(f"[pair] {arch} train step, device ms (mean of the profiled steps of both turns):"
              f" parent {pair['parent']:.3f}, this tree {pair['this']:.3f} "
              f"({pair['this'] - pair['parent']:+.3f} ms)")
    for arch in by["this"][0]["decode_step_ms"]:
        pair = {name: {k: statistics.mean(r["decode_step_ms"][arch][k] for r in rs)
                       for k in ("device", "wall")} for name, rs in by.items()}
        summary["decode_step_ms"][arch] = pair
        print(f"[pair] {arch} decode step (8 slots, cache 513), device ms: parent "
              f"{pair['parent']['device']:.3f}, this tree {pair['this']['device']:.3f} "
              f"({pair['this']['device'] - pair['parent']['device']:+.3f} ms); wall ms: "
              f"parent {pair['parent']['wall']:.3f}, this tree {pair['this']['wall']:.3f}")
    same = True
    for key in by["this"][0]["hash"]:
        hashes = {name: {r["hash"][key] for r in rs} for name, rs in by.items()}
        equal = len(hashes["parent"] | hashes["this"]) == 1
        same &= equal
        summary["hash"][key] = equal
        print(f"[pair] {key}: {'the same bits in all four turns' if equal else 'BITS DIFFER'} "
              f"{hashes}")
    summary["own_hash"] = {}
    for key in by["this"][0]["own_hash"]:
        hashes = {name: {r["own_hash"][key] for r in rs} for name, rs in by.items()}
        equal = all(len(h) == 1 for h in hashes.values())
        same &= equal
        summary["own_hash"][key] = equal
        print(f"[pair] {key}: {'the same bits in each tree' if equal else 'BITS DIFFER'} "
              f"between its two turns {hashes}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({"card": smi, **summary}))
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
