"""Chip smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the script on its own (exit code 1, and no
result line):
  1. build   - nvcc builds the CUDA kernels from ``src/repro_torch/kernels/
               csrc`` (all sources at once, the backward's
               flash_attention_bwd_sm90.cu, flash_attention_bwd.cu,
               rglru_bwd.cu and wkv_bwd.cu among them) and Triton
               compiles its kernels (the norms, silu_mul, and the
               RMSNorm, LayerNorm and SwiGLU backward ones) and the GELU
               kernel gelu.cu replaced, which is timed beside it
               (registers and spills read from the compiled kernels);
  2. kernels - each hand-written kernel against its plain PyTorch version on
               the card, in bf16 and fp32 (relative error to the largest
               output below 2e-2 and 2e-5, the JAX kernel tests' bounds; in
               bf16 also element by element: the four elementwise kernels
               (norms, gelu, silu_mul) within one bf16 rounding, |a-b| <=
               2^-7 |b| + 1e-3, the attention kernels within |a-b| <= 2^-6
               |b| + 2^-5 rms(row)),
               at the JAX kernel tests' shapes and at the served models' own
               shapes (each of the three head layouts); each attention case
               on the flash kernel ``wgmma_eligible`` picks for it (the
               TMA + wgmma one for bf16 at D = 64 and 128, contiguous or
               the model's transposed views; mma.sync for D = 32 and a
               sequence stride TMA cannot take; fp32 on its own); each
               decode case on the kernel ``decode_kernel`` picks (the
               chunked one for bf16 at G = 1, the mma one for bf16 at G >=
               2, each at D = 32-256 with lengths at its unit edges; the
               split one for fp32), the served decode shapes on every
               kernel that takes them; the fp32
               wkv op to 1e-4 (output and final state), the JAX wkv tests'
               bound, each case on the kernel ``chunked_eligible`` picks
               (the chunked one for T > 1, the step-by-step one for the
               decode step and strides the chunked one cannot copy), at
               their shapes, T off either kernel's chunk and below 16,
               decays with exact 0, 1e-30 and 1, the served prefill with
               prompt lengths, a batch-1 refill of 452 tokens and the
               decode step in place on a nonzero state; the gated-GELU mode
               (gelu_mul) at recurrentgemma's MLP shapes; flash attention at
               D = 256 on the wgmma kernel (10 query heads on one kv-head,
               windows that cut key tiles, the served wave and the ring
               phase's prefill) and in fp32; decode attention at D = 256
               with 10 query heads (the mma kernel; fp32 on the split
               one); the rglru op to 1e-4 (output and final h) at d = 2560,
               each case on the kernel ``picks_chunked`` names (the chunked
               scan for T > 1, rglru.cu for the decode step), one launch of
               it: unequal lengths with a 0, h0 nonzero, decays near 0 and
               near 1, T off every segment and tile, the served wave, a
               batch-1 refill of 452, the ring phase's prefill of 2304 and
               the decode step in place; then every input ROADMAP C9 once listed as
               refused, through its op, on the kernel its launch count
               names: fp16 GEMMs (and matmul_fp8 writing fp16) at 1e-3 and
               per element, flash attention at D = 16, 48, 96 and 200
               (zero-padded) and 256 in fp32, decode attention at 16, 200
               and 256 in fp32, wkv at N = 16, 48 and 128; and that D above
               256 and N above 128 are still refused;
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
               TMA + wgmma kernel (matmul_wgmma), the 8 int8 ones on its
               int8 mode (matmul_int8_wgmma) and the 8 fp32 ones on its FFMA
               mode (matmul_f32_tma), with one split-K reduction
               (matmul_reduce) for each GEMM its split plan splits, none on
               matmul.cu (SIMT, mma.sync) or matmul_int8.cu, no other
               kernel; before that, int8 at
               K past 131071 (131072 and 140000 on the wgmma kernel, 131073
               on mma.sync: ROADMAP C8); the reduction bit for bit against
               its plain version, also with the int8 scales; the
               per-element check is shown to fail two mutants made from the plain product (a dropped
               k-step, a transposed tile of B); then the e4m3 probe: native
               e4m3 wgmma, promoted into fp32 every 128 of K or every
               instruction, at the same gpt3 shapes against the fp8 checks,
               beside ``torch._scaled_mm``'s own errors;
  4. serve   - nine served paths, one model each, random weights from a
               seeded torch.Generator: qwen3-1.7b (full width and depth;
               rmsnorm, silu_mul), stablelm-1.6b (full width and depth;
               layernorm, silu_mul, partial RoPE, d_head 64), gpt3-175b
               (full width cut to 8 of 96 layers; layernorm, gelu,
               sinusoidal positions, 96 heads), rwkv6-7b (full width and
               depth, attention-free; layernorm, wkv) and recurrentgemma-2b
               (full width and depth, 26 layers: 18 RG-LRU layers (gelu on
               the gate branch, rglru_chunked at prefill and rglru at a
               decode step) and 8 local-attention layers at
               D = 256 on one kv-head; rmsnorm, gelu_mul), and two MoE
               decoders: granite-moe-3b-a800m (full size, 3.30 G
               parameters: 40 experts, top-8, SwiGLU experts on silu_mul,
               24 heads of 64 on 8 kv-heads) and grok-1-314b (full width
               cut to 4 of 64 layers, 21.3 G parameters: 8 experts, top-2,
               gated-GELU experts on gelu_mul, 48 heads of 128 on 8, both
               attention kernels under its logit softcap of 30); their
               experts' products are torch.bmm and their dispatch and
               combine plain ops, as the JAX model leaves them to XLA; and
               two cross-attending models, each request with its own
               seeded stub frontend: llama-3.2-vision-11b (full size,
               9.78 G parameters: 40 layers, 8 of them gated
               cross-attention over 1601 frontend tokens, 32 heads of 128
               on 8; rmsnorm, silu_mul) and whisper-tiny (full size: a
               4-layer encoder over 1500 frontend tokens, 4 decoder layers
               cross-attending to it, 6 heads of 64; layernorm, gelu, qkv
               bias, sinusoidal positions); each cross-attention runs
               non-causal flash at prefill, and at a decode step
               ``attend_all_keys``: the decode op (every length the
               frontend's) where it runs the chunked or the mma kernel
               (whisper's G = 1, llama's G = 4), else flash on the one
               query. Each
               serves 16 greedy
               requests of 16-48 new tokens on 8 slots through the port's
               Engine: one whole-batch prefill of prompts of unequal
               lengths, then each freed slot refilled by a batch-1 prefill
               and insert. Every kernel's launch count is set to 0 just
               before each serve and read just after, split into the
               prefill and the decode phase: each kernel of that model's
               path must be above 0, and each phase must show exactly its
               steps' launches (9 prefills: one wave, 8 refills; L
               launches a decode step of the decode kernel
               ``decode_kernel`` names for the model's G and 0 of the
               others, the split kernel 0 on every model; rwkv6: L
               wkv_chunked and 0 wkv a prefill, L wkv and 0 wkv_chunked a
               decode step; recurrentgemma: 18 rglru_chunked
               and 0 rglru a prefill, 18 rglru and 0 rglru_chunked a decode
               step; a cross-attending model also
               its cross layers', and at each prefill its encoder's,
               ``expected_launches``); then the
               device time of the served wave's prefill (its device-busy
               time under torch.profiler, and CUDA events with the host's
               enqueue hidden behind a sleep of the card), the
               launches of one prefill and one decode step, a torch.profiler
               breakdown of the decode step, and the model's peak memory;
               for an MoE model the share of (token, choice) assignments
               its capacity drops at layer 0, in the served wave (its pads
               route and take capacity as in the JAX model, ROADMAP C10)
               and in one 8-slot decode step, and one decode step run under
               torch.cuda.set_sync_debug_mode("error"): nothing on it waits
               for the host;
               for recurrentgemma-2b then the ring phase: one request of a
               2304-token prompt, past its 2048-token window, on a budget
               of 2560, and 40 decode steps past the ring's wrap, with
               exactly one prefill's and 40 steps' launches;
               each model and its cache are freed before the next is built;
  5. model   - each model at full width cut in depth (qwen3, stablelm,
               rwkv6 and granite to 2 layers, gpt3 and grok to 1,
               recurrentgemma to 3 and llama-3.2-vision to 5: one unit
               each; whisper-tiny whole; the two cross-attending ones with
               full-length frontends, xgate 0.5, random qkv biases and
               their cross output projection scaled up, their cross K/V
               held too), its prefill and decode logits
               on the card against the port's CPU path on a batch of two
               prompts of unequal lengths, the card teacher-forced on the
               CPU's greedy tokens (llama's card held to an fp32 CPU run
               instead: no further from it than the bf16 CPU path, times
               ``FP32_FACTOR``, ``MODEL_CHECKS`` says why); an MoE model's routing is recorded on
               the CPU and replayed on the card (a top-k near-tie may flip
               between the two and move a token by a share of its MLP
               term), and in that run the experts the card would have
               chosen itself are held to the CPU's: a choice may differ
               only where the CPU's margin between the k-th and (k+1)-th
               router logit is at most twice the largest card-CPU
               router-logit difference of that layer's call; for
               rwkv6 and recurrentgemma also the short prompt's recurrent
               state (and ring K/V) after the padded wave against that
               prompt prefilled alone on the card; then the ring phase held
               the same way: recurrentgemma at 3 layers, prompts of 2304 and
               2100 tokens on a 2560 budget (a ring of 2048), 40 decode
               steps past the wrap;
  6. timing  - each kernel at the served models' shapes (the GEMMs at the
               matmul path's), beside its plain version, the one PyTorch call
               that computes the same function where there is one, and its
               bound on the card; beside the wgmma flash kernel and the
               wgmma GEMM modes, the mma.sync kernel each ran on before
               (flash_attention.cu, matmul.cu, matmul_int8.cu), beside the
               decode kernel the op picks the others that take the shape
               and torch.sum over the same live K and V, beside the fp32 FFMA mode the SIMT
               kernel, each on the same operands; gelu, F.gelu and the
               Triton kernel gelu.cu replaced in turns at the prefill and
               the decode shape; gelu_mul beside F.gelu(g) * u; flash at
               D = 256 (recurrentgemma's wave and its ring prefill) beside
               SDPA; rglru_chunked at the served recurrentgemma run's wave,
               longest refill and the ring phase's prefill beside rglru.cu
               (which ran them before) and at each segment length, and the
               decode step on rglru.cu beside the chunked kernel; the
               chunked wkv kernel at the served rwkv6 run's wave and each
               of its 8 refills beside the step-by-step kernel and at each
               column split, and the decode
               step beside ``s0.mul_(1.0)`` on its state, and at N = 128
               (wkv.cu); silu_mul beside F.silu(g) * u, also at granite's
               expert buffer at its served wave; gelu_mul at grok's; flash
               at both MoE models' waves on the model's transposed views
               (grok's under its softcap, beside SDPA without it, which
               takes none); the mma decode kernel at their decode steps
               (grok's softcap) beside the chunked and the split one and
               SDPA; each of
               these MoE shapes first held to its plain version on the
               tensors timed, as in phase 2 (the split kernel too); the
               whole MoE layer of granite at its decode step and its wave
               against the bytes of its 40 experts (its own ``[timing]
               moe_apply`` record, outside the kernels); the three decode
               kernels at G = 1, 2, 3, 4, 6, 10 and 16 (the crossover that
               ``decode_kernel`` follows, ROADMAP B17), the chunked and the
               mma kernel in alternating turns at qwen3's G = 2 and
               stablelm's G = 1, the split kernel at recurrentgemma's
               shape with 10 and with 2 query heads (the cost of its
               blocks reading the same keys again), and at llama's
               G = 4; flash, non-causal, at llama's cross-attention and
               whisper's encoder and cross-attention at the served wave;
               the two candidates for a cross-attention at a decode step
               (the decode op and flash on one query, the JAX model's
               form; ``attend_all_keys`` picks), each of these held to its plain version on the
               tensors timed; the fp16 GEMM mode
               beside torch.matmul in fp16; for bf16 the
               port's mapper's predicted latency on its H100 preset and the
               wgmma kernel's time at the tile ``mapper_blocks`` picks;
  7. analytic - the port's copy of the analytical model
               (``repro_torch.core``) on ``nvidia_h100()`` as it stands,
               beside the card: each timed shape with a counterpart in
               ``core/operators.py`` (matmul at gpt3's eight GEMMs in bf16,
               rmsnorm, layernorm, gelu, silu_mul, and recurrent_scan at
               the wkv and RG-LRU shapes with the arguments the graph
               builders pass), its prediction against the kernel's and the
               library call's times of phase 6, each error signed, and
               their mean |error| (the paper's statistic); then each served
               model's predicted decode step (8 slots, cache 513) against
               its profiled device and wall ms, and its predicted prefill
               at the served wave's padded length against that wave's
               timed prefill, each also under the model's fused + flash
               execution; a failure of the model fails the run;
  8. bwd     - the backward kernels of a train step (``BACKWARD``: flash
               attention on CUDA, the TMA + wgmma kernel given the forward's
               log-sum-exp and the mma.sync one; RMSNorm, LayerNorm and the
               SwiGLU gate on Triton; GELU and the gated GELU on CUDA, the
               backward modes of gelu.cu; the RG-LRU scan's, rglru_bwd.cu;
               the wkv recurrence's, wkv_bwd.cu; no TPU counterpart, JAX
               differentiates in XLA),
               each against its plain version on the card: flash at
               qwen3-1.7b's (8, 16, 512, 128) / (8, 8, 512, 128) causal and
               qwen2-0.5b's 14:2 heads at D = 64, lengths that cut a 64- and
               a 128-row tile and non-causal, on the model's transposed views
               (relative error below 2e-2, the same bits in a second run),
               the forward's log-sum-exp to fp32 2e-5 and the served forward
               (no log-sum-exp) bit for bit the same; the wgmma backward
               under a window, a softcap and at D = 256
               (``FLASH_BWD_MODES``: recurrentgemma-2b's (8, 10, 512, 256) on
               1 kv-head under its window of 2048 and (1, 10, 4096, 256),
               which the window cuts, windows of 32 and 48 at D 64 and 128 on
               odd lengths, grok-1-314b's (8, 48, 512, 128) on 8 under its
               softcap of 30, window and softcap together, also at D = 256,
               and D = 256 at lengths off the 64-row tile under a softcap
               alone and under a window alone),
               each with the forward's log-sum-exp to fp32 2e-5, per element
               (``attention_excess`` at most 1) and bit-equal in a second
               run, and the mma.sync backward under them at a sequence
               stride of D + 4; the RG-LRU backward at (8, 512, 2560) and a
               (2, 333, 2560) with h0 and the final state's gradient, ga at
               -40 on a quarter of the channels (fp32 gradients to 1e-4, the
               bf16 du and dgate within one rounding, bit-equal in a second
               run); the wkv backward at rwkv6-7b's (8, 512, 64, 64), a
               (1, 333, 64, 64) with state0 (64 blocks: fewer than the SMs)
               and a (2, 90, 64, 64) with state0 (T off the chunk and the
               segment), each with the final state's
               gradient, decays across (0.05, 0.999), from the segments'
               states the chunked forward wrote (``s_seg``, first held to
               the plain states at the segments' starts and its output to
               the served call's bits): every gradient to 1e-4 and
               bit-equal in a second run; RMSNorm at (4096,
               2048), the q- and k-norm's (65536, 128) and (32768, 128), an
               odd shape and fp32 (dx within one bf16 rounding per element,
               dg to 2e-5 and the same in a second run); LayerNorm the same
               way (dx, and dg and db each to 2e-5 and bit-equal in a second
               run), through ``layernorm_bwd``, which routes each shape, and
               its launch count named: the ring kernel
               (``csrc/layernorm_bwd.cu``) at stablelm's (4096, 2048), gpt3's
               (4096, 12288), whisper's decoder (4096, 384) and encoder
               (12000, 384) rows, an odd shape and fp32, the Triton kernel
               at rwkv6's (4096, 4096) (the ring kernel held there too), a
               ragged (33, 2100) and pitches of 2050 and 386 elements;
               SwiGLU at (4096, 6144), an odd shape and fp32; GELU at gpt3's
               (4096, 49152) and the gated GELU at recurrentgemma's (4096,
               7680) and grok's expert buffer (8720, 32768), each also at an
               odd shape and in fp32, with elements where gelu' saturates and
               where x^3 overflows fp32 (outputs finite, within one bf16
               rounding); then each timed at the training shapes beside its
               plain version, its bound and the backward half of one PyTorch
               call through torch.autograd.grad (SDPA, F.rms_norm,
               F.layer_norm, F.silu(g) * u, F.gelu, F.gelu(g) * u): both
               flash kernels, and the forward with and without the
               log-sum-exp, each launch of the wgmma backward and SDPA's
               backward in two turns at qwen3's and qwen2's shapes; the
               RMSNorm backward beside the design it replaced, each design's
               row pass and column sum apart, at the three norm shapes; the
               LayerNorm backward at its five rows beside its row pass alone,
               the Triton design it replaced, F.layer_norm's backward and
               torch.add of x and dy (the same bytes), in two turns; the
               wgmma backward's modes at recurrentgemma's two
               shapes and grok's, each launch apart, beside the plain version
               and SDPA's backward (the window as a band mask, no softcap),
               and at D = 256 the dk/dv launch's blocks (``bwd_dkdv_plan``)
               and the query tiles of its longest;
               the RG-LRU backward at (8, 512, 2560) beside its plain
               version (no PyTorch call scans); the chunked wkv forward at
               (8, 512, 64, 64) with and without ``s_seg`` in two turns
               (serving writes none), and the wkv backward there beside its
               plain version (no PyTorch call scans), its two launches apart
               (torch.profiler);
  9. train   - gradient checks (``TRAIN_CHECKS``): each trained config at
               full width cut to a few layers (qwen3-1.7b, stablelm-1.6b and
               granite-moe-3b-a800m to 2, gpt3-175b to 1, whisper-tiny whole,
               llama-3.2-vision-11b to its 5-layer unit, recurrentgemma-2b
               to its 3-layer unit at 1 x 2304 tokens, past its window, its
               RG-LRU decays unhidden, grok-1-314b to 1 layer with 4 of its
               8 experts, rwkv6-7b to 2 layers at 1 x 256 tokens, its wkv
               decays (w0 across [-6.9, 1.1]) and bonus unhidden): the loss
               and every
               parameter's gradient of one step on the card against the CPU
               plain path in bf16 and an fp32 CPU run, each leaf no further
               from fp32 than 1.5 times the bf16 CPU path (a key bias, whose
               gradient is 0 in exact arithmetic, below 0.1 of its query
               bias's), the loss within 2e-2; cross-attending models with a
               seeded stub frontend and their cross branch unhidden, granite
               and grok with the bf16 CPU run's routing replayed; then the
               train runs
               (``TRAIN_RUNS``), each at full width, 8 steps of AdamW on one
               repeated batch of 8 x 512 tokens from TokenPipeline (a seeded
               stub frontend for whisper and llama): qwen3-1.7b,
               stablelm-1.6b and granite-moe-3b-a800m whole, gpt3-175b at 1
               of 96 layers, whisper-tiny whole, llama-3.2-vision-11b at
               10 of 40 layers, recurrentgemma-2b whole, grok-1-314b at 1
               of 64 layers with 4 of its 8 experts and rwkv6-7b at 15 of 32
               layers (depths reckoned beside ``TRAIN_RUNS``): the
               loss falls at every step and by 0.5 in all; per step wall ms,
               tokens/s and model-FLOPs share (6 x active parameters x
               tokens, ``model_flops``), the peak memory, and exactly the
               launches ``train_launches`` gives at every step (qwen3: 28
               flash backward on the wgmma kernel, 113 RMSNorm backward, 28
               SwiGLU backward and 28, 113, 28 of their forwards;
               recurrentgemma: 8 flash, 18 rglru_chunked, 18 gelu, 26
               gelu_mul and 53 rmsnorm and as many of their backward, the
               scan's on rglru_bwd; rwkv6: 15 wkv_chunked and 31 layernorm,
               the scan's backward on wkv_bwd); qwen3's, gpt3's,
               recurrentgemma's and rwkv6's runs again from the same seed
               with their last 2
               steps under torch.profiler (device ms a step, the largest
               device events), granite's run again plainly: whether each
               second run's losses equal the first's bit for bit;
The last lines are the ``{"kernels": [...]}`` summary (the backward
kernels' launches are the sum of the full-size train runs', each run's
apart in ``launches_by_train_run``), the card's name and
power limit from nvidia-smi, and ``{"ok": true, "device": {...}}``.
Imports nothing of JAX or of the JAX package.
"""
import contextlib
import dataclasses
import json
import math
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
# (arch, layers served or None for all): the port's served paths
SERVED = (("qwen3-1.7b", None), ("stablelm-1.6b", None), ("gpt3-175b", 8),
          ("rwkv6-7b", None), ("recurrentgemma-2b", None), ("granite-moe-3b-a800m", None),
          ("grok-1-314b", 4), ("llama-3.2-vision-11b", None), ("whisper-tiny", None))
# (arch, layers or None for all, prompt tokens, decode steps) of the
# card-vs-CPU check; gpt3's CPU side runs 2.4 G parameters in bf16 and
# grok's 6.5 G, hence the short prompts. llama-3.2-vision runs its whole
# unit of 5 layers (attn, attn, attn, xattn, attn), where two bf16 paths
# part by about the tolerance: card and CPU differ by 1.70e-2 to 2.27e-2 of
# the largest logit over 8 prompt draws (qwen3 at 5 layers by 1.69e-2 to
# 1.80e-2), each of them 2.04e-2 to 2.26e-2 from an fp32 run of the same
# weights. So the models of FP32_ANCHORED hold the card to an fp32 CPU run
# instead, in the prefill and every decode step: the card no further from
# it than FP32_FACTOR times the bf16 CPU path is (measured 0.90 to 1.07
# times; the cross branch moves llama's logits by 0.25, 11 times that
# distance, so a wrong cross-attention cannot pass)
MODEL_CHECKS = (("qwen3-1.7b", 2, 64, 8), ("stablelm-1.6b", 2, 64, 8),
                ("gpt3-175b", 1, 16, 4), ("rwkv6-7b", 2, 64, 8),
                ("recurrentgemma-2b", 3, 64, 8), ("granite-moe-3b-a800m", 2, 64, 8),
                ("grok-1-314b", 1, 16, 4), ("llama-3.2-vision-11b", 5, 64, 8),
                ("whisper-tiny", None, 64, 8))
FP32_ANCHORED, FP32_FACTOR = ("llama-3.2-vision-11b",), 1.5
# the cross-attending models' weights in the card-vs-CPU check: the init
# sets xgate to 0 (tanh(0) = 0 wipes the vision layers' cross-attention)
# and whisper's qkv biases to 0, which would hide a wrong cross-attention
# (``unhide_cross_attention``)
XGATE, BIAS_SCALE = 0.5, 0.2
# the decode kernels at G query heads a kv-head, the crossover sweep
# (8 kv-heads of 128, the served decode lengths)
G_SWEEP = (1, 2, 3, 4, 6, 10, 16)
# the decode kernels, by the order the summary lists them in
DECODE_KERNELS = ("decode_attention_chunked", "decode_attention_mma", "decode_attention")
# the ring phase: recurrentgemma-2b past its 2048-token window, a prompt of
# RING_PROMPT tokens on a RING_MAX_LEN budget, RING_STEPS decode steps past
# the wrap; held against the CPU path at RING_LAYERS layers (one unit)
RING_PROMPT, RING_MAX_LEN, RING_STEPS, RING_LAYERS = 2304, 2560, 40, 3
SLOTS, MAX_LEN, N_REQUESTS = 8, 1024, 16
# new tokens per request: staggered, so that slots free in different rounds
# and the 8 requests past the first wave go through the per-slot refill
NEW_TOKENS = [16 + (7 * i) % 33 for i in range(N_REQUESTS)]

REPLACES = {
    "rmsnorm": "src/repro/kernels/rmsnorm/kernel.py:32",
    "layernorm": "src/repro/kernels/rmsnorm/kernel.py:48",
    "gelu": "src/repro/kernels/gelu/kernel.py:29",
    "gelu_mul": "src/repro/models/layers.py:341",
    "silu_mul": "src/repro/kernels/gelu/kernel.py:43",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:71",
    "flash_attention_wgmma": "src/repro/kernels/flash_attention/kernel.py:71",
    "decode_attention": "src/repro/kernels/decode_attention/kernel.py:61",
    "decode_attention_chunked": "src/repro/kernels/decode_attention/kernel.py:61",
    "decode_attention_mma": "src/repro/kernels/decode_attention/kernel.py:61",
    "wkv": "src/repro/kernels/wkv/kernel.py:51",
    "wkv_chunked": "src/repro/kernels/wkv/kernel.py:51",
    "rglru": "src/repro/models/recurrent.py:206",
    "rglru_chunked": "src/repro/models/recurrent.py:206",
    "matmul": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_wgmma": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_f32_tma": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_reduce": "src/repro/kernels/matmul/kernel.py:37",
    "matmul_int8": "src/repro/kernels/matmul/kernel.py:86",
    "matmul_int8_wgmma": "src/repro/kernels/matmul/kernel.py:86",
}
SOURCES = {
    "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py"),
    "layernorm": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py"),
    "gelu": ("cuda", "src/repro_torch/kernels/csrc/gelu.cu"),
    "gelu_mul": ("cuda", "src/repro_torch/kernels/csrc/gelu.cu"),
    "silu_mul": ("triton", "src/repro_torch/kernels/gelu/kernel.py"),
    "flash_attention": ("cuda", "src/repro_torch/kernels/csrc/flash_attention.cu"),
    "flash_attention_wgmma": ("cuda", "src/repro_torch/kernels/csrc/flash_attention_sm90.cu"),
    "decode_attention": ("cuda", "src/repro_torch/kernels/csrc/decode_attention.cu"),
    "decode_attention_chunked": ("cuda",
                                 "src/repro_torch/kernels/csrc/decode_attention_chunked.cu"),
    "decode_attention_mma": ("cuda", "src/repro_torch/kernels/csrc/decode_attention_mma.cu"),
    "wkv": ("cuda", "src/repro_torch/kernels/csrc/wkv.cu"),
    "wkv_chunked": ("cuda", "src/repro_torch/kernels/csrc/wkv_chunked.cu"),
    "rglru": ("cuda", "src/repro_torch/kernels/csrc/rglru.cu"),
    "rglru_chunked": ("cuda", "src/repro_torch/kernels/csrc/rglru_chunked.cu"),
    "matmul": ("cuda", "src/repro_torch/kernels/csrc/matmul.cu"),
    "matmul_wgmma": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
    "matmul_f32_tma": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
    "matmul_reduce": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
    "matmul_int8": ("cuda", "src/repro_torch/kernels/csrc/matmul_int8.cu"),
    "matmul_int8_wgmma": ("cuda", "src/repro_torch/kernels/csrc/matmul_sm90.cu"),
}
# the GEMM path: gpt3-175b's layer GEMMs at full width (name, K, N), at the
# decode batch of 8 slots and a prefill wave of 8 x 512 rows
GPT3_GEMMS = (("qkv", 12288, 36864), ("out", 12288, 12288), ("ffn_up", 12288, 49152),
              ("ffn_down", 49152, 12288))
GEMM_ROWS = (SLOTS, 8 * 512)
GEMM_EDGES = ((128, 128, 128), (256, 512, 128), (100, 200, 50), (1, 300, 77), (513, 129, 257))
GEMM_MODES = ("bf16", "fp32", "fp8", "int8")
# fp16 (operands, and matmul_fp8's output) at 1e-3, tighter than bf16's 2e-2:
# fp16 keeps 11 bits, and kernel and plain version round the same fp32 sum
GEMM_TOL = {"bf16": 2e-2, "fp32": 2e-5, "fp8": 2e-5, "int8": 1e-4, "fp16": 1e-3,
            "fp8-fp16out": 1e-3}
GELU_PAIRS = 6   # gelu and F.gelu timed in alternating pairs
ELEMENTWISE = ("rmsnorm", "layernorm", "gelu", "gelu_mul", "silu_mul")  # one bf16 rounding apart
RGLRU_TOL = 1e-4   # fp32, the gates' exponentials in another order


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


def grad_excess(a, b):
    """``attention_excess`` for attention's gradients dq, dk, dv: the same
    per-element bound plus 2^-7 of b's rms over the whole tensor. A
    gradient row can be a cancellation whose exact value is 0 (dq of a
    query that sees one key: dP = delta there), so its own rms bounds
    nothing: the kernel's and the plain version's sums in another order
    leave noise of the size of the terms cancelled, which the tensor's rms
    measures. A dropped or doubled tile moves a row by a share of its rms,
    of the tensor's size, and still fails."""
    a, b = a.float(), b.float()
    rms = b.pow(2).mean(-1, keepdim=True).sqrt()
    floor = 2.0 ** -7 * b.pow(2).mean().sqrt()
    return ((a - b).abs() / (2.0 ** -6 * b.abs() + 2.0 ** -5 * rms + floor)).max().item()


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
    seconds = _build.build(["flash_attention", "flash_attention_sm90", "decode_attention",
                            "decode_attention_chunked", "decode_attention_mma", "wkv",
                            "wkv_chunked", "gelu", "rglru",
                            "rglru_chunked", "matmul", "matmul_sm90", "matmul_int8",
                            "flash_attention_bwd", "flash_attention_bwd_sm90", "rglru_bwd",
                            "wkv_bwd", "layernorm_bwd"])
    for name, s in seconds.items():
        print(f"[build] {name}.cu: nvcc {s:.2f} s")
    print(f"[build] nvcc, all sources in parallel: {time.perf_counter() - t0:.2f} s")
    for name, log in _build.LOGS.items():
        for line in resource_usage(log):
            print(f"[build] {name}.cu {line}")
    # the wgmma kernels' shared memory is dynamic: ptxas does not see it
    import ctypes
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS
    from repro_torch.kernels.matmul.kernel import E4M3_FORMS, TILES
    smem = _build.load("matmul_sm90").matmul_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 5, ctypes.c_int
    for mode, dtype, forms in ((0, torch.bfloat16, {"": 0}),
                               (1, torch.float8_e4m3fn, E4M3_FORMS), (2, torch.int8, {"": 0}),
                               (3, torch.float16, {"": 0}), (4, torch.float32, {"": 0})):
        for tile in TILES[dtype]:
            for form, f in forms.items():
                print(f"[build] matmul_sm90.cu {dtype} {form} tile {tile}: "
                      f"{smem(mode, f, *tile)} bytes of dynamic shared memory")
    smem = _build.load("flash_attention_sm90").flash_attention_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for d in WGMMA_HEAD_DIMS:
        print(f"[build] flash_attention_sm90.cu D={d}: {smem(d)} bytes of dynamic shared memory")
    from repro_torch.kernels.flash_attention.kernel import BWD_HEAD_DIMS
    smem = _build.load("flash_attention_bwd_sm90").flash_attention_bwd_sm90_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    for d in BWD_HEAD_DIMS:
        print(f"[build] flash_attention_bwd_sm90.cu D={d}: dq {smem(d, 0)}, dk/dv {smem(d, 1)} "
              "bytes of dynamic shared memory")
    from repro_torch.kernels.wkv.kernel import COLUMN_SPLITS
    smem = _build.load("wkv_chunked").wkv_chunked_smem
    smem.argtypes, smem.restype = [ctypes.c_int] * 2, ctypes.c_int
    for n, splits in COLUMN_SPLITS.items():
        for nc in splits:
            print(f"[build] wkv_chunked.cu N={n} columns={nc}: {smem(n, nc)} bytes of dynamic "
                  "shared memory")
    from repro_torch.kernels.rglru.kernel import SEGMENT_STEPS
    smem = _build.load("rglru_chunked").rglru_chunked_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for steps in SEGMENT_STEPS:
        print(f"[build] rglru_chunked.cu {steps} steps a segment: {smem(steps)} bytes of "
              "dynamic shared memory")
    smem = _build.load("rglru_bwd").rglru_bwd_smem
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    for steps in SEGMENT_STEPS:
        print(f"[build] rglru_bwd.cu {steps} steps a segment: {smem(steps)} bytes of "
              "dynamic shared memory")
    smem = _build.load("wkv_bwd").wkv_bwd_smem
    smem.restype = ctypes.c_int
    print(f"[build] wkv_bwd.cu: {smem()} bytes of dynamic shared memory")
    lib = _build.load("decode_attention_mma")
    lib.decode_attention_mma_smem.argtypes = [ctypes.c_int] * 2
    lib.decode_attention_mma_blocks_per_sm.argtypes = [ctypes.c_int]
    for d in (32, 64, 128, 256):
        print(f"[build] decode_attention_mma.cu D={d}: {lib.decode_attention_mma_smem(d, SLOTS)} "
              f"bytes of dynamic shared memory at {SLOTS} slots, "
              f"{lib.decode_attention_mma_blocks_per_sm(d)} blocks an SM")
    from repro_torch.kernels.gelu.kernel import (gelu_triton, silu_mul_bwd_triton,
                                                 silu_mul_triton)
    from repro_torch.kernels.rmsnorm.kernel import (layernorm_bwd_triton, layernorm_triton,
                                                    rmsnorm_bwd_triton, rmsnorm_triton)
    x = torch.ones((4, 12288), device="cuda", dtype=torch.bfloat16)
    w = x[0].float()
    for label, fn, args in (
            ("rmsnorm C=2048", rmsnorm_triton, (x[:, :2048], w[:2048])),
            ("rmsnorm C=128", rmsnorm_triton, (x[:, :128], w[:128])),
            ("layernorm C=2048", layernorm_triton, (x[:, :2048], w[:2048], w[:2048])),
            ("layernorm C=12288", layernorm_triton, (x, w, w)),
            ("gelu (the Triton kernel gelu.cu replaced, timed beside it)", gelu_triton, (x,)),
            ("silu_mul", silu_mul_triton, (x, x)),
            ("rmsnorm_bwd C=2048", rmsnorm_bwd_triton, (x[:, :2048], w[:2048], x[:, :2048])),
            ("silu_mul_bwd", silu_mul_bwd_triton, (x, x, x)),
            ("layernorm_bwd_triton C=2048 (whole rows; the route of the rows the ring "
             "kernel does not take, and timed beside it)", layernorm_bwd_triton,
             (x[:, :2048], w[:2048], x[:, :2048])),
            ("layernorm_bwd_triton C=12288 (in chunks)", layernorm_bwd_triton, (x, w, x))):
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
    from repro_torch.kernels.decode_attention.kernel import (HEAD_DIMS, chunked_eligible,
                                                             decode_kernel)
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.kernel import wgmma_eligible
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gelu.ref import gelu_mul_ref, gelu_ref, silu_mul_ref
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
                               ("(3,1001) ragged", rnd((3, 1001), dt), False),
                               ("(8,49152)", rnd((8, 49152), dt), True),
                               ("(4096,49152)", rnd((4096, 49152), dt), True),
                               ("(256,1024) |x|<=20", torch.linspace(
                                   -20, 20, 256 * 1024, device="cuda").reshape(
                                   256, 1024).to(dt), False)):
            cases.append(("gelu", label, KERNELS["gelu"], gelu_ref, (x,), main))
        for r, c, main in ((100, 256, False), (4096, 6144, True)):
            cases.append(("silu_mul", f"({r},{c})", KERNELS["silu_mul"], silu_mul_ref,
                          (rnd((r, c), dt), rnd((r, c), dt)), main))
        # recurrentgemma's gated-GELU MLP: the decode step and the prefill wave
        for r, c, main in ((100, 256, False), (3, 1001, False), (SLOTS, 7680, True),
                           (4096, 7680, True)):
            cases.append(("gelu_mul", f"({r},{c})", KERNELS["gelu_mul"], gelu_mul_ref,
                          (rnd((r, c), dt) * 3, rnd((r, c), dt)), main))
        # (B, H, S, D) tensors, or (B, S, H, D) ones passed as the model
        # passes them (transposed views), or with a sequence stride of D + 4
        # elements; each case on the kernel wgmma_eligible picks
        for b, hq, hkv, sq, sk, causal, window, cap, d, layout, main in (
                (2, 4, 4, 128, 128, True, 0, 0.0, 64, "bhsd", False),
                (2, 8, 2, 130, 130, True, 0, 0.0, 64, "bhsd", False),
                (2, 4, 1, 64, 200, False, 0, 0.0, 64, "bhsd", False),
                (2, 4, 2, 128, 128, True, 32, 0.0, 64, "bhsd", False),
                (2, 4, 2, 96, 96, True, 0, 30.0, 64, "bhsd", False),
                (2, 4, 2, 70, 70, True, 0, 0.0, 32, "bhsd", False),
                (2, 4, 2, 300, 300, True, 48, 30.0, 128, "view", False),
                (2, 16, 8, 384, 384, True, 0, 0.0, 128, "view", False),
                (2, 32, 32, 384, 384, True, 0, 0.0, 64, "view", False),
                (2, 96, 96, 384, 384, True, 0, 0.0, 128, "view", False),
                (2, 4, 2, 130, 130, True, 0, 0.0, 64, "seq stride D+4", False),
                (8, 16, 8, 512, 512, True, 0, 0.0, 128, "bhsd", True),
                (8, 32, 32, 512, 512, True, 0, 0.0, 64, "bhsd", True),
                (8, 96, 96, 512, 512, True, 0, 0.0, 128, "bhsd", True),
                # D = 256, recurrentgemma's 10 query heads on one kv-head:
                # windows that cut key tiles (and skip those left of them),
                # a softcap, a ragged length, the served wave (its window of
                # 2048 past every key) and the ring phase's prefill
                (2, 10, 1, 300, 300, True, 100, 0.0, 256, "view", False),
                (2, 10, 1, 333, 333, True, 64, 30.0, 256, "bhsd", False),
                (1, 4, 2, 700, 700, False, 130, 0.0, 256, "bhsd", False),
                (2, 4, 1, 150, 150, True, 70, 0.0, 256, "seq stride D+4", False),
                (8, 10, 1, 512, 512, True, 2048, 0.0, 256, "view", True),
                (1, 10, 1, RING_PROMPT, RING_PROMPT, True, 2048, 0.0, 256, "view", True),
                # non-causal, Sq != Sk, Sk no multiple of a key tile (64
                # or 128): llama-3.2-vision's cross-attention at the
                # served wave (436 queries, 32 heads on 8, over 1601
                # frontend keys), whisper's encoder (1500 x 1500, 6
                # heads of 64) and its cross-attention (over 1500); one
                # query over all keys, the flash candidate of the
                # cross-attention at a decode step
                (SLOTS, 32, 8, 436, 1601, False, 0, 0.0, 128, "view", True),
                (SLOTS, 6, 6, 1500, 1500, False, 0, 0.0, 64, "view", True),
                (SLOTS, 6, 6, 436, 1500, False, 0, 0.0, 64, "view", True),
                (SLOTS, 32, 8, 1, 1601, False, 0, 0.0, 128, "view", False),
                (SLOTS, 6, 6, 1, 1500, False, 0, 0.0, 64, "view", False)):
            kw = dict(causal=causal, window=window, softcap=cap)
            q, k, v = (attention_input(rnd, shape, dt, layout) for shape in
                       ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d)))
            name = "flash_attention_wgmma" if wgmma_eligible(q, k, v) else "flash_attention"
            cases.append((name, f"q({b},{hq},{sq},{d}) kv({b},{hkv},{sk},{d}) {layout} {kw}",
                          lambda *a, kw=kw, name=name: KERNELS[name](*a, **kw),
                          lambda *a, kw=kw: attention_ref(*a, **kw), (q, k, v), main))
        # (B, Hkv, G, T, D, lengths, is_main_path): the JAX kernel tests'
        # rows, lengths at the chunked kernel's unit edges (1, UK - 1, UK,
        # UK + 1, T) at D = 128 and 256 (fp32 on the split kernel's D = 256
        # mode) and at the mma kernel's (1, 15, 16, 17, T) at G = 3, 6 and
        # 16, and the served shapes (recurrentgemma's: 10 query heads on one
        # kv-head, D = 256, and the ring phase's full window; granite's G =
        # 3 at D = 64; llama's self-attention, G = 4; the cross-attention
        # at a decode step, every length the frontend's: llama's 1601 keys,
        # whisper's 1500); each case on the kernel decode_kernel picks for
        # it, each served shape on the other kernels that take it too
        for b, hkv, g, t, d, lens, main in (
                (3, 2, 4, 128, 64, [128, 64, 42], False),
                (3, 1, 8, 200, 64, [200, 100, 66], False),
                (3, 4, 1, 64, 64, [64, 32, 21], False),
                (5, 2, 2, 197, 128, edge_lengths(128, 197), False),
                (5, 1, 10, 101, 256, edge_lengths(256, 101), False),
                (5, 2, 1, 101, 256, edge_lengths(256, 101), False),
                (5, 2, 3, 53, 64, [1, 15, 16, 17, 53], False),
                (5, 2, 6, 53, 128, [1, 15, 16, 17, 53], False),
                (5, 1, 16, 53, 256, [1, 15, 16, 17, 53], False),
                (SLOTS, 8, 3, MAX_LEN, 64, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 8, 2, MAX_LEN, 128, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 32, 1, MAX_LEN, 64, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 96, 1, MAX_LEN, 128, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 1, 10, MAX_LEN, 256, decode_lengths(SLOTS, MAX_LEN), True),
                (1, 1, 10, 2048, 256, [2048], True),
                (SLOTS, 8, 4, MAX_LEN, 128, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 6, 1, MAX_LEN, 64, decode_lengths(SLOTS, MAX_LEN), True),
                (SLOTS, 8, 4, 1601, 128, [1601] * SLOTS, True),
                (SLOTS, 6, 1, 1500, 64, [1500] * SLOTS, True)):
            if d not in HEAD_DIMS and dt != torch.bfloat16:
                continue
            q, k, v = (rnd((b, hkv, g, d), dt), rnd((b, t, hkv, d), dt),
                       rnd((b, t, hkv, d), dt))
            picked = decode_kernel(q, k, v)
            args = (q, k, v, torch.tensor(lens, dtype=torch.int32, device="cuda"))
            label = f"q({b},{hkv},{g},{d}) T={t} lengths={lens}"
            for name in DECODE_KERNELS:
                if name == picked or (main and chunked_eligible(q, k, v)):
                    cases.append((name, label, KERNELS[name], decode_attention_ref, args,
                                  main and name == picked))
    return cases


def attention_input(rnd, shape, dt, layout):
    """A (B, H, S, D) attention input: contiguous ("bhsd"), a transposed view
    of a (B, S, H, D) tensor ("view", the model's layout), or a view of a
    (B, H, S, D + 4) tensor (a sequence stride no TMA descriptor takes)."""
    b, h, s, d = shape
    if layout == "view":
        return rnd((b, s, h, d), dt).transpose(1, 2)
    if layout == "bhsd":
        return rnd(shape, dt)
    return rnd((b, h, s, d + 4), dt)[..., :d]


def edge_lengths(d, t):
    """Cache lengths at the unit edges of the chunked decode kernel at head
    dim d (1, UK - 1, UK, UK + 1 keys) and the full cache t."""
    from repro_torch.kernels.decode_attention.kernel import chunk_keys
    c = chunk_keys(d)
    return [1, c - 1, c, c + 1, t]


def decode_lengths(b, t):
    """Mixed cache lengths of the main path: prompts of 128-512 tokens plus
    up to 48 generated, one slot at the full cache."""
    return [t] + [128 + (97 * i) % 417 for i in range(1, b)]


def prompt_lengths(b, t):
    """Prompt lengths of a served wave: 128-512 tokens, the longest t."""
    return [t] + [128 + (97 * i) % 385 for i in range(1, b)]


def wkv_inputs(torch, rnd, B, T, H, N, with_state, decays="uniform", odd=False):
    """r, k, v normal, w in (0.45, 0.95) as the JAX wkv tests draw them
    (decays "edge": a fifth each of exact 0, 1e-30 and exact 1 among them),
    a per-head u and, with_state, a nonzero initial state; all fp32. odd:
    r, k, v, w as views with a head stride of N + 1, which only the
    step-by-step kernel takes."""
    f32 = torch.float32
    shape = (B, T, H, N + 1) if odd else (B, T, H, N)
    r, k, v = rnd(shape, f32), rnd(shape, f32), rnd(shape, f32)
    w = torch.sigmoid(rnd(shape, f32)) * 0.5 + 0.45
    if decays == "edge":
        pick = torch.randint(0, 5, shape, generator=rnd.gen, device="cuda")
        w = torch.where(pick == 0, 0.0, torch.where(pick == 1, 1e-30, torch.where(
            pick == 2, 1.0, w)))
    if odd:
        r, k, v, w = (a[..., :N] for a in (r, k, v, w))
    return r, k, v, w, rnd((H, N), f32), rnd((B, H, N, N), f32) if with_state else None


def wkv_cases():
    """(B, T, H, N, lengths or None, nonzero state0, decays, odd strides,
    is_main_path): the JAX kernel tests' rows (u tiled over two heads) and
    their model-scan shape, T off a multiple of either kernel's chunk (16
    and 32 steps), T below 16, decays with exact 0, 1e-30 and 1 (ragged, a
    length of 0), strides only the step-by-step kernel takes, the served
    prefill (8 slots, 64 heads of 64, prompt lengths), a batch-1 refill of
    452 tokens (the longest of the served rwkv6 run's refills) and the
    decode step."""
    return [(2, 96, 2, 32, None, False, "uniform", False, False),
            (2, 64, 2, 32, None, False, "uniform", False, False),
            (2, 100, 2, 32, None, False, "uniform", False, False),
            (2, 64, 2, 32, None, True, "uniform", False, False),
            (3, 77, 4, 64, [77, 40, 1], True, "uniform", False, False),
            (2, 7, 4, 64, [7, 5], True, "uniform", False, False),
            (3, 90, 4, 64, [90, 41, 0], True, "edge", False, False),
            (2, 37, 2, 32, None, True, "edge", False, False),
            (2, 50, 4, 64, [50, 19], True, "uniform", True, False),
            (SLOTS, 512, 64, 64, prompt_lengths(SLOTS, 512), False, "uniform", False, True),
            (1, 452, 64, 64, [452], False, "uniform", False, True),
            (SLOTS, 1, 64, 64, None, True, "uniform", False, True)]


def phase_wkv(torch, errs):
    """The wkv op against its plain version on the card, fp32, each case on
    the kernel the op picks (``chunked_eligible``: T > 1 and 16-byte copies
    on wkv_chunked, else wkv): output and final state within 1e-4 of the
    plain version's largest, pads' outputs zero, one launch of that kernel;
    with a nonzero state it updates that state in place, as the decode step
    does."""
    from repro_torch import kernels as K
    from repro_torch.kernels.wkv.kernel import chunked_eligible
    from repro_torch.kernels.wkv.ops import wkv
    from repro_torch.kernels.wkv.ref import wkv_ref
    rnd = Inputs(torch, 4)
    for B, T, H, N, lens, with_state, decays, odd, main in wkv_cases():
        r, k, v, w, u, s0 = wkv_inputs(torch, rnd, B, T, H, N, with_state, decays, odd)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                         device="cuda")
        want_out, want_state = wkv_ref(r, k, v, w, u, s0, lengths)
        name = "wkv_chunked" if chunked_eligible(r, k, v, w) else "wkv"
        state_in = None if s0 is None else s0.clone()
        before = K.launches()
        out, state = wkv(r, k, v, w, u, state_in, lengths, state_out=state_in)
        torch.cuda.synchronize()
        label = (f"({B},{T},{H},{N}) lengths={lens} state0={'nonzero' if with_state else 'zero'}"
                 f" decays={decays}" + (" head stride N+1" if odd else ""))
        require(K.launches() == {**before, name: before[name] + 1},
                f"{name} {label}: not one launch of {name} alone")
        require(state_in is None or state is state_in, f"{name} {label}: state not in place")
        e_out, e_state = rel_err(out, want_out), rel_err(state, want_state)
        require(e_out < WKV_TOL and e_state < WKV_TOL, f"{name} {label}: rel_err out "
                f"{e_out:.3e}, state {e_state:.3e} (tol {WKV_TOL:g})")
        require(all(not out[b, n:].any() for b, n in enumerate(lens or [])),
                f"{name} {label}: a pad step has a nonzero output")
        print(f"[kernels] {name:16s} float32  {label}: rel_err out {e_out:.3e}, "
              f"state {e_state:.3e} (tol {WKV_TOL:g}) ok")
        if main:
            errs[name] = max(errs.get(name, 0.0), max_abs(out, want_out),
                             max_abs(state, want_state))


def rglru_inputs(torch, rnd, B, T, d, with_h0):
    """u and the gate bf16, the gate pre-activations fp32 (3 sigma, so that
    sigmoid reaches near 0 and 1), lam over [-6, 12] (softplus(lam) from
    0.0025 to 12: decays a from near 1 to near 0), h0 nonzero if asked."""
    f32 = torch.float32
    return (rnd((B, T, d), torch.bfloat16), rnd((B, T, d), f32) * 3, rnd((B, T, d), f32) * 3,
            torch.linspace(-6.0, 12.0, d, device="cuda"), rnd((B, T, d), torch.bfloat16),
            rnd((B, d), f32) if with_h0 else None)


def rglru_cases():
    """(B, T, lengths or None, nonzero h0, is_main_path) at recurrentgemma's
    width: unequal lengths with a 0, h0 nonzero, T = 1 in place, a T that no
    segment or tile of the chunked kernel divides, the served prefill wave
    (8 slots, prompt lengths), a batch-1 refill of 452 tokens, the ring
    phase's prefill of RING_PROMPT tokens and the decode step."""
    return [(3, 40, [40, 7, 0], True, False),
            (2, 97, None, True, False),
            (5, 1, [1, 0, 1, 1, 0], True, False),
            (2, 333, [333, 201], True, False),
            (SLOTS, 512, prompt_lengths(SLOTS, 512), False, True),
            (1, 452, [452], False, True),
            (1, RING_PROMPT, None, False, True),
            (SLOTS, 1, None, True, True)]


def phase_rglru(torch, errs):
    """The rglru op against its plain step loop on the card, at d = 2560,
    each case on the kernel ``picks_chunked`` names (rglru_chunked for
    T > 1, rglru for the decode step): output (gate * h) and final h within
    1e-4 of the plain version's largest, one launch of that kernel a call
    and of no other, h written in place where h0 is given (the decode
    step)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.rglru.kernel import picks_chunked
    from repro_torch.kernels.rglru.ops import rglru
    from repro_torch.kernels.rglru.ref import rglru_ref
    rnd = Inputs(torch, 5)
    for B, T, lens, with_h0, main in rglru_cases():
        u, ga, gx, lam, gate, h0 = rglru_inputs(torch, rnd, B, T, 2560, with_h0)
        lengths = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                         device="cuda")
        want_y, want_h = rglru_ref(u, ga, gx, lam, gate, h0, lengths)
        name = "rglru_chunked" if picks_chunked(u, ga, gx, gate) else "rglru"
        require((name == "rglru_chunked") == (T > 1), f"rglru ({B},{T}): routed to {name}")
        before = K.launches()
        y, h = rglru(u, ga, gx, lam, gate, h0, lengths, h_out=h0)
        torch.cuda.synchronize()
        label = f"({B},{T},2560) lengths={lens} h0={'nonzero' if with_h0 else 'zero'}"
        require(K.launches() == {**before, name: before[name] + 1},
                f"{name} {label}: not one launch of {name} alone")
        require(h0 is None or h is h0, f"{name} {label}: h not in place")
        e_y, e_h = rel_err(y, want_y), rel_err(h, want_h)
        require(e_y < RGLRU_TOL and e_h < RGLRU_TOL, f"{name} {label}: rel_err y {e_y:.3e}, "
                f"h {e_h:.3e} (tol {RGLRU_TOL:g})")
        print(f"[kernels] {name:16s} float32  {label}: rel_err y {e_y:.3e}, h {e_h:.3e} "
              f"(tol {RGLRU_TOL:g}) ok")
        if main:
            errs[name] = max(errs.get(name, 0.0), max_abs(y, want_y), max_abs(h, want_h))


def phase_c9(torch):
    """ROADMAP C9, resolved: every input the card once refused, through its
    op, on the kernel the op picks (its launch count shows which), against
    the plain version: fp16 GEMM operands (the wgmma kernel's fp16 mode;
    mma.sync where TMA cannot take the pitch) and matmul_fp8 writing fp16,
    held as the GEMM path holds bf16 (``check_gemm``, 1e-3); flash attention
    at D = 256 in fp32 and at D = 16, 48, 96 and 200 zero-padded to the next
    kernel dim; decode attention at 16 (padded), 200 and 256 in fp32; wkv at
    16 and 48 (padded) and 128 (the step-by-step kernel, T > 1 and the
    decode step). Then the one refusal left: D above 256 (N above 128)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.decode_attention.ops import decode_attention
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.wkv.ops import wkv
    from repro_torch.kernels.wkv.ref import wkv_ref
    rnd = Inputs(torch, 6)

    def launched(op, *args, **kw):
        before = K.launches()
        out = op(*args, **kw)
        torch.cuda.synchronize()
        return out, {k: n - before[k] for k, n in K.launches().items() if n != before[k]}

    f32 = torch.float32
    for mode, (m, k, n), want in (("fp16", (300, 512, 768), "matmul_wgmma"),
                                  ("fp16", (8, 12288, 12288), "matmul_wgmma"),
                                  ("fp16", (100, 129, 77), "matmul"),
                                  ("fp8-fp16out", (300, 512, 768), "matmul_wgmma"),
                                  ("fp8-fp16out", (100, 200, 50), "matmul")):
        a, b = rnd((m, k), f32), rnd((k, n), f32)
        (got, plain, qa, qb), launches = launched(gemm_case, torch, mode, a, b)
        label = f"({m},{k})x({k},{n}) on {want}"
        require(set(launches) - {"matmul_reduce"} == {want},
                f"C9 {mode} {label}: launches {launches}")
        require(got.dtype == torch.float16, f"C9 {mode} {label}: output {got.dtype}")
        check_gemm(torch, mode, label, got, plain, qa, qb)
    cases = [(d, dt, kern) for d, dt, kern in (
        (256, f32, "flash_attention"), (16, torch.bfloat16, "flash_attention"),
        (48, torch.bfloat16, "flash_attention_wgmma"), (96, torch.bfloat16,
                                                         "flash_attention_wgmma"),
        (200, torch.bfloat16, "flash_attention_wgmma"), (200, f32, "flash_attention"))]
    for d, dt, kern in cases:
        q, k, v = rnd((2, 4, 150, d), dt), rnd((2, 1, 150, d), dt), rnd((2, 1, 150, d), dt)
        got, launches = launched(flash_attention, q, k, v, causal=True, window=70)
        want = attention_ref(q, k, v, causal=True, window=70)
        name = str(dt).replace("torch.", "")
        err = rel_err(got, want)
        line = f"[c9] flash attention D={d} {name} on {kern}: rel_err {err:.3e}"
        require(launches == {kern: 1} and got.shape == q.shape and err < TOL[name],
                f"{line}, launches {launches}: fails")
        if dt == torch.bfloat16:
            line += f", per-element excess {attention_excess(got, want):.3f} (<= 1)"
            require(attention_excess(got, want) <= 1, f"{line}: fails")
        print(f"{line} ok")
    lens = torch.tensor([150, 33], dtype=torch.int32, device="cuda")
    # 10 query heads a kv-head: the mma kernel in bf16 (G > CHUNKED_MAX_G),
    # the split kernel in fp32
    for d, dt, kern in ((16, torch.bfloat16, "decode_attention_mma"),
                        (200, f32, "decode_attention"), (256, f32, "decode_attention")):
        q, k, v = rnd((2, 1, 10, d), dt), rnd((2, 150, 1, d), dt), rnd((2, 150, 1, d), dt)
        got, launches = launched(decode_attention, q, k, v, lens)
        want = decode_attention_ref(q, k, v, lens)
        name = str(dt).replace("torch.", "")
        err = rel_err(got, want)
        line = f"[c9] decode attention D={d} {name} on {kern}: rel_err {err:.3e}"
        require(launches == {kern: 1} and got.shape == q.shape and err < TOL[name],
                f"{line}, launches {launches}: fails")
        print(f"{line} ok")
    for N, T, kern in ((16, 33, "wkv_chunked"), (48, 33, "wkv_chunked"), (128, 33, "wkv"),
                       (128, 1, "wkv"), (48, 1, "wkv")):
        r, k, v, w, u, s0 = wkv_inputs(torch, rnd, 2, T, 2, N, True)
        want_out, want_state = wkv_ref(r, k, v, w, u, s0)
        (out, state), launches = launched(wkv, r, k, v, w, u, s0, state_out=s0)
        e_out, e_state = rel_err(out, want_out), rel_err(state, want_state)
        line = (f"[c9] wkv N={N} T={T} on {kern}: rel_err out {e_out:.3e}, state "
                f"{e_state:.3e}")
        require(launches == {kern: 1} and state is s0 and max(e_out, e_state) < WKV_TOL,
                f"{line}, launches {launches}: fails")
        print(f"{line} ok")
    x = rnd((1, 4, 40, 320), torch.bfloat16)
    for what, fn in (("flash attention D=320", lambda: flash_attention(x, x[:, :1], x[:, :1])),
                     ("wkv N=192", lambda: wkv(*(rnd((1, 4, 2, 192), f32),) * 4,
                                               rnd((2, 192), f32)))):
        try:
            fn()
        except ValueError as e:
            print(f"[c9] {what}: refused on the card, as it stays ({e})")
            continue
        raise RuntimeError(f"C9: {what} was not refused")


def phase_kernels(torch):
    """Returns {kernel: largest |kernel - plain| in bf16 at its main-path
    shapes, or at all its shapes where it has no main-path one}."""
    errs, any_errs = {}, {}
    for name, label, fn, plain, args, main in kernel_cases(torch):
        dt = str(args[0].dtype).replace("torch.", "")
        err = hold(torch, name, label, dt, fn(*args), plain(*args))
        if dt == "bfloat16":
            into = errs if main else any_errs
            into[name] = max(into.get(name, 0.0), err)
    phase_wkv(torch, errs)
    phase_rglru(torch, errs)
    phase_c9(torch)
    return {**any_errs, **errs}


def hold(torch, name, label, dt, got, want):
    """Holds a kernel's output `got` to its plain version's `want`: relative
    error below TOL[dt] and, in bf16, element by element (one rounding for
    the elementwise kernels, ``attention_excess`` for attention). Prints the
    case's line; returns the largest |got - want|."""
    torch.cuda.synchronize()
    err = rel_err(got, want)
    require(got.shape == want.shape and got.dtype == want.dtype,
            f"{name} {label}: {tuple(got.shape)} {got.dtype} vs plain "
            f"{tuple(want.shape)} {want.dtype}")
    require(err < TOL[dt], f"{name} {label} {dt}: rel_err {err:.3e} >= {TOL[dt]}")
    line = f"[kernels] {name:16s} {dt:8s} {label}: rel_err {err:.3e} (tol {TOL[dt]:g})"
    if name in ELEMENTWISE and dt == "bfloat16":
        require(within_one_rounding(got, want),
                f"{name} {label}: an element is off by more than one bf16 rounding")
    elif dt == "bfloat16":
        excess = attention_excess(got, want)
        line += f", per-element excess {excess:.3f} (<= 1)"
        require(excess <= 1, f"{line}: an element is off by more than "
                "2^-6 |b| + 2^-5 rms(row)")
    print(f"{line} ok")
    return max_abs(got, want)


def gemm_excess(torch, got, want, a, b):
    """Largest |got - want| / (r |want| + 2^-16 (|a| @ |b|)) over the
    elements of a GEMM's output; at most 1 passes. a, b are the operands'
    values (dequantized for int8, e4m3 for fp8), |a| @ |b| taken in fp32;
    r = 2^-7 for a bf16 output (the two sides' roundings leave them at most
    one bf16 ulp apart), 2^-10 for fp16 (one fp16 ulp), 0 for fp32. The fp32
    sums of kernel and plain version differ by their order, about sqrt(K)
    2^-24 of the partial sums, far below 2^-16 (|a| @ |b|). A kernel that
    drops one k-step or uses a tile of B transposed moves an element by a sum
    of ~16 products, ~4 at unit-normal operands, against 2^-16 (|a| @ |b|) =
    0.12-0.48 at K = 12288-49152 and one bf16 ulp of an output of ~100-400
    (0.5-2), so it fails where the relative error to the largest output (~4.5
    sqrt(K)) may not. NaNs count as agreeing here; their places are compared
    apart."""
    r = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(got.dtype, 0.0)
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
    if mode in ("bf16", "fp32", "fp16"):
        dt = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16}[mode]
        a, b = a.to(dt), b.to(dt)
        return ops.matmul(a, b, **kw), matmul_ref(a, b), a, b
    if mode == "fp8":
        return ops.matmul_fp8(a, b, **kw), matmul_fp8_ref(a, b), quantize_fp8(a), quantize_fp8(b)
    if mode == "fp8-fp16out":   # fp16 operands rounded to e4m3, the output fp16
        a, b = a.half(), b.half()
        return (ops.matmul_fp8(a, b, **kw), matmul_fp8_ref(a, b, out_dtype=torch.float16),
                quantize_fp8(a), quantize_fp8(b))
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
    {mode: largest |kernel - plain| at the gpt3 shapes}, {kernel: largest
    |kernel - plain| of matmul.cu and matmul_int8.cu, which the path does
    not reach, at the shapes TMA cannot take})."""
    from repro_torch import kernels as K
    from repro_torch.kernels.matmul.kernel import INT8_MAX_K, tma_eligible
    rnd = Inputs(torch, 5)
    off_path = {"matmul": 0.0, "matmul_int8": 0.0}
    dtypes = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp8": torch.float8_e4m3fn,
              "int8": torch.int8}
    for mode in GEMM_MODES:
        for m, k, n in GEMM_EDGES:
            a, b = rnd((m, k), torch.float32), rnd((k, n), torch.float32)
            got, want, x, y = gemm_case(torch, mode, a, b, (128, 128, 128))
            check_gemm(torch, mode, f"({m},{k})x({k},{n}) blocks 128/128/128", got, want, x, y)
            if not tma_eligible(dtypes[mode], m, k, n):   # matmul.cu or matmul_int8.cu
                name = "matmul_int8" if mode == "int8" else "matmul"
                off_path[name] = max(off_path[name], max_abs(got, want))
    # int8 past the exact int32 sum (ROADMAP C8): chunks of at most INT8_MAX_K
    # of K, on the wgmma kernel (K a multiple of 16) and on mma.sync
    for m, k, n in ((64, INT8_MAX_K + 1, 200), (48, 140000, 96), (33, INT8_MAX_K + 2, 40)):
        a, b = rnd((m, k), torch.float32), rnd((k, n), torch.float32)
        got, want, x, y = gemm_case(torch, "int8", a, b)
        path = "matmul_int8" if k % 16 else "matmul_int8_wgmma"
        check_gemm(torch, "int8", f"({m},{k})x({k},{n}), K past {INT8_MAX_K}, on {path}", got,
                   want, x, y)
        if k % 16:
            off_path["matmul_int8"] = max(off_path["matmul_int8"], max_abs(got, want))
        del a, b, got, want, x, y
    # the fp8 op beyond e4m3's range: NaN where the reference's cast gives it
    a, b = rnd((70, 96), torch.float32), rnd((96, 130), torch.float32)
    a[3, 5], a[10, 0], a[11, 95], a[20, 20] = 500.0, float("inf"), -465.0, 464.0
    b[7, 9], b[0, 129], b[30, 30] = float("-inf"), 1e4, -448.0
    got, want, x, y = gemm_case(torch, "fp8", a, b)
    check_gemm(torch, "fp8", "(70,96)x(96,130) with 500, -465, 1e4, +-inf (NaN) and 464, "
               f"-448 (+-448), {int(want.isnan().sum())} NaNs", got, want, x, y)

    # every GEMM on the TMA ring kernel: bf16 and e4m3 on wgmma, int8 on its
    # s8 mode, fp32 on its FFMA mode; one reduction where a split plan splits
    # K; none on matmul.cu or matmul_int8.cu
    from repro_torch.kernels.matmul.kernel import select_tile, split_plan
    splits = sum(len(split_plan(M, n, k, select_tile(dt, min(256, M), min(512, k),
                                                     min(256, n)),
                                INT8_MAX_K if dt == torch.int8 else None)) > 1
                 for M in GEMM_ROWS for _, k, n in GPT3_GEMMS
                 for dt in (torch.bfloat16, torch.float8_e4m3fn, torch.int8, torch.float32))
    expected = dict.fromkeys(K.KERNELS, 0)
    expected.update(matmul_f32_tma=len(GEMM_ROWS) * len(GPT3_GEMMS),
                    matmul_wgmma=2 * len(GEMM_ROWS) * len(GPT3_GEMMS), matmul_reduce=splits,
                    matmul_int8_wgmma=len(GEMM_ROWS) * len(GPT3_GEMMS))
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
    print(f"[matmul] paths: all {counts['matmul_wgmma']} bf16 and e4m3 GEMMs and all "
          f"{counts['matmul_int8_wgmma']} int8 ones on the TMA + wgmma kernel, all "
          f"{counts['matmul_f32_tma']} fp32 ones on its FFMA mode "
          f"({counts['matmul_reduce']} split-K reductions); {counts['matmul']} on matmul.cu "
          f"(mma.sync, SIMT), {counts['matmul_int8']} on matmul_int8.cu")

    # the split-K reduction against its plain version: the same bits
    from repro_torch.kernels.matmul.ref import matmul_reduce_ref
    p = rnd((6, SLOTS, 12288), torch.float32)
    for dt in (torch.float32, torch.bfloat16):
        got = K.KERNELS["matmul_reduce"](p, torch.empty((SLOTS, 12288), device="cuda",
                                                        dtype=dt))
        require(torch.equal(got, matmul_reduce_ref(p, dt)),
                f"matmul_reduce ({dt}) differs from its plain version")
    sa, sb = rnd((SLOTS, 1), torch.float32).abs(), rnd((1, 12288), torch.float32).abs()
    got = K.KERNELS["matmul_reduce"](p, torch.empty((SLOTS, 12288), device="cuda"), sa, sb)
    require(torch.equal(got, matmul_reduce_ref(p, torch.float32, sa, sb)),
            "matmul_reduce with the int8 scales differs from its plain version")
    print("[matmul] matmul_reduce (6, 8, 12288) fp32 partials -> fp32 and bf16, and with the "
          "int8 scales: equal to the plain version bit for bit")

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
    return counts, errs, off_path


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


def served_config(arch, n_layers, n_experts=None):
    """`arch`'s full config, cut to `n_layers` layers and to `n_experts`
    experts (the first of them, top-k kept) where given."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers, name=f"{arch}-{n_layers}l")
    if n_experts is not None:
        cfg = dataclasses.replace(cfg, n_experts=n_experts, name=f"{cfg.name}-{n_experts}e")
    return cfg


def prefill_attention(cfg):
    """The kernel of `cfg`'s prefill attention: the TMA + wgmma one at the
    head dims it takes (every served model's, bf16 (B, S, H, D) views), else
    the mma.sync one."""
    from repro_torch.kernels.flash_attention.kernel import WGMMA_HEAD_DIMS
    return "flash_attention_wgmma" if cfg.d_head in WGMMA_HEAD_DIMS else "flash_attention"


def decode_attention_kernel(cfg):
    """The kernel of `cfg`'s decode attention (every served model's bf16
    cache views take 16-byte loads): the chunked one at most
    ``CHUNKED_MAX_G`` query heads a kv-head, the mma one above it; the
    split one at a head dim neither takes."""
    from repro_torch.kernels.decode_attention.kernel import CHUNKED_HEAD_DIMS, CHUNKED_MAX_G
    if cfg.d_head not in CHUNKED_HEAD_DIMS:
        return "decode_attention"
    return "decode_attention_chunked" if cfg.group_size <= CHUNKED_MAX_G else \
        "decode_attention_mma"


def mlp_kernel(cfg):
    """The kernel of `cfg`'s MLP activation: SwiGLU, gated GELU or GELU."""
    if not cfg.mlp_gated:
        return "gelu"
    return "gelu_mul" if cfg.activation == "gelu" else "silu_mul"


def expected_launches(cfg, prefill):
    """Launches of each kernel in one prefill or one decode step of `cfg`:
    two norms per layer, a third (``lnx``) per encoder-decoder layer, and
    the final one (q- and k-norm per attention layer with qk-norm are
    RMSNorms whatever `cfg.norm`; a cross layer's k-norm runs at prefill
    only), one MLP activation per layer (``mlp_kernel``'s), one attention
    per self-attention layer and one per cross-attending layer
    (``prefill_attention``'s kernel at prefill; at decode
    ``decode_attention_kernel``'s for self-attention and
    ``cross_decode_kernel``'s for cross-attention; none on the other flash
    or decode kernel), and at prefill the encoder's: two norms, one MLP
    activation and one non-causal flash attention per encoder layer, and
    its final norm; per Griffin RG-LRU layer one gelu (its gate branch) and
    one rglru_chunked at prefill or one rglru at decode; for RWKV6, one
    wkv_chunked per layer at prefill, one wkv per layer at decode, and no
    attention."""
    from repro_torch.kernels import KERNELS
    from repro_torch.models.lm import layer_kinds
    L = cfg.n_layers
    kinds = layer_kinds(cfg)
    n_self = kinds.count("attn") + kinds.count("encdec")
    n_cross = kinds.count("xattn") + kinds.count("encdec")
    n_rec = kinds.count("rglru")
    n_enc = cfg.n_encoder_layers if prefill else 0
    counts = dict.fromkeys(KERNELS, 0)
    counts[cfg.norm] += 2 * L + 1 + kinds.count("encdec") + (2 * n_enc + 1 if n_enc else 0)
    if cfg.attention_free:
        counts["wkv_chunked" if prefill else "wkv"] = L
        return counts
    if cfg.qk_norm:
        counts["rmsnorm"] += 2 * n_self + (2 if prefill else 1) * n_cross
    counts[mlp_kernel(cfg)] += L + n_enc
    counts["gelu"] += n_rec
    counts["rglru_chunked" if prefill else "rglru"] = n_rec
    if prefill:
        counts[prefill_attention(cfg)] = n_self + n_cross + n_enc
        return counts
    counts[decode_attention_kernel(cfg)] = n_self
    counts[cross_decode_kernel(cfg)] += n_cross
    return counts


def cross_decode_kernel(cfg):
    """The kernel of `cfg`'s cross-attention at a decode step (one query
    over every cross key), as ``attend_all_keys`` routes a bf16 call at its
    shape on the card (``LM.decode_step``): the decode kernel
    ``decode_kernel`` names where ``all_keys_on_decode`` holds (the chunked
    one at whisper's G = 1, the mma one at llama-3.2-vision's G = 4), else
    flash on the one query."""
    import torch
    from repro_torch.kernels.decode_attention.kernel import decode_kernel
    from repro_torch.kernels.decode_attention.ops import all_keys_on_decode
    q = torch.empty((1, cfg.n_kv_heads, cfg.group_size, cfg.d_head), dtype=torch.bfloat16,
                    device="cuda")
    k = torch.empty((1, cfg.n_frontend_tokens, cfg.n_kv_heads, cfg.d_head),
                    dtype=torch.bfloat16, device="cuda")
    return decode_kernel(q, k, k) if all_keys_on_decode(q, k, k) else prefill_attention(cfg)


def phase_serve(torch, arch, n_layers):
    """Serve the 16-request schedule on one model; returns its launch counts
    (serve run, one prefill step, one decode step), the prompt lengths (the
    first wave's SLOTS, then the refills') and what the analytic phase holds
    the model's predictions to: the served wave's padded length and its
    prefill's device and wall ms (``time_wave_prefill``), and a decode
    step's wall and device ms at SLOTS slots (``profile_decode``). The model
    and its caches are freed on return."""
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
    if cfg.n_experts:
        heads += (f", {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-{cfg.top_k}"
                  + (f", logit softcap {cfg.attn_logit_softcap:g}"
                     if cfg.attn_logit_softcap else ""))
    if cfg.n_frontend_tokens:
        heads += (f", {cfg.n_encoder_layers} encoder layers and cross-attention in every "
                  "decoder layer" if cfg.cross_attention else
                  f", gated cross-attention at layers {list(cfg.cross_attn_layers)}")
        heads += f" over a stub frontend of {cfg.n_frontend_tokens} tokens a request"
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{heads}, {n_params} parameters ({cfg.param_count()} by the config's "
          f"accounting, without the vocab padding) "
          f"({torch.cuda.memory_allocated() / 2**30:.2f} GiB), random init on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator("cpu").manual_seed(1)

    def prompt(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()

    # a seeded stub frontend per request, for a model that cross-attends
    # (its own generator: the prompts stay those of the other models)
    fgen = torch.Generator("cuda").manual_seed(3)

    def frontend(*batch):
        if not cfg.n_frontend_tokens:
            return None
        return torch.randn(batch + (cfg.n_frontend_tokens, cfg.d_model), generator=fgen,
                           device="cuda").to(torch.bfloat16)

    # a short warm-up serve, so the measured one excludes one-off set-up
    Engine(cfg, model, batch_size=2, max_len=64, device="cuda").run(
        [Request(uid=i, prompt=prompt(16), max_new_tokens=2, frontend=frontend())
         for i in range(3)])
    torch.cuda.synchronize()

    lens = torch.randint(128, 513, (N_REQUESTS,), generator=gen).tolist()
    reqs = [Request(uid=i, prompt=prompt(n), max_new_tokens=new, frontend=frontend())
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
    seq = "wkv_chunked" if cfg.attention_free else prefill_attention(cfg)
    require(prefill_counts[seq] == prefills * per_step[0][seq],
            f"{prefill_counts[seq]} {seq} launches in the prefill phase, not the "
            f"{prefills} x {per_step[0][seq]} of one wave and {prefills - 1} refills")
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
    measured = time_wave_prefill(torch, cfg, model, cache, reqs[:SLOTS], frontend(SLOTS))
    toks = torch.randint(0, cfg.vocab_size, (SLOTS, 512), generator=gen).cuda()
    K.reset_launches()
    model.prefill(toks, cache, frontend=frontend(SLOTS))
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
    measured["decode_wall_ms"], measured["decode_device_ms"] = profile_decode(
        torch, model, cache, toks[:, 0])
    if cfg.n_experts:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            model.decode_step(toks[:, 0], cache)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        print(f"[serve] {cfg.name}: a decode step under torch.cuda.set_sync_debug_mode"
              f"(\"error\") ran: nothing on it waits for the host")
        moe_drops(torch, cfg, model, reqs[:SLOTS])
    print(f"[serve] {cfg.name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del cache
    if cfg.attn_window:
        phase_ring_serve(torch, cfg, model, gen)
    del model
    torch.cuda.empty_cache()
    return counts, per_prefill, per_decode, lens, measured


def time_wave_prefill(torch, cfg, model, cache, wave, fr, runs=3):
    """The served wave's prefill, `wave`'s prompts right-padded to the
    longest as ``Engine.admit_wave`` pads them, into `cache` with the
    frontends `fr`: its device-busy time, the device-side events of one
    prefill summed under torch.profiler as ``profile_decode`` sums a decode
    step's, and its wall time (host clock to a synchronize, median of
    `runs`)."""
    from torch.profiler import ProfilerActivity, profile
    S = max(len(r.prompt) for r in wave)
    toks = torch.tensor([r.prompt + [0] * (S - len(r.prompt)) for r in wave],
                        dtype=torch.int32, device="cuda")
    lens = torch.tensor([len(r.prompt) for r in wave], dtype=torch.int32, device="cuda")
    model.prefill(toks, cache, lens, fr)
    torch.cuda.synchronize()
    walls = []
    for _ in range(runs):
        t0 = time.perf_counter()
        model.prefill(toks, cache, lens, fr)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.prefill(toks, cache, lens, fr)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type != torch.autograd.DeviceType.CPU) / 1e3
    print(f"[serve] {cfg.name}: the served wave's prefill ({len(wave)} x {S} tokens): device "
          f"busy {busy_ms:.4f} ms (torch.profiler), wall {wall_ms:.4f} ms")
    return {"wave_S": S, "wave_lengths": [len(r.prompt) for r in wave],
            "prefill_device_ms": busy_ms, "prefill_wall_ms": wall_ms}


@contextlib.contextmanager
def routing(replay=None):
    """Within the block the port's ``moe_route`` records each call's experts
    and fp32 router logits, on the CPU, into the list yielded. With `replay`
    (such a list) it then returns the replayed experts, call by call, gated
    by its own probabilities at them: its records hold the experts it would
    have chosen itself on the replayed run's inputs."""
    from repro_torch.models import layers
    route, records, calls = layers.moe_route, [], iter(replay or ())

    def recorded(cfg, p, xt):
        probs, gate, idx = route(cfg, p, xt)
        records.append((idx.cpu(), (xt.float() @ p["router"]).detach().cpu()))
        if replay is None:
            return probs, gate, idx
        idx = next(calls)[0].to(xt.device)
        gate = probs.gather(-1, idx)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

    layers.moe_route = recorded
    try:
        yield records
    finally:
        layers.moe_route = route
    require(next(calls, None) is None, "a recorded routing was not replayed in full")


def dropped_share(torch, idx, n_experts):
    """(share of a call's (token, choice) assignments past their expert's
    capacity, that capacity), from the experts' counts: an expert keeps
    min(count, capacity) of its assignments whatever their order."""
    T, k = idx.shape
    capacity = max(1, int(1.25 * T * k / n_experts))
    counts = torch.bincount(idx.flatten(), minlength=n_experts)
    return (counts - capacity).clamp(min=0).sum().item() / (T * k), capacity


def moe_drops(torch, cfg, model, wave):
    """The share of (token, choice) assignments dropped at capacity in
    layer 0, in the served wave (the first SLOTS requests, right-padded as
    the Engine pads them: every row routes and takes capacity, C10) and in
    the 8-slot decode step after it."""
    from repro_torch.models import init_cache
    S = max(len(r.prompt) for r in wave)
    toks = torch.zeros((SLOTS, S), dtype=torch.int32)
    for i, r in enumerate(wave):
        toks[i, :len(r.prompt)] = torch.tensor(r.prompt)
    lens = torch.tensor([len(r.prompt) for r in wave], dtype=torch.int32)
    cache = init_cache(cfg, SLOTS, MAX_LEN, device="cuda")
    with routing() as calls:
        logits = model.prefill(toks.cuda(), cache, lens.cuda())
        model.decode_step(logits[:, :cfg.vocab_size].argmax(-1).int(), cache)
    wave_share, wave_cap = dropped_share(torch, calls[0][0], cfg.n_experts)
    step_share, step_cap = dropped_share(torch, calls[cfg.n_layers][0], cfg.n_experts)
    print(f"[serve] {cfg.name}: layer 0 drops {wave_share:.4f} of the served wave's "
          f"{SLOTS * S} x {cfg.top_k} assignments ({SLOTS} x {S} rows, {int(lens.sum())} of "
          f"them prompt tokens; capacity {wave_cap} an expert) and {step_share:.4f} of "
          f"an 8-slot decode step's {SLOTS} x {cfg.top_k} (capacity {step_cap})")
    del cache


def phase_ring_serve(torch, cfg, model, gen):
    """A windowed model at full depth past its window: one request of
    RING_PROMPT tokens and RING_STEPS + 1 new ones on one slot of a
    RING_MAX_LEN budget, through the Engine: a prefill longer than the ring
    (min(max_len, window) slots, each position in slot pos % ring) and
    RING_STEPS decode steps past its wrap. The launches are exactly one
    prefill step's and RING_STEPS decode steps'; the tokens lie in the
    vocabulary."""
    from repro_torch import kernels as K
    from repro_torch.serving import Engine, Request
    eng = Engine(cfg, model, batch_size=1, max_len=RING_MAX_LEN, device="cuda")
    ring = eng.cache["k"].shape[2]
    require(ring == min(RING_MAX_LEN, cfg.attn_window) < RING_PROMPT,
            f"{cfg.name}: a ring of {ring} slots for a prompt of {RING_PROMPT}")
    req = Request(uid=0, prompt=torch.randint(0, cfg.vocab_size, (RING_PROMPT,),
                                              generator=gen).tolist(),
                  max_new_tokens=RING_STEPS + 1)
    K.reset_launches()
    t0 = time.perf_counter()
    eng.run([req])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pre, dec = expected_launches(cfg, True), expected_launches(cfg, False)
    want = {name: pre[name] + RING_STEPS * dec[name] for name in pre}
    require(K.launches() == want, f"{cfg.name} ring: launches {K.launches()}, not one "
            f"prefill's and {RING_STEPS} decode steps' {want}")
    require(req.done and len(req.output) == RING_STEPS + 1
            and all(0 <= t < cfg.vocab_size for t in req.output),
            f"{cfg.name} ring: {len(req.output)} tokens, done={req.done}")
    st = eng.stats
    print(f"[ring] {cfg.name}: one prompt of {RING_PROMPT} tokens into a ring of {ring} "
          f"slots (max_len {RING_MAX_LEN}, window {cfg.attn_window}), then {st['steps']} "
          f"decode steps at positions {RING_PROMPT}-{RING_PROMPT + st['steps'] - 1}, all "
          f"past the wrap: prefill {st['prefill_s']:.4f} s, decode {st['decode_s']:.4f} s "
          f"({st['decode_s'] / st['steps'] * 1e3:.3f} ms a step), wall {wall:.4f} s; "
          f"launches exact: {json.dumps({k: n for k, n in K.launches().items() if n})}")
    del eng


def profile_decode(torch, model, cache, tok, steps=5):
    """Where a decode step's time goes: host wall time per step, device
    time per step from a torch.profiler trace, and the kernels by device
    time. Device time sums the device-side events (kernels, copies) only:
    an ATen op's own device time is the time of the kernels it launched,
    so adding the two would count that time twice. Returns the wall and
    device ms per step."""
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
    return wall_ms, dev_us / 1e3


def phase_model(torch, arch, n_layers, S, steps, short=None, T=None):
    """Full width, cut in depth: the card's logits against the port's CPU
    path on the same weights, two prompts of S and `short` (S*41/64 by
    default) tokens on a cache of T (2 S by default) tokens, then `steps`
    decode steps, each fed the CPU's greedy token. An MoE model's routing on
    the CPU is replayed on the card, and the experts the card would have
    chosen in each of those calls are held to the CPU's by
    ``routing_flips``: with the routing replayed, both sides' router inputs
    differ by the kernels' and GEMMs' roundings alone, in every layer and
    step."""
    from repro_torch.models import LM, init_cache, init_params
    cfg = served_config(arch, n_layers)
    gpu = init_params(cfg, seed=1, device="cuda")
    gen = torch.Generator("cpu").manual_seed(2)
    B = 2
    fe = None
    if cfg.n_frontend_tokens:
        unhide_cross_attention(torch, gpu)
        fe = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=gen).bfloat16()
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen)
    lens = torch.tensor([S, short or S * 41 // 64], dtype=torch.int32)
    T = T or 2 * S
    V = cfg.vocab_size
    t0 = time.perf_counter()
    with routing() as cpu_routing:
        cc = init_cache(cfg, B, T, device="cpu")
        lc = [cpu.prefill(toks, cc, lens, fe)]
        fed = []
        for _ in range(steps):
            fed.append(lc[-1][:, :V].argmax(-1).int())
            lc.append(cpu.decode_step(fed[-1], cc))
    with routing(replay=cpu_routing) as card_routing:
        cg = init_cache(cfg, B, T, device="cuda")
        lg = [gpu.prefill(toks.cuda(), cg, lens.cuda(), None if fe is None else fe.cuda()).cpu()]
        if cfg.attention_free or "rglru" in cfg.block_pattern:
            check_wave_state(torch, cfg, gpu, toks, lens, cg, lg[0])
        lg += [gpu.decode_step(tok.cuda(), cg).cpu() for tok in fed]
    ring = cg["k"].shape[2] if "k" in cg else None
    require(all(torch.isfinite(x[:, :V].float()).all() for x in lg),
            "non-finite logits on the card")
    anchored = arch in FP32_ANCHORED
    if anchored:
        cpu.float()
        c32 = {k: v.float() if v.is_floating_point() else v
               for k, v in init_cache(cfg, B, T, device="cpu").items()}
        l32 = [cpu.prefill(toks, c32, lens, fe)] + [cpu.decode_step(tok, c32) for tok in fed]
        to32 = [(rel_err(g[:, :V], f[:, :V]), rel_err(c[:, :V], f[:, :V]))
                for g, c, f in zip(lg, lc, l32)]
        del c32, l32
    errs = [rel_err(g[:, :V], c[:, :V]) for g, c in zip(lg, lc)]
    agree = [(g[:, :V].argmax(-1) == c[:, :V].argmax(-1)).float().mean().item()
             for g, c in zip(lg, lc)]
    tol = 2e-2
    ring = f", a ring of {ring} slots" if cfg.attn_window else ""
    routed = ", the CPU's routing replayed" if cfg.n_experts else ""
    if fe is not None:
        cross = max(rel_err(cg[name].cpu(), cc[name]) for name in ("xk", "xv"))
        routed += (f", frontends of {cfg.n_frontend_tokens} tokens, xgate {XGATE:g}, random "
                   f"qkv biases; cross K/V rel_err {cross:.3e}")
        require(cross < 2e-2, f"{cfg.name}: card vs CPU cross K/V rel_err {cross:.3e}")
    print(f"[model] {cfg.name} (full width, {cfg.n_layers} layers, batch {B}, prompts "
          f"{lens.tolist()}, cache {T}{ring}{routed}) card vs CPU, rel_err of logits: prefill "
          f"{errs[0]:.3e}, "
          f"decode max {max(errs[1:]):.3e} ("
          + ("held to fp32 below" if anchored else f"tol {tol:g}")
          + ": both bf16, kernels against plain versions and another GEMM order); "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"[model] {cfg.name}: greedy token agreement over prefill + {steps} decode "
          f"steps: {statistics.mean(agree):.4f}")
    if anchored:
        worst = max(g / c for g, c in to32)
        print(f"[model] {cfg.name}: rel_err of logits from an fp32 CPU run of the same "
              f"weights, card / bf16 CPU, prefill then each decode step: "
              + ", ".join(f"{g:.3e}/{c:.3e}" for g, c in to32)
              + f"; the card's at most {worst:.3f} times the CPU's (limit {FP32_FACTOR:g}; "
              f"card vs CPU itself not held at this depth, MODEL_CHECKS)")
        require(worst <= FP32_FACTOR, f"{cfg.name}: the card is {worst:.3f} times as far "
                f"from fp32 as the bf16 CPU path, > {FP32_FACTOR:g}")
    else:
        require(max(errs) < tol, f"{cfg.name}: card vs CPU logits rel_err "
                f"{max(errs):.3e} >= {tol}")
    if cfg.n_experts:
        n, beyond, worst = routing_flips(cfg.top_k, cpu_routing, card_routing)
        print(f"[model] {cfg.name}: the card's own choices in the replayed run against "
              f"the CPU's, {len(card_routing)} calls ({cfg.n_layers} layers x {1 + steps} "
              f"steps): {n} of {sum(i.numel() for i, _ in cpu_routing)} choices differ, "
              f"{beyond} of them where the CPU's k-th margin exceeds twice the call's "
              f"largest card-CPU router-logit difference (largest {worst:.3e})")
        require(beyond == 0, f"{cfg.name}: {beyond} routing choices flipped beyond the margin")
    del gpu, cpu, cc, cg
    torch.cuda.empty_cache()


def unhide_recurrence(torch, model):
    """In place: every RG-LRU ``lam`` to seeded values in [-6, 1], so that
    the recurrence gates a reach 0.99 and the scan carries its state (and
    its backward its gradient) over many steps; at the init's 3.0 every a is
    about 5e-6 (as in ``tests/test_torch_train_hybrid.py``). Every RWKV6
    base decay ``w0`` to seeded values in [-6.9, 1.1] (decays w from about
    0.999 to 0.05; at the init's -6 every w is about 0.9975, and a backward
    that dropped the decays would pass) and the bonus ``u`` to seeded
    normal values at the init's scale of 0.3."""
    gen = torch.Generator("cuda").manual_seed(6)
    for name, p in model.named_parameters():
        if name.endswith("rec.lam"):
            p.copy_(torch.rand(p.shape, generator=gen, device="cuda") * 7.0 - 6.0)
        elif name.endswith("tmix.w0"):
            p.copy_(torch.rand(p.shape, generator=gen, device="cuda") * 8.0 - 6.9)
        elif name.endswith("tmix.u"):
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * 0.3)


def unhide_cross_attention(torch, model):
    """In place: every ``xgate`` to XGATE, every qkv bias to seeded normal
    values of scale BIAS_SCALE, and every cross-attention output projection
    (``xattn.wo``) 8 times its init, so that the cross branch moves the
    logits by more than their tolerance (as in ``tests/test_torch_xattn.py``)."""
    gen = torch.Generator("cuda").manual_seed(4)
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "xgate":
            p.fill_(XGATE)
        elif leaf in ("bq", "bk", "bv"):
            p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * BIAS_SCALE)
        elif name.endswith("xattn.wo"):
            p.mul_(8)


def routing_flips(k, want, got):
    """(choices of `got` outside `want`'s top-k over all calls; those of them
    whose token's margin in `want` between its k-th and (k+1)-th router
    logit exceeds twice the largest |got - want| router logit of the call;
    that largest difference over the calls). Such a margin cannot flip:
    each of the two logits moved by at most the call's largest difference."""
    n = beyond = 0
    worst = 0.0
    require(len(want) == len(got), f"{len(got)} routing calls, not {len(want)}")
    for (wi, wl), (gi, gl) in zip(want, got):
        differ = (gi[:, :, None] != wi[:, None, :]).all(-1).sum(-1)
        top = wl.sort(-1, descending=True).values
        delta = (gl - wl).abs().max().item()
        worst = max(worst, delta)
        n += int(differ.sum())
        beyond += int(differ[top[:, k - 1] - top[:, k] > 2 * delta].sum())
    return n, beyond, worst


def check_wave_state(torch, cfg, gpu, toks, lens, cache, logits):
    """On the card: the short prompt's recurrent state (RWKV6's state and
    token shifts, Griffin's h and conv carry), its ring K/V (Griffin) and
    its logits after the right-padded wave against that prompt prefilled
    alone (its pads must stay out of its state, and its ring must hold its
    own last keys, ROADMAP.md C4), within 2e-2. The alone cache's ring has
    min(n, window) slots, the wave's the same first ones."""
    from repro_torch.models import init_cache
    n = int(lens[1])
    alone = init_cache(cfg, 1, n, device="cuda")
    want = gpu.prefill(toks[1:2, :n].cuda(), alone).cpu()
    V = cfg.vocab_size
    errs = {"logits": rel_err(logits[1:2, :V], want[:, :V])}
    errs.update({name: rel_err(cache[name][:, 1, :alone[name].shape[2]] if name in ("k", "v")
                               else cache[name][:, 1], alone[name][:, 0])
                 for name in alone if name != "pos"})
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


def time_decode(torch, add, rows, label, qd, kd, vd, lens_list, cap=0.0, held=False,
                kernels=DECODE_KERNELS, **extra):
    """One decode shape through `add` (``phase_timing``'s, into its `rows`):
    the kernel the op picks (``decode_kernel``) and each other of `kernels`
    that takes the call, every one held to the plain version on these
    tensors where `held`, SDPA (a mask of the live keys; it takes no
    softcap, so it runs without one) as the library call, the bound from
    the live keys' bytes. Each row's shape notes every kernel's time; the
    picked one's also `extra`. Returns {kernel: ms}."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention.kernel import chunked_eligible, decode_kernel
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    B, Hkv, G, D = qd.shape
    T = kd.shape[1]
    mask = (torch.arange(T, device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    q_sdpa = qd.reshape(B, Hkv * G, 1, D)
    picked = decode_kernel(qd, kd, vd)
    names = [n for n in DECODE_KERNELS if n == picked or (
        n in kernels and (n == "decode_attention" or chunked_eligible(qd, kd, vd)))]
    ms = {}
    for name in names:
        add(name, label + ("" if name == picked else f" (the op picks {picked})"),
            lambda name=name: KERNELS[name](qd, kd, vd, lens, softcap=cap),
            lambda: decode_attention_ref(qd, kd, vd, lens, cap),
            lambda: F.scaled_dot_product_attention(q_sdpa, kd.transpose(1, 2),
                                                   vd.transpose(1, 2), attn_mask=mask,
                                                   enable_gqa=True),
            2 * (2 * B * Hkv * G * D + 2 * sum(lens_list) * Hkv * D) + 4 * B,
            4 * D * G * Hkv * sum(lens_list), BF16_TENSOR_FLOPS, held=held,
            **(extra if name == picked else {}))
        ms[name] = rows[name]["shapes"][-1]["ms"]
    for name in names:
        rows[name]["shapes"][-1]["decode_kernels_ms"] = ms
    sdpa = rows[picked]["shapes"][-1]["library_ms"]
    print(f"[timing] decode {label}: " + ", ".join(f"{n} {t:.5f} ms" for n, t in ms.items())
          + f", SDPA {sdpa:.5f} ms; the op picks {picked}")
    return ms


def time_decode_and_cross(torch, add, rows, rnd, cross_lens):
    """The timing phase's rows of ROADMAP B17's crossover and of the
    cross-attending models, through `add` (``phase_timing``'s, into its
    `rows`), on inputs from `rnd`; `cross_lens` the served llama run's
    prompt lengths (its wave: the first SLOTS)."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.decode_attention.kernel import CHUNKED_MAX_G
    from repro_torch.kernels.decode_attention.ops import all_keys_on_decode
    from repro_torch.kernels.flash_attention.ref import attention_ref
    bf, B, T = torch.bfloat16, SLOTS, MAX_LEN

    # ROADMAP B17: the three decode kernels at G = 1, 2, 3, 4, 6, 10 and
    # 16 query heads a kv-head (8 kv-heads of 128, the served decode
    # lengths), in one call; the op sends G <= CHUNKED_MAX_G to the chunked
    # kernel, the rest to the mma one
    sweep = {}
    lens_list = decode_lengths(SLOTS, T)
    for G in G_SWEEP:
        qd = rnd((SLOTS, 8, G, 128), bf)
        kd, vd = rnd((SLOTS, T, 8, 128), bf), rnd((SLOTS, T, 8, 128), bf)
        sweep[G] = time_decode(
            torch, add, rows,
            f"G sweep q({SLOTS},8,{G},128) kv({SLOTS},{T},8,128) lengths={lens_list} bf16",
            qd, kd, vd, lens_list, held=True)
        del qd, kd, vd
    print(f"[timing] decode G sweep (D = 128, 8 kv-heads, T = {T}): {json.dumps(sweep)}; the "
          "fastest at G = " + ", ".join(f"{G}: {min(r, key=r.get)}" for G, r in sweep.items())
          + f"; the op sends G <= {CHUNKED_MAX_G} to the chunked kernel, the rest to the mma one")
    # the crossover in alternating turns (chunked, mma, mma, chunked, ...) at
    # the served decode shapes of one and two query heads a kv-head
    for what, Hkv, G, D in (("qwen3-1.7b", 8, 2, 128), ("stablelm-1.6b", 32, 1, 64)):
        qd = rnd((SLOTS, Hkv, G, D), bf)
        kd, vd = rnd((SLOTS, T, Hkv, D), bf), rnd((SLOTS, T, Hkv, D), bf)
        lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
        turns = {"decode_attention_chunked": [], "decode_attention_mma": []}
        for i in range(4):
            for name in sorted(turns, reverse=i % 2 == 1):
                turns[name].append(time_ms(torch, lambda name=name: KERNELS[name](qd, kd, vd,
                                                                                 lens)))
        print(f"[timing] decode crossover in turns at {what}'s q({SLOTS},{Hkv},{G},{D}) "
              f"kv({SLOTS},{T},{Hkv},{D}): " + "; ".join(
                  f"{name} " + " ".join(f"{t:.5f}" for t in ts) + " ms"
                  for name, ts in turns.items()))
        del qd, kd, vd
    # the split kernel's cost of reading K and V again: recurrentgemma's
    # decode shape (one kv-head of 256, blocks of 2 query heads) with its
    # 10 heads (5 blocks a slot over the same keys) against its first 2 (1)
    qd = rnd((SLOTS, 1, 10, 256), bf)
    kd, vd = rnd((SLOTS, T, 1, 256), bf), rnd((SLOTS, T, 1, 256), bf)
    lens = torch.tensor(lens_list, dtype=torch.int32, device="cuda")
    q2 = qd[:, :, :2].contiguous()
    reread = {G: time_ms(torch, lambda q=q: KERNELS["decode_attention"](q, kd, vd, lens))
              for G, q in ((10, qd), (2, q2))}
    print(f"[timing] decode_attention (the split kernel) at q({SLOTS},1,G,256) "
          f"kv({SLOTS},{T},1,256), the same keys read by G / 2 blocks a slot: G = 10 "
          f"{reread[10]:.5f} ms, G = 2 {reread[2]:.5f} ms")
    del qd, kd, vd, q2

    # the cross-attending models, each shape held to its plain version on
    # the tensors timed: flash, non-causal, at llama-3.2-vision's
    # cross-attention at the served wave (over its 1601 frontend keys), and
    # at whisper's encoder (1500 x 1500) and cross-attention (over 1500),
    # the model's transposed views, beside SDPA; the decode kernels at
    # llama's self-attention decode step (G = 4); then the two candidates
    # for a cross-attention at a decode step, one query over all nf keys:
    # the decode op (every length nf) and flash on one query (the JAX
    # model's form), both held, beside SDPA; the model's route is the one
    # ``attend_all_keys`` takes (``all_keys_on_decode``)
    cross_S = max(cross_lens[:SLOTS])
    for what, Hq, Hkv, Sq, Sk, D in (
            ("llama-3.2-vision-11b's cross-attention at its wave", 32, 8, cross_S, 1601, 128),
            ("whisper-tiny's encoder", 6, 6, 1500, 1500, 64),
            ("whisper-tiny's cross-attention at the wave", 6, 6, cross_S, 1500, 64)):
        q, k, v = (attention_input(rnd, shape, bf, "view")
                   for shape in ((B, Hq, Sq, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D)))
        add("flash_attention_wgmma", f"{what} q({B},{Hq},{Sq},{D}) kv({B},{Hkv},{Sk},{D}) "
            "view non-causal bf16",
            lambda: KERNELS["flash_attention_wgmma"](q, k, v, causal=False),
            lambda: attention_ref(q, k, v, causal=False),
            lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True),
            2 * (2 * B * Hq * Sq * D + 2 * B * Hkv * Sk * D), 4 * D * B * Hq * Sq * Sk,
            BF16_TENSOR_FLOPS, held=True)
        del q, k, v
    qd = rnd((SLOTS, 8, 4, 128), bf)
    kd, vd = rnd((SLOTS, T, 8, 128), bf), rnd((SLOTS, T, 8, 128), bf)
    time_decode(torch, add, rows, f"llama-3.2-vision-11b's decode step q({SLOTS},8,4,128) "
                f"kv({SLOTS},{T},8,128) lengths={lens_list} bf16", qd, kd, vd, lens_list,
                held=True)
    del qd, kd, vd
    cross_decode = {}
    for cfg_name, Hkv, G, nf, D in (("llama-3.2-vision-11b", 8, 4, 1601, 128),
                                    ("whisper-tiny", 6, 1, 1500, 64)):
        qd = rnd((SLOTS, Hkv, G, D), bf)
        kd, vd = rnd((SLOTS, nf, Hkv, D), bf), rnd((SLOTS, nf, Hkv, D), bf)
        label = (f"{cfg_name}'s cross-attention at a decode step q({SLOTS},{Hkv},{G},{D}) "
                 f"kv({SLOTS},{nf},{Hkv},{D}) every length {nf} bf16 (the decode op)")
        route = "decode op" if all_keys_on_decode(qd, kd, vd) else "flash"
        ms = time_decode(torch, add, rows, label, qd, kd, vd, [nf] * SLOTS, held=True)
        qf, kf, vf = qd.reshape(SLOTS, Hkv * G, 1, D), kd.transpose(1, 2), vd.transpose(1, 2)
        add("flash_attention_wgmma", f"{cfg_name}'s cross-attention at a decode step, one "
            f"query q({SLOTS},{Hkv * G},1,{D}) kv({SLOTS},{Hkv},{nf},{D}) view non-causal bf16 "
            "(flash on one query)",
            lambda: KERNELS["flash_attention_wgmma"](qf, kf, vf, causal=False),
            lambda: attention_ref(qf, kf, vf, causal=False),
            lambda: F.scaled_dot_product_attention(qf, kf, vf, enable_gqa=True),
            2 * (2 * SLOTS * Hkv * G * D + 2 * SLOTS * nf * Hkv * D),
            4 * D * G * Hkv * SLOTS * nf, BF16_TENSOR_FLOPS, held=True)
        flash_ms = rows["flash_attention_wgmma"]["shapes"][-1]["ms"]
        cross_decode[cfg_name] = {"decode_kernels_ms": ms, "flash_ms": flash_ms,
                                  "model_route": route}
        del qd, kd, vd, qf, kf, vf
    print(f"[timing] cross-attention at a decode step, the decode op against flash on one "
          f"query: {json.dumps(cross_decode)}")


def time_rglru(torch, add, rnd, griffin_lens):
    """The timing phase's rglru rows, through `add` (``phase_timing``'s), on
    inputs from `rnd`: the RG-LRU scan at the served recurrentgemma run's
    wave and longest refill (`griffin_lens`: its prompt lengths) and the ring
    phase's prefill on the kernel the op picks (the chunked one), beside
    rglru.cu (which ran them before) and the chunked kernel at each segment
    length; then the decode step in place on rglru.cu, beside the chunked
    kernel. Data-dependent: the inputs of the live steps are counted (u and
    the gate 2 bytes, ga and gx 4), the output y (4 bytes) in full, about 20
    fp32 operations a live element."""
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.rglru.kernel import SEGMENT_STEPS, picks_chunked
    from repro_torch.kernels.rglru.ref import rglru_ref
    d = 2560
    for label, lens, h0 in (("the served wave", griffin_lens[:SLOTS], False),
                            ("its longest refill", [max(griffin_lens[SLOTS:])], False),
                            ("the ring phase's prefill", [RING_PROMPT], False),
                            ("the decode step, h in place", [1] * SLOTS, True)):
        B, T = len(lens), max(lens)
        u, ga, gx, lam, gate, h = rglru_inputs(torch, rnd, B, T, d, h0)
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        name = "rglru_chunked" if picks_chunked(u, ga, gx, gate) else "rglru"
        other = "rglru" if name == "rglru_chunked" else "rglru_chunked"
        other_ms = time_ms(torch, lambda: KERNELS[other](u, ga, gx, lam, gate, h, lens_t,
                                                         h_out=h))
        steps_ms = {L: time_ms(torch, lambda L=L: KERNELS["rglru_chunked"](
            u, ga, gx, lam, gate, h, lens_t, h_out=h, steps=L)) for L in SEGMENT_STEPS}
        floors = {}
        if h0:   # the decode step's floors: one launch, and a pass over its state
            one = torch.ones(1, device="cuda")
            floors = {"launch_floor_ms": time_ms(torch, lambda: one.mul_(1.0)),
                      "state_mul_floor_ms": time_ms(torch, lambda: h.mul_(1.0))}
            print(f"[timing] rglru            decode step floors: one.mul_(1.0) on one element "
                  f"{floors['launch_floor_ms']:.5f} ms (a launch), h.mul_(1.0) on its "
                  f"({B},{d}) state {floors['state_mul_floor_ms']:.5f} ms")
        add(name, f"u,ga,gx,gate ({B},{T},{d}) lengths={lens}, {label}",
            lambda: KERNELS[name](u, ga, gx, lam, gate, h, lens_t, h_out=h),
            lambda: rglru_ref(u, ga, gx, lam, gate, h, lens_t), None,
            12 * sum(lens) * d + 4 * B * T * d + 4 * d + 4 * B * d * (2 if h0 else 1),
            20 * sum(lens) * d, FP32_FLOPS, plain_iters=5,
            model=("recurrent_scan", (T, B, d, 12.0 * d, 4 * B * T * d * 2)),
            **{f"{other}_ms": other_ms, "segment_steps_ms": steps_ms}, **floors)
        print(f"[timing] {name:16s} {label}: {other} {other_ms:.5f} ms on the same inputs; "
              f"the chunked kernel by steps a segment {json.dumps(steps_ms)} ms")
        del u, ga, gx, gate


def phase_timing(torch, counts, per_prefill, per_decode, errs, prompt_lens, griffin_lens,
                 moe_lens, cross_lens):
    """Each kernel at the served shapes. The first shape timed for a kernel
    gives its row of the summary; every shape is kept in the row's
    ``shapes``. wkv's prefill is timed at the served rwkv6 run's prompt
    lengths `prompt_lens`: its wave (the first SLOTS) and each of its batch-1
    refills; rglru's at the served recurrentgemma run's `griffin_lens`: its
    wave and its longest refill; the MoE models' shapes at the served wave
    of `moe_lens` (its first SLOTS prompts, padded to the longest) and their
    decode step; the cross-attending models' at the served wave of
    `cross_lens`. `counts` holds each kernel's launches in its path's run
    (the serve runs, the GEMM path for the GEMM kernels). Returns the rows
    and, apart from them, each shape's counterpart in core/operators.py,
    keyed by kernel and shape label, for the analytic phase."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.gelu.ref import gelu_mul_ref, gelu_ref, silu_mul_ref
    from repro_torch.kernels.rmsnorm.ref import layernorm_ref, rmsnorm_ref
    from repro_torch.kernels.wkv.ref import wkv_ref
    bf = torch.bfloat16
    rnd = Inputs(torch, 3)
    rows, models = {}, {}

    def add(name, label, kernel, plain, library, nbytes, flops, rate, iters=25,
            plain_iters=25, held=False, model=None, **extra):
        # held: a main-path shape no kernel case covers; the kernel is held
        # to its plain version on these tensors, and its error joins the row's.
        # model: the shape's counterpart in core/operators.py, (function,
        # arguments), kept for the analytic phase outside the row
        if model is not None:
            models[(name, label)] = model
        err = hold(torch, name, label, "bfloat16", kernel(), plain()) if held else 0.0
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
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            return
        route, source = SOURCES[name]
        rows[name] = {"name": name, "route": route, "source": source,
                      "replaces": REPLACES[name], "launches": counts[name],
                      "max_abs_err": max(errs[name], err), **shape,
                      "launches_per_prefill_step": {a: c[name] for a, c in per_prefill.items()},
                      "launches_per_decode_step": {a: c[name] for a, c in per_decode.items()},
                      "shapes": [shape]}

    for R, C in ((4096, 2048), (4096 * 16, 128)):
        x, g = rnd((R, C), bf), rnd((C,), torch.float32)
        gb = g.to(bf)
        add("rmsnorm", f"x({R},{C}) bf16", lambda: KERNELS["rmsnorm"](x, g),
            lambda: rmsnorm_ref(x, g), lambda: F.rms_norm(x, (C,), gb, 1e-6),
            2 * R * C * 2 + C * 4, 4 * R * C, FP32_FLOPS, model=("rmsnorm", (R, C)))

    for R, C in ((4096, 2048), (4096, 12288)):
        x, g, b = rnd((R, C), bf), rnd((C,), torch.float32), rnd((C,), torch.float32)
        gb, bb = g.to(bf), b.to(bf)
        add("layernorm", f"x({R},{C}) bf16", lambda: KERNELS["layernorm"](x, g, b),
            lambda: layernorm_ref(x, g, b), lambda: F.layer_norm(x, (C,), gb, bb, 1e-5),
            2 * R * C * 2 + 2 * C * 4, 8 * R * C, FP32_FLOPS, model=("layernorm", (R, C)))

    # gelu at gpt3's FFN width: the prefill wave (8 x 512 rows) and the decode
    # step (8 slots); the kernel, F.gelu and the Triton kernel gelu.cu
    # replaced in turn, GELU_PAIRS times: is the kernel slower than F.gelu?
    from repro_torch.kernels.gelu.kernel import gelu_triton
    C = 49152
    for R in (4096, SLOTS):
        x = rnd((R, C), bf)
        turns = [(time_ms(torch, lambda: KERNELS["gelu"](x)),
                  time_ms(torch, lambda: F.gelu(x, approximate="tanh")),
                  time_ms(torch, lambda: gelu_triton(x))) for _ in range(GELU_PAIRS)]
        ratios = [kern / lib for kern, lib, _ in turns]
        print(f"[timing] gelu x({R},{C}): kernel, F.gelu, Triton kernel in {GELU_PAIRS} turns "
              f"(ms): {json.dumps(turns)}; kernel slower than F.gelu in "
              f"{sum(r > 1 for r in ratios)} of {GELU_PAIRS}, median ratio "
              f"{statistics.median(ratios):.5f}; against the Triton kernel "
              f"{statistics.median(kern / tri for kern, _, tri in turns):.5f}")
        add("gelu", f"x({R},{C}) bf16", lambda: KERNELS["gelu"](x), lambda: gelu_ref(x),
            lambda: F.gelu(x, approximate="tanh"), 2 * R * C * 2, 10 * R * C, FP32_FLOPS,
            paired_ms=[t[0] for t in turns], paired_library_ms=[t[1] for t in turns],
            paired_triton_ms=[t[2] for t in turns], median_ratio=statistics.median(ratios),
            model=("gelu", (R * C,)))
        del x

    # SwiGLU at qwen3's and stablelm's MLP width (8 x 512 rows) and at
    # granite's expert buffer at its served wave (E x capacity rows), beside
    # F.silu(g) * u (two PyTorch kernels); the gated GELU at grok's
    from repro_torch.configs import get_config
    granite, grok = get_config("granite-moe-3b-a800m"), get_config("grok-1-314b")
    moe_S = max(moe_lens[:SLOTS])

    def capacity(cfg, T):
        return max(1, int(1.25 * T * cfg.top_k / cfg.n_experts))

    E = granite.n_experts
    R = E * capacity(granite, SLOTS * moe_S)
    for R, C, what in ((4096, 6144, ""), (4096, 5632, ""),
                       (R, granite.d_ff, f" (granite's {E} experts x capacity {R // E} at "
                                         "its served wave)")):
        a, b = rnd((R, C), bf), rnd((R, C), bf)
        add("silu_mul", f"g,u({R},{C}) bf16{what}", lambda: KERNELS["silu_mul"](a, b),
            lambda: silu_mul_ref(a, b), lambda: F.silu(a) * b, 3 * R * C * 2, 5 * R * C,
            FP32_FLOPS, held=bool(what), model=("silu_mul", (R * C,)))

    # gated GELU at recurrentgemma's MLP width: the prefill wave and the
    # decode step, beside F.gelu(g) * u (two PyTorch kernels)
    for R in (4096, SLOTS):
        a, b = rnd((R, 7680), bf) * 3, rnd((R, 7680), bf)
        add("gelu_mul", f"g,u({R},7680) bf16", lambda: KERNELS["gelu_mul"](a, b),
            lambda: gelu_mul_ref(a, b), lambda: F.gelu(a, approximate="tanh") * b,
            3 * R * 7680 * 2, 11 * R * 7680, FP32_FLOPS)
    E, C = grok.n_experts, grok.d_ff
    R = E * capacity(grok, SLOTS * moe_S)
    a, b = rnd((R, C), bf) * 3, rnd((R, C), bf)
    add("gelu_mul", f"g,u({R},{C}) bf16 (grok's {E} experts x capacity {R // E} at its "
        "served wave)", lambda: KERNELS["gelu_mul"](a, b), lambda: gelu_mul_ref(a, b),
        lambda: F.gelu(a, approximate="tanh") * b, 3 * R * C * 2, 11 * R * C, FP32_FLOPS,
        plain_iters=5, held=True)
    del a, b

    time_rglru(torch, add, rnd, griffin_lens)

    # (heads, kv-heads, d_head) of qwen3, stablelm, gpt3 and recurrentgemma
    # (whose window of 2048 reaches past every key at S = 512)
    B, S, T = SLOTS, 512, MAX_LEN
    for Hq, Hkv, D in ((16, 8, 128), (32, 32, 64), (96, 96, 128), (10, 1, 256)):
        q, k, v = rnd((B, Hq, S, D), bf), rnd((B, Hkv, S, D), bf), rnd((B, Hkv, S, D), bf)
        pairs = S * (S + 1) // 2
        label = f"q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) causal bf16"
        work = (2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D), 4 * D * B * Hq * pairs,
                BF16_TENSOR_FLOPS)

        def sdpa():
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

        # the mma.sync kernel (the prefill's before the wgmma one), then the
        # wgmma kernel with the mma.sync kernel's time beside it
        add("flash_attention", label + " on mma.sync",
            lambda: KERNELS["flash_attention"](q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True), sdpa, *work)
        add("flash_attention_wgmma", label,
            lambda: KERNELS["flash_attention_wgmma"](q, k, v, causal=True),
            lambda: attention_ref(q, k, v, causal=True), sdpa, *work,
            mma_sync_ms=rows["flash_attention"]["shapes"][-1]["ms"])
        del q, k, v

        if D == 256:   # the ring phase's prefill: one prompt, the window cuts
            S1, W = RING_PROMPT, 2048
            q, k, v = rnd((1, Hq, S1, D), bf), rnd((1, Hkv, S1, D), bf), rnd((1, Hkv, S1, D), bf)
            pos = torch.arange(S1, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)
            pairs_w = int(band.sum())
            add("flash_attention_wgmma", f"q(1,{Hq},{S1},{D}) kv(1,{Hkv},{S1},{D}) causal "
                f"window {W} bf16 (the ring phase's prefill)",
                lambda: KERNELS["flash_attention_wgmma"](q, k, v, causal=True, window=W),
                lambda: attention_ref(q, k, v, causal=True, window=W),
                lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                                       enable_gqa=True),
                2 * (2 * Hq * S1 * D + 2 * Hkv * S1 * D), 4 * D * Hq * pairs_w,
                BF16_TENSOR_FLOPS, plain_iters=5)
            del q, k, v, band

        # the decode kernels at the model's decode step: the one the op
        # picks, with torch.sum over a contiguous copy of the same live K and
        # V (what reading those bytes costs under this timing's L2 flush),
        # beside the chunked and the split kernel
        G = Hq // Hkv
        lens_list = decode_lengths(SLOTS, T)
        qd = rnd((SLOTS, Hkv, G, D), bf)
        kd, vd = rnd((SLOTS, T, Hkv, D), bf), rnd((SLOTS, T, Hkv, D), bf)
        live = torch.cat([x[b, :n] for x in (kd, vd) for b, n in enumerate(lens_list)])
        time_decode(torch, add, rows, f"q({SLOTS},{Hkv},{G},{D}) kv({SLOTS},{T},{Hkv},{D}) "
                    f"lengths={lens_list} bf16", qd, kd, vd, lens_list,
                    kernels=("decode_attention_chunked", "decode_attention"),
                    sum_of_live_kv_ms=time_ms(torch, lambda: live.sum()))
        del qd, kd, vd, live

    # the MoE models' attention, each held to its plain version here (no
    # kernel case has these shapes): flash at their served wave on the
    # model's transposed views (grok's under its softcap of 30; SDPA takes
    # no softcap, so it runs without one), the decode kernels at their
    # decode step (the mma one the op picks, the chunked and the split one
    # beside it, all under the same softcap) and SDPA (none)
    for cfg in (granite, grok):
        Hq, Hkv, D, cap = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.attn_logit_softcap
        S, G = moe_S, cfg.n_heads // cfg.n_kv_heads
        q, k, v = (attention_input(rnd, shape, bf, "view")
                   for shape in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
        sdpa_note = ", the library call SDPA without it" if cap else ""
        add("flash_attention_wgmma", f"{cfg.name}'s wave q({B},{Hq},{S},{D}) "
            f"kv({B},{Hkv},{S},{D}) view causal softcap {cap:g} bf16{sdpa_note}",
            lambda: KERNELS["flash_attention_wgmma"](q, k, v, causal=True, softcap=cap),
            lambda: attention_ref(q, k, v, causal=True, softcap=cap),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
            2 * (2 * B * Hq * S * D + 2 * B * Hkv * S * D), 4 * D * B * Hq * S * (S + 1) // 2,
            BF16_TENSOR_FLOPS, held=True)
        del q, k, v
        lens_list = decode_lengths(SLOTS, T)
        qd = rnd((SLOTS, Hkv, G, D), bf)
        kd, vd = rnd((SLOTS, T, Hkv, D), bf), rnd((SLOTS, T, Hkv, D), bf)
        time_decode(torch, add, rows, f"{cfg.name}'s decode step q({SLOTS},{Hkv},{G},{D}) "
                    f"kv({SLOTS},{T},{Hkv},{D}) lengths={lens_list} softcap {cap:g} bf16"
                    f"{sdpa_note}", qd, kd, vd, lens_list, cap, held=True)
        del qd, kd, vd

    time_decode_and_cross(torch, add, rows, rnd, cross_lens)

    # granite's whole MoE layer (router, dispatch, the 40 experts' bmm and
    # silu_mul, combine, aux loss) at its decode step and its served wave,
    # against the bytes of its experts and router (and of x and y) and the
    # experts' bf16 products over every buffer row
    from repro_torch.models import layers
    E, d, f = granite.n_experts, granite.d_model, granite.d_ff
    p = layers.moe_init(granite, torch.Generator("cuda").manual_seed(0), "cuda")
    weight_bytes = 3 * E * d * f * 2 + d * E * 4
    moe_layer = []
    for label, rows_in in (("decode step", SLOTS), ("served wave", SLOTS * moe_S)):
        x = rnd((1, rows_in, d), bf)
        C = capacity(granite, rows_in)
        ms = time_ms(torch, lambda: layers.moe_apply(granite, p, x))
        b_ms, b_by = bound(weight_bytes + 2 * rows_in * d * 2, 2 * 3 * E * C * d * f,
                           BF16_TENSOR_FLOPS)
        expert_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
        moe_layer.append({"shape": f"{label}: x({rows_in},{d}), capacity {C}", "ms": ms,
                          "bound_ms": b_ms, "bound_by": b_by, "expert_bytes_ms": expert_ms})
        print(f"[timing] moe_apply        granite's layer at its {label}, x({rows_in},{d}), "
              f"{E} experts x capacity {C}: {ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}); its "
              f"experts' {weight_bytes / 1e6:.1f} MB alone {expert_ms:.5f} ms at 3.35 TB/s "
              f"({expert_ms / ms * 100:.1f}%)")
        del x
    print(f"[timing] moe_apply {json.dumps(moe_layer)}")
    del p

    # wkv at the served rwkv6 run's prefills: its wave and its 8 batch-1
    # refills (data-dependent: the steps of the prompt lengths are counted,
    # the output is written in full), on the chunked kernel at the op's
    # column split, beside the step-by-step kernel (which ran them before)
    # and the chunked kernel at every column split; then the decode step in
    # place on the step-by-step kernel, beside s0.mul_(1.0), which reads and
    # writes the same state in place: the floor of its state traffic under
    # this timing. Per step 5 fp32 operations a state element (an FMA for
    # r.S, a multiply and an FMA for the update) and 2 N for the bonus dot
    # r.(u*k), whose product with v_j is O(N) too
    from repro_torch.kernels.wkv.kernel import COLUMN_SPLITS, chunked_eligible
    H, N = 64, 64

    def wkv_work(lens, T, with_state, H=H, N=N):
        steps, B = sum(lens), len(lens)
        return (4 * steps * H * N * 4 + B * T * H * N * 4
                + B * H * N * N * 4 * (2 if with_state else 1) + H * N * 4,
                5 * steps * H * N * N + 2 * steps * H * N, FP32_FLOPS)

    def wkv_model(B, T):
        # the ScanSpec graph.build_rwkv makes for rwkv6-7b (d = H N, head N)
        d = H * N
        return "recurrent_scan", (T, B, d * N, 6.0 * d * N, 6 * B * T * d * 2)

    wave_lens, refill_lens = prompt_lens[:SLOTS], prompt_lens[SLOTS:]
    refills = {"ms": 0.0, "step_kernel_ms": 0.0, "bound_ms": 0.0}
    for i, lens in enumerate([wave_lens] + [[n] for n in refill_lens]):
        B, T = len(lens), max(lens)
        r, k, v, w, u, _ = wkv_inputs(torch, rnd, B, T, H, N, False)
        lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
        require(chunked_eligible(r, k, v, w), f"wkv ({B},{T}): not on the chunked kernel")
        step_ms = time_ms(torch, lambda: KERNELS["wkv"](r, k, v, w, u, None, lens_t))
        splits = {nc: time_ms(torch, lambda nc=nc: KERNELS["wkv_chunked"](
            r, k, v, w, u, None, lens_t, columns=nc)) for nc in COLUMN_SPLITS[N]}
        label = (f"r,k,v,w ({B},{T},{H},{N}) fp32 lengths={lens}, "
                 + ("the served wave" if i == 0 else f"refill {i} of {len(refill_lens)}"))
        work = wkv_work(lens, T, False)
        if i <= 1 or T == max(refill_lens):   # the wave, the first and the longest refill
            add("wkv_chunked", label, lambda: KERNELS["wkv_chunked"](r, k, v, w, u, None, lens_t),
                lambda: wkv_ref(r, k, v, w, u, None, lens_t), None, *work,
                step_kernel_ms=step_ms, column_split_ms=splits, model=wkv_model(B, T))
            ms = rows["wkv_chunked"]["shapes"][-1]["ms"]
        else:
            ms = time_ms(torch, lambda: KERNELS["wkv_chunked"](r, k, v, w, u, None, lens_t))
            print(f"[timing] wkv_chunked      {label}: kernel {ms:.5f} ms, step-by-step kernel "
                  f"{step_ms:.5f} ms, bound {bound(*work)[0]:.5f} ms")
        print(f"[timing] wkv_chunked      {label}: step-by-step kernel {step_ms:.5f} ms; "
              f"column splits {json.dumps(splits)} ms")
        if i > 0:
            refills["ms"] += ms
            refills["step_kernel_ms"] += step_ms
            refills["bound_ms"] += bound(*work)[0]
        del r, k, v, w
    rows["wkv_chunked"]["refills"] = {"lengths": refill_lens, **refills}
    print(f"[timing] wkv_chunked      the {len(refill_lens)} refills {refill_lens}, summed: "
          f"kernel {refills['ms']:.5f} ms, step-by-step kernel {refills['step_kernel_ms']:.5f} "
          f"ms, bound {refills['bound_ms']:.5f} ms")
    r, k, v, w, u, s0 = wkv_inputs(torch, rnd, SLOTS, 1, H, N, True)
    floor_ms = time_ms(torch, lambda: s0.mul_(1.0))
    one = torch.ones(1, device="cuda")
    launch_ms = time_ms(torch, lambda: one.mul_(1.0))
    add("wkv", f"r,k,v,w ({SLOTS},1,{H},{N}) fp32 state0 in place (decode step)",
        lambda: KERNELS["wkv"](r, k, v, w, u, s0, None, state_out=s0),
        lambda: wkv_ref(r, k, v, w, u, s0, None), None, *wkv_work([1] * SLOTS, 1, True),
        state_mul_floor_ms=floor_ms, launch_floor_ms=launch_ms, model=wkv_model(SLOTS, 1))
    print(f"[timing] wkv              decode step: s0.mul_(1.0) on its ({SLOTS},{H},{N},{N}) "
          f"state, {floor_ms:.5f} ms (the floor of its state traffic here); one.mul_(1.0) on "
          f"one element {launch_ms:.5f} ms (a launch)")
    del r, k, v, w, s0
    # N = 128 (no model has it; ROADMAP C9) on wkv.cu at the [c9] shapes
    for T in (33, 1):
        r, k, v, w, u, s0 = wkv_inputs(torch, rnd, 2, T, 2, 128, True)
        add("wkv", f"r,k,v,w (2,{T},2,128) fp32 state0 in place (C9's N = 128)",
            lambda: KERNELS["wkv"](r, k, v, w, u, s0, None, state_out=s0),
            lambda: wkv_ref(r, k, v, w, u, s0, None), None,
            *wkv_work([T] * 2, T, True, H=2, N=128))
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
    from repro_torch.kernels.matmul.kernel import (E4M3_FORM, INT8_MAX_K, INT8_MMA_SYNC_TILES,
                                                   SIMT_TILES, select_tile, split_plan)
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
                mapper_tile=list(mtile), mapper_tile_ms=mapper_ms, model=("matmul", (M, Kd, N)))
            add("matmul", f"{shape} bf16 on mma.sync, tile {old_tile}",
                lambda: KERNELS["matmul"](a, b, bm=old_tile[0], bk=old_tile[1],
                                          bn=old_tile[2]),
                lambda: matmul_ref(a, b), lambda: torch.matmul(a, b),
                2 * (M * Kd + Kd * N + M * N), ops2, BF16_TENSOR_FLOPS, iters, plain_iters,
                mode="bf16")
            del a, b
            if M == SLOTS or gemm == "ffn_up":
                # the SIMT kernel at the tile the op ran fp32 with before,
                # then the TMA ring's fp32 mode at the op's tile
                work = (4 * (M * Kd + Kd * N + M * N), ops2, FP32_FLOPS, iters, plain_iters)
                tile = select_tile(f32, *request, tiles=SIMT_TILES)
                add("matmul", f"{shape} fp32 on the SIMT kernel, tile {tile}",
                    lambda: KERNELS["matmul"](a32, b32, bm=tile[0], bk=tile[1], bn=tile[2]),
                    lambda: matmul_ref(a32, b32), lambda: torch.matmul(a32, b32), *work,
                    mode="fp32")
                tile = select_tile(f32, *request)
                splits = len(split_plan(M, N, Kd, tile))
                add("matmul_f32_tma", f"{shape} fp32 tile {tile}, {splits} split(s) of K",
                    lambda: KERNELS["matmul_f32_tma"](a32, b32, bm=tile[0], bk=tile[1],
                                                      bn=tile[2]),
                    lambda: matmul_ref(a32, b32), lambda: torch.matmul(a32, b32), *work,
                    mode="fp32", simt_ms=rows["matmul"]["shapes"][-1]["ms"])
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
            int_mm = library_or_none(lambda: torch._int_mm(qa, qb) * sa * sb, f"{shape} int8")
            work = (M * Kd + Kd * N + 4 * (M + N) + 4 * M * N, ops2, INT8_FP8_TENSOR_OPS, iters,
                    plain_iters)
            # the mma.sync kernel at the tile the op ran it with before the
            # wgmma kernel took int8, then the wgmma kernel at the op's tile
            tile = select_tile(torch.int8, *request, tiles=INT8_MMA_SYNC_TILES)
            add("matmul_int8", f"{shape} int8, fp32 out, on mma.sync, tile {tile}",
                lambda: KERNELS["matmul_int8"](qa, qb, sa, sb, bm=tile[0], bk=tile[1],
                                               bn=tile[2]),
                lambda: dequant_matmul_ref(qa, qb, sa, sb), int_mm, *work, mode="int8")
            tile = select_tile(torch.int8, *request)
            splits = len(split_plan(M, N, Kd, tile, INT8_MAX_K))
            add("matmul_int8_wgmma", f"{shape} int8, fp32 out, tile {tile}, {splits} split(s) "
                "of K",
                lambda: KERNELS["matmul_int8_wgmma"](qa, qb, sa, sb, bm=tile[0], bk=tile[1],
                                                     bn=tile[2]),
                lambda: dequant_matmul_ref(qa, qb, sa, sb), int_mm, *work, mode="int8",
                mma_sync_ms=rows["matmul_int8"]["shapes"][-1]["ms"])
            del qa, qb, a32, b32
            torch.cuda.empty_cache()
    # the fp16 mode (ROADMAP C9) at gpt3's out GEMM for the decode batch
    M, Kd, N = SLOTS, 12288, 12288
    a, b = rnd((M, Kd), torch.float16), rnd((Kd, N), torch.float16)
    tile = select_tile(torch.float16, min(256, M), min(512, Kd), min(256, N))
    splits = len(split_plan(M, N, Kd, tile))
    add("matmul_wgmma", f"gpt3-175b out ({M},{Kd})x({Kd},{N}) fp16 tile {tile}, {splits} "
        "split(s) of K (C9's fp16 mode)",
        lambda: KERNELS["matmul_wgmma"](a, b, bm=tile[0], bk=tile[1], bn=tile[2]),
        lambda: matmul_ref(a, b), lambda: torch.matmul(a, b), 2 * (M * Kd + Kd * N + M * N),
        2 * M * Kd * N, BF16_TENSOR_FLOPS, mode="fp16")
    return [rows[name] for name in SOURCES], models


def signed_err(pred, meas):
    return (pred - meas) / meas


def phase_analytic(rows, models, measured):
    """The analytical model (``repro_torch.core``) beside the card's times,
    each prediction held to the measurement that covers what it prices.
    ``nvidia_h100()`` adds a launch overhead to every kernel it prices, and
    a time on the card leaves the host's launches out (a kernel timed by
    ``time_ms`` behind a card sleep; a model step as the sum of its
    device-side events under torch.profiler), so the error against the card
    is that of the card's work: the same Device with its
    ``kernel_launch_overhead_s`` set to 0. The full prediction, launch
    overhead included, is held to wall time, which holds the host's
    launches and the rest of its work too. Errors are signed,
    (pred - meas) / meas.

    Per operator: each timed shape the timing phase tagged with its
    counterpart in ``core/operators.py`` (`models`, keyed by kernel and
    shape: the function and its arguments, for the scans those
    ``graph.build_rwkv`` and ``build_rglru`` pass), against the hand-written
    kernel's ms and the library call's, and the mean |error| over the rows,
    the paper's statistic. End to end: for each served model at its served
    depth, ``inference_model.decode_step`` at SLOTS slots and a cache of 513
    (the profile's decode step) and ``inference_model.prefill`` at the
    served wave's padded length, against that step's or wave's device-busy
    and wall ms; the card's work also under the fused + flash execution
    (epilogues fused into their GEMMs, attention scores streamed on chip),
    the form the port's flash kernel runs. The model is numpy on the host;
    the phase's own wall time is printed."""
    from repro_torch.core import operators
    from repro_torch.core import inference_model as im
    from repro_torch.core.evaluator import Evaluator
    from repro_torch.core.fusion import FusionPolicy
    from repro_torch.core.graph import Plan
    from repro_torch.core.hardware import make_system, nvidia_h100
    t0 = time.perf_counter()
    dev = nvidia_h100()
    work_dev = dataclasses.replace(dev, kernel_launch_overhead_s=0.0)
    overhead_ms = dev.kernel_launch_overhead_s * 1e3
    op_rows = []
    for row in rows:
        for shape in row["shapes"]:
            if (row["name"], shape["shape"]) not in models:
                continue
            op, args = models[(row["name"], shape["shape"])]
            r = getattr(operators, op)(dev, *args)
            w = getattr(operators, op)(work_dev, *args)
            pred, work = r.latency * 1e3, w.latency * 1e3
            require(all(math.isfinite(x) and x > 0 for x in (pred, work)),
                    f"{op}{tuple(args)}: predictions {pred}, {work}")
            lib = shape["library_ms"]
            out = {"kernel": row["name"], "shape": shape["shape"], "op": op, "args": list(args),
                   "pred_ms": pred, "pred_bound": r.bound, "work_ms": work,
                   "work_bound": w.bound, "kernel_ms": shape["ms"],
                   "kernel_err": signed_err(work, shape["ms"]), "library_ms": lib,
                   "library_err": signed_err(work, lib) if lib is not None else None,
                   "card_bound_ms": shape["bound_ms"], "card_bound_by": shape["bound_by"]}
            note = ""
            if "mapper_tile_ms" in shape:
                out["mapper_tile"] = shape["mapper_tile"]
                out["mapper_tile_ms"] = shape["mapper_tile_ms"]
                out["mapper_tile_err"] = signed_err(work, shape["mapper_tile_ms"])
                note = (f"; at the tile mapper_blocks picks {tuple(shape['mapper_tile'])} "
                        f"{shape['mapper_tile_ms']:.5f} ms, error {out['mapper_tile_err']:+.1%}")
            lib_s = (f"library {lib:.5f} ms, error {out['library_err']:+.1%}"
                     if lib is not None else "library none")
            print(f"[analytic] {op:14s} {shape['shape']}: nvidia_h100() predicts {pred:.5f} ms "
                  f"({r.bound}), of it {work:.5f} ms the card's work ({w.bound}) and "
                  f"{overhead_ms:.4f} ms launch overhead; kernel {row['name']} "
                  f"{shape['ms']:.5f} ms, error {out['kernel_err']:+.1%}; {lib_s}; "
                  f"the card's bound {shape['bound_ms']:.5f} ms ({shape['bound_by']}){note}")
            op_rows.append(out)
    for op, n in (("matmul", 2 * len(GPT3_GEMMS)), ("rmsnorm", 2), ("layernorm", 2),
                  ("gelu", 2), ("silu_mul", 3), ("recurrent_scan", 4)):
        require(sum(r["op"] == op for r in op_rows) >= n,
                f"[analytic] fewer than {n} timed {op} shapes")
    kernel_mae = statistics.fmean(abs(r["kernel_err"]) for r in op_rows)
    libs = [abs(r["library_err"]) for r in op_rows if r["library_err"] is not None]
    print(f"[analytic] operators: mean |error| of the card's work {kernel_mae:.1%} against the "
          f"hand-written kernels over {len(op_rows)} timed shapes, "
          f"{statistics.fmean(libs):.1%} against the library calls over the {len(libs)} that "
          f"have one (the paper: 10.4% on an A100)")

    system, work_system = make_system(dev, 1), make_system(work_dev, 1)
    ev, work_ev = Evaluator(system), Evaluator(work_system)
    flash = FusionPolicy(fuse_epilogues=True, flash_stream=True)
    e2e_rows = []
    for arch, n_layers in SERVED:
        cfg, m = served_config(arch, n_layers), measured[arch]
        require(m["prefill_device_ms"] > 0 and m["decode_device_ms"] > 0,
                f"{cfg.name}: the profiler traced no device time")
        out = {"model": cfg.name, "wave_S": m["wave_S"],
               "device_busy": m["decode_device_ms"] / m["decode_wall_ms"]}
        for step, price, arg in (("decode", im.decode_step, 513),
                                 ("prefill", im.prefill, m["wave_S"])):
            rep = price(system, cfg, Plan(), SLOTS, arg, evaluator=ev)
            work = price(work_system, cfg, Plan(), SLOTS, arg, evaluator=work_ev)
            flash_ms = price(work_system, cfg, Plan(), SLOTS, arg, evaluator=work_ev,
                             fusion=flash).latency * 1e3
            pred, work_ms = rep.latency * 1e3, work.latency * 1e3
            require(all(math.isfinite(x) and x > 0 for x in (pred, work_ms, flash_ms)),
                    f"{cfg.name} {step}: predictions {pred}, {work_ms}, {flash_ms}")
            dev_ms, wall_ms = m[f"{step}_device_ms"], m[f"{step}_wall_ms"]
            out.update({f"{step}_pred_ms": pred, f"{step}_work_ms": work_ms,
                        f"{step}_work_bound": work.dominant,
                        f"{step}_overhead_ms": pred - work_ms,
                        f"{step}_device_ms": dev_ms, f"{step}_wall_ms": wall_ms,
                        f"{step}_device_err": signed_err(work_ms, dev_ms),
                        f"{step}_wall_err": signed_err(pred, wall_ms),
                        f"{step}_flash_work_ms": flash_ms,
                        f"{step}_flash_device_err": signed_err(flash_ms, dev_ms)})
            what = (f"decode step at {SLOTS} slots, cache 513" if step == "decode"
                    else f"wave prefill {SLOTS} x {m['wave_S']}")
            print(f"[analytic] end to end {cfg.name}: {what}: the card's work predicted "
                  f"{work_ms:.4f} ms ({work.dominant}), device busy {dev_ms:.4f} ms, error "
                  f"{out[f'{step}_device_err']:+.1%}; with {pred - work_ms:.4f} ms of launch "
                  f"overhead ({(pred - work_ms) / pred:.1%}) predicted {pred:.4f} ms, wall "
                  f"{wall_ms:.4f} ms, error {out[f'{step}_wall_err']:+.1%}; fused + flash work "
                  f"{flash_ms:.4f} ms, error {out[f'{step}_flash_device_err']:+.1%} against "
                  f"device busy")
        print(f"[analytic] end to end {cfg.name}: the decode step's device busy share "
              f"{out['device_busy']:.1%} ({'host' if out['device_busy'] < 0.9 else 'device'}"
              f"-bound)")
        e2e_rows.append(out)
    mae = {k: statistics.fmean(abs(r[k]) for r in e2e_rows)
           for k in ("decode_device_err", "decode_wall_err", "prefill_device_err",
                     "prefill_wall_err", "decode_flash_device_err", "prefill_flash_device_err")}
    seconds = time.perf_counter() - t0
    print(f"[analytic] end to end: mean |error| over the {len(e2e_rows)} served models: "
          f"the card's work against device busy: decode step {mae['decode_device_err']:.1%}, "
          f"wave prefill {mae['prefill_device_err']:.1%}; the prediction with launch "
          f"overhead against wall time: decode step {mae['decode_wall_err']:.1%}, wave prefill "
          f"{mae['prefill_wall_err']:.1%} (the paper: 4.1% on an A100); fused + flash work "
          f"against device busy: decode step {mae['decode_flash_device_err']:.1%}, wave "
          f"prefill {mae['prefill_flash_device_err']:.1%}; the phase took {seconds:.2f} s")
    print("[analytic] " + json.dumps({"operators": op_rows, "operators_mean_abs_err": kernel_mae,
                                      "library_mean_abs_err": statistics.fmean(libs),
                                      "end_to_end": e2e_rows, "end_to_end_mean_abs_err": mae,
                                      "seconds": seconds}))


# ---------------------------------------------------------------------------
# training: the backward kernels, the train step, checkpoints
# ---------------------------------------------------------------------------

# the backward kernels of a train step: (route, source, the TPU kernel whose
# function they differentiate; the JAX package differentiates in XLA and
# has no backward kernel)
BACKWARD = {
    "flash_attention_bwd_wgmma": ("cuda",
                                  "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
                                  "src/repro/kernels/flash_attention/kernel.py:71"),
    "flash_attention_bwd": ("cuda", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                            "src/repro/kernels/flash_attention/kernel.py:71"),
    "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                    "src/repro/kernels/rmsnorm/kernel.py:32"),
    "silu_mul_bwd": ("triton", "src/repro_torch/kernels/gelu/kernel.py",
                     "src/repro/kernels/gelu/kernel.py:43"),
    "layernorm_bwd": ("cuda", "src/repro_torch/kernels/csrc/layernorm_bwd.cu",
                      "src/repro/kernels/rmsnorm/kernel.py:48"),
    "layernorm_bwd_triton": ("triton", "src/repro_torch/kernels/rmsnorm/kernel.py",
                             "src/repro/kernels/rmsnorm/kernel.py:48"),
    "gelu_bwd": ("cuda", "src/repro_torch/kernels/csrc/gelu.cu",
                 "src/repro/kernels/gelu/kernel.py:29"),
    "gelu_mul_bwd": ("cuda", "src/repro_torch/kernels/csrc/gelu.cu",
                     "src/repro/models/layers.py:341"),
    "rglru_bwd": ("cuda", "src/repro_torch/kernels/csrc/rglru_bwd.cu",
                  "src/repro/models/recurrent.py:206"),
    "wkv_bwd": ("cuda", "src/repro_torch/kernels/csrc/wkv_bwd.cu",
                "src/repro/kernels/wkv/kernel.py:51"),
}
# the backward checks beyond the three of the first train slice: LayerNorm
# (R, C, pad: rows C + pad elements apart, dtype, the route) at stablelm's,
# gpt3's and whisper's decoder and encoder rows, an odd shape and fp32 (the
# ring kernel), rwkv6's rows, a ragged row and two pitches off 16 bytes (the
# Triton kernel; at rwkv6's rows the ring kernel is held too);
# GELU at gpt3's MLP, the gated GELU at recurrentgemma's MLP and grok's
# expert buffer
LN_BWD_CHECKS = ((4096, 2048, 0, "bf16", "layernorm_bwd"),
                 (4096, 12288, 0, "bf16", "layernorm_bwd"),
                 (4096, 4096, 0, "bf16", "layernorm_bwd_triton"),   # the ring runs slower
                 (4096, 384, 0, "bf16", "layernorm_bwd"), (12000, 384, 0, "bf16", "layernorm_bwd"),
                 (33, 2100, 0, "bf16", "layernorm_bwd_triton"),     # a 4200-byte row
                 (300, 2048, 2, "bf16", "layernorm_bwd_triton"),    # a 4100-byte pitch
                 (4096, 384, 2, "bf16", "layernorm_bwd_triton"),    # a 772-byte pitch
                 (4099, 896, 0, "bf16", "layernorm_bwd"), (1000, 2048, 0, "fp32", "layernorm_bwd"))
GELU_BWD_CHECKS = (("gelu_bwd", (4096, 49152), "bf16"), ("gelu_bwd", (3, 1001), "bf16"),
                   ("gelu_bwd", (1000, 1536), "fp32"), ("gelu_mul_bwd", (4096, 7680), "bf16"),
                   ("gelu_mul_bwd", (8720, 32768), "bf16"), ("gelu_mul_bwd", (3, 1001), "bf16"),
                   ("gelu_mul_bwd", (1000, 1536), "fp32"))
LN_BWD_TIMED = ((4096, 2048, "stablelm-1.6b"), (4096, 12288, "gpt3-175b"),
                (4096, 4096, "rwkv6-7b"), (4096, 384, "whisper-tiny decoder"),
                (8 * 1500, 384, "whisper-tiny encoder"))
# the Triton route's row in the kernel table: rwkv6-7b's, which the router
# sends it (one chunk of its chunked kernel a row ran faster than the ring)
LN_BWD_TRITON_TIMED = (4096, 4096)
GELU_BWD_TIMED = (("gelu_bwd", (4096, 49152), "gpt3-175b MLP"),
                  ("gelu_mul_bwd", (4096, 7680), "recurrentgemma-2b MLP"),
                  ("gelu_mul_bwd", (8720, 32768), "grok-1-314b expert buffer"))
# the full-size runs: one repeated batch of TRAIN_BATCH x TRAIN_SEQ tokens,
# TRAIN_STEPS steps of AdamW at a constant rate each. qwen3: at 1e-3 and 3e-4
# the freshly initialised model's loss rose at step 2 (Adam's first steps
# move every weight by about the rate), at 5e-5 it falls at each step; the
# narrow whisper-tiny falls ~0.04 a step at 5e-5 and takes 3e-4; the
# 10-layer llama fell from 12.56 to 0.10 in one step at 5e-5, and at 1e-5
# reached 0.040 at step 5 and rose at step 7: it takes 2.5e-6 (H100 runs);
# recurrentgemma-2b at 5e-5 fell to 0.039 at step 2 and rose at step 3, and
# grok-1l-4e to 0.065 at step 3 and rose after: both take 1e-5.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 8
# the profiled run traces its last PROFILED_STEPS steps (the profiler adds
# ~6 s of host time to each of qwen3's steps)
PROFILED_STEPS = 2
# (arch, layers or None for all, rate, the second run: "profile" under
# torch.profiler, "rerun" to see whether the losses repeat bit for bit, or
# None). Depths, reckoned at 14 bytes a parameter after init (bf16 weight,
# fp32 master, m and v) and 16 with the gradients, with 8 GiB of the card's
# 79.6 GiB left free; peaks are an H100 run's:
#   qwen3-1.7b whole: 1.72 G parameters, 24 GiB; peak 41.8 GiB;
#   stablelm-1.6b whole: 1.64 G, 24.5 GiB; peak 35.3 GiB;
#   granite-moe-3b-a800m whole: 3.30 G, 49 GiB with the gradients, plus ~0.6
#     GiB of expert buffers a layer; peak 63.3 GiB;
#   gpt3-175b 1 of 96 layers: 3.05 G (the untied embedding and head are 1.24
#     G), 45 GiB; 2 layers would be 4.86 G and 72 GiB, which does not fit;
#   whisper-tiny whole: 56 M; peak 5.7 GiB;
#   llama-3.2-vision-11b 10 of 40 layers (2 of its 5-layer units, cross
#     layers 3 and 8): 3.23 G, 48 GiB; peak 57.6 GiB, ~3 GiB more a layer, so
#     15 layers (4.32 G, 64 GiB) would peak near 72.6 GiB, past 71.6.
#   recurrentgemma-2b whole: 2.89 G parameters, 40 GiB with the gradients;
#   grok-1-314b 1 of 64 layers with 4 of its 8 experts (top-2 kept): 4.11 G,
#     57 GiB with the gradients; all 8 experts would be 6.53 G, 91 GB
#     before any activation, past the card.
#   rwkv6-7b 15 of 32 layers: 0.537 G of embedding and head and 0.2019 G a
#     layer, 3.57 G; 16 layers (3.77 G) peaked at 76.30 GiB in an H100 run,
#     past ~75, so one layer (~4 GiB with its activations) less; all 32
#     would be 7.00 G, ~98 GB before any activation. At 1e-5 its loss
#     fell from 11.93 to 0.10 in 8 steps, at 3e-6 to 5.97.
TRAIN_RUNS = (("qwen3-1.7b", None, 5e-5, "profile"), ("stablelm-1.6b", None, 5e-5, None),
              ("granite-moe-3b-a800m", None, 5e-5, "rerun"), ("gpt3-175b", 1, 5e-5, "profile"),
              ("whisper-tiny", None, 3e-4, None), ("llama-3.2-vision-11b", 10, 2.5e-6, None),
              ("recurrentgemma-2b", None, 1e-5, "profile"), ("grok-1-314b", 1, 1e-5, None, 4),
              ("rwkv6-7b", 15, 1e-5, "profile"))
# the gradient checks: (arch, layers or None, batch, sequence), full width at
# a cut the CPU runs in seconds; per leaf the card no further from an fp32
# CPU run than TRAIN_FP32_FACTOR times the bf16 CPU path is (the rule
# llama's logits follow, MODEL_CHECKS), the loss within 2e-2 of the bf16 CPU
# path's; cross-attending models with a seeded stub frontend and their
# cross branch unhidden (``unhide_cross_attention``), granite with the CPU's
# routing replayed on the card and in the fp32 run
# (recurrentgemma at its 3-layer unit past its 2048 window, its RG-LRU
# decays unhidden; grok at 1 layer with 4 of its 8 experts, with an extra
# field for the experts)
TRAIN_CHECKS = (("qwen3-1.7b", 2, 2, 128), ("stablelm-1.6b", 2, 2, 64),
                ("granite-moe-3b-a800m", 2, 2, 64), ("gpt3-175b", 1, 2, 16),
                ("whisper-tiny", None, 2, 128), ("llama-3.2-vision-11b", 5, 2, 32),
                ("recurrentgemma-2b", 3, 1, 2304), ("grok-1-314b", 1, 2, 16, 4),
                ("rwkv6-7b", 2, 1, 256))
TRAIN_FP32_FACTOR = 1.5
KEY_BIAS_LIMIT = 0.1   # the key bias's gradient over its query bias's (0 exactly)
CKPT_ARCH, CKPT_STEPS, CKPT_AT, CKPT_BATCH, CKPT_SEQ = "qwen3-1.7b", 6, 2, 8, 256
# the flash backward under a window, a softcap and at D = 256: (B, Hq, Hkv,
# S, D, window, softcap, q scale, what); q scaled where a softcap is on, so
# that the logits (about 8) bend under it; timed where `what` is set
FLASH_BWD_MODES = (
    (8, 10, 1, 512, 256, 2048, 0.0, 1.0, "recurrentgemma-2b train shape (window 2048 past S)"),
    (1, 10, 1, 4096, 256, 2048, 0.0, 1.0, "recurrentgemma-2b past its window (cuts)"),
    (2, 8, 2, 333, 64, 32, 0.0, 1.0, None), (2, 8, 2, 301, 128, 48, 0.0, 1.0, None),
    (1, 4, 2, 777, 64, 48, 0.0, 1.0, None), (2, 6, 2, 419, 128, 32, 0.0, 1.0, None),
    (8, 48, 8, 512, 128, 0, 30.0, 8.0, "grok-1-314b train shape (softcap 30)"),
    (2, 8, 2, 400, 128, 100, 20.0, 6.0, None), (1, 10, 1, 700, 256, 200, 30.0, 8.0, None),
    (2, 10, 1, 333, 256, 0, 30.0, 8.0, None), (1, 10, 1, 77, 256, 40, 0.0, 1.0, None))
# the RG-LRU backward: (B, T, h0 and the final state's gradient given, what)
RGLRU_BWD_CHECKS = ((8, 512, False, "recurrentgemma-2b train shape"), (2, 333, True, None))
# the wkv backward at 64 heads of 64: (B, T, state0 given, what); the final
# state's gradient given in each
WKV_BWD_CHECKS = ((8, 512, False, "rwkv6-7b train shape"), (1, 333, True, None),
                  (2, 90, True, None))


def flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, causal, window=0, softcap=0.0,
                     q_scale=1.0):
    """q (times `q_scale`), k, v, do as the model's transposed (B, S, H, D)
    views, and o and the rows' log-sum-exp from the forward kernel as a
    train step runs it."""
    from repro_torch.kernels.flash_attention.kernel import attention_cuda
    bf = torch.bfloat16
    q, k, v, do = (rnd((B, S, h, D), bf).transpose(1, 2) for h in (Hq, Hkv, Hkv, Hq))
    if q_scale != 1.0:
        q = (q * q_scale).transpose(1, 2).contiguous().transpose(1, 2)
    o, lse = attention_cuda(q, k, v, causal=causal, window=window, softcap=softcap,
                            with_lse=True)
    return q, k, v, o, do, lse


def wkv_train_inputs(torch, rnd, B, T, with_state):
    """r, k, v, dout normal, w across (0.05, 0.999) (the init's w0 = -6
    would put every decay near 0.9975 and hide them), u at the init's scale
    of 0.3, state0 normal if asked and the final state's gradient normal;
    all fp32 at 64 heads of 64."""
    f32 = torch.float32
    shape = (B, T, 64, 64)
    r, k, v, dout = (rnd(shape, f32) for _ in range(4))
    w = 0.05 + 0.949 * torch.rand(shape, generator=rnd.gen, device="cuda")
    s0 = rnd((B, 64, 64, 64), f32) if with_state else None
    return r, k, v, w, rnd((64, 64), f32) * 0.3, s0, dout, rnd((B, 64, 64, 64), f32)


def wkv_segment_states(torch, r, k, v, w, s0, steps):
    """The plain states at the start of every segment of `steps` steps,
    (B, H, segments, N, N)."""
    B, T, H, N = r.shape
    S = torch.zeros((B, H, N, N), device=r.device) if s0 is None else s0.clone()
    out = []
    for t in range(T):
        if t % steps == 0:
            out.append(S)
        S = S * w[:, t, :, :, None] + k[:, t, :, :, None] * v[:, t, :, None, :]
    return torch.stack(out, 2)


def live_pairs(S, window):
    """The (query, key) pairs of a causal head of S rows that a window (0:
    none) leaves live."""
    if not window or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def band_mask(torch, S, window):
    """The (S, S) bool mask of a causal window, True where a key is live: the
    window as SDPA takes it."""
    i = torch.arange(S, device="cuda")
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def phase_bwd(torch):
    """Each backward kernel against its plain version on the card (relative
    error to the largest output below TOL; the RMSNorm and SwiGLU ones also
    within one bf16 rounding per element, their dg sums to 2e-5), then
    timed at the training shapes beside its plain version and the backward
    half of one PyTorch call through torch.autograd.grad, with its bound.
    Returns the rows of the ``kernels`` summary (launches filled by the
    train phase)."""
    import torch.nn.functional as F
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    from repro_torch.kernels.gelu.ref import gelu_bwd_ref, gelu_mul_bwd_ref, silu_mul_bwd_ref
    from repro_torch.kernels.rglru.ref import rglru_bwd_ref
    from repro_torch.kernels.rmsnorm.ref import layernorm_bwd_ref, rmsnorm_bwd_ref
    bf, f32 = torch.bfloat16, torch.float32
    rnd = Inputs(torch, 11)
    errs = dict.fromkeys(BACKWARD, 0.0)

    def held(name, label, dt, got, want, tol=None, elementwise=False):
        torch.cuda.synchronize()
        tol = tol or TOL[dt]
        err = rel_err(got, want)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{name} {label}: {tuple(got.shape)} {got.dtype} vs plain "
                f"{tuple(want.shape)} {want.dtype}")
        require(err < tol, f"{name} {label}: rel_err {err:.3e} >= {tol:g}")
        if elementwise:
            require(within_one_rounding(got, want),
                    f"{name} {label}: an element is off by more than one bf16 rounding")
        errs[name] = max(errs[name], max_abs(got, want))
        return f"{err:.3e}"

    # (B, Hq, Hkv, S, D, causal): qwen3-1.7b's training shape, qwen2-0.5b's
    # 14:2 heads at D 64, lengths that cut a 64- and a 128-row tile,
    # non-causal; both backward kernels, the wgmma one given the forward's
    # log-sum-exp L, which is held to the plain one first
    for B, Hq, Hkv, S, D, causal in ((8, 16, 8, 512, 128, True), (8, 14, 2, 512, 64, True),
                                     (2, 16, 8, 333, 128, True), (2, 14, 2, 200, 64, False),
                                     (1, 8, 8, 130, 128, False), (2, 14, 2, 130, 64, True)):
        q, k, v, o, do, lse = flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, causal)
        label = f"q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) causal={causal}"
        want_lse = attention_lse_ref(q, k, causal=causal)
        e_lse = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        require(e_lse < TOL["float32"], f"forward L {label}: error {e_lse:.3e}")
        require(torch.equal(KERNELS["flash_attention_wgmma"](q, k, v, causal=causal), o),
                f"forward {label}: the served forward (no L) differs from the one writing L")
        want = attention_bwd_ref(q, k, v, o, do, causal=causal)
        for name, run in (("flash_attention_bwd_wgmma",
                           lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse,
                                                                         causal=causal)),
                          ("flash_attention_bwd",
                           lambda: KERNELS["flash_attention_bwd"](q, k, v, o, do,
                                                                   causal=causal))):
            got = run()
            e = [held(name, label, "bfloat16", g, w) for g, w in zip(got, want)]
            again = run()
            require(all(torch.equal(a, g) for a, g in zip(again, got)),
                    f"{name} {label}: dq, dk or dv differ from run to run")
            print(f"[bwd] {name} {label}, model views: rel_err dq {e[0]}, dk {e[1]}, "
                  f"dv {e[2]} (tol {TOL['bfloat16']:g}), the same bits in a second run ok")
        print(f"[bwd] flash forward {label}: L within {e_lse:.3e} of the plain one (fp32 "
              f"{TOL['float32']:g}, relative to max(|L|, 1)); the served forward without L "
              "gives the same output bits ok")
    # the modes a window, a softcap and D = 256 open (recurrentgemma-2b,
    # grok-1-314b), on the wgmma backward; then the mma.sync one under a
    # window and a softcap at a sequence stride TMA cannot take (D + 4)
    for B, Hq, Hkv, S, D, window, cap, qs, _ in FLASH_BWD_MODES:
        kw = dict(causal=True, window=window, softcap=cap)
        q, k, v, o, do, lse = flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, True, window, cap,
                                               qs)
        label = (f"q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) window={window} softcap={cap:g}"
                 + (f" q x{qs:g}" if qs != 1.0 else ""))
        want_lse = attention_lse_ref(q, k, **kw)
        e_lse = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        require(e_lse < TOL["float32"], f"forward L {label}: error {e_lse:.3e}")
        want = attention_bwd_ref(q, k, v, o, do, **kw)
        run = lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse, **kw)
        got = run()
        e = [held("flash_attention_bwd_wgmma", label, "bfloat16", g, w) for g, w in zip(got, want)]
        excess = max(grad_excess(g, w) for g, w in zip(got, want))
        require(excess <= 1, f"flash_attention_bwd_wgmma {label}: per-element excess {excess:.3f}")
        again = run()
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"flash_attention_bwd_wgmma {label}: dq, dk or dv differ from run to run")
        print(f"[bwd] flash_attention_bwd_wgmma {label}, model views: rel_err dq {e[0]}, dk "
              f"{e[1]}, dv {e[2]} (tol {TOL['bfloat16']:g}), per-element excess {excess:.3f} "
              f"(<= 1), the same bits in a second run; forward L within {e_lse:.3e} ok")
        del q, k, v, o, do, lse, want, got, again
    for D, window, cap in ((64, 32, 0.0), (128, 0, 30.0), (128, 64, 20.0)):
        q, k, v, do = (rnd((2, h, 300, D + 4), bf)[..., :D] for h in (8, 2, 2, 8))
        q = q * 6
        kw = dict(causal=True, window=window, softcap=cap)
        label = f"q(2,8,300,{D}) kv(2,2,300,{D}) sequence stride {D + 4} window={window} " \
                f"softcap={cap:g}"
        o = KERNELS["flash_attention"](q, k, v, **kw)
        want = attention_bwd_ref(q, k, v, o, do, **kw)
        got = KERNELS["flash_attention_bwd"](q, k, v, o, do, **kw)
        e = [held("flash_attention_bwd", label, "bfloat16", g, w) for g, w in zip(got, want)]
        excess = max(grad_excess(g, w) for g, w in zip(got, want))
        require(excess <= 1, f"flash_attention_bwd {label}: per-element excess {excess:.3f}")
        again = KERNELS["flash_attention_bwd"](q, k, v, o, do, **kw)
        require(all(torch.equal(a, g) for a, g in zip(again, got)),
                f"flash_attention_bwd {label}: dq, dk or dv differ from run to run")
        print(f"[bwd] flash_attention_bwd {label}: rel_err dq {e[0]}, dk {e[1]}, dv {e[2]}, "
              f"per-element excess {excess:.3f}, the same bits in a second run ok")
    # the RG-LRU backward at recurrentgemma's width, ga at -40 on a quarter
    # of the channels (the clamp holds there), from the segments' states
    # the chunked forward wrote
    from repro_torch.kernels.rglru.kernel import segment_steps, segments
    for B, T, given, _ in RGLRU_BWD_CHECKS:
        u, ga, gx, lam, gate, h0 = rglru_inputs(torch, rnd, B, T, 2560, given)
        ga[..., :640] = -40.0
        dy = rnd((B, T, 2560), f32)
        dh_last = rnd((B, 2560), f32) if given else None
        steps = segment_steps(T)
        h_seg = torch.empty((B, segments(T, steps), 2560), device="cuda")
        KERNELS["rglru_chunked"](u, ga, gx, lam, gate, h0, h_seg=h_seg)
        run = lambda: KERNELS["rglru_bwd"](u, ga, gx, lam, gate, h_seg, dy, dh_last,
                                           with_dh0=given)
        got, want = run(), rglru_bwd_ref(u, ga, gx, lam, gate, h0, dy, dh_last)
        # the fp32 gradients to RGLRU_TOL; the bf16 du and dgate (each side
        # rounds its fp32 value once) within one bf16 rounding per element
        names = ("du", "dga", "dgx", "dlam", "dgate", "dh0")
        e = [held("rglru_bwd", f"({B},{T},2560) {n}", "bfloat16", g, w, elementwise=True)
             if w.dtype == bf else
             held("rglru_bwd", f"({B},{T},2560) {n}", "float32", g, w, tol=RGLRU_TOL)
             for n, g, w in zip(names, got, want) if w is not None]
        again = run()
        require(all(a is None or torch.equal(a, g) for a, g in zip(again, got)),
                f"rglru_bwd ({B},{T}): a gradient differs from run to run")
        print(f"[bwd] rglru_bwd u,gate,ga,gx,dy ({B},{T},2560), {steps} steps a segment"
              + (", h0 and the final state's gradient given" if given else "")
              + ": rel_err " + ", ".join(f"{n} {x}" for n, x in zip(names, e))
              + f" (fp32 {RGLRU_TOL:g}; the bf16 du and dgate within one bf16 rounding per "
              "element), the same bits in a second run ok")
        del u, ga, gx, gate, dy, h_seg, got, want, again
    # the wkv backward at 64 heads of 64, from the segments' states the
    # chunked forward wrote (held first to the plain states there), decays
    # across (0.05, 0.999), u at the init's scale, the final state's gradient
    from repro_torch.kernels.wkv.kernel import SEGMENT_STEPS, segments as wkv_segments
    from repro_torch.kernels.wkv.ref import wkv_bwd_ref, wkv_ref
    for B, T, given, _ in WKV_BWD_CHECKS:
        r, k, v, w, u, s0, dout, dstate = wkv_train_inputs(torch, rnd, B, T, given)
        s_seg = torch.empty((B, 64, wkv_segments(T), 64, 64), device="cuda")
        out, state = KERNELS["wkv_chunked"](r, k, v, w, u, s0, s_seg=s_seg)
        served = KERNELS["wkv_chunked"](r, k, v, w, u, s0)
        require(torch.equal(out, served[0]) and torch.equal(state, served[1]),
                f"wkv_chunked ({B},{T}): the output with s_seg differs from the served one's")
        e_seg = rel_err(s_seg, wkv_segment_states(torch, r, k, v, w, s0, SEGMENT_STEPS))
        e_out = rel_err(out, wkv_ref(r, k, v, w, u, s0)[0])
        require(e_seg < WKV_TOL and e_out < WKV_TOL, f"wkv_chunked ({B},{T}) with s_seg: "
                f"rel_err states {e_seg:.3e}, out {e_out:.3e} (tol {WKV_TOL:g})")
        run = lambda: KERNELS["wkv_bwd"](r, k, v, w, u, s_seg, dout, dstate, with_dstate0=given)
        got, want = run(), wkv_bwd_ref(r, k, v, w, u, s0, dout, dstate)
        names = ("dr", "dk", "dv", "dw", "du", "dstate0")
        e = [held("wkv_bwd", f"({B},{T},64,64) {n}", "float32", g, x, tol=WKV_TOL)
             for n, g, x in zip(names, got, want) if x is not None]
        again = run()
        require(all(a is None or torch.equal(a, g) for a, g in zip(again, got)),
                f"wkv_bwd ({B},{T}): a gradient differs from run to run")
        print(f"[bwd] wkv_chunked ({B},{T},64,64) with s_seg: the states at the "
              f"{wkv_segments(T)} segments' starts within {e_seg:.3e} of the plain ones, its "
              f"output within {e_out:.3e} and the served call's bits (tol {WKV_TOL:g}) ok")
        print(f"[bwd] wkv_bwd r,k,v,w,dout ({B},{T},64,64), {SEGMENT_STEPS} steps a segment, "
              "w in (0.05, 0.999), the final state's gradient given"
              + (", state0 given" if given else "") + ": rel_err "
              + ", ".join(f"{n} {x}" for n, x in zip(names, e))
              + f" (fp32 {WKV_TOL:g}), the same bits in a second run ok")
        del r, k, v, w, dout, dstate, s_seg, got, want, again, out, state, served
    torch.cuda.empty_cache()
    for R, C, dt in ((4096, 2048, bf), (65536, 128, bf), (32768, 128, bf), (4099, 896, bf),
                     (1000, 2048, f32)):
        x, g, dy = rnd((R, C), dt) * 3, rnd((C,), f32), rnd((R, C), dt)
        dx, dg = KERNELS["rmsnorm_bwd"](x, g, dy)
        wdx, wdg = rmsnorm_bwd_ref(x, g, dy)
        dtn = str(dt).split(".")[1]
        ex = held("rmsnorm_bwd", f"({R},{C})", dtn, dx, wdx, elementwise=dt == bf)
        eg = held("rmsnorm_bwd", f"({R},{C}) dg", "float32", dg, wdg)
        require(torch.equal(KERNELS["rmsnorm_bwd"](x, g, dy)[1], dg),
                f"rmsnorm_bwd ({R},{C}): dg differs from run to run")
        print(f"[bwd] rmsnorm_bwd x({R},{C}) {dtn}: rel_err dx {ex}, dg {eg} (fp32 2e-05); "
              "dg the same in a second run ok")
    for shape, dt in (((4096, 6144), bf), ((3, 1001), bf), ((1000, 1536), f32)):
        g, u, dy = rnd(shape, dt) * 3, rnd(shape, dt), rnd(shape, dt)
        got, want = KERNELS["silu_mul_bwd"](g, u, dy), silu_mul_bwd_ref(g, u, dy)
        dtn = str(dt).split(".")[1]
        e = [held("silu_mul_bwd", f"{shape}", dtn, a, w, elementwise=dt == bf)
             for a, w in zip(got, want)]
        print(f"[bwd] silu_mul_bwd {shape} {dtn}: rel_err dg {e[0]}, du {e[1]} ok")
    # LayerNorm through the router: the ring kernel at the model rows, an odd
    # shape and fp32, the Triton kernel at rwkv6's rows (where it ran faster),
    # a ragged row and rows whose pitch is off 16 bytes; the launch count of
    # the kernel the route names moves, the other's does not. Where the ring
    # takes rows the router sends to the Triton kernel, it is held as well.
    from repro_torch.kernels.rmsnorm.kernel import (_ring_plan_of, layernorm_bwd,
                                                    layernorm_bwd_route)
    dtypes = {"bf16": bf, "fp32": f32}
    for R, C, pad, dtn, want_route in LN_BWD_CHECKS:
        dt = dtypes[dtn]
        x = (rnd((R, C + pad), dt) * 3 + 1.5)[:, :C]
        g, dy = rnd((C,), f32), rnd((R, C + pad), dt)[:, :C]
        route = layernorm_bwd_route(x, dy)
        require(route == want_route, f"layernorm_bwd ({R},{C}) pitch {C + pad} {dtn}: routed "
                f"to {route}, not {want_route}")
        want = layernorm_bwd_ref(x, g, dy)
        fns = {route: layernorm_bwd}
        if route == "layernorm_bwd_triton" and _ring_plan_of(x, dy) is not None:
            fns["layernorm_bwd"] = KERNELS["layernorm_bwd"]
        for name, fn in fns.items():
            before = {n: KERNELS[n].launches for n in ("layernorm_bwd", "layernorm_bwd_triton")}
            got = fn(x, g, dy)
            moved = {n: KERNELS[n].launches - c for n, c in before.items()}
            require(moved == {n: int(n == name) for n in moved},
                    f"layernorm_bwd ({R},{C}) {dtn}: launches {moved} for {name}")
            tn = str(dt).split(".")[1]      # the name TOL knows
            e = [held(name, f"({R},{C}) pitch {C + pad} {part}",
                      "float32" if part != "dx" else tn, a, w,
                      elementwise=dt == bf and part == "dx")
                 for part, a, w in zip(("dx", "dg", "db"), got, want)]
            again = fn(x, g, dy)
            require(torch.equal(again[1], got[1]) and torch.equal(again[2], got[2]),
                    f"{name} ({R},{C}): dg or db differ from run to run")
            print(f"[bwd] layernorm_bwd x({R},{C}) pitch {C + pad} {tn} on {name}"
                  f"{' (the route)' if name == route else ' (the ring kernel, called directly)'}"
                  f": rel_err dx {e[0]}, dg {e[1]}, db {e[2]} (fp32 2e-05); dg and db the same "
                  "bits in a second run ok")
    # three launches of the ring kernel back to back on one stream, of three
    # shapes: no counter or scratch carries from one to the next
    ins = [(rnd((R, C), bf) * 3 + 1.5, rnd((C,), f32), rnd((R, C), bf))
           for R, C in ((4096, 2048), (33, 384), (500, 4096))]
    outs = [KERNELS["layernorm_bwd"](*a) for a in ins]
    for a, got in zip(ins, outs):
        want = layernorm_bwd_ref(*a)
        held("layernorm_bwd", f"{tuple(a[0].shape)} back to back dx", "bfloat16", got[0],
             want[0], elementwise=True)
        for part, i in (("dg", 1), ("db", 2)):
            held("layernorm_bwd", f"{tuple(a[0].shape)} back to back {part}", "float32",
                 got[i], want[i])
    from repro_torch.kernels.rmsnorm.kernel import _counter
    require(not _counter(ins[0][0].device, torch.cuda.current_stream().cuda_stream).any(),
            "layernorm_bwd: the grid barrier's counters are not back at 0")
    print("[bwd] layernorm_bwd: three shapes back to back on one stream, each held to its "
          "plain version, the barrier's counters back at 0 ok")
    # GELU at gpt3's MLP, the gated GELU at recurrentgemma's MLP and grok's
    # expert buffer; elements where gelu' saturates and where x^3 overflows
    tails = torch.tensor([-1e30, -1e4, -20.0, -9.5, 9.5, 20.0, 1e4, 1e30], device="cuda")
    for name, shape, dtn in GELU_BWD_CHECKS:
        dt = dtypes[dtn]
        ins = [rnd(shape, dt) for _ in range(2 if name == "gelu_bwd" else 3)]
        ins[0] = ins[0] * 3
        ins[0].view(-1)[:8] = tails.to(dt)
        got = KERNELS[name](*ins)
        want = (gelu_bwd_ref if name == "gelu_bwd" else gelu_mul_bwd_ref)(*ins)
        got, want = ((got,), (want,)) if name == "gelu_bwd" else (got, want)
        dtn = str(dt).split(".")[1]
        require(all(torch.isfinite(a).all() for a in got), f"{name} {shape}: non-finite output")
        # the tails held element by element; the relative error over the
        # rest, which du = dy gelu(g) at g = 1e30 would otherwise swamp
        require(all(within_one_rounding(a.view(-1)[:8], w.view(-1)[:8])
                    for a, w in zip(got, want)), f"{name} {shape}: a tail element is off")
        e = [held(name, f"{shape}", dtn, a.view(-1)[8:], w.view(-1)[8:], elementwise=dt == bf)
             for a, w in zip(got, want)]
        print(f"[bwd] {name} {shape} {dtn}: the 8 tail elements within one bf16 rounding, "
              "rel_err of the rest " + ", ".join(e) + " ok")

    rows = {}

    def add(name, label, kernel, plain, library, nbytes, flops, rate):
        ms, plain_ms = time_ms(torch, kernel), time_ms(torch, plain)
        lib_ms = None if library is None else time_ms(torch, library)
        b_ms, b_by = bound(nbytes, flops, rate)
        route, source, replaces = BACKWARD[name]
        print(f"[timing] {name:16s} {label}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
              f"library " + ("none (no PyTorch call computes it)" if lib_ms is None
                             else f"{lib_ms:.5f} ms")
              + f", bound {b_ms:.5f} ms ({b_by}), {b_ms / ms * 100:.1f}% of bound")
        rows[name] = {"name": name, "route": route, "source": source, "replaces": replaces,
                      "launches": 0, "max_abs_err": errs[name],
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": lib_ms, "shapes": [{"shape": label}]}

    def grad_of(fn, inputs, dout):
        """The backward half of one PyTorch call: its graph built once, the
        timed function torch.autograd.grad over it."""
        leaves = [t.detach().requires_grad_(True) for t in inputs]
        out = fn(*leaves)
        return lambda: torch.autograd.grad(out, leaves, dout, retain_graph=True)

    from repro_torch.kernels.flash_attention.kernel import attention_cuda
    for arch, (B, Hq, Hkv, S, D) in (("qwen3-1.7b", (8, 16, 8, 512, 128)),
                                     ("qwen2-0.5b", (8, 14, 2, 512, 64))):
        q, k, v, o, do, lse = flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, True)
        pairs = S * (S + 1) // 2      # the live (query, key) pairs of a causal head
        # q, k, v, o, dO and L read once, dq, dk, dv written once; the five
        # products of the causal half
        nbytes = 2 * (4 * B * Hq * S * D + 4 * B * Hkv * S * D) + 4 * B * Hq * S
        flops = 5 * 2 * B * Hq * pairs * D
        label = (f"{arch} q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) causal, the model's "
                 "(B, S, H, D) views")
        library = grad_of(lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), (q, k, v), do)
        if arch == "qwen3-1.7b":   # the mma.sync kernel reads no L
            for name, kern, n in (
                    ("flash_attention_bwd_wgmma",
                     lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse), nbytes),
                    ("flash_attention_bwd", lambda: KERNELS["flash_attention_bwd"](q, k, v, o, do),
                     nbytes - 4 * B * Hq * S)):
                add(name, label, kern, lambda: attention_bwd_ref(q, k, v, o, do, causal=True),
                    library, n, flops, BF16_TENSOR_FLOPS)
        # the steps apart: the forward with and without L (serving must not
        # pay), each launch of the wgmma backward alone, in turns
        steps = {
            "forward served (no L)": lambda: KERNELS["flash_attention_wgmma"](q, k, v),
            "forward writing L": lambda: attention_cuda(q, k, v, with_lse=True),
            "wgmma bwd dq launch (delta, (L, delta) scratch, dq)":
                lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse, phases=1),
            "wgmma bwd dk/dv launch":
                lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse, phases=2),
            "wgmma bwd, both launches":
                lambda: KERNELS["flash_attention_bwd_wgmma"](q, k, v, o, do, lse),
            "mma.sync bwd (flash_attention_bwd.cu)":
                lambda: KERNELS["flash_attention_bwd"](q, k, v, o, do),
            "SDPA backward": library}
        times = {name: [] for name in steps}
        for turn in range(2):
            for name in (steps if turn == 0 else reversed(list(steps))):
                times[name].append(time_ms(torch, steps[name]))
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        print(f"[timing] flash steps {label}: " + ", ".join(
            f"{name} {t[0]:.5f} / {t[1]:.5f} ms" for name, t in times.items())
              + f" (two turns, the second in reverse order); bound {b_ms:.5f} ms ({b_by})")
        whole = statistics.mean(times["wgmma bwd, both launches"])
        if arch == "qwen3-1.7b":
            rows["flash_attention_bwd_wgmma"]["steps_ms"] = {k: v for k, v in times.items()}
        else:
            for name in ("flash_attention_bwd_wgmma", "flash_attention_bwd"):
                key = ("wgmma bwd, both launches" if name == "flash_attention_bwd_wgmma"
                       else "mma.sync bwd (flash_attention_bwd.cu)")
                rows[name]["shapes"].append({
                    "shape": label, "ms": statistics.mean(times[key]),
                    "library_ms": statistics.mean(times["SDPA backward"]), "bound_ms": b_ms,
                    "bound_by": b_by})
        print(f"[timing] flash_attention_bwd_wgmma {label}: {whole:.5f} ms, "
              f"{statistics.mean(times['SDPA backward']) / whole:.3f}x SDPA's backward speed, "
              f"{b_ms / whole * 100:.1f}% of bound")
    # the modes at recurrentgemma's and grok's train shapes: each launch
    # apart, beside the plain version and SDPA's backward (the window as a
    # band mask; without the softcap, which no PyTorch call takes)
    for B, Hq, Hkv, S, D, window, cap, qs, what in FLASH_BWD_MODES:
        if what is None:
            continue
        kw = dict(causal=True, window=window, softcap=cap)
        q, k, v, o, do, lse = flash_bwd_inputs(torch, rnd, B, Hq, Hkv, S, D, True, window, cap,
                                               qs)
        nbytes = 2 * (4 * B * Hq * S * D + 4 * B * Hkv * S * D) + 4 * B * Hq * S
        flops = 5 * 2 * B * Hq * live_pairs(S, window) * D
        if window and window < S:
            mask = band_mask(torch, S, window)
            library = grad_of(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, attn_mask=mask, enable_gqa=True), (q, k, v), do)
            lib_note = "SDPA backward with the window as a bool band mask"
        else:
            library = grad_of(lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True, enable_gqa=True), (q, k, v), do)
            lib_note = "SDPA backward, causal" + (" (no softcap: SDPA takes none)" if cap else "")
        bwd = KERNELS["flash_attention_bwd_wgmma"]
        steps = {"dq launch": lambda: bwd(q, k, v, o, do, lse, **kw, phases=1),
                 "dk/dv launch": lambda: bwd(q, k, v, o, do, lse, **kw, phases=2),
                 "both launches": lambda: bwd(q, k, v, o, do, lse, **kw),
                 lib_note: library}
        times = {name: [] for name in steps}
        for turn in range(2):
            for name in (steps if turn == 0 else reversed(list(steps))):
                times[name].append(time_ms(torch, steps[name]))
        ms = {name: statistics.mean(t) for name, t in times.items()}
        plain_ms = time_ms(torch, lambda: attention_bwd_ref(q, k, v, o, do, **kw), iters=5)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        label = f"{what}: q({B},{Hq},{S},{D}) kv({B},{Hkv},{S},{D}) window={window} " \
                f"softcap={cap:g}, the model's views"
        print(f"[timing] flash_attention_bwd_wgmma {label}: " + ", ".join(
            f"{name} {t[0]:.5f} / {t[1]:.5f} ms" for name, t in times.items())
              + f" (two turns, the second in reverse order); plain {plain_ms:.5f} ms; bound "
              f"{b_ms:.5f} ms ({b_by}), {b_ms / ms['both launches'] * 100:.1f}% of it; "
              f"{ms[lib_note] / ms['both launches']:.3f}x the library call's speed")
        if D == 256:
            from repro_torch.kernels.flash_attention.kernel import (bwd_dkdv_plan,
                                                                    bwd_head_splits,
                                                                    bwd_tile_work)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            work = bwd_tile_work(B, Hkv, S, S, Hq // Hkv, True, window)
            plan = bwd_dkdv_plan(B, Hkv, S, S, Hq // Hkv, True, window, sms)
            splits = bwd_head_splits(len(work), Hq // Hkv, sms)
            print(f"[timing] flash_attention_bwd_wgmma {what}: the dk/dv launch's {len(plan)} "
                  f"blocks over {len(work)} work tiles of 64 keys (bwd_dkdv_plan), the longest "
                  f"walking {max((g1 - g0) * work[t] for t, g0, g1, _, _ in plan)} query tiles; "
                  f"one split for every tile ({splits}, bwd_head_splits) would give "
                  f"{len(work) * splits} blocks, the longest walking "
                  f"{-(-(Hq // Hkv) // splits) * max(work)}")
        rows["flash_attention_bwd_wgmma"]["shapes"].append({
            "shape": label, "ms": ms["both launches"], "dq_ms": ms["dq launch"],
            "dkdv_ms": ms["dk/dv launch"], "plain_ms": plain_ms, "library_ms": ms[lib_note],
            "library": lib_note, "bound_ms": b_ms, "bound_by": b_by})
        del q, k, v, o, do, lse, library
    torch.cuda.empty_cache()
    # the RG-LRU backward at recurrentgemma's train shape: both launches (the
    # scan, dlam's batch sum) beside the plain version; no PyTorch call scans
    from repro_torch.kernels.rglru.kernel import segment_steps, segments
    for B, T, given, what in RGLRU_BWD_CHECKS:
        if what is None:
            continue
        d = 2560
        u, ga, gx, lam, gate, _ = rglru_inputs(torch, rnd, B, T, d, False)
        dy = rnd((B, T, d), f32)
        steps = segment_steps(T)
        h_seg = torch.empty((B, segments(T, steps), d), device="cuda")
        KERNELS["rglru_chunked"](u, ga, gx, lam, gate, h_seg=h_seg)
        n = B * T * d
        # u, gate (2 bytes), ga, gx, dy (4) read; du, dgate (2), dga, dgx (4)
        # written; h_seg, lam read and dlam written once; ~40 fp32 operations
        # an element
        nbytes = 28 * n + 4 * h_seg.numel() + 8 * d
        add("rglru_bwd", f"{what}: u,gate,ga,gx,dy ({B},{T},{d}), {steps} steps a segment",
            lambda: KERNELS["rglru_bwd"](u, ga, gx, lam, gate, h_seg, dy),
            lambda: rglru_bwd_ref(u, ga, gx, lam, gate, None, dy), None, nbytes, 40 * n,
            FP32_FLOPS)
        del u, ga, gx, gate, dy, h_seg
    # the wkv backward at rwkv6-7b's train shape beside its plain version (no
    # PyTorch call scans); first the chunked forward at the served wave with
    # and without s_seg, in two turns: serving passes none
    for B, T, given, what in WKV_BWD_CHECKS:
        if what is None:
            continue
        r, k, v, w, u, _, dout, _ = wkv_train_inputs(torch, rnd, B, T, False)
        s_seg = torch.empty((B, 64, wkv_segments(T), 64, 64), device="cuda")
        fwd = {"without s_seg (served)": lambda: KERNELS["wkv_chunked"](r, k, v, w, u),
               "with s_seg (train)": lambda: KERNELS["wkv_chunked"](r, k, v, w, u,
                                                                      s_seg=s_seg)}
        times = {name: [] for name in fwd}
        for turn in range(2):
            for name in (fwd if turn == 0 else reversed(list(fwd))):
                times[name].append(time_ms(torch, fwd[name]))
        n = B * T * 64 * 64
        # r, k, v, w read, out written, the final state written (fp32), and
        # with s_seg its states
        fwd_bytes = 20 * n + 4 * B * 64 * 64 * 64
        print(f"[timing] wkv_chunked r,k,v,w ({B},{T},64,64) fp32 ({what}): " + ", ".join(
            f"{name} {t[0]:.5f} / {t[1]:.5f} ms" for name, t in times.items())
              + " (two turns, the second in reverse order); bound "
              f"{bound(fwd_bytes, 5 * 64 * n, FP32_FLOPS)[0]:.5f} ms without s_seg, "
              f"{bound(fwd_bytes + 4 * s_seg.numel(), 5 * 64 * n, FP32_FLOPS)[0]:.5f} with it "
              f"(bytes); plain {time_ms(torch, lambda: wkv_ref(r, k, v, w, u), iters=5):.5f} ms")
        # r, k, v, w, dout read and dr, dk, dv, dw written (fp32), s_seg and u
        # read and du written once; ~10 N^2 fp32 operations a (b, t, h)
        nbytes = 36 * n + 4 * s_seg.numel() + 8 * 64 * 64
        add("wkv_bwd", f"{what}: r,k,v,w,dout ({B},{T},64,64) fp32, {SEGMENT_STEPS} steps a "
            "segment", lambda: KERNELS["wkv_bwd"](r, k, v, w, u, s_seg, dout),
            lambda: wkv_bwd_ref(r, k, v, w, u, None, dout), None, nbytes, 10 * 64 * n,
            FP32_FLOPS)
        rows["wkv_bwd"]["forward_ms"] = {name: statistics.mean(t) for name, t in times.items()}
        # its two launches apart: the chunks from the end, and du's sum over
        # the batch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                KERNELS["wkv_bwd"](r, k, v, w, u, s_seg, dout)
            torch.cuda.synchronize()
        apart = {e.key: e.self_device_time_total / e.count / 1e3 for e in prof.key_averages()
                 if e.device_type != torch.autograd.DeviceType.CPU and "wkv_bwd" in e.key}
        print(f"[timing] wkv_bwd {what}: its launches apart (torch.profiler, mean of 5, L2 not "
              "flushed): " + ", ".join(f"{k_[:60]} {v_:.5f} ms" for k_, v_ in apart.items()))
        rows["wkv_bwd"]["launches_apart_ms"] = apart
        del r, k, v, w, dout, s_seg
    torch.cuda.empty_cache()
    # RMSNorm: the model's norms (4096, 2048), the q-norm over qwen3's 16
    # heads (65536, 128) and the k-norm over its 8 (32768, 128); beside the
    # design it replaced and F.rms_norm's backward, and each design's row
    # pass and column sum apart, in two turns (the second in reverse order)
    from repro_torch.kernels.rmsnorm.kernel import (rmsnorm_bwd_launches,
                                                    rmsnorm_bwd_replaced_triton)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    for R, C, what in ((tokens, 2048, "norms"), (tokens * 16, 128, "q-norm"),
                       (tokens * 8, 128, "k-norm")):
        x, g, dy = rnd((R, C), bf), rnd((C,), f32), rnd((R, C), bf)
        nbytes, flops = 3 * R * C * 2 + 2 * C * 4, 11 * R * C
        library = grad_of(lambda a, w: F.rms_norm(a, (C,), w, 1e-6), (x, g.to(bf)), dy)
        label = f"x({R},{C}) bf16 ({what})"
        if C == 2048:
            add("rmsnorm_bwd", label, lambda: KERNELS["rmsnorm_bwd"](x, g, dy),
                lambda: rmsnorm_bwd_ref(x, g, dy), library, nbytes, flops, FP32_FLOPS)
        _, _, row_new, col_new = rmsnorm_bwd_launches(x, g, dy)
        _, _, row_old, col_old = rmsnorm_bwd_launches(x, g, dy, replaced=True)
        row_new(), row_old()     # each column sum reads what its row pass wrote
        steps = {"kernel": lambda: KERNELS["rmsnorm_bwd"](x, g, dy), "row pass": row_new,
                 "column sum": col_new,
                 "replaced design": lambda: rmsnorm_bwd_replaced_triton(x, g, dy),
                 "its row pass": row_old, "its column sum (with the zeroing of dg)": col_old,
                 "F.rms_norm backward": library}
        times = {name: [] for name in steps}
        for turn in range(2):
            for name in (steps if turn == 0 else reversed(list(steps))):
                times[name].append(time_ms(torch, steps[name]))
        ms = {name: statistics.mean(t) for name, t in times.items()}
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        print(f"[timing] rmsnorm_bwd steps {label}: " + ", ".join(
            f"{name} {t[0]:.5f} / {t[1]:.5f} ms" for name, t in times.items())
              + f"; bound {b_ms:.5f} ms ({b_by}): the kernel at "
              f"{b_ms / ms['kernel'] * 100:.1f}% of it, the replaced design at "
              f"{b_ms / ms['replaced design'] * 100:.1f}%")
        if C == 2048:
            rows["rmsnorm_bwd"]["steps_ms"] = times
        else:
            rows["rmsnorm_bwd"]["shapes"].append({
                "shape": label, "ms": ms["kernel"], "replaced_ms": ms["replaced design"],
                "library_ms": ms["F.rms_norm backward"], "bound_ms": b_ms, "bound_by": b_by})
    R, C = TRAIN_BATCH * TRAIN_SEQ, 6144
    g, u, dy = rnd((R, C), bf), rnd((R, C), bf), rnd((R, C), bf)
    add("silu_mul_bwd", f"g,u({R},{C}) bf16", lambda: KERNELS["silu_mul_bwd"](g, u, dy),
        lambda: silu_mul_bwd_ref(g, u, dy),
        grad_of(lambda a, b: F.silu(a) * b, (g, u), dy), 5 * R * C * 2, 12 * R * C, FP32_FLOPS)
    del g, u, dy
    # LayerNorm at the trained rows of stablelm, gpt3, rwkv6 and whisper
    # (decoder, and encoder over its frames): the ring kernel, its row pass
    # alone, the Triton design it replaced (the earlier kernel, same call;
    # the route of rwkv6's rows), F.layer_norm's backward and an elementwise
    # op moving the same bytes (what the L2 flush leaves of the bound), in
    # two turns
    from repro_torch.kernels.rmsnorm.kernel import layernorm_bwd_ring_row_pass
    for R, C, what in LN_BWD_TIMED:
        x, g, dy = rnd((R, C), bf) * 3 + 1.5, rnd((C,), f32), rnd((R, C), bf)
        zero = torch.zeros((C,), dtype=bf, device="cuda")
        nbytes, flops = 3 * R * C * 2 + 3 * C * 4, 15 * R * C
        library = grad_of(lambda a, w, b: F.layer_norm(a, (C,), w, b, 1e-5),
                          (x, g.to(bf), zero), dy)
        label = f"x({R},{C}) bf16 ({what}; routed to {layernorm_bwd_route(x, dy)})"
        first = "layernorm_bwd" not in rows
        if first:
            add("layernorm_bwd", label, lambda: KERNELS["layernorm_bwd"](x, g, dy),
                lambda: layernorm_bwd_ref(x, g, dy), library, nbytes, flops, FP32_FLOPS)
        steps = {"kernel": lambda: KERNELS["layernorm_bwd"](x, g, dy),
                 "row pass alone": lambda: layernorm_bwd_ring_row_pass(x, g, dy)}
        steps["Triton design (earlier)"] = lambda: KERNELS["layernorm_bwd_triton"](x, g, dy)
        steps["F.layer_norm backward"] = library
        same_bytes = torch.empty_like(x)     # reads x and dy, writes one (R, C): 6 B an element
        steps["torch.add of x and dy (the same bytes)"] = lambda: torch.add(x, dy, out=same_bytes)
        times = {name: [] for name in steps}
        for turn in range(2):
            for name in (steps if turn == 0 else reversed(list(steps))):
                times[name].append(time_ms(torch, steps[name]))
        ms = {name: statistics.mean(t) for name, t in times.items()}
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        print(f"[timing] layernorm_bwd steps {label}: " + ", ".join(
            f"{name} {t[0]:.5f} / {t[1]:.5f} ms" for name, t in times.items())
              + f"; bound {b_ms:.5f} ms ({b_by}): the kernel at "
              f"{b_ms / ms['kernel'] * 100:.1f}% of it, "
              f"{ms['Triton design (earlier)'] / ms['kernel']:.3f}x faster than the Triton "
              f"design, {ms['F.layer_norm backward'] / ms['kernel']:.3f}x than F.layer_norm")
        if first:
            rows["layernorm_bwd"]["steps_ms"] = times
        else:
            rows["layernorm_bwd"]["shapes"].append({
                "shape": label, "ms": ms["kernel"], "plain_ms": time_ms(
                    torch, lambda: layernorm_bwd_ref(x, g, dy)),
                "library_ms": ms["F.layer_norm backward"], "bound_ms": b_ms, "bound_by": b_by})
        rows["layernorm_bwd"].setdefault("steps_ms_by_shape", {})[label] = ms
        del x, dy, library
    # the Triton route at the trained rows the router sends it
    R, C = LN_BWD_TRITON_TIMED
    x, g, dy = rnd((R, C), bf) * 3 + 1.5, rnd((C,), f32), rnd((R, C), bf)
    zero = torch.zeros((C,), dtype=bf, device="cuda")
    add("layernorm_bwd_triton", f"x({R},{C}) bf16 (rwkv6-7b, routed to it)",
        lambda: KERNELS["layernorm_bwd_triton"](x, g, dy), lambda: layernorm_bwd_ref(x, g, dy),
        grad_of(lambda a, w, b: F.layer_norm(a, (C,), w, b, 1e-5), (x, g.to(bf), zero), dy),
        3 * R * C * 2 + 3 * C * 4, 15 * R * C, FP32_FLOPS)
    del x, dy
    # GELU at gpt3's MLP; the gated GELU at recurrentgemma's MLP and grok's
    # expert buffer (both trained by the train runs)
    for name, (R, C), what in GELU_BWD_TIMED:
        n = R * C
        ins = [rnd((R, C), bf) * 3] + [rnd((R, C), bf) for _ in range(1 if name == "gelu_bwd"
                                                                        else 2)]
        if name == "gelu_bwd":
            plain = lambda: gelu_bwd_ref(*ins)
            library = grad_of(lambda a: F.gelu(a, approximate="tanh"), ins[:1], ins[1])
            nbytes, flops = 3 * n * 2, 20 * n
        else:
            plain = lambda: gelu_mul_bwd_ref(*ins)
            library = grad_of(lambda a, b: F.gelu(a, approximate="tanh") * b, ins[:2], ins[2])
            nbytes, flops = 5 * n * 2, 22 * n
        label = f"({R},{C}) bf16 ({what})"
        if name not in rows:
            add(name, label, lambda: KERNELS[name](*ins), plain, library, nbytes, flops,
                FP32_FLOPS)
        else:
            ms, lib_ms = time_ms(torch, lambda: KERNELS[name](*ins)), time_ms(torch, library)
            b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
            plain_ms = time_ms(torch, plain)
            print(f"[timing] {name:16s} {label}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
                  f"library {lib_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}), "
                  f"{b_ms / ms * 100:.1f}% of bound")
            rows[name]["shapes"].append({"shape": label, "ms": ms, "plain_ms": plain_ms,
                                         "library_ms": lib_ms, "bound_ms": b_ms,
                                         "bound_by": b_by})
        del ins, library
    torch.cuda.empty_cache()
    return [rows[name] for name in BACKWARD]


def grads_of(torch, model, tokens, targets, frontend=None):
    """(loss, {name: gradient}) of one loss_fn call, its GEMMs summing in
    fp32 as a train step's do (``training.fp32_reductions``)."""
    from repro_torch.models import loss_fn
    from repro_torch.training import fp32_reductions
    with fp32_reductions():
        loss, _ = loss_fn(model, tokens, targets, frontend=frontend)
        params = dict(model.named_parameters())
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def phase_train_check(torch, arch, n_layers, B, S, n_experts=None):
    """`arch` at full width cut to `n_layers` layers: the loss and every
    parameter's gradient of one step on the card (the backward kernels)
    against the CPU plain path in bf16 and an fp32 CPU run of the same
    weights, on B x S tokens; with a seeded stub frontend and the cross
    branch unhidden for a cross-attending model, the bf16 CPU run's routing
    replayed on the card and in the fp32 run for an MoE one. A key bias's
    gradient is 0 in exact arithmetic (the softmax ignores a shift common to
    a row's scores), so each side's is rounding alone (about 2^-9 of the
    key gradients it sums): it is held below KEY_BIAS_LIMIT of its layer's
    query-bias gradient instead of by the ratio; a wrong key gradient would
    put it near 1. A Griffin model's RG-LRU decays and RWKV6's wkv decays
    and bonus are unhidden (``unhide_recurrence``)."""
    from repro_torch.models import LM, init_params
    cfg = served_config(arch, n_layers, n_experts)
    gpu = init_params(cfg, seed=3, device="cuda")
    gen = torch.Generator("cpu").manual_seed(4)
    fe = None
    if cfg.block_pattern or cfg.attention_free:
        unhide_recurrence(torch, gpu)
    if cfg.n_frontend_tokens:
        unhide_cross_attention(torch, gpu)
        fe = torch.randn((B, cfg.n_frontend_tokens, cfg.d_model), generator=gen).bfloat16()
    gpu.requires_grad_(True)
    cpu = LM(cfg, device="cpu")
    cpu.load_state_dict(gpu.state_dict())
    cpu.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab_size, (B, S + 1), generator=gen)
    t0 = time.perf_counter()
    with routing() as cpu_routing:
        lc, gc = grads_of(torch, cpu, tok[:, :-1], tok[:, 1:], fe)
    with routing(replay=cpu_routing):
        lg, gg = grads_of(torch, gpu, tok[:, :-1].cuda(), tok[:, 1:].cuda(),
                          None if fe is None else fe.cuda())
    with routing(replay=cpu_routing):
        l32, g32 = grads_of(torch, cpu.float(), tok[:, :-1], tok[:, 1:], fe)
    require(all(torch.isfinite(g).all() for g in gg.values()), "non-finite gradients on the card")
    worst, rows, key_bias = 0.0, [], 0.0
    for n, g in gg.items():
        ref = g32[n]
        if n.endswith(".bk"):
            scale = g32[n[:-1] + "q"].norm().item()
            key_bias = max(key_bias, g.float().norm().item() / scale,
                           gc[n].float().norm().item() / scale)
            continue
        d_card = (g.float().cpu() - ref).norm().item()
        d_cpu = (gc[n].float() - ref).norm().item()
        ratio = d_card / max(d_cpu, 1e-30)
        rows.append((ratio, n, d_card / max(ref.norm().item(), 1e-30),
                     d_cpu / max(ref.norm().item(), 1e-30)))
        worst = max(worst, ratio)
    rows.sort(reverse=True)
    what = (f", frontends of {cfg.n_frontend_tokens} tokens, the cross branch unhidden"
            if fe is not None else "") + (", the CPU's routing replayed" if cfg.n_experts else "") \
        + (", the RG-LRU decays unhidden" if cfg.block_pattern else "") \
        + (", the wkv decays and bonus unhidden" if cfg.attention_free else "")
    print(f"[train] {cfg.name} batch {B} x {S}{what}: loss card {lg.item():.6f}, bf16 CPU "
          f"{lc.item():.6f}, fp32 CPU {l32.item():.6f}; {time.perf_counter() - t0:.1f} s")
    print(f"[train] {cfg.name}: per-leaf gradient distance from the fp32 CPU run (relative "
          f"Frobenius), card / bf16 CPU, the 5 leaves with the largest ratio: "
          + ", ".join(f"{n} {c:.3e}/{p:.3e} ({r:.3f})" for r, n, c, p in rows[:5])
          + f"; largest ratio {worst:.3f} over {len(rows)} leaves (limit "
          f"{TRAIN_FP32_FACTOR:g})" + (f"; key-bias gradients (card and bf16 CPU) at most "
                                       f"{key_bias:.3e} of their query bias's (limit "
                                       f"{KEY_BIAS_LIMIT:g})" if key_bias else ""))
    require(worst <= TRAIN_FP32_FACTOR, f"{cfg.name}: a gradient of the card is {worst:.3f} "
            f"times as far from fp32 as the bf16 CPU path's, > {TRAIN_FP32_FACTOR:g}")
    require(key_bias < KEY_BIAS_LIMIT, f"{cfg.name}: a key-bias gradient {key_bias:.3e} of "
            "its query bias's")
    require(abs(lg.item() - lc.item()) < 2e-2, f"{cfg.name}: card loss {lg.item():.6f} vs CPU "
            f"{lc.item():.6f}")
    del gpu, cpu, gg, gc, g32
    torch.cuda.empty_cache()


def profile_step(torch, step_fn, top=0, pick=None):
    """Device ms of one call of `step_fn` from a torch.profiler trace (the
    device-side events: kernels, copies, sets) and its result; prints the
    `top` device events by time, and every event whose name holds `pick`."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        out = step_fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type != torch.autograd.DeviceType.CPU]
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)
    shown = ranked[:top] + [e for e in ranked[top:] if top and pick and pick in e.key]
    for e in shown:
        print(f"[profile]   train step {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x  {e.key[:90]}")
    return sum(e.self_device_time_total for e in events) / 1e3, sum(e.count for e in events), out


def train_launches(cfg):
    """The exact kernel launches of one train step of `cfg`, forward and
    backward: flash attention per self-attention, cross-attention and
    encoder layer (a vision cross layer's in place of its self-attention;
    causal, windowed or softcapped alike), the norm per norm (two a layer,
    an encoder-decoder's lnx, the final norms, and the RMSNorm of the q-
    and k-norm per attention), the MLP's activation per layer (an MoE
    layer's experts share one launch), per RG-LRU layer the chunked scan
    and the GELU of its gate branch in place of the attention, and for
    RWKV6 two LayerNorms a layer, the final one and one chunked wkv a layer
    (no attention, its channel mix's relu^2 plain ops); each as often in
    the backward (the scans' backward kernels are rglru_bwd and wkv_bwd; the
    LayerNorm backward's is the kernel the router picks for bf16 rows of
    d_model: the ring kernel, layernorm_bwd, or at rwkv6's 4096 the Triton
    kernel, layernorm_bwd_triton)."""
    import torch
    from repro_torch.kernels.rmsnorm.kernel import ring_preferred
    L, E = cfg.n_layers, cfg.n_encoder_layers
    ln_bwd = "layernorm_bwd" if ring_preferred(cfg.d_model, torch.bfloat16) \
        else "layernorm_bwd_triton"
    if cfg.attention_free:
        return {"layernorm": 2 * L + 1, ln_bwd: 2 * L + 1, "wkv_chunked": L, "wkv_bwd": L}
    rec = sum(cfg.block_kind(i) == "rglru" for i in range(L)) if cfg.block_pattern else 0
    cross = L if cfg.cross_attention else 0
    attn = L - rec + E + cross
    norms = 2 * (L + E) + 1 + (1 if E else 0) + cross
    act = ("silu_mul" if cfg.activation == "silu" else "gelu_mul") if cfg.mlp_gated else "gelu"
    want = {"flash_attention_wgmma": attn, cfg.norm: norms, act: L + E}
    if cfg.qk_norm:
        want["rmsnorm"] = want.get("rmsnorm", 0) + 2 * attn
    if rec:
        want["gelu"] = want.get("gelu", 0) + rec
        want["rglru_chunked"] = rec
    backward = {"flash_attention_wgmma": "flash_attention_bwd_wgmma",
                "rglru_chunked": "rglru_bwd", "layernorm": ln_bwd}
    want.update({backward.get(k, k + "_bwd"): n for k, n in want.items()})
    return want


def model_flops(cfg, model, B, S):
    """6 x parameters x tokens of one train step: an MoE layer's experts at
    top_k / n_experts of their parameters (the active parameters); the
    encoder's parameters and the cross layers' K and V projections against
    the B x n_frontend_tokens frontend rows, every other parameter against
    the B x S tokens."""
    flops = 0.0
    for n, p in model.named_parameters():
        k = p.numel() * (cfg.top_k / cfg.n_experts if ".moe.w_" in n else 1)
        frontal = n.startswith("enc.") or n.endswith(("xattn.wk", "xattn.wv", "xattn.bk",
                                                      "xattn.bv"))
        flops += 6 * k * B * (cfg.n_frontend_tokens if frontal else S)
    return flops


def phase_train(torch, arch, n_layers, lr, second, n_experts=None):
    """`arch` at full width (cut to `n_layers` layers where given) trained
    TRAIN_STEPS steps on one repeated batch of TRAIN_BATCH x TRAIN_SEQ
    tokens from TokenPipeline (a cross-attending model with a seeded stub
    frontend): the loss falls at every step and by at least 0.5 in all; per
    step wall ms, tokens per second and the model-FLOPs share
    (``model_flops``), the exact launches of each kernel per step
    (``train_launches``). Then, with `second`, the same run again from the
    same seed, its last PROFILED_STEPS steps under torch.profiler
    ("profile": their device ms and the largest device events of the last)
    or plain ("rerun"), and whether its losses equal the first run's bit for
    bit. Returns each kernel's launches in the first run."""
    from repro_torch import kernels as K
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.models import needs_frontend
    from repro_torch.training import AdamW, constant_schedule, init_state, make_train_step
    cfg = served_config(arch, n_layers, n_experts)
    opt = AdamW(lr=constant_schedule(lr))
    raw = TokenPipeline(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=0)).batch_at(0)
    batch = {k: torch.from_numpy(v).cuda() for k, v in raw.items()}
    if needs_frontend(cfg):
        gen = torch.Generator("cuda").manual_seed(5)
        batch["frontend"] = torch.randn((TRAIN_BATCH, cfg.n_frontend_tokens, cfg.d_model),
                                        generator=gen, device="cuda").bfloat16()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    want = {**dict.fromkeys(K.KERNELS, 0), **train_launches(cfg)}
    runs = []
    for again in (False, True) if second else (False,):
        t0 = time.perf_counter()
        state = init_state(cfg, opt, seed=0, device="cuda")
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(p.numel() for p in state.model.parameters())
        flops = model_flops(cfg, state.model, TRAIN_BATCH, TRAIN_SEQ)
        step = make_train_step(cfg, opt, has_frontend=needs_frontend(cfg))
        torch.cuda.reset_peak_memory_stats()
        losses, total, walls = [], dict.fromkeys(K.KERNELS, 0), []
        for s in range(TRAIN_STEPS):
            K.reset_launches()
            t0 = time.perf_counter()
            profiled = again and second == "profile" and s >= TRAIN_STEPS - PROFILED_STEPS
            if profiled:
                dev_ms, n_events, (state, met) = profile_step(
                    torch, lambda: step(state, batch), top=14 if s == TRAIN_STEPS - 1 else 0,
                    pick="bwd")
            else:
                state, met = step(state, batch)
                torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = K.launches()
            require(counts == want, f"{cfg.name} train step {s}: launches {counts}, not {want}")
            total = {k: total[k] + counts[k] for k in total}
            losses.append(met["loss"].item())
            walls.append(wall_ms)
            if profiled:
                print(f"[train] {cfg.name} profiled step {s}: loss {losses[-1]:.6f}, device "
                      f"{dev_ms:.3f} ms in {n_events} device events (torch.profiler), wall "
                      f"{wall_ms:.3f} ms with the profiler on")
            elif not again:
                print(f"[train] {cfg.name} step {s}: loss {losses[-1]:.6f}, grad_norm "
                      f"{met['grad_norm'].item():.4f}, wall {wall_ms:.3f} ms, "
                      f"{tokens / wall_ms * 1e3:.1f} tokens/s, model-FLOPs share "
                      f"{flops / (wall_ms / 1e3) / BF16_TENSOR_FLOPS * 100:.2f}% "
                      f"({flops:.4e} FLOP / wall / 989 TFLOP/s)")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        runs.append(losses)
        if not again:
            launches = total
            steady = statistics.median(walls[1:])
            print(f"[train] {cfg.name} ({n_params} parameters, batch {TRAIN_BATCH} x "
                  f"{TRAIN_SEQ}, AdamW lr {lr:g}): init {t_init:.2f} s, peak device memory "
                  f"{peak:.2f} GiB; median wall of steps 1-{TRAIN_STEPS - 1} {steady:.3f} ms, "
                  f"{tokens / steady * 1e3:.1f} tokens/s, model-FLOPs share "
                  f"{flops / (steady / 1e3) / BF16_TENSOR_FLOPS * 100:.2f}%; launches per "
                  f"step {json.dumps({k: n for k, n in want.items() if n})}, exact at every "
                  "step")
            falls = all(b < a for a, b in zip(losses, losses[1:]))
            require(falls and losses[0] - losses[-1] >= 0.5,
                    f"{cfg.name}: losses {losses} do not fall at every step by 0.5 in all")
            print(f"[train] {cfg.name}: loss {losses[0]:.4f} -> {losses[-1]:.4f} over "
                  f"{TRAIN_STEPS} steps, falling at every step ok")
        del state, step
        torch.cuda.empty_cache()
    if second:
        same = runs[0] == runs[1]
        print(f"[train] {cfg.name}: the {'profiled' if second == 'profile' else 'second'} "
              f"run's losses {'equal' if same else 'differ from'} the first run's bit for bit"
              + ("" if same else f": {runs[1]} against {runs[0]}"))
    return launches


def phase_ckpt(torch):
    """The m100 preset of qwen3-1.7b: CKPT_STEPS steps straight; then
    CKPT_AT + 1 steps, an async save of step CKPT_AT, a restore into a
    fresh model and optimizer (another seed), and the steps after it: the
    restored state equals the saved one bit for bit, and the resumed
    losses equal the straight run's (bit for bit where every kernel of the
    step is deterministic, else within 1e-4 relative)."""
    import shutil
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, TokenPipeline
    from repro_torch.launch.serve import preset_config
    from repro_torch.training import (AdamW, cosine_schedule, init_state, load_state_tree,
                                      make_train_step, state_tree)
    cfg = preset_config(get_config(CKPT_ARCH), "m100")
    opt = AdamW(lr=cosine_schedule(1e-3, warmup=1, total=CKPT_STEPS))
    pipe = TokenPipeline(DataConfig(cfg.vocab_size, CKPT_SEQ, CKPT_BATCH, seed=1))
    step = make_train_step(cfg, opt)

    def run(state, steps):
        losses = []
        for s in steps:
            b = {k: torch.from_numpy(v).cuda() for k, v in pipe.batch_at(s).items()}
            state, met = step(state, b)
            losses.append(met["loss"].item())
        return state, losses

    _, straight = run(init_state(cfg, opt, seed=0, device="cuda"), range(CKPT_STEPS))
    state, before = run(init_state(cfg, opt, seed=0, device="cuda"), range(CKPT_AT + 1))
    d = ROOT / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    ck = Checkpointer(str(d))
    t0 = time.perf_counter()
    tree = state_tree(state)
    t_copy = time.perf_counter() - t0
    ck.save(CKPT_AT, tree, extra={"data_step": CKPT_AT}, async_=True)
    ck.wait()
    t_save = time.perf_counter() - t0
    size = sum(f.stat().st_size for f in (d / f"step_{CKPT_AT}").iterdir())
    fresh = init_state(cfg, opt, seed=1, device="cuda")
    t0 = time.perf_counter()
    restored, manifest = ck.restore(state_tree(fresh))
    load_state_tree(fresh, restored)
    torch.cuda.synchronize()
    t_restore = time.perf_counter() - t0
    from repro_torch.checkpoint.checkpointer import flatten
    saved, back = flatten(tree), flatten(state_tree(fresh))
    require([k for k, _ in saved] == [k for k, _ in back]
            and all(a.tobytes() == b.tobytes() for (_, a), (_, b) in zip(saved, back)),
            "the restored state differs from the saved one")
    _, after = run(fresh, range(CKPT_AT + 1, CKPT_STEPS))
    resumed = before + after
    exact = resumed == straight
    worst = max(abs(a - b) / abs(b) for a, b in zip(resumed, straight))
    n_params = sum(p.numel() for p in fresh.model.parameters())
    print(f"[ckpt] {cfg.name} ({n_params} parameters, batch {CKPT_BATCH} x {CKPT_SEQ}): "
          f"step {CKPT_AT} saved async in {t_save:.3f} s (host copy {t_copy:.3f} s on the "
          f"caller's thread), {len(manifest['leaves'])} leaves, {size / 2 ** 20:.1f} MiB on "
          f"disk; restored into a fresh model and optimizer in {t_restore:.3f} s, bit for bit")
    print(f"[ckpt] losses straight {straight}; resumed {resumed}: "
          + ("equal bit for bit" if exact else f"largest relative difference {worst:.3e}"))
    require(exact or worst < 1e-4, f"{cfg.name}: resumed losses {resumed} vs straight "
            f"{straight}")
    shutil.rmtree(d, ignore_errors=True)
    del state, fresh
    torch.cuda.empty_cache()
    return exact


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device; this script "
                         "runs on the card")
    import repro_torch  # noqa: F401  (fails here without the repository)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    t_lap = [t_start]

    def lap(what):
        now = time.perf_counter()
        print(f"[env] {what} took {now - t_lap[0]:.1f} s")
        t_lap[0] = now

    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, card {torch.cuda.get_device_name(0)}")
    phase_build(torch)
    lap("[build]")
    errs = phase_kernels(torch)
    lap("the kernel checks")
    gemm_counts, gemm_errs, off_path_errs = phase_matmul(torch)
    probe = phase_e4m3_probe(torch)
    lap("[matmul] and the e4m3 probe")
    counts, per_prefill, per_decode, prompt_lens, measured = {}, {}, {}, {}, {}
    for arch, n_layers in SERVED:
        (run, per_prefill[arch], per_decode[arch], prompt_lens[arch],
         measured[arch]) = phase_serve(torch, arch, n_layers)
        counts = {name: counts.get(name, 0) + n for name, n in run.items()}
    print(f"[serve] launches summed over the {len(SERVED)} serve runs: "
          f"{json.dumps(counts)}")
    lap("[serve]")
    for check in MODEL_CHECKS:
        phase_model(torch, *check)
    # the ring phase against the CPU path: a wave of a prompt past the window
    # and a shorter one also past it, RING_STEPS decode steps past the wrap
    phase_model(torch, "recurrentgemma-2b", RING_LAYERS, RING_PROMPT, RING_STEPS,
                short=RING_PROMPT - 204, T=RING_MAX_LEN)
    lap("[model]")
    # the GEMM kernels' launches are those of their path; no model calls them
    gemm_kernels = ("matmul", "matmul_wgmma", "matmul_f32_tma", "matmul_reduce", "matmul_int8",
                    "matmul_int8_wgmma")
    by_mode = {"matmul": (), "matmul_wgmma": ("bf16", "fp8"), "matmul_f32_tma": ("fp32",),
               "matmul_reduce": (), "matmul_int8": (), "matmul_int8_wgmma": ("int8",)}
    for name in gemm_kernels:
        errs[name] = max((gemm_errs[m] for m in by_mode[name]), default=0.0)
    errs.update(off_path_errs)   # the shapes TMA cannot take, off the path
    path_counts = {**counts, **{name: gemm_counts[name] for name in gemm_kernels}}
    rows, models = phase_timing(torch, path_counts, per_prefill, per_decode, errs,
                        prompt_lens["rwkv6-7b"], prompt_lens["recurrentgemma-2b"],
                        prompt_lens["granite-moe-3b-a800m"], prompt_lens["llama-3.2-vision-11b"])
    for row in rows:
        if row["name"] in gemm_kernels:
            row["launches_in_serve_runs"] = counts[row["name"]]
            row["max_abs_err_by_mode"] = {m: gemm_errs[m] for m in by_mode[row["name"]]}
            if row["name"] == "matmul_wgmma":
                row["e4m3_probe_passes"] = probe
    lap("[timing]")
    phase_analytic(rows, models, measured)
    lap("[analytic]")
    bwd_rows = phase_bwd(torch)
    lap("[bwd]")
    for check in TRAIN_CHECKS:
        phase_train_check(torch, *check)
    lap("the [train] gradient checks")
    by_run = {}
    for run in TRAIN_RUNS:
        arch, n_layers = run[:2]
        by_run[served_config(arch, n_layers, *run[4:]).name] = phase_train(torch, *run)
        lap(f"the [train] run of {arch}")
    # each train run is a path of its own: its counts were set to 0 before
    # each step and read just after; a kernel's launches are their sum
    trained = {name: sum(run[name] for run in by_run.values())
               for name in next(iter(by_run.values()))}
    for row in bwd_rows:
        row["launches"] = trained[row["name"]]
        row["launches_by_train_run"] = {k: run[row["name"]] for k, run in by_run.items()
                                        if run[row["name"]]}
    for row in rows:
        row["launches_in_train_runs"] = trained[row["name"]]
    rows += bwd_rows
    phase_ckpt(torch)
    lap("[ckpt]")
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
