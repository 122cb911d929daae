"""Serving engine of the port: batched prefill + continuous-batching decode.

The same slot model as ``repro.serving.engine``:
  * the engine owns `batch_size` slots and one cache (K/V and cross K/V, a
    Griffin model's ring K/V, RG-LRU state and conv carry, or an RWKV6
    model's recurrent state and token shifts); slot admission,
    budgets and refill-on-completion live in `core.scheduler.SlotScheduler`;
  * prefill runs per admission wave (right-padded prompts, per-sequence
    prompt lengths); finished slots are refilled by a single-prompt prefill
    into a fresh batch-1 cache that is copied into the slot;
  * decode advances all live slots every step (dead slots masked), sampling
    every slot with its own request's SamplingParams.

A model with cross-attention takes each request's stub frontend,
(n_frontend_tokens, d) embeddings: the wave's prefill stacks them, with
zero rows for idle slots, and a refill passes its request's own. A slot's cross
K/V are always its request's own, or zero where the request brings no
frontend (an encoder-decoder refuses such a request); never another's. The
JAX engine passes no frontend at all, so it cannot serve whisper
(``ROADMAP.md``, C12).

A wave's prompts need not be of one length, for recurrent models too: the
model's prefill keeps each sequence's right pads out of its recurrent state
(where the JAX engine's docstring promises equal-length buckets that its
scheduler does not make).

PyTorch runs eagerly, so nothing is jitted. The cache is updated in place.
The prefill and decode times in `stats` end when the sampled tokens are read
back to the host, which waits for the device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from ..configs.base import ModelConfig
from ..core.scheduler import SlotScheduler
from ..device import resolve_device
from ..models.lm import LM, init_cache
from .sampler import SamplingParams, sample_per_request


@dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: int = 32
    eos_id: int = -1
    sampling: SamplingParams = field(default_factory=SamplingParams)
    frontend: Optional[torch.Tensor] = None   # (n_frontend_tokens, d) stub embeddings
    output: List[int] = field(default_factory=list)
    done: bool = False


class Engine:
    def __init__(self, cfg: ModelConfig, params: LM, batch_size: int,
                 max_len: int, seed: int = 0, policy: str = "continuous",
                 device=None):
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"the model lies on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.B = batch_size
        self.max_len = max_len
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.cache = init_cache(cfg, batch_size, max_len, self.device)
        self.sched = SlotScheduler(batch_size, policy=policy)
        self.stats = {"tokens_out": 0, "prefill_s": 0.0, "decode_s": 0.0,
                      "steps": 0}

    def _tensor(self, data) -> torch.Tensor:
        return torch.tensor(data, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    def _insert(self, one_cache: dict, slot: int) -> None:
        """Copy every tensor of a batch-1 cache into `slot` of the engine
        cache: the slot is axis 0 of ``pos`` and axis 1 (after the layer)
        of every other tensor (K/V and their ring, cross K/V, RG-LRU state
        and conv carry, RWKV6 state and token shifts alike)."""
        for name, one in one_cache.items():
            if name == "pos":
                self.cache[name][slot] = one[0]
            else:
                self.cache[name][:, slot] = one[:, 0]

    def _frontends(self, reqs: List[Request], batch: int) -> Optional[torch.Tensor]:
        """The requests' frontends stacked into (batch, n_frontend_tokens, d)
        bf16, zero rows past them (idle slots) and for a request that brings
        none (which give it zero cross K/V), or None where none brings one.
        Raises ValueError for a frontend of another shape, and for a request
        without one to a model with an encoder."""
        cfg = self.cfg
        want = (cfg.n_frontend_tokens, cfg.d_model)
        for r in reqs:
            if r.frontend is None and cfg.n_encoder_layers:
                raise ValueError(f"request {r.uid} brings no frontend; {cfg.name} needs one "
                                 f"of {want}")
            if r.frontend is not None and tuple(r.frontend.shape) != want:
                raise ValueError(f"request {r.uid}: frontend of {tuple(r.frontend.shape)}, "
                                 f"{cfg.name} takes {want}")
        if all(r.frontend is None for r in reqs):
            return None
        out = torch.zeros((batch,) + want, dtype=torch.bfloat16, device=self.device)
        for i, r in enumerate(reqs):
            if r.frontend is not None:
                out[i] = r.frontend
        return out

    # ------------------------------------------------------------------
    def admit_wave(self, requests: List[Request]):
        """Prefill a wave of requests into free slots (right-padded)."""
        pairs = self.sched.plan_wave(requests)
        if not pairs:
            return []
        wave = [r for _, r in pairs]
        t0 = time.perf_counter()
        if self.sched.idle:
            # whole-batch prefill path
            S = max(max(len(r.prompt) for r in wave), 1)
            toks = [[0] * S for _ in range(self.B)]
            lens = [1] * self.B
            for i, r in enumerate(wave):
                toks[i][:len(r.prompt)] = r.prompt
                lens[i] = max(len(r.prompt), 1)
            logits = self.params.prefill(self._tensor(toks), self.cache,
                                         self._tensor(lens), self._frontends(wave, self.B))
            first = sample_per_request(logits[:len(wave)], self.generator,
                                       [r.sampling for r in wave]).tolist()
            for i, r in enumerate(wave):
                self._admit_slot(i, r, first[i])
        else:
            # per-slot insertion
            for slot, r in pairs:
                one = init_cache(self.cfg, 1, self.max_len, self.device)
                logits = self.params.prefill(self._tensor([r.prompt]), one,
                                             self._tensor([len(r.prompt)]),
                                             self._frontends([r], 1))
                self._insert(one, slot)
                first = sample_per_request(logits[:1], self.generator,
                                           [r.sampling]).tolist()
                self._admit_slot(slot, r, first[0])
        self.stats["prefill_s"] += time.perf_counter() - t0
        return wave

    # ------------------------------------------------------------------
    def _admit_slot(self, slot: int, r: Request, first_token: int):
        """The prefill's first sampled token counts against the budget."""
        r.output.append(first_token)
        self.stats["tokens_out"] += 1
        if (r.max_new_tokens <= 1
                or (r.eos_id >= 0 and first_token == r.eos_id)):
            r.done = True
            return
        self.sched.admit(slot, r, r.max_new_tokens - 1)

    # ------------------------------------------------------------------
    def decode_round(self):
        """One decode step for all live slots (dead slots stay masked;
        each live slot samples with its own request's SamplingParams)."""
        live = self.sched.live_slots()
        if not live:
            return
        t0 = time.perf_counter()
        tok = [0] * self.B
        for i in live:
            tok[i] = self.sched.slot_req[i].output[-1]
        logits = self.params.decode_step(self._tensor(tok), self.cache)
        nxt = sample_per_request(
            logits[torch.tensor(live, device=self.device)], self.generator,
            [self.sched.slot_req[i].sampling for i in live]).tolist()
        self.stats["decode_s"] += time.perf_counter() - t0
        self.stats["steps"] += 1
        for j, i in enumerate(live):
            r = self.sched.slot_req[i]
            r.output.append(nxt[j])
            self.stats["tokens_out"] += 1
            hit_eos = r.eos_id >= 0 and r.output[-1] == r.eos_id
            if self.sched.step(i, hit_eos=hit_eos):
                r.done = True

    # ------------------------------------------------------------------
    def run(self, requests: List[Request]) -> List[Request]:
        """Offline serve: continuous batching until all requests finish."""
        pending = list(requests)
        submitted: List[Request] = []
        while pending or not self.sched.idle:
            if pending:
                wave = self.admit_wave(pending)
                submitted += wave
                pending = pending[len(wave):]
            self.decode_round()
        return submitted

    def throughput(self) -> float:
        tot = self.stats["prefill_s"] + self.stats["decode_s"]
        return self.stats["tokens_out"] / tot if tot > 0 else 0.0
