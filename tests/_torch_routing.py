"""Recording and replaying the port's MoE routing in tests.

A routing is a discrete choice: where two router logits of a token nearly
tie at its k-th choice, a rounding elsewhere (another framework, the card
against the CPU) can flip which expert runs, and that moves the token's
output by a share of its MLP term. So a test replays one side's experts on
the other through the port's ``moe_route`` and holds the other side's own
choices apart, with ``routing_flips``.

Imports no JAX, so that ``test_torch_cuda.py`` can use it where only the
port is installed. A record is (experts (T, k), fp32 router logits (T, E))
of one ``moe_route`` call, as tensors or numpy arrays.
"""
import numpy as np
import torch

from repro_torch.models import layers


def record_routing(monkeypatch):
    """Wrap the port's ``moe_route``: each call appends its experts and
    fp32 router logits, on the CPU, to the list returned."""
    records, route = [], layers.moe_route

    def recorded(cfg, p, xt):
        out = route(cfg, p, xt)
        records.append((out[2].cpu(), (xt.float() @ p["router"]).detach().cpu()))
        return out

    monkeypatch.setattr(layers, "moe_route", recorded)
    return records


def replay_routing(monkeypatch, records, own=None):
    """Make the port's ``moe_route`` return the recorded experts, call by
    call, gated by its own probabilities at them; returns the iterator of
    the records left. With `own` (a list), each call first appends the
    experts it would have chosen itself, and its router logits, as
    ``record_routing`` does: on the replayed run's inputs, which follow the
    recorded side's in every layer and step."""
    calls, route = iter(records), layers.moe_route

    def replayed(cfg, p, xt):
        probs, _, idx = route(cfg, p, xt)
        if own is not None:
            own.append((idx.cpu(), (xt.float() @ p["router"]).detach().cpu()))
        idx = torch.as_tensor(np.array(next(calls)[0]), dtype=torch.long, device=xt.device)
        gate = probs.gather(-1, idx)
        return probs, gate / gate.sum(-1, keepdim=True).clamp_min(1e-9), idx

    monkeypatch.setattr(layers, "moe_route", replayed)
    return calls


def routing_flips(k, want, got):
    """(choices of `got` outside `want`'s top-k over all calls; those of
    them whose token's margin in `want` between its k-th and (k+1)-th
    router logit exceeds twice the call's largest |got - want| router
    logit). Such a margin cannot flip: each of the two logits moved by at
    most that difference."""
    n = beyond = 0
    assert len(want) == len(got), f"{len(got)} routing calls, not {len(want)}"
    for (wi, wl), (gi, gl) in zip(want, got):
        wi, wl, gi, gl = (torch.as_tensor(np.array(a)) for a in (wi, wl, gi, gl))
        differ = (gi[:, :, None] != wi[:, None, :]).all(-1).sum(-1)
        top = wl.sort(-1, descending=True).values
        delta = (gl - wl).abs().max().item()
        n += int(differ.sum())
        beyond += int(differ[top[:, k - 1] - top[:, k] > 2 * delta].sum())
    return n, beyond
