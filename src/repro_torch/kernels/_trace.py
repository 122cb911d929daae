"""What a kernel wrapper counts where it launches its kernel: one launch,
and the operations the launch does (``ops``) in a tally beside it.

A real launch and a traced one (a wrapper given fake tensors by a dry run,
``device.traced``) count alike: the traced wrapper takes the route the real
call would take, allocates the outputs and workspaces the real launch
allocates, counts, and returns before anything is built or launched. Each
wrapper's operation count is a function of its shapes alone, never of the
data (a decode launch counts every key slot of its cache, a wkv or RG-LRU
one every step of its input), so that a trace can count it; these are the
"operations" of the kernels' bounds in PERF.md.
"""
from __future__ import annotations


def launched(fn, ops: float, result=None):
    """Count one launch of `fn`'s kernel doing `ops` operations; returns
    `result` (the outputs, for a traced wrapper's early return)."""
    fn.launches += 1
    fn.ops = getattr(fn, "ops", 0) + ops
    return result


def attention_pairs(Sq: int, Sk: int, causal: bool, window: int) -> int:
    """(query, key) pairs an attention call scores: every pair, or under a
    causal mask (query i aligned to key i) the keys up to the query's, the
    last `window` of them where a window is set."""
    if not causal:
        return Sq * Sk
    w = window if 0 < window < Sk else Sk
    n = min(Sq, Sk)
    first = min(n, w)           # the queries before the window fills
    past = sum(max(0, Sk - max(0, i - window + 1 if window else 0))  # queries past the keys
               for i in range(Sk, Sq))
    return first * (first + 1) // 2 + (n - first) * w + past
