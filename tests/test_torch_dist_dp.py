"""The port's data-parallel train step on rwkv6 (the wkv recurrence; its
tensor parallelism is ``test_torch_dist_rwkv.py``'s) and the models that
take no tensor parallelism yet (ROADMAP A12b): recurrentgemma (the RG-LRU
scan and its window), whisper-tiny (an encoder-decoder) and
llama-3.2-vision-11b (gated cross layers), each whole on every rank of a
(data, model) = (2, 1) world of gloo CPU ranks, against the JAX package's
single-device step on the same weights and masked batch, the frontends
split by rows like the tokens; one and two microbatches, at the lengths
of the single-rank tests (rwkv6 96 tokens, recurrentgemma 128). The
decays, the bonus, the RG-LRU's lam and the cross gates are unhidden as in
the single-rank tests, so that every leaf's gradient shows. Tolerances as
``test_torch_dist_train.py``, every gradient against JAX's, with one
microbatch and two; llama-3.2-vision's scalar ``xgate`` by its own rule
there: with two microbatches their two gradients of it nearly cancel in the
mean the step takes, so it is held to the microbatches' own scale."""
import pytest

from test_torch_dist_train import check, run_cases
from test_torch_train_configs import opened_gate
from test_torch_train_hybrid import seeded_lam
from test_torch_train_rwkv import unhidden

DP_ARCHS = ("rwkv6-7b", "recurrentgemma-2b", "whisper-tiny", "llama-3.2-vision-11b")
CASES = [(a, (2, 1), n) for a in DP_ARCHS for n in (1, 2)]


def unhide(tree):
    return unhidden(seeded_lam(opened_gate(tree)))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    by_arch = {a: [(m, n) for b, m, n in CASES if b == a] for a in DP_ARCHS}
    return run_cases(tmp_path_factory.mktemp("dist_dp"), by_arch, ((2, [(2, 1)]),),
                     prepare=unhide)


@pytest.mark.parametrize("arch,mesh,microbatches", CASES,
                         ids=[f"{a}-{m[0]}x{m[1]}-mb{n}" for a, m, n in CASES])
def test_data_parallel_step_matches_jax_single_device(results, arch, mesh, microbatches):
    check(results, arch, mesh, microbatches)
