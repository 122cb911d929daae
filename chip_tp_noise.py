"""How far rwkv6-7b's tensor-parallel train step lies from the single-rank
one on the card, by rounding alone: rwkv6-7b at full width cut to 2 layers,
one step of 1 x 256 tokens at (data, model) = (1, 2) on two gloo ranks
sharing the card, against the single-rank card step and, for bf16, an fp32
CPU step of the same weights, under two unhidings (``chip_smoke.
unhide_recurrence``: the decays and the bonus; ``unhide_rwkv``: also the
group-norm gains and the shift mixes), bf16 over three data seeds and fp32
over one.

    python3 chip_tp_noise.py          # on a host with a card; ~5 min

Prints a ``[probe]`` line a run: for bf16 each leaf's distance from the
single-rank step and the ratio ``chip_smoke.py``'s [dist] (b) rule reads
(the TP step's distance from the fp32 CPU step over the single-rank card
step's); for fp32 each leaf's distance from the single-rank fp32 step.
Writes every leaf's numbers to ``build/probe_rwkv_tp.json``."""
import json
import shutil
import sys
import tempfile
from pathlib import Path
import numpy as np
import torch
import torch.multiprocessing as mp
ROOT = Path(__file__).resolve().parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
import chip_smoke as CS

VARIANTS = ("w0u", "full")
SEEDS = (0, 1, 2)


def unhide(model, variant):
    with torch.no_grad():
        if variant == "w0u":
            CS.unhide_recurrence(torch, model)
        else:
            CS.unhide_rwkv(torch, model)


def combos():
    for v in VARIANTS:
        for dt in ("bf16", "fp32"):
            for seed in (SEEDS if dt == "bf16" else SEEDS[:1]):
                yield v, dt, seed


def batch_of(cfg, seed):
    from repro_torch.data import DataConfig, TokenPipeline
    raw = TokenPipeline(DataConfig(cfg.vocab_size, 256, 1, seed=seed)).batch_at(0)
    return {k: torch.from_numpy(v) for k, v in raw.items()}


def worker(rank, world, store, tmp):
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from repro_torch.distributed.sharding import init_sharded
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.training import step_grads
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world)
    cfg = CS.served_config("rwkv6-7b", 2)
    mesh = make_host_mesh(1, 2)
    for v, dt, seed in combos():
        model = init_sharded(cfg, mesh, seed=0, device="cuda")
        unhide(model, v)
        if dt == "fp32":
            model = model.float()
        model.requires_grad_(True)
        b = {k: t.cuda() for k, t in batch_of(cfg, seed).items()}
        loss, grads, _ = step_grads(model, b)
        grads = model.par.gather_state(grads)
        if rank == 0:
            torch.save({"loss": float(loss), "grads": {n: g.float() for n, g in grads.items()}},
                       Path(tmp) / f"tp_{v}_{dt}_{seed}.pt")
        del model, grads
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def main():
    from repro_torch.models.lm import LM, init_params
    from repro_torch.training import step_grads
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    CS.phase_build(torch)
    tmp = Path(tempfile.mkdtemp(dir=ROOT / "build"))
    ctx = mp.start_processes(worker, args=(2, str(tmp / "store"), str(tmp)), nprocs=2,
                             join=False, start_method="spawn")
    cfg = CS.served_config("rwkv6-7b", 2)
    single, cpu32 = {}, {}
    for v, dt, seed in combos():
        model = init_params(cfg, seed=0, device="cuda")
        unhide(model, v)
        if dt == "fp32":
            model = model.float()
        model.requires_grad_(True)
        b = batch_of(cfg, seed)
        loss, g, _ = step_grads(model, {k: t.cuda() for k, t in b.items()})
        single[(v, dt, seed)] = (float(loss), {n: x.float().cpu() for n, x in g.items()})
        if dt == "bf16":
            state = {n: p.detach().cpu() for n, p in model.state_dict().items()}
            cpu = LM(cfg, device="cpu")
            cpu.load_state_dict(state)
            cpu = cpu.float().requires_grad_(True)
            cpu32[(v, seed)] = step_grads(cpu, b)[1]
            del cpu
        del model
        torch.cuda.empty_cache()
    while not ctx.join(600):
        pass
    out = {}
    for v, dt, seed in combos():
        tp = torch.load(tmp / f"tp_{v}_{dt}_{seed}.pt")
        l1, g1 = single[(v, dt, seed)]
        rows = []
        for n in g1:
            rel = ((tp["grads"][n] - g1[n]).norm() / g1[n].norm().clamp_min(1e-30)).item()
            row = [n, rel]
            if dt == "bf16":
                f = cpu32[(v, seed)][n].float()
                row += [((tp["grads"][n] - f).norm() / (g1[n] - f).norm().clamp_min(1e-30)).item(),
                        ((g1[n] - f).norm() / f.norm().clamp_min(1e-30)).item()]
            rows.append(row)
        rows.sort(key=lambda r: -(r[2] if dt == "bf16" else r[1]))
        key = f"{v} {dt} seed {seed}"
        out[key] = rows
        if dt == "bf16":
            ratios = [r[2] for r in rows]
            print(f"[probe] {key}: loss tp {tp['loss']:.6f} one {l1:.6f}; ratio max "
                  f"{max(ratios):.3f} median {np.median(ratios):.3f}, >1.5: "
                  f"{sum(r > 1.5 for r in ratios)} of {len(ratios)}; rel to one rank median "
                  f"{np.median([r[1] for r in rows]):.4f}; one rank from fp32 median "
                  f"{np.median([r[3] for r in rows]):.4f} max {max(r[3] for r in rows):.4f}; "
                  f"worst {[(r[0], round(r[2], 3), round(r[1], 4), round(r[3], 4)) for r in rows[:4]]}",
                  flush=True)
        else:
            print(f"[probe] {key}: loss tp {tp['loss']:.8f} one {l1:.8f}; rel to one rank max "
                  f"{rows[0][1]:.3e} median {np.median([r[1] for r in rows]):.3e}; worst "
                  f"{[(r[0], r[1]) for r in rows[:4]]}", flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    with open(ROOT / "build" / "probe_rwkv_tp.json", "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
