"""Plain PyTorch candidate tables of the mapper: ``core/mapper.py::_tables``
statement for statement on int64 / float64 tensors.

It takes the gathered chunk as per-row tensors (``ops.to_tensors``): every
column densified to the chunk's rows in numpy's dtype, int64 for tiles,
shapes and hardware integers, float64 for the clock, the memory rate, the
issue-rate scale and any byte column numpy promoted, bool for the flags.
PyTorch promotes int64 with float64 as numpy does; where the two differ it
is written out: an int64 true division (float32 in PyTorch) and the square
root of an int64 (float32 too) cast to float64 first, and every mixed
maximum, minimum and select taken in the common type. Floor division of
float64 is numpy's algorithm in both (fmod, then the quotient snapped to
an integer), and ``torch.round`` rounds half to even as ``np.round`` does.
"""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor

# pipeline options p = (db2, db1), in the mapper's order
_DB_OPTIONS = ((0, 0), (0, 1), (1, 0), (1, 1))


def _common(a: Tensor, b: Tensor):
    t = torch.promote_types(a.dtype, b.dtype)
    return a.to(t), b.to(t)


def _max(a: Tensor, b: Tensor) -> Tensor:
    return torch.maximum(*_common(a, b))


def _min(a: Tensor, b: Tensor) -> Tensor:
    return torch.minimum(*_common(a, b))


def _where(c: Tensor, a: Tensor, b: Tensor) -> Tensor:
    return torch.where(c, *_common(a, b))


def _fdiv(a: Tensor, b: Tensor) -> Tensor:
    """``a // b`` as numpy computes it (floor, in the common type)."""
    return torch.div(*_common(a, b), rounding_mode="floor")


def _cdiv(a: Tensor, b: Tensor) -> Tensor:
    """``-(-a // b)``: the tables' ceiling division."""
    return -_fdiv(-a, b)


def _tdiv(a: Tensor, b: Tensor) -> Tensor:
    """``a / b`` as numpy computes it: float64 true division."""
    return a.to(torch.float64) / b.to(torch.float64)


def gemm_cycles_ref(m: Tensor, k: Tensor, n: Tensor, rows: Tensor,
                    cols: Tensor) -> Tensor:
    """``core/systolic.py::gemm_cycles_array`` on int64 tensors."""
    full_r, rem_r = _fdiv(m, rows), torch.remainder(m, rows)
    full_c, rem_c = _fdiv(n, cols), torch.remainder(n, cols)

    def pc(r_occ, c_occ):
        return 2 * r_occ + c_occ + k - 2

    zero = torch.zeros_like(m)
    total = full_r * full_c * pc(rows, cols)
    total = total + torch.where(rem_r > 0, full_c * pc(rem_r, cols), zero)
    total = total + torch.where(rem_c > 0, full_r * pc(rows, rem_c), zero)
    total = total + torch.where((rem_r > 0) & (rem_c > 0), pc(rem_r, rem_c),
                                zero)
    return total


def tables_ref(g: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Price every candidate row of a gathered chunk, as ``_tables`` does.
    Returns the same tables as tensors on g's device: `totals` [rows, 4]
    (inf where the pipeline option is infeasible), `use_s2` and `tile_time`
    [rows, 2], and the level-2 columns."""
    TM_, TK_, TN_ = g["tm"], g["tk"], g["tn"]
    SM_, SK_, SN_ = g["sm"], g["sk"], g["sn"]
    P_OK = g["p_ok"]
    sa_rows, sa_cols, lanes = g["sa_rows"], g["sa_cols"], g["lanes"]
    freq, cores, gb_bw_cyc = g["freq"], g["cores"], g["gb_bw_cyc"]
    mem_bw, vec_tp = g["mem_bw"], g["vec_tp"]
    m_v, k_v, n_v, batch_v = g["m"], g["k"], g["n"], g["batch"]
    bytes_a_v, bytes_b_v = g["bytes_a"], g["bytes_b"]
    bytes_out_v, bytes_acc_v = g["bytes_out"], g["bytes_acc"]
    bshared_v, mac_scale_v = g["b_shared"], g["mac_scale"]

    # ---------------- level 0: core compute time for one subtile ----------
    sn_lane = _cdiv(SN_, lanes)
    subtile_cyc = gemm_cycles_ref(SM_, SK_, sn_lane, sa_rows, sa_cols)
    subtile_cyc = torch.ceil(_tdiv(subtile_cyc, mac_scale_v)).to(torch.int64)

    # ---------------- level 1: schedule subtiles across cores -------------
    n_sub_m = _cdiv(TM_, SM_)
    n_sub_n = _cdiv(TN_, SN_)
    n_sub_k = _cdiv(TK_, SK_)

    # -- scheme 1: distinct C subtiles per core, k-loop inside core --------
    out_subtiles = n_sub_m * n_sub_n
    waves = _cdiv(out_subtiles, cores)
    w = _min(out_subtiles, cores)
    gm = _min(n_sub_m, torch.clamp_min(torch.round(torch.sqrt(w.to(torch.float64))),
                                       1.0).to(torch.int64))
    gn = _min(n_sub_n, torch.clamp_min(_cdiv(w, gm), 1))
    wave_traffic = gm * SM_ * TK_ * bytes_a_v + gn * TK_ * SN_ * bytes_b_v \
        + gm * gn * SM_ * SN_ * bytes_out_v
    wave_mem_cyc = _cdiv(wave_traffic, gb_bw_cyc)
    wave_cmp_cyc = n_sub_k * subtile_cyc
    s1_db0 = waves * (wave_mem_cyc + wave_cmp_cyc)
    s1_db1 = waves * _max(wave_mem_cyc, wave_cmp_cyc) \
        + _min(wave_mem_cyc, wave_cmp_cyc)

    # -- scheme 2: split K of each C subtile across spare cores ------------
    ck = torch.clamp_min(_min(_fdiv(cores, torch.clamp_min(out_subtiles, 1)),
                              n_sub_k), 1)
    k_per_core = _cdiv(n_sub_k, ck)
    s2_cmp_cyc = k_per_core * subtile_cyc
    red_traffic = (2 * (ck - 1)) * SM_ * SN_ * bytes_acc_v
    red_cyc = _cdiv(red_traffic, gb_bw_cyc) + \
        _cdiv((ck - 1) * SM_ * SN_, torch.clamp_min(vec_tp * cores, 1))
    s2_waves = _cdiv(out_subtiles * ck, cores)
    s2_traffic = SM_ * TK_ * bytes_a_v + TK_ * SN_ * bytes_b_v
    s2_mem_cyc = _cdiv(_fdiv(s2_traffic * out_subtiles,
                             torch.clamp_min(s2_waves, 1)), gb_bw_cyc)
    s2_db0 = s2_waves * (s2_mem_cyc + s2_cmp_cyc) + red_cyc
    s2_db1 = s2_waves * _max(s2_mem_cyc, s2_cmp_cyc) + red_cyc

    use_s2 = (torch.lt(*_common(s2_db0, s1_db0)), torch.lt(*_common(s2_db1, s1_db1)))
    tile_time = (_tdiv(_where(use_s2[0], s2_db0, s1_db0), freq),
                 _tdiv(_where(use_s2[1], s2_db1, s1_db1), freq))

    # ---------------- level 2: main memory <-> global buffer --------------
    n_t_m = _cdiv(m_v, _min(TM_, m_v))
    n_t_n = _cdiv(n_v, _min(TN_, n_v))
    n_t_k = _cdiv(k_v, _min(TK_, k_v))
    steps = batch_v * n_t_m * n_t_n * n_t_k
    a_bytes_step = TM_ * TK_ * bytes_a_v
    b_bytes_step = TK_ * TN_ * bytes_b_v
    c_bytes_tile = TM_ * TN_ * bytes_out_v
    # B re-read only once per k-sweep regardless of batch when b_shared
    step_mem_t = torch.where(bshared_v & (batch_v > 1),
                             _tdiv(a_bytes_step + _tdiv(b_bytes_step, batch_v), mem_bw),
                             _tdiv(a_bytes_step + b_bytes_step, mem_bw))
    c_mem_t = _tdiv(c_bytes_tile, mem_bw)
    c_total_t = batch_v * n_t_m * n_t_n * c_mem_t

    inf = torch.full_like(c_total_t, float("inf"))
    cols = []
    for p, (db2, db1) in enumerate(_DB_OPTIONS):
        tt = tile_time[db1]
        if db2:
            tot = steps * torch.maximum(step_mem_t, tt) + c_total_t \
                + torch.minimum(step_mem_t, tt)
        else:
            tot = steps * (step_mem_t + tt) + c_total_t
        cols.append(torch.where(P_OK[:, p], tot, inf))

    return {"totals": torch.stack(cols, dim=1),
            "use_s2": torch.stack(use_s2, dim=1),
            "tile_time": torch.stack(tile_time, dim=1),
            "steps": steps, "step_mem_t": step_mem_t,
            "c_total_t": c_total_t,
            "n_t_m": n_t_m, "n_t_n": n_t_n, "n_t_k": n_t_k}
