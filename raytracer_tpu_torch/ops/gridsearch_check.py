"""The grid search's tie rule: check-only, no path of the port calls it.

The tests and chip_smoke.py hold a search's picks (j, t0, m) to the
rows of a twin (`ops/gridsearch.py`) with it.  Node ids of two summation
orders are never compared outright: two nodes can tie to the last bit (a
halo twin and its partner carry the same times), and two orders flip a
near tie.  So a pick passes when

  * its misfit in the rows is within the tolerance of the rows' minimum,
  * its m and t0 equal the rows' values at that node within the
    tolerance,
  * its node is the rows' argmin wherever the rows' best misfit beats
    their second best by more than the two nodes' tolerances.

The tolerances follow the formula's rounding:

  * direct: m is a sum of non-negative terms, so m_tol = m_rtol * m, plus
    the square of t0's rounding, W2 (terms_rtol * t0_terms)^2 (a t0 off
    by d moves m by W2 d^2 only), where t0_terms = sum_k w2 |resid_k| / W2
    bounds t0's terms; t0_tol = terms_rtol * t0_terms + t0_atol;
  * expanded: m = A_e - 2 B_ej + C_j cancels terms of size up to A_e + C_j
    (~1e8 s^2 at 180x63 against a minimum of ~12 s^2), so m_tol =
    terms_rtol * (A_e + C_j), and t0 = (s1_e - s2_j) / W2 gives t0_tol =
    terms_rtol * (|s1_e| + |s2_j|) / W2 + t0_atol.  In float32 that
    cancellation leaves most picks of a catalogue within the tolerance of
    another node, so there the rule compares few ids.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gridsearch import _direct_rows, _expanded_rows


def ulp_rtol(dtype: torch.dtype, K: int) -> float:
    """Four times the rounding bound of a K-term weighted sum and its
    combine, 4 (K + 2) eps: a few ulps of the terms' magnitudes."""
    return 4.0 * (K + 2) * torch.finfo(dtype).eps


class SearchRows(NamedTuple):
    """Every node's misfit and origin time for every event (E, n), with
    the tolerance on each (see the module docstring)."""

    m: torch.Tensor
    t0: torch.Tensor
    m_tol: torch.Tensor
    t0_tol: torch.Tensor


def misfit_rows(T: torch.Tensor, T_obs: torch.Tensor, w2: torch.Tensor,
                mode: str, m_rtol: float, terms_rtol: float = None,
                t0_atol: float = 0.0) -> SearchRows:
    """Every node's (m, t0) for every event by the twin of `mode`, with
    their tolerances; terms_rtol defaults to m_rtol."""
    if terms_rtol is None:
        terms_rtol = m_rtol
    if mode == "expanded":
        m, W2, s1, s2, A, C = _expanded_rows(T, T_obs, w2)
        t0 = (s1[:, None] - s2[None, :]) / W2
        m_tol = terms_rtol * (A[:, None] + C[None, :])
        t0_tol = terms_rtol * (s1.abs()[:, None] + s2.abs()[None, :]) / W2
    else:
        W2 = torch.sum(w2)
        pairs = [_direct_rows(T, row, w2) for row in T_obs]
        m = torch.stack([p[0] for p in pairs])
        t0 = torch.stack([p[1] for p in pairs])
        terms = torch.stack([w2 @ (row[:, None] - T).abs()
                             for row in T_obs]) / W2
        t0_tol = terms_rtol * terms
        m_tol = m_rtol * m.abs() + W2 * t0_tol ** 2
    # a non-finite column (m = inf) is matched exactly
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    m_tol = torch.where(torch.isfinite(m), m_tol, zero)
    t0_tol = torch.where(torch.isfinite(t0_tol), t0_tol, zero)
    return SearchRows(m, t0, m_tol, t0_tol + t0_atol)


def _require(ok: bool, *what) -> None:
    if not ok:
        raise AssertionError(what)


def _host(rows: SearchRows) -> SearchRows:
    return SearchRows(*(x.detach().cpu().double() for x in rows))


def tie_free(rows: SearchRows) -> torch.Tensor:
    """(E,) bool: the rows' best misfit beats their second best by more
    than the two nodes' tolerances, so any right search picks the best."""
    rows = _host(rows)
    two = torch.topk(rows.m, 2, dim=1, largest=False)
    best, second = two.indices[:, 0], two.indices[:, 1]
    e = torch.arange(rows.m.shape[0])
    gap = rows.m[e, second] - rows.m[e, best]
    return gap > rows.m_tol[e, best] + rows.m_tol[e, second]


def search_agreement(rows: SearchRows, j, t0, m) -> dict:
    """Hold a search's (j, t0, m) (E,) to reference rows under the tie
    rule (module docstring).  Raises AssertionError naming the first
    event that breaks a rule; returns the counts and the largest errors
    of m (s^2) and t0 (s), and m's relative to its tolerance."""
    j, t0, m = (x.detach().cpu() if torch.is_tensor(x)
                else torch.from_numpy(np.array(x)) for x in (j, t0, m))
    j, t0, m = j.long(), t0.double(), m.double()
    free = tie_free(rows)
    rows = _host(rows)
    out = dict(events=int(j.shape[0]), same_node=0, tied=0, m_abs=0.0,
               m_of_tol=0.0, t0_err=0.0)
    for e in range(j.shape[0]):
        jk, row = int(j[e]), rows.m[e]
        best = int(torch.argmin(row))
        tol = float(rows.m_tol[e, jk])
        both_inf = bool(torch.isinf(row[jk])) and bool(torch.isinf(m[e]))
        _require(float(row[jk]) <= float(row[best]) + tol
                 + float(rows.m_tol[e, best]) or both_inf,
                 "pick not a minimum", e, jk, float(row[jk]), best,
                 float(row[best]), tol)
        err = 0.0 if both_inf else abs(float(m[e]) - float(row[jk]))
        _require(err <= tol, "m", e, jk, float(m[e]), float(row[jk]), tol)
        rt0 = float(rows.t0[e, jk])
        terr = abs(float(t0[e]) - rt0)
        if not (torch.isfinite(t0[e]) and np.isfinite(rt0)):
            terr = 0.0 if str(float(t0[e])) == str(rt0) else float("inf")
        _require(terr <= float(rows.t0_tol[e, jk]), "t0", e, jk,
                 float(t0[e]), rt0, float(rows.t0_tol[e, jk]))
        if bool(free[e]):
            _require(jk == best, "node", e, jk, best)
            out["same_node"] += 1
        else:
            out["tied"] += 1
        out["m_abs"] = max(out["m_abs"], err)
        out["m_of_tol"] = max(out["m_of_tol"], err / tol if tol else 0.0)
        out["t0_err"] = max(out["t0_err"], terr)
    return out
