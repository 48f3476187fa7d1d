"""The numbers that decide ``correct``: each a gap between what the
program's timed path produced and the float64 reference, worst case over
what was compared.  ``portbench/limits/<cell>.json`` holds each number's
limit and the readings it was set from.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from .reference.ppca import canonical_gram


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double().to(a.device)
    den = float(torch.linalg.vector_norm(b))
    return float(torch.linalg.vector_norm(a - b)) / den if den > 0 else float(
        torch.linalg.vector_norm(a))


def train(prog_llks: List[float], prog_params: Dict, ref_llks: List[float],
          ref_params: Dict) -> Dict[str, float]:
    """``llk_rel``: the worst relative gap of a step's llk per row.
    ``param_rel``: the worst relative gap, over components, of C C^T, the
    mean and sigma after the steps (norms of the differences), and of the
    mixture weights (absolute)."""
    gaps_llk = [abs(p - r) / abs(r) for p, r in zip(prog_llks, ref_llks)]
    llk = max(gaps_llk, default=math.inf)
    if len(prog_llks) != len(ref_llks) or not all(map(math.isfinite, gaps_llk)):
        llk = math.inf
    gaps = []
    for j in range(ref_params["Cs"].shape[0]):
        gaps.append(_rel(canonical_gram(prog_params["Cs"][j].double()),
                         canonical_gram(ref_params["Cs"][j].double())))
        gaps.append(_rel(prog_params["means"][j], ref_params["means"][j]))
        gaps.append(_rel(prog_params["sigmas"][j].reshape(1), ref_params["sigmas"][j].reshape(1)))
    if ref_params["log_weights"] is not None:
        w_p = prog_params["log_weights"].double().exp()
        w_r = ref_params["log_weights"].double().exp().to(w_p.device)
        gaps.append(float((w_p - w_r).abs().max()))
    param = max(gaps) if all(map(math.isfinite, gaps)) else math.inf
    return {"llk_rel": llk, "param_rel": param}


class ReadoutGap:
    """The worst gaps of readout outputs against the reference, fed block
    by block.  ``score_rel``: the worst gap of a row's score (a model's
    llk, a mixture's log-posterior of each component) over max(1,
    |reference|).  ``impute_rel``: the worst gap of an imputed entry over
    the largest reference entry compared.  Outputs of the wrong shape, or
    not all finite, make both infinite."""

    def __init__(self):
        self.score, self.gap, self.scale, self.bad = 0.0, 0.0, 0.0, False

    def add(self, prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> None:
        if prog is None:
            self.bad = True
            return
        p, pi = prog["score"].double(), prog["impute"].double()
        r, ri = ref["score"].double().to(p.device), ref["impute"].double().to(pi.device)
        if p.shape != r.shape or pi.shape != ri.shape:
            self.bad = True
            return
        if p.numel() == 0:
            return
        if not (bool(torch.isfinite(p).all()) and bool(torch.isfinite(pi).all())):
            self.bad = True
            return
        self.score = max(self.score, float(((p - r).abs() / r.abs().clamp(min=1.0)).max()))
        self.gap = max(self.gap, float((pi - ri).abs().max()))
        self.scale = max(self.scale, float(ri.abs().max()))

    def failed(self) -> Dict[str, float]:
        self.bad = True
        return self.result()

    def result(self) -> Dict[str, float]:
        if self.bad or self.scale <= 0:
            return {"score_rel": math.inf, "impute_rel": math.inf}
        return {"score_rel": _finite(self.score), "impute_rel": _finite(self.gap / self.scale)}


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf
