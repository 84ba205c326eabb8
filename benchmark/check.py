"""The numbers that decide ``correct``, each beside its limit.

Training cells compare the program's first three steps with the
reference's (``reference/train.py``), by the numbers below that the
cell's ``limits`` name (the others are printed, not compared):

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first gradient;
* ``grad_err``: the norm of the difference between the program's and the
  reference's whole first gradient (every leaf) over the norm of the
  reference's, floored at 1. A rounding error of relative size e moves a leaf's norm by
  about e**2 / 2 and by e over the root of its size, so the gap of norms
  sees bf16 and fp8 nearly alike; the norm of the difference grows with e
  itself. Taken leaf by leaf it swings from seed to seed with the size of
  a leaf's gradient. bf16's error is about 2e-3 of a gradient whose norm
  is over 1, and about 2e-3 in absolute size below (a floor of rounding
  noise that does not shrink with the gradient), so the error is held
  against the larger of the gradient's norm and 1: steady from seed to
  seed either way;
* ``change_gap``: the median over the leaves of the gap between the
  norms of each leaf's change over the three steps. Adam moves an element
  by about ``lr`` whatever its gradient's size, so an element whose
  gradient is near 0 moves one way in the program and the other in the
  reference, and a small leaf's worst gap swings from seed to seed; the
  median leaf's is steady.

A leaf's gap is ``|norm_p - norm_r| / max(norm_r, the median leaf's
norm_r)``. A leaf whose reference gradient is under a thousandth of the
median leaf's moves by round-off alone and is left out of ``change_gap``.

The serving cell compares every served logit with the reference's
(``logit_gap``: the largest absolute gap).
"""

from __future__ import annotations

import statistics


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    floor = statistics.median(ref.values())
    return {k: abs(prog.get(k, 0.0) - r) / max(r, floor) if max(r, floor) > 0 else abs(prog.get(k, 0.0))
            for k, r in ref.items() if keep is None or k in keep}


def table_errors(prog: tuple, ref: tuple, d: int) -> dict:
    """Norms of the difference of two tables' gradients, each given as
    (global row ids, rows [n, D + 1]); a row one side lacks is 0 there."""
    import torch

    (pi, pg), (ri, rg) = prog, ref
    ri, order = torch.sort(ri.to(rg.device))
    rg, pi, pg = rg[order].double(), pi.to(rg.device), pg.to(rg.device).double()
    pos = torch.searchsorted(ri, pi).clamp_(max=max(ri.numel() - 1, 0))
    hit = ri[pos] == pi if ri.numel() else torch.zeros_like(pi, dtype=torch.bool)
    diff = -rg
    diff[pos[hit]] += pg[hit]
    extra = pg[~hit]
    sq = lambda x: float((x ** 2).sum())  # noqa: E731
    return {"table.emb": (sq(diff[:, :d]) + sq(extra[:, :d])) ** 0.5,
            "table.wide": (sq(diff[:, d]) + sq(extra[:, d])) ** 0.5}


def grad_diffs(prog: dict, ref: dict) -> dict:
    """Each leaf's ``norm(g_p - g_r)``."""
    import torch

    d = ref["grad_table"][1].shape[1] - 1
    out = table_errors(prog["grad_table"], ref["grad_table"], d)
    for k, r in ref["grad_vec"].items():
        out[k] = float(torch.linalg.vector_norm(prog["grad_vec"][k].double().to(r.device) - r.double()))
    return out


GRAD_FLOOR = 1.0  # the reference's first-gradient norm below which the error is held absolute


def grad_err(diffs: dict, norms: dict) -> float:
    """The whole first gradient's error: the norm of the difference over
    every leaf, over the larger of the reference's norm over every leaf and
    ``GRAD_FLOOR``."""
    ref = sum(norms[k] ** 2 for k in diffs) ** 0.5
    return sum(x * x for x in diffs.values()) ** 0.5 / max(ref, GRAD_FLOOR)


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog``/``ref``: {"loss": [K], "grad": {leaf: norm}, "grad_vec":
    {dense leaf: tensor}, "grad_table": (row ids, rows), "change": {leaf:
    norm}}."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    if len(prog["loss"]) != len(ref["loss"]):
        loss = float("inf")
    med = statistics.median(ref["grad"].values())
    moving = {k for k, g in ref["grad"].items() if g >= 1e-3 * med}
    return {"loss_gap": loss,
            "grad_gap": max(leaf_gaps(prog["grad"], ref["grad"]).values()),
            "grad_err": grad_err(grad_diffs(prog, ref), ref["grad"]),
            "change_gap": statistics.median(leaf_gaps(prog["change"], ref["change"], moving).values())}


def describe(prog: dict, ref: dict) -> str:
    """The losses side by side, every number, the leaf that sets each gap,
    and each leaf's gradient error beside its reference norm (for the run's
    stderr)."""
    g = leaf_gaps(prog["grad"], ref["grad"])
    c = leaf_gaps(prog["change"], ref["change"])
    e = {k: [float(f"{v:.3g}"), float(f"{ref['grad'][k]:.3g}")] for k, v in grad_diffs(prog, ref).items()}
    return (f"losses {prog['loss']} reference {ref['loss']}; numbers {train_numbers(prog, ref)}; grad_gap set "
            f"by {max(g, key=g.get)}; worst change gap {max(c.values())!r} ({max(c, key=c.get)}); leaves' "
            f"[grad diff, reference norm] {e}")


def judged(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] for each number the cell's ``limits`` name
    (the others are read, not compared); a limit whose number is missing,
    or a number that is not finite, fails."""
    return [(name, float(numbers.get(name, float("nan"))), float(limit)) for name, limit in limits.items()]


def correct(checks: list) -> bool:
    return all(v == v and v <= lim for _, v, lim in checks)
