"""How far one trainer's state after a step is from another's.

The checks of the data-parallel step (the CPU tests, ``graft_entry.
dryrun_multichip`` and ``chip_smoke.py``) hold a step on a mesh to the
unsharded step on the same batch, draws and state, leaf by leaf, at
``STEP_BOUNDS``: the bounds the unsharded port is held to against the JAX
package (tests/test_torch_port_siamese_train.py). The trainer itself does
not use this module.
"""

from __future__ import annotations

import torch

#: the loss relative, the parameters absolute, each running statistic
#: ``stats_atol + stats_rtol * |ref|``. The momentum trace holds raw
#: gradients, so each leaf is held to ``trace_rtol`` of its own largest
#: entry, or ``trace_floor`` of the net's where that is larger.
STEP_BOUNDS = {"loss_rtol": 1e-5, "param_atol": 1e-5, "stats_rtol": 1e-5, "stats_atol": 1e-6,
               "trace_rtol": 2e-4, "trace_floor": 1e-6}

MEASURES = ("params", "stats", "trace")


def _momentum(trainer) -> dict:
    return {k: trainer.opt.state[p]["momentum_buffer"].detach().cpu().double()
            for k, p in trainer.model.named_parameters()
            if "momentum_buffer" in trainer.opt.state.get(p, {})}


def leaf_gaps(ref, other, ref_loss: float, other_loss: float) -> dict:
    """``other``'s distance from ``ref`` over its bound in ``STEP_BOUNDS``
    (1 or less passes): ``"loss"`` a number; ``"params"``, ``"stats"``
    (each running statistic; a ``num_batches_tracked`` that differs is
    ``inf``) and ``"trace"`` (a momentum buffer that one of them lacks is
    ``inf``) each a {leaf name: gap} dict."""
    b = STEP_BOUNDS
    sr = {k: v.detach().cpu().double() for k, v in ref.model.state_dict().items()}
    so = {k: v.detach().cpu().double() for k, v in other.model.state_dict().items()}
    gaps = {"loss": abs(other_loss - ref_loss) / max(b["loss_rtol"] * abs(ref_loss), 1e-30),
            "params": {}, "stats": {}, "trace": {}}
    for k, r in sr.items():
        d = (so[k] - r).abs()
        if "num_batches" in k:
            gaps["stats"][k] = 0.0 if torch.equal(so[k], r) else float("inf")
        elif "running" in k:
            gaps["stats"][k] = float((d / (b["stats_atol"] + b["stats_rtol"] * r.abs())).max())
        else:
            gaps["params"][k] = float(d.max()) / b["param_atol"]
    mr, mo = _momentum(ref), _momentum(other)
    floor = b["trace_floor"] * max((float(r.abs().max()) for r in mr.values()), default=0.0)
    for k in mr.keys() | mo.keys():
        if k not in mr or k not in mo:
            gaps["trace"][k] = float("inf")
            continue
        bound = max(b["trace_rtol"] * float(mr[k].abs().max()), floor, 1e-30)
        gaps["trace"][k] = float((mo[k] - mr[k]).abs().max()) / bound
    return gaps


def worst_leaves(gaps: dict) -> dict:
    """The worst leaf of each measure of ``leaf_gaps``' result, and the
    worst of them all (``"worst"``)."""
    gap = {"loss": gaps["loss"], **{m: max(gaps[m].values(), default=0.0) for m in MEASURES}}
    gap["worst"] = max(gap.values())
    return gap


def step_gap(ref, other, ref_loss: float, other_loss: float) -> dict:
    """``worst_leaves`` of ``leaf_gaps``."""
    return worst_leaves(leaf_gaps(ref, other, ref_loss, other_loss))


def over_bound(gaps: dict) -> dict:
    """The leaves of ``leaf_gaps`` that exceed their bound, as {"measure:
    leaf": gap} (the loss under ``"loss"``)."""
    out = {f"{m}:{k}": v for m in MEASURES for k, v in gaps[m].items() if not v <= 1.0}
    if not gaps["loss"] <= 1.0:
        out["loss"] = gaps["loss"]
    return out


def replicas_equal(trainer) -> bool:
    """Whether every replica's parameters, statistics and momentum are
    bit-equal to the home replica's."""
    home = trainer.model.state_dict()
    for model, opt in zip(trainer.replicas[1:], trainer.opts[1:]):
        if any(not torch.equal(v.to(home[k].device), home[k])
               for k, v in model.state_dict().items()):
            return False
        for p0, p1 in zip(trainer.model.parameters(), model.parameters()):
            b0 = trainer.opt.state.get(p0, {}).get("momentum_buffer")
            b1 = opt.state.get(p1, {}).get("momentum_buffer")
            if (b0 is None) != (b1 is None) or (b0 is not None and
                                                 not torch.equal(b1.to(b0.device), b0)):
                return False
    return True
