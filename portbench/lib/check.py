"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference works out from the same
inputs.

Train cells. The state compared is the one after epoch 0's first two
chunks: the eager first chunk and one replay of the captured graph that the
window replays (16 steps at 8 a chunk). ``loss``, the largest relative gap
of a step's loss over those steps; ``grad``, the gap between the norms of
the first step's gradient (the program's read from its momentum after one
step: buf - wd * p0); ``change``, of the parameters' change over the
steps; ``momentum``, of the SGD momentum after them. The BatchNorm running
variances are not compared: over 16 steps the two trajectories part, and
a sound run's gap reaches the fp8 control's (PERF.md, "Correctness").

Each of these three is taken leaf by leaf within each module group
(encoder, decoder, latent heads): a leaf's gap is |norm(prog) - norm(ref)|
over the larger of its reference norm and its group's median leaf's; a
group reads its median leaf; the number is the largest group's. The median
and not the worst leaf: in the bfloat16 trunk the worst leaf is an early
BatchNorm scale or shift, whose gradient is a sum over 786,432 rows that
cancels to a small remainder, so two sound bfloat16 computations part on
it by a tenth or more while they agree to about 0.002 in float32. The
group's median and not the median over all leaves, so that a fault
confined to one group, such as a wrong gradient of the decoder's weights,
shows (PERF.md, "Correctness"). Leaves whose reference gradient is under a
thousandth of the median leaf's move under SGD by weight decay and
round-off alone, and are left out of ``change`` and ``momentum`` by that
rule.

``eval_sums``: the largest relative gap of the valid split's eval sums
(reconstruction, both KL terms, the squared error and the ELBO) of the
window's first epoch, against the reference's eval forward from the state
the program held then. The first epoch's, because later states drift on
the synthetic data to latents whose KL sums reach 1e9, where bfloat16
rounding moves a sum by a thousandth on some seeds and not on others
(PERF.md, "Correctness").

The serving cell: ``probs_mean``, the mean absolute gap of the class
probabilities over every row of the sampled calls. The mean and not the
largest: the heads round their float32 operands to bfloat16, so where the
program's and the reference's float32 features straddle a rounding
boundary a probability moves by up to about 5e-6, in both a sound run and
a TF32 one, while the TF32 trunk moves every row (PERF.md,
"Correctness").
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

# the control's precision: the nearest below the configuration's
LOWER = {"bfloat16": "fp8", "float32": "tf32"}
QUIET_LEAF = 1e-3  # a leaf's gradient under this share of the median's
EVAL_SUMS = ("recon_sum", "cont_kl_sum", "disc_kl_sum", "mse_sum",
             "elbo_sum")
HEADS = ("continuous_inference", "disc_latent_inference")


def group(name: str) -> str:
    """The module group of a tensor of the VAE's state_dict."""
    top = name.split(".")[0]
    return "heads" if top in HEADS else top


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names) -> Dict[str, float]:
    """{leaf: |norm(prog) - norm(ref)| / max(norm(ref), its group's median
    leaf's norm(ref))}."""
    norms = {n: (float(prog[n].double().norm()), float(ref[n].double().norm()))
             for n in names}
    by_group: Dict[str, List[float]] = {}
    for n, (_, r) in norms.items():
        by_group.setdefault(group(n), []).append(r)
    med = {g: statistics.median(v) for g, v in by_group.items()}
    return {n: abs(p - r) / max(r, med[group(n)])
            for n, (p, r) in norms.items()}


def group_medians(gaps: Dict[str, float]) -> Dict[str, float]:
    by_group: Dict[str, List[float]] = {}
    for n, g in gaps.items():
        by_group.setdefault(group(n), []).append(g)
    return {g: statistics.median(v) for g, v in sorted(by_group.items())}


def state_gap(prog, ref, names) -> float:
    """The largest group's median leaf gap."""
    return max(group_medians(leaf_gaps(prog, ref, names)).values())


def moving(grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose gradient is at least QUIET_LEAF of the median
    leaf's."""
    names = sorted(grad)
    g = [float(grad[n].double().norm()) for n in names]
    med = statistics.median(g)
    return [n for n, v in zip(names, g) if v >= QUIET_LEAF * med]


def relative_gap(prog, ref) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(prog, ref))


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` and ``ref``: {"losses": [floats], "grad", "change",
    "momentum": {leaf: tensor}, "eval": {sum: float}}."""
    move = moving(ref["grad"])
    return {"loss": relative_gap(prog["losses"], ref["losses"]),
            "grad": state_gap(prog["grad"], ref["grad"], sorted(ref["grad"])),
            "change": state_gap(prog["change"], ref["change"], move),
            "momentum": state_gap(prog["momentum"], ref["momentum"], move),
            "eval_sums": relative_gap([prog["eval"][k] for k in EVAL_SUMS],
                                      [ref["eval"][k] for k in EVAL_SUMS])}


def serve_numbers(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    return {"probs_mean": float((prog.double() - ref.double()).abs().mean())}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: [number, limit]}): correct where every number that
    has a limit is finite and at most it."""
    table = {k: [numbers[k], limits[k]] for k in limits}
    ok = all(v == v and v <= lim for v, lim in table.values())
    return ok, table
