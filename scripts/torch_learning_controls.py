#!/usr/bin/env python3
"""Controls of the SHOT arm of scripts/torch_learning_quality.py: the same
run with one part of the recipe changed, to locate what sets its test
accuracy.

    python3 scripts/torch_learning_controls.py CONTROL [CONTROL ...] \\
        [--seed 1] [--steps-per-call 8] [--epochs 200] --out PATH

Each CONTROL is one of
  * ``random_partner``: the posterior mixup's partner a random permutation
    (``om`` off) in place of the optimal KL match;
  * ``exact_match``: the optimal match from a pairwise KL whose three
    matrix products take float32 operands (``mixup.MATCH_OPERAND_DTYPE``
    None), where the port rounds them to bfloat16 as XLA's default
    precision runs a float32 matmul on a TPU (ROADMAP queue 3, F6);
  * ``f32_trunk``: the trunk in float32 (``bf16=False``) in place of
    bfloat16;
  * ``exact_heads``: the latent heads' products with float32 operands
    (``layers.HEAD_OPERAND_DTYPE`` None), where the port rounds them to
    bfloat16 as XLA's default precision runs the JAX model's float32
    ``TorchDense`` heads on a TPU (ROADMAP queue 3, F7).

The artifact is the harness's (the SHOT arm alone), its ``device`` block
naming the controls. Runs on the card; ``--device cpu`` for tests.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CONTROLS = ("random_partner", "exact_match", "f32_trunk", "exact_heads")


def _harness():
    spec = importlib.util.spec_from_file_location(
        "torch_learning_quality",
        os.path.join(HERE, "torch_learning_quality.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("controls", nargs="+", choices=CONTROLS)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--steps-per-call", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", required=True)
    p.add_argument("harness_argv", nargs="*",
                   help="further flags of torch_learning_quality.py "
                        "(after --)")
    args = p.parse_args(argv)

    from shotvae_torch.models import layers
    from shotvae_torch.ops import mixup

    lq = _harness()
    controls = set(args.controls)
    run_arm, changed = lq.run_arm, {}
    block = {"control": ",".join(sorted(controls))}
    if "random_partner" in controls:
        changed["om"] = False
    if "f32_trunk" in controls:
        changed["bf16"] = False
        block["trunk"] = "float32"
    lq.run_arm = lambda arm, common, *a: run_arm(arm, dict(common, **changed),
                                                 *a)
    operands = mixup.MATCH_OPERAND_DTYPE
    if "exact_match" in controls:
        mixup.MATCH_OPERAND_DTYPE = None
    heads = layers.HEAD_OPERAND_DTYPE
    if "exact_heads" in controls:
        layers.HEAD_OPERAND_DTYPE = None
    device_block = lq.device_block
    lq.device_block = lambda *a: dict(device_block(*a), **block)
    try:
        return lq.main(["--arms", "shot", "--seed", str(args.seed),
                        "--epochs", str(args.epochs), "--steps-per-call",
                        str(args.steps_per_call), "--device", args.device,
                        "--out", args.out, *args.harness_argv])
    finally:
        mixup.MATCH_OPERAND_DTYPE = operands
        layers.HEAD_OPERAND_DTYPE = heads


if __name__ == "__main__":
    sys.exit(main())
