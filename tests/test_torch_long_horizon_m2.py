"""The port's M2 train step in lockstep with the JAX step for 150 steps on
the CPU, and its low-lr control arm: the M2 half of
tests/test_torch_long_horizon.py (whose docstring gives the set-up and the
bounds), in a file of its own so that the two arms run on two workers."""

import pytest

from test_torch_long_horizon import (CONTROL_STEPS, DRIFT_STEPS, LOW_LR, LR,
                                     _run, check_control, check_drift,
                                     jax_side, one_torch_thread)

__all__ = ["jax_side", "one_torch_thread"]  # the module's fixtures

# the model and data seeds of tests/test_lockstep_long_horizon.py
SEEDS = [("m2", 53, 54)]


@pytest.mark.parametrize("kind,seed,data_seed", SEEDS)
def test_150_steps_in_lockstep_with_jax(jax_side, kind, seed, data_seed):
    check_drift(*_run(jax_side, kind, LR, DRIFT_STEPS, seed, data_seed))


@pytest.mark.parametrize("kind,seed,data_seed", SEEDS)
def test_low_lr_control_arm(jax_side, kind, seed, data_seed):
    check_control(*_run(jax_side, kind, LOW_LR, CONTROL_STEPS, seed,
                        data_seed))
