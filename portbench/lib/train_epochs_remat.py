"""The ``train_epochs_remat`` traffic: the ``train_epochs`` traffic as it
stands (the same program, window and epochs), for configurations whose
plain reference does not fit the card beside what it checks, and whose
state drifts too far by the window's first epoch for its eval sums to
tell rounding from a fault. Two parts of the check differ:

* the plain reference's train step recomputes each encoder unit's forward
  in its backward (``reference/shot_step_remat.py``), with the same
  arithmetic and draws, so that its 16 checked steps at 768 + 768 fit;
* the eval pass compared is epoch 0's, the last part of set-up, and not
  the window's first: on WideResNet-28-10 the latents' log-sigmas reach
  about 27 by then on some seeds, the valid split's KL sum 4.5e23, where
  bfloat16 rounding moves that sum by 0.9 % between two sound runs while
  the fp8 control moves it by 3.7 % at its least (PERF.md,
  "Correctness"). Epoch 0 runs the same eval step at the same batch.

Every compared number is computed as ``train_epochs``' is.
"""

from __future__ import annotations

import contextlib

from portbench.lib import train_epochs
from portbench.lib.train_epochs import numbers  # noqa: F401
from portbench.reference.shot_step_remat import recomputed_units

CHECKED_EVAL = 0  # the eval pass whose sums are compared


@contextlib.contextmanager
def _checked():
    saved = train_epochs.CHECKED_EVAL
    train_epochs.CHECKED_EVAL = CHECKED_EVAL
    try:
        with recomputed_units():
            yield
    finally:
        train_epochs.CHECKED_EVAL = saved


def drive(cell, dev, t_start: float) -> dict:
    with _checked():
        run = train_epochs.drive(cell, dev, t_start)
    if run["eval_epoch"] != CHECKED_EVAL:  # train_epochs no longer reads it
        raise RuntimeError(f"the eval pass compared is epoch "
                           f"{run['eval_epoch']}'s, not {CHECKED_EVAL}'s")
    return run


def control(cell, dev, run: dict) -> dict:
    with _checked():
        return train_epochs.control(cell, dev, run)
