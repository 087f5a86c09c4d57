"""What decides ``correct``, at a size a test run holds, on the CPU: a run
of each cell with the chip's look skipped and its timed path broken
underneath reads ``correct`` false, once for each fault the cell can have,
and its broken number reads far above a sound run's; the controls (the
plain reference one precision below the configuration's) read above the
program. The limits are the cells' own, set at full size on the card
(PERF.md, ``portbench/control.py``); a sound train run at this size reads
near them, so only the serving cell's sound run is held to them here. A
decoder fault shows in its module group though not in the median over
every leaf."""

import statistics

import pytest
import torch

from portbench.lib import cells, check, train_epochs
from portbench.run import run_cell

TRAIN_SIZES = {"cli": {"batch_size": 8, "valid_per_class": 2,
                       "annotated_per_class": 2, "steps_per_call": 2},
               "derived": {"valid_per_class": 2, "labeled_per_class": 2},
               "data": {"train_images": 60, "test_images": 12}}
SERVE_SIZES = {"traffic": {"batch": 4, "warmup_calls": 1, "sample_from": 3,
                           "sample_calls": 2},
               "data": {"test_images": 24}}


def _cell(name, fault=None, seed=2**31 + 11):
    cell = cells.find(name)
    cell.seed, cell.seconds, cell.fault = seed, 0.0, fault
    cell.sizes = (TRAIN_SIZES if cell.traffic["kind"] == "train_epochs"
                  else SERVE_SIZES)
    return cell


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def sound_train():
    return run_cell(_cell("shot-wrn28-2-c10-4k.train"),
                    torch.device("cpu"))[1]


@pytest.mark.parametrize("fault,number", [("frozen", "change"),
                                          ("half", "grad"),
                                          ("decoder", "grad"),
                                          ("padding", "eval_sums")])
def test_train_cell_faults(fault, number, sound_train):
    result, table = run_cell(_cell("shot-wrn28-2-c10-4k.train", fault),
                             torch.device("cpu"))
    assert result["correct"] is False, table
    assert list(result)[-1] == "checked"
    assert table[number][0] > 10 * sound_train[number][0]


def test_a_decoder_fault_shows_in_its_group_alone():
    """The decoder's weight gradients halved move the decoder group's
    median leaf by a third or more and leave the encoder's as a sound run
    has it; a median over every leaf would not see it."""
    cell = _cell("shot-wrn28-2-c10-4k.train", "decoder")
    run = train_epochs.drive(cell, torch.device("cpu"), 0.0)
    prog, ref = run["program"], run["reference"]
    gaps = check.leaf_gaps(prog["grad"], ref["grad"], sorted(ref["grad"]))
    groups = check.group_medians(gaps)
    assert 0.3 < groups["feature_reconstructor"] <= 0.5
    assert groups["feature_extractor"] < 0.05
    assert statistics.median(gaps.values()) < 0.05


@pytest.mark.parametrize("fault,correct", [(None, True), ("altered", False)])
def test_serve_cell_faults(fault, correct):
    cell = _cell("shot-wrn28-2-c10-4k.classify", fault)
    cell.seconds = 0.5
    result, table = run_cell(cell, torch.device("cpu"))
    assert result["correct"] is correct, table


def test_train_control_reads_above_the_program():
    """The fp8 control against the bfloat16 reference fails the cell's
    limits, on a number it reads at three times the program's or more."""
    cell = _cell("shot-wrn28-2-c10-4k.train")
    dev = torch.device("cpu")
    run = train_epochs.drive(cell, dev, 0.0)
    low = train_epochs.control(cell, dev, run)
    sound = train_epochs.numbers(run)
    control = check.train_numbers(low, run["reference"])
    assert not check.judge(control, cell.limits)[0]
    assert max(control[k] / sound[k] for k in cell.limits) > 3, (control,
                                                                 sound)


@pytest.mark.card
def test_serve_control_reads_above_the_program():
    """TF32 exists on the card only."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 is a card's arithmetic; no card here")
    from portbench.lib import serve_closed

    cell = _cell("shot-wrn28-2-c10-4k.classify")
    cell.sizes = {}
    cell.seconds = 3.0
    dev = torch.device("cuda", 0)
    run = serve_closed.drive(cell, dev, 0.0)
    low = serve_closed.control(cell, dev, run)
    sound = serve_closed.numbers(run)
    control = serve_closed.numbers({"program": low,
                                    "reference": run["reference"]})
    assert control["probs_mean"] > 3 * sound["probs_mean"]
