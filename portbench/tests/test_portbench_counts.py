"""The yardstick's own counts: FLOPs from the configuration's widths
against torch's FlopCounterMode over the port's float32 model, against a
hand count, the kernels' launch counts, and the idle union."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import cells, work
from portbench.lib.trace import Trace, breakdown, union
from portbench.reference.model import forward_flops


def _model(name):
    return cells.find(name).config["model"]


@pytest.mark.parametrize("cell", ["shot-wrn28-2-c10-4k.train",
                                  "shot-preact18-c100-4k.train"])
def test_forward_flops_match_flop_counter(cell):
    from shotvae_torch.models.vae import VariationalAutoEncoder

    m = _model(cell)
    torch.manual_seed(0)
    vae = VariationalAutoEncoder(
        m["net_name"], continuous_latent_dim=m["ldc"],
        disc_latent_dim=m["num_classes"], device="cpu").eval()
    x = torch.rand(2, 3, 32, 32)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        vae(x, noise={"eps": torch.zeros(2, m["ldc"]),
                      "unif": torch.full((2, m["num_classes"]), 0.5)})
    assert counter.get_total_flops() == work.eval_flops(m, 2)


def test_wrn28_2_convs_by_hand():
    f = forward_flops(_model("shot-wrn28-2-c10-4k.train"), 1)
    stem = 2 * 32 * 32 * 9 * 3 * 16
    group1 = (2 * 32 * 32 * 9 * (16 * 32 + 7 * 32 * 32)
              + 2 * 32 * 32 * 16 * 32)
    group2 = (2 * 16 * 16 * 9 * (32 * 64 + 7 * 64 * 64)
              + 2 * 16 * 16 * 32 * 64)
    group3 = (2 * 8 * 8 * 9 * (64 * 128 + 7 * 128 * 128)
              + 2 * 8 * 8 * 64 * 128)
    assert f["encoder"] == stem + group1 + group2 + group3
    assert f["stem"] == stem


def test_launch_counts_of_a_wrn_step():
    launches = work.shot_step_launches(_model("shot-wrn28-2-c10-4k.train"),
                                       768)
    total = {k: sum(n for _, n in rows) for k, rows in launches.items()}
    # the port's kernel table: 132 / 132 / 122 / 122 bn_leaky and 88 conv
    assert total == {"stats": 132, "apply": 132, "bwd_reduce": 122,
                     "bwd_apply": 122, "conv": 88}
    sites = work.sites(_model("shot-preact18-c100-4k.train"), 1)
    assert (len(sites["fused"]), len(sites["encoder_bn"])) == (13, 7)


def test_idle_union_of_overlapping_intervals():
    assert union([(5, 9), (0, 3), (2, 4), (9, 10), (12, 12)]) == [(0, 4),
                                                                  (5, 10)]
    t = Trace(window=(0, 100), kernels=[("a", 10, 30), ("b", 20, 40)],
              activity=[("a", 10, 30), ("b", 20, 40), ("c", 60, 70),
                        ("Memcpy", 90, 120)],
              spans={"call": [(0, 100)], "eval": [(0, 50)],
                     "readback": [(45, 95)]})
    assert t.busy() == [(10, 40), (60, 70), (90, 100)]
    assert t.busy_s() == pytest.approx(5e-8)
    # each gap goes to the innermost span the host was in as it began
    gaps = dict(breakdown(t)["idle_gaps"])
    assert gaps == pytest.approx({"eval": 3e-8, "readback": 2e-8})
