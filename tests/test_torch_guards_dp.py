"""chip_smoke.py's phase 13 (data parallelism over gloo) on the CPU at a
tiny size, and its check failing a wrong rank: the data-parallel guards of
tests/test_torch_guards.py, in a file of their own so that they run on a
worker of their own."""

import sys

import pytest
import torch

from test_torch_guards import _LOOP_CPU, _chip_smoke, one_torch_thread

__all__ = ["one_torch_thread"]  # the module's fixture


# phase 13 at a tiny size over gloo: the full-width model at 4 + 4 (2 + 2
# a rank), the loop of _LOOP_CPU (2 steps of 8 + 8 a rank, 27 eval forwards
# on rank 0 and 26 on rank 1, which draws no grid)
_DP_BATCH = 4


def _dp_chip_smoke(monkeypatch):
    """chip_smoke loaded as the spawned ranks import it (by name)."""
    chip_smoke = _chip_smoke(monkeypatch)
    monkeypatch.setitem(sys.modules, "chip_smoke", chip_smoke)
    monkeypatch.setattr(chip_smoke, "DP_TIMEOUT_S", 300)
    return chip_smoke


def test_chip_smoke_dp_phase_runs_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's phase 13 on the CPU: the group path at world 1 over
    gloo against today's step; two ranks over gloo against one process,
    sync-BN in f32 and bf16 and per replica in bf16; the loop's epoch on
    both ranks, restored from rank 0's checkpoint, written by rank 0
    only. No launch is counted on the CPU."""
    import torch.distributed as dist

    chip_smoke = _dp_chip_smoke(monkeypatch)
    dev = torch.device("cpu")
    world1 = chip_smoke.dp_world1_phase(dev, _DP_BATCH)
    assert not dist.is_initialized()
    assert world1["backend"] == "gloo"
    assert world1["vs_today"]["worst_share_of_tol"] <= 1.0
    assert set(world1["launches"].values()) == {0}
    out = chip_smoke.dp_two_rank_phase(dev, _DP_BATCH, str(tmp_path),
                                       dict(_LOOP_CPU), (2, 27))
    for r in range(2):
        assert out[f"rank{r}_sync_f32_vs_one_process"][
            "grad_max_share_of_tol"] <= 1.0
        assert set(out[f"rank{r}_loop_launches"].values()) == {0}
    assert out["loop"]["restored_bit_identical"]
    assert out["loop"]["rank0_files"] > 0 and out["loop"]["rank1_files"] == 0


def _planted_dgamma_rank(rank, world, folder):
    """A rank whose bn_leaky backward returns dgamma summed over the ranks
    (the global sum) where its own rows' sum belongs: the gradient mean
    then scales it by the world size."""
    import chip_smoke
    from shotvae_torch.ops.kernels import bn_leaky

    backward = bn_leaky._BnLeakyTrain.backward

    def planted(ctx, *grads):
        dx, dgamma, *rest = backward(ctx, *grads)
        return (dx, dgamma * world, *rest)

    bn_leaky._BnLeakyTrain.backward = staticmethod(planted)
    chip_smoke.dp_rank(rank, world, folder)


def _raising_rank(rank, world, folder):
    if rank == 1:
        raise RuntimeError("rank 1 of phase 13 fails")
    import chip_smoke

    chip_smoke.dp_rank(rank, world, folder)


@pytest.mark.parametrize("rank_fn,match", [
    (_planted_dgamma_rank, "disagree on the gradient of .*norm"),
    (_raising_rank, "rank 1 of phase 13 fails")])
def test_chip_smoke_dp_phase_fails_a_wrong_rank(rank_fn, match, monkeypatch,
                                                 tmp_path):
    """Phase 13 fails where a rank's BN weight gradient is the global sum
    (scaled by the world size after the mean), and where a rank raises:
    the other rank is stopped and the phase raises."""
    chip_smoke = _dp_chip_smoke(monkeypatch)
    with pytest.raises(Exception, match=match):
        chip_smoke.dp_two_rank_phase(torch.device("cpu"), _DP_BATCH,
                                     str(tmp_path), None, None, rank_fn)
