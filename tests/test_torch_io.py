"""The port's meters, image grid, TensorBoard writer and checkpoint manager:
the meters and the grid against the JAX package's, exactly; the writer's
events read back; the manager's slots, pointer, asynchronous writer, error
surfacing and snapshot; the serving API on its checkpoints."""

import os
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from shotvae_tpu.io import tb as jax_tb
from shotvae_tpu.utils import meters as jax_meters
from shotvae_torch.api import ShotVaeInference
from shotvae_torch.io.checkpoint import (CheckpointManager,
                                         resolve_checkpoint_path)
from shotvae_torch.io.tb import TBWriter, make_image_grid
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.train.state import TrainState, sgd_torch
from shotvae_torch.utils.meters import AverageMeter, MetricAccumulator


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_average_meter_matches_jax():
    port, ref = AverageMeter(), jax_meters.AverageMeter()
    for val, n in ((2.0, 4), (4.5, 3), (0.1, 1), (np.float32(7.25), 2)):
        port.update(val, n)
        ref.update(val, n)
        assert vars(port) == vars(ref)
    port.reset()
    ref.reset()
    assert vars(port) == vars(ref)


def test_metric_accumulator_matches_jax():
    rng = np.random.default_rng(0)
    port, ref = MetricAccumulator(), jax_meters.MetricAccumulator()
    for _ in range(4):
        values = {"recon_sum": rng.normal(size=()) * 1e3,
                  "top1_count": rng.integers(0, 64), "count": 64.0,
                  "loss": rng.normal(size=())}
        port.update({k: torch.tensor(np.float32(v))
                     for k, v in values.items()})
        ref.update({k: jnp.float32(v) for k, v in values.items()})
        port.update({"extra_sum": 0.1})  # a plain number passes exactly
        ref.update({"extra_sum": 0.1})
    assert port.totals == ref.totals
    assert port.averages() == ref.averages()


@pytest.mark.parametrize("n,h,c,dtype", [(4, 8, 3, np.float32),
                                         (3, 5, 1, np.float32),
                                         (1, 6, 3, np.uint8),
                                         (5, 4, 3, np.float64)])
def test_image_grid_matches_jax(n, h, c, dtype):
    images = np.random.default_rng(n).uniform(0, 1, (n, h, h + 1, c))
    images = (images * 255).astype(dtype) if dtype == np.uint8 \
        else images.astype(dtype)
    for nrow in (1, 2, 3):
        got = make_image_grid(images, nrow)
        want = jax_tb.make_image_grid(images, nrow)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


def _event_tags(log_dir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    events = EventAccumulator(log_dir)
    events.Reload()
    return events.Tags()


def test_tb_writer_writes_and_degrades_to_a_no_op(tmp_path, monkeypatch):
    writer = TBWriter(str(tmp_path / "live"))
    assert writer.live
    writer.scalar("Valid/ELBO", np.float32(1.5), 1)
    writer.image_grid("Valid/Raw_Image", np.zeros((4, 8, 8, 3)), 1)
    writer.close()
    tags = _event_tags(str(tmp_path / "live"))
    assert tags["scalars"] == ["Valid/ELBO"]
    assert tags["images"] == ["Valid/Raw_Image"]
    # without tensorboard: no writer, no file, every call a no-op
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    dead = TBWriter(str(tmp_path / "dead"))
    assert not dead.live
    dead.scalar("Valid/ELBO", 1.0, 1)
    dead.image_grid("Valid/Raw_Image", np.zeros((4, 8, 8, 3)), 1)
    dead.flush()
    dead.close()
    assert not os.path.exists(tmp_path / "dead")


def _tiny_state(seed=0):
    """A model with parameters and a BN buffer, SGD with momentum, one
    update made (so the momentum buffers exist)."""
    torch.manual_seed(seed)
    model = nn.Sequential(nn.Linear(4, 3), nn.BatchNorm1d(3))
    opt = sgd_torch(model, lr=0.1)
    state = TrainState(model, opt)
    _update(state)
    return state


def _update(state, seed=1):
    x = torch.randn(8, 4, generator=torch.Generator().manual_seed(seed))
    state.optimizer.zero_grad()
    state.model.train()
    state.model(x).square().sum().backward()
    state.apply_gradients()


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {i: s["momentum_buffer"].clone()
             for i, s in state.optimizer.state_dict()["state"].items()},
            state.step)


def _same_state(state, snap):
    sd, momentum, step = snap
    got = state.model.state_dict()
    assert list(got) == list(sd)
    assert all(torch.equal(got[k], sd[k]) for k in sd)
    opt = state.optimizer.state_dict()["state"]
    assert set(opt) == set(momentum)
    assert all(torch.equal(opt[i]["momentum_buffer"], momentum[i])
               for i in momentum)
    assert state.step == step


def test_checkpoint_round_trip_slots_and_paths(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "Cifar10", 3)
    assert mgr.folder == os.path.join(str(tmp_path), "Cifar10-SHOT-VAE",
                                      "parameter", "train_time_3")
    state = _tiny_state()
    snaps, paths = [], []
    for epoch in (1, 2, 3):
        snaps.append(_snapshot(state))
        paths.append(mgr.save(state, epoch=epoch, config={"ewm": 0.1 * epoch,
                                                          "adjust_lr": [1]}))
        _update(state, seed=epoch + 1)
    best = mgr.save(state, epoch=4, config={}, best=True)
    mgr.wait_until_finished()
    assert [os.path.basename(p) for p in paths] == [
        "checkpoint.slot0.pth.tar", "checkpoint.slot1.pth.tar",
        "checkpoint.slot0.pth.tar"]
    assert os.path.basename(best) == "best.slot0.pth.tar"
    pointer = os.path.join(mgr.folder, "checkpoint.current")
    assert open(pointer).read() == paths[2]
    # every form of path restores: the pointer, a pointer name, the run
    # folder, the file itself
    for path in (None, os.path.join(mgr.folder, "checkpoint"), mgr.folder,
                 paths[2]):
        fresh = _tiny_state(seed=5)
        _, epoch, args = mgr.restore(fresh, path=path)
        assert (epoch, args) == (3, {"ewm": 0.1 * 3, "adjust_lr": [1]})
        _same_state(fresh, snaps[2])
    fresh = _tiny_state(seed=5)
    assert mgr.restore(fresh, best=True)[1] == 4
    assert resolve_checkpoint_path(mgr.folder, ("best",)) == best
    # an earlier slot file still holds its own epoch
    fresh = _tiny_state(seed=5)
    assert mgr.restore(fresh, path=paths[1])[1] == 2
    _same_state(fresh, snaps[1])


def test_checkpoint_restore_of_a_missing_path_raises(tmp_path):
    mgr = CheckpointManager(str(tmp_path), "Cifar10", 1)
    for kw in ({}, {"best": True}, {"path": str(tmp_path / "nothing")}):
        with pytest.raises(FileNotFoundError):
            mgr.restore(_tiny_state(), **kw)


def test_checkpoint_writer_error_surfaces_on_next_call(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path), "Cifar10", 1)
    state = _tiny_state()
    good = mgr.save(state, epoch=1)
    mgr.wait_until_finished()

    def broken_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken_save)
    mgr.save(state, epoch=2)  # returns: the write fails in the background
    with pytest.raises(OSError, match="disk full"):
        mgr.save(state, epoch=3)
    mgr.wait_until_finished()  # the error was raised once
    mgr.save(state, epoch=4)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait_until_finished()
    monkeypatch.undo()
    pointer = os.path.join(mgr.folder, "checkpoint.current")
    assert open(pointer).read() == good  # still the last complete write
    assert mgr.restore(_tiny_state(seed=3))[1] == 1


def test_checkpoint_snapshot_is_taken_at_save(tmp_path, monkeypatch):
    """The writer writes what the state held when ``save`` was called, not
    what a later in-place update made of it: the write is held back until
    after another step."""
    mgr = CheckpointManager(str(tmp_path), "Cifar10", 1)
    state = _tiny_state()
    released = threading.Event()
    real_save = torch.save

    def late_save(obj, path):
        assert released.wait(timeout=60)
        real_save(obj, path)

    monkeypatch.setattr(torch, "save", late_save)
    snap = _snapshot(state)
    mgr.save(state, epoch=1)
    _update(state, seed=9)  # in place: parameters, BN buffers, momentum
    assert not torch.equal(state.model[0].weight, snap[0]["0.weight"])
    released.set()
    mgr.wait_until_finished()
    fresh = _tiny_state(seed=4)
    mgr.restore(fresh)
    _same_state(fresh, snap)


def test_from_checkpoint_takes_manager_folder_pointer_and_file(tmp_path):
    """A VAE checkpoint the manager wrote serves through every form of
    source, ``best`` picking the best pointer; classify equals the model
    it was taken from."""
    kw = dict(continuous_latent_dim=8, disc_latent_dim=10)
    models = [VariationalAutoEncoder("wideresnet-10-1", device="cpu", **kw)
              for _ in range(2)]
    mgr = CheckpointManager(str(tmp_path), "Cifar10", 1)
    args = {"net_name": "wideresnet-10-1", "temperature": 0.5}
    for model, best in zip(models, (False, True)):
        mgr.save(TrainState(model, sgd_torch(model)), epoch=1, config=args,
                 best=best)
    mgr.wait_until_finished()
    images = np.random.default_rng(0).integers(0, 256, (3, 32, 32, 3),
                                               np.uint8)
    want = [ShotVaeInference(m, device="cpu").classify(images)
            for m in models]
    sources = {False: [mgr, mgr.folder, os.path.join(mgr.folder,
                                                     "checkpoint"),
                       resolve_checkpoint_path(mgr.folder)],
               True: [mgr, mgr.folder, os.path.join(mgr.folder, "best")]}
    for best, found in sources.items():
        for source in found:
            serving = ShotVaeInference.from_checkpoint(source, best=best,
                                                       device="cpu")
            assert serving.model.sample_temperature == 0.5
            assert torch.equal(serving.classify(images), want[int(best)])


def test_checkpoint_is_plain_for_weights_only_load(tmp_path):
    """The payload loads with ``weights_only=True`` and holds the keys the
    serving API and the loop read."""
    mgr = CheckpointManager(str(tmp_path), "SVHN", 2)
    path = mgr.save(_tiny_state(), epoch=7,
                    config={"image_size": (32, 32), "num_devices": None,
                            "adjust_lr": [1, 2], "bf16": True})
    mgr.wait_until_finished()
    payload = torch.load(path, map_location="cpu", weights_only=True)
    assert set(payload) == {"state_dict", "optimizer", "step", "epoch",
                            "args"}
    assert payload["epoch"] == 7 and payload["step"] == 1
    assert payload["args"]["image_size"] == (32, 32)
    assert not os.path.exists(path + ".tmp")
