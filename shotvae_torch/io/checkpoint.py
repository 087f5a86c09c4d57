"""Checkpoints in the reference's layout and cadence, written with
``torch.save``. Port of shotvae_tpu/io/checkpoint.py:34-225.

The folder is ``<base_path>/<dataset>-<tag>/parameter/train_time_<t>/``, as
the reference's (main_shot_vae.py:237-251). A checkpoint is one file
holding ``{"state_dict", "optimizer", "step", "epoch", "args"}``: the
model's state_dict under the reference's key names (so
``ShotVaeInference.from_checkpoint`` serves it), the optimizer's
state_dict, the number of updates made, the epoch to resume at and the
config dict.

Crash safety: each name (``checkpoint``, ``best``) alternates between two
slot files (``<name>.slot0.pth.tar`` / ``<name>.slot1.pth.tar``), and the
pointer ``<name>.current`` names the last slot written in full; it is
replaced only after the slot's file is complete, so a crash mid-write
leaves the previous checkpoint in place.

Saves are asynchronous: ``save`` copies the state to the host at once (the
model and the optimizer update their tensors in place, so the writer must
not read the live ones), and one background writer writes the file and the
pointer. The next call joins it first and raises any error it hit. The
folder is made by the first save, so a manager that only restores (a
data-parallel run's ranks but the first) writes nothing.
"""

from __future__ import annotations

import atexit
import os
import threading
from typing import Optional

import torch

from shotvae_torch.utils.spans import span

NAMES = ("checkpoint", "best")
# the optimizer's implementation flags: the run's own, not the checkpoint's
IMPLEMENTATION_FLAGS = ("fused", "foreach", "differentiable", "capturable")


def _read_pointer(pointer: str) -> str:
    with open(pointer) as f:
        return f.read().strip()


def resolve_checkpoint_path(path: str, names: tuple = NAMES) -> str:
    """An explicit path by the manager's pointer conventions: a
    pointer-managed name (a ``<path>.current`` file beside it), a run
    folder holding ``<name>.current`` for one of ``names`` (the first found
    wins), or a checkpoint file (returned as it is)."""
    p = os.path.abspath(path)
    if os.path.isfile(p + ".current"):
        return _read_pointer(p + ".current")
    if os.path.isdir(p):
        for name in names:
            pointer = os.path.join(p, name + ".current")
            if os.path.isfile(pointer):
                return _read_pointer(pointer)
    return p


def _host_copy(obj):
    """``obj`` with every tensor copied to the host (a copy even where it
    already lies there) and every container rebuilt."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _bytes(obj) -> int:
    """The bytes of every tensor in ``obj``'s containers."""
    if torch.is_tensor(obj):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_bytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_bytes(v) for v in obj)
    return 0


def _replace_atomically(path: str, write) -> None:
    """``write(tmp)``, then rename ``tmp`` over ``path``."""
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, base_path: str, dataset: str, train_time: int, *,
                 tag: str = "SHOT-VAE"):
        self.folder = os.path.join(base_path, f"{dataset}-{tag}", "parameter",
                                   f"train_time_{train_time}")
        self._next_slot = {name: 0 for name in NAMES}
        self._write_thread: Optional[threading.Thread] = None
        self._write_error: Optional[BaseException] = None
        atexit.register(self.wait_until_finished)

    def wait_until_finished(self):
        """Join the write in flight and raise any error it hit. Registered
        atexit, so the last checkpoint lands before the process exits."""
        if self._write_thread is not None:
            self._write_thread.join()
            self._write_thread = None
        if self._write_error is not None:
            err, self._write_error = self._write_error, None
            raise err

    @staticmethod
    def _name(best: bool) -> str:
        return "best" if best else "checkpoint"

    def _pointer(self, name: str) -> str:
        return os.path.join(self.folder, name + ".current")

    def save(self, state, *, epoch: int, config: Optional[dict] = None,
             best: bool = False) -> str:
        """Save ``state`` (a ``TrainState``) with ``epoch`` and ``config``.

        Returns once the state is copied to the host; the file and the
        pointer are written in the background (``wait_until_finished``
        blocks on them). Returns the path the checkpoint will land at.
        A profiler sees the copy, the save's stall on the caller's thread,
        as a ``ckpt.host_copy`` span."""
        with span("ckpt.host_copy") as counts:
            payload = {"state_dict": _host_copy(state.model.state_dict()),
                       "optimizer": _host_copy(state.optimizer.state_dict()),
                       "step": int(state.step), "epoch": int(epoch),
                       "args": dict(config or {})}
            if counts is not None:
                counts["bytes"] = _bytes(payload)
        # one writer at a time, in order: the pointer follows the writes
        self.wait_until_finished()
        os.makedirs(self.folder, exist_ok=True)
        name = self._name(best)
        slot = self._next_slot[name]
        self._next_slot[name] = 1 - slot
        path = os.path.abspath(os.path.join(self.folder,
                                            f"{name}.slot{slot}.pth.tar"))

        def write():
            try:
                _replace_atomically(path, lambda p: torch.save(payload, p))
                _replace_atomically(self._pointer(name),
                                    lambda p: _write_text(p, path))
            except Exception as e:  # noqa: BLE001 - raised on the next call
                self._write_error = e

        self._write_thread = threading.Thread(target=write, daemon=True)
        self._write_thread.start()
        return path

    def latest_path(self, best: bool = False) -> str:
        """The file the pointer of ``best`` or ``checkpoint`` names, once
        any write in flight has landed."""
        self.wait_until_finished()
        pointer = self._pointer(self._name(best))
        if os.path.isfile(pointer):
            return _read_pointer(pointer)
        return os.path.abspath(os.path.join(self.folder,
                                            self._name(best) + ".pth.tar"))

    def restore(self, state, *, best: bool = False,
                path: Optional[str] = None):
        """Load a checkpoint into ``state`` in place: the model's parameters
        and buffers, the optimizer's state (moved to the parameters'
        device) and ``state.step``. Returns (state, epoch, config).
        ``path`` may be a pointer-managed name, a run folder or a file.
        Raises FileNotFoundError where there is no checkpoint."""
        if path:
            self.wait_until_finished()
            path = resolve_checkpoint_path(path, (self._name(best),))
        else:
            path = self.latest_path(best)
        if not os.path.isfile(path):
            raise FileNotFoundError(f"Checkpoint Resume File {path} Not Found")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(payload["state_dict"], strict=True)
        load_optimizer(state.optimizer, payload["optimizer"])
        state.step = int(payload["step"])
        return state, int(payload["epoch"]), payload["args"]


def load_optimizer(optimizer: torch.optim.Optimizer, state_dict: dict) -> None:
    """``optimizer.load_state_dict(state_dict)``: the state (momentum
    buffers) and the hyperparameters (``lr``, ``momentum``,
    ``weight_decay``, ...) of the checkpoint, with the run's own
    implementation flags (``IMPLEMENTATION_FLAGS``) put back after it, which
    ``load_state_dict`` would take from the checkpoint: a checkpoint of
    torch's default (foreach) SGD stores ``fused: None``, which would turn
    the run's fused SGD, whose rate a CUDA graph of steps gives as a tensor,
    into a foreach one. The JAX package's optax state carries no such
    flag."""
    own = [{k: g[k] for k in IMPLEMENTATION_FLAGS if k in g}
           for g in optimizer.param_groups]
    optimizer.load_state_dict(state_dict)
    for group, flags in zip(optimizer.param_groups, own):
        group.update(flags)


def _write_text(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
