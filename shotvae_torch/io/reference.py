"""Reference state_dicts with or without ``nn.DataParallel`` wrappers.

The reference wraps its submodules in ``nn.DataParallel`` by default (its
``--dp`` is ``store_false``): the pre-process, each block, the heads and
the decoder of the VAE and the WideResNet classifier, and always the MLP
classifier's ``encoder`` and ``classifier``. Each wrapper adds a
``.module`` to the keys below it, e.g.
``feature_extractor.encoder.wideblock1.module.wide_block...``, where the
port's modules carry the plain reference names. The port's own copy of
the JAX package's rule: shotvae_tpu/io/torch_compat.py:201, 245 and 305
strip the wrappers on import, shotvae_tpu/io/torch_export.py:318-335
re-inserts them on export.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Optional

import numpy as np
import torch
from torch import nn


def strip_module_wrappers(state_dict: Mapping) -> Dict:
    """Each key with every ``.module`` taken out (``key.replace(".module",
    "")``, the JAX package's exact rule), the values as they are (tensors
    or numpy arrays). A whole-model wrapper's leading ``module.`` has no
    dot before it and is left in place, as the JAX package leaves it."""
    return {k.replace(".module", ""): v for k, v in state_dict.items()}


def insert_module_wrappers(state_dict: Mapping,
                           target_keys: Iterable[str]) -> Dict:
    """Rename plain keys to a DataParallel model's ``.module``-wrapped key
    set. ``target_keys`` is the target model's own ``state_dict().keys()``;
    every key of ``state_dict`` must be used exactly once."""
    out = {}
    used = set()
    for tk in target_keys:
        stripped = tk.replace(".module", "")
        if stripped not in state_dict:
            raise KeyError(f"no exported value for target key {tk!r}")
        out[tk] = state_dict[stripped]
        used.add(stripped)
    leftover = set(state_dict) - used
    if leftover:
        raise KeyError(f"exported keys unused by target: {sorted(leftover)}")
    return out


def load_reference_state_dict(model: nn.Module, state_dict: Mapping
                              ) -> nn.Module:
    """Strict-load a reference state_dict, with or without DataParallel
    wrappers, into a port model that carries the reference's key names
    (``VariationalAutoEncoder`` over any trunk, ``WideResNetClassifier``,
    ``MLPClassifier``, ``SmoothVAE``); values may be tensors or numpy
    arrays (copied: an exporter's flipped or read-only views are fine).
    Returns ``model``."""
    model.load_state_dict(
        {k: v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
         for k, v in strip_module_wrappers(state_dict).items()}, strict=True)
    return model


def reference_state_dict(model: nn.Module,
                         target_keys: Optional[Iterable[str]] = None
                         ) -> Dict[str, torch.Tensor]:
    """``model``'s state_dict on the host under the reference's names:
    plain keys, or with ``target_keys`` (a DataParallel reference model's
    own keys) the wrapped key set."""
    plain = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    return plain if target_keys is None else insert_module_wrappers(
        plain, target_keys)
