"""JAX (flax) parameter trees -> the port's state_dict.

The port's own copy of the VAE (with a WideResNet, PreActResNet or DenseNet
trunk), WideResNet classifier and MLP paths of
shotvae_tpu/io/torch_export.py:39-235, 143-153 and 295-315 (the port
imports nothing of the JAX package). Input: the ``params`` and
``batch_stats`` trees as nested dicts of numpy arrays. Output: a state_dict
with the reference key names, which the port's ``VariationalAutoEncoder``,
``WideResNetClassifier`` and ``MLPClassifier`` load with ``strict=True``.
The WideResNet and PreActResNet trees name their units alike, so a VAE's
trunk family is given (``encoder_kind``), not sniffed from its paths.

Layouts: Conv HWIO -> OIHW; ConvTranspose (kh, kw, I, O) flipped in space,
then (I, O, kh, kw); Dense (I, O) -> (O, I); BatchNorm
``scale/bias/mean/var`` -> ``weight/bias/running_mean/running_var`` plus a
``num_batches_tracked`` of 0. The MLP's first Dense reads the flattened
conv features, which JAX flattens in (H, W, C) order and torch in
(C, H, W): its input rows are permuted back.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

_WRN_UNIT = {
    "norm1/bn": "f_block.norm1", "conv1": "f_block.conv1",
    "norm2/bn": "f_block.norm2", "conv2": "f_block.conv2",
    "shortcut_norm/bn": "i_block.norm", "shortcut_conv": "i_block.conv",
}


def _wrn_stem(path: str) -> str:
    """A WideResNet trunk path (below ``feature_extractor/``) -> its
    reference stem below ``encoder.``."""
    if path == "pre_process/conv0":
        return "pre_process.conv0"
    if path == "transition_norm/bn":
        return "transition.norm"
    m = re.match(r"block(\d+)_unit(\d+)/(.+)$", path)
    if m is None or m.group(3) not in _WRN_UNIT:
        raise KeyError(f"unknown wideresnet path: {path}")
    return (f"wideblock{m.group(1)}.wide_block.wideunit{m.group(2)}."
            f"{_WRN_UNIT[m.group(3)]}")


def _preact_stem(path: str) -> str:
    """A PreActResNet trunk path -> its reference stem below ``encoder.``
    (torch_export.py:60-77)."""
    if path == "pre_process/conv0":
        return "pre_process.conv0"
    if path == "transition_norm/bn":
        return "transition.norm"
    m = re.match(r"block(\d+)_unit(\d+)/(.+)$", path)
    if m is None:
        raise KeyError(f"unknown preactresnet path: {path}")
    rest = m.group(3)
    tail = {"shortcut_norm/bn": "i_block.norm",
            "shortcut_conv": "i_block.conv"}.get(
                rest, "f_block." + rest.split("/")[0])
    return f"block{m.group(1)}.preact_block.unit{m.group(2)}.{tail}"


def _densenet_stem_of(paths):
    """The DenseNet trunk path -> reference stem map for a tree holding
    ``paths`` (torch_export.py:80-103). The reference's last transition
    holds only the final BN (JAX's ``final_norm``): its index is one past
    the highest transition that has a conv."""
    last = 1 + max((int(m.group(1)) for p in paths
                    for m in [re.match(r"transition(\d+)_", p)] if m),
                   default=0)

    def stem(path: str) -> str:
        if path == "pre_process/conv0":
            return "pre_process.conv0"
        if path == "final_norm/bn":
            return f"transition{last}.norm"
        m = re.match(r"denseblock(\d+)/denselayer(\d+)/"
                     r"(norm1|conv1|norm2|conv2)(/bn)?$", path)
        if m:
            return f"denseblock{m.group(1)}.denselayer{m.group(2)}.{m.group(3)}"
        m = re.match(r"transition(\d+)_(norm|conv)(/bn)?$", path)
        if m:
            return f"transition{m.group(1)}.{m.group(2)}"
        raise KeyError(f"unknown densenet path: {path}")

    return stem


def _vae_stem_of(paths, encoder_kind: str):
    """The VAE node path -> reference stem map for a tree holding ``paths``
    whose trunk is of ``encoder_kind``."""
    pre = "feature_extractor/"
    if encoder_kind == "densenet":
        trunk = _densenet_stem_of(p[len(pre):] for p in paths
                                  if p.startswith(pre))
    else:
        trunk = {"wideresnet": _wrn_stem,
                 "preactresnet": _preact_stem}[encoder_kind]
    return lambda path: (
        "feature_extractor.encoder." + trunk(path[len(pre):])
        if path.startswith(pre) else _vae_stem(path))


def _vae_stem(path: str) -> str:
    """A VAE node path outside the trunk -> its reference state_dict
    stem."""
    heads = {"cont_mean": "continuous_inference.mean.fc",
             "cont_log_sigma": "continuous_inference.log_sigma.fc",
             "disc_inference": "disc_latent_inference.fc"}
    if path in heads:
        return heads[path]
    m = re.match(r"feature_reconstructor/up(\d+)$", path)
    if m:  # ConvTranspose at Sequential indices 0, 3, ..., 15
        return f"feature_reconstructor.decoder.{int(m.group(1)) * 3}"
    m = re.match(r"feature_reconstructor/norm(\d+)/bn$", path)
    if m:  # BatchNorm at 1, 4, ..., 13
        return f"feature_reconstructor.decoder.{int(m.group(1)) * 3 + 1}"
    raise KeyError(f"unknown vae path: {path}")


def _classifier_stem(path: str) -> str:
    """A WideResNet classifier node path -> its reference stem: the trunk
    under ``encoder.``, its final BN in the ``global_avg`` head and the
    Dense in ``classification``."""
    if path == "encoder/transition_norm/bn":
        return "global_avg.norm"
    if path.startswith("encoder/"):
        return "encoder." + _wrn_stem(path[len("encoder/"):])
    if path == "fc":
        return "classification.fc"
    raise KeyError(f"unknown classifier path: {path}")


def _chw_to_hwc_perm(c: int, h: int, w: int) -> np.ndarray:
    """perm[i_hwc] = i_chw: the flattening-order change at a reshape."""
    return np.arange(c * h * w).reshape(c, h, w).transpose(1, 2, 0).reshape(-1)


def _flatten(tree: Mapping, prefix=()) -> Dict[str, Dict[str, np.ndarray]]:
    """Nested dict -> {node path: {leaf name: float32 array}}."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out.setdefault("/".join(prefix), {})[k] = np.asarray(
                v, dtype=np.float32)
    return out


def _node_leaves(path: str, leaves: Dict[str, np.ndarray],
                 stats: Dict[str, Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
    """The torch leaves of one flax node, keyed by leaf name."""
    if path.endswith("/bn"):
        return {"weight": leaves["scale"], "bias": leaves["bias"],
                "running_mean": stats[path]["mean"],
                "running_var": stats[path]["var"],
                "num_batches_tracked": np.asarray(0, dtype=np.int64)}
    out = {}
    kernel = leaves.get("kernel")
    if kernel is not None:
        if kernel.ndim == 4 and path.rsplit("/", 1)[-1].startswith("up"):
            out["weight"] = kernel[::-1, ::-1].transpose(2, 3, 0, 1)
        elif kernel.ndim == 4:
            out["weight"] = kernel.transpose(3, 2, 0, 1)
        elif kernel.ndim == 2:
            out["weight"] = kernel.T
        else:
            raise ValueError(f"unexpected kernel shape at {path}: "
                             f"{kernel.shape}")
    if "bias" in leaves:
        out["bias"] = leaves["bias"]
    return out


def _convert(flat_params: Dict[str, Dict[str, np.ndarray]],
             batch_stats: Mapping, stem_of) -> Dict[str, torch.Tensor]:
    """The flattened flax nodes -> state_dict entries under ``stem_of``'s
    names."""
    stats = _flatten(batch_stats)
    out: Dict[str, torch.Tensor] = {}
    for path, leaves in flat_params.items():
        stem = stem_of(path)
        for name, value in _node_leaves(path, leaves, stats).items():
            # a fresh copy: flipped views have negative strides and JAX
            # buffers are read-only, neither of which torch takes
            out[f"{stem}.{name}"] = torch.from_numpy(np.array(value))
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        encoder_kind: str = "wideresnet"
                        ) -> Dict[str, torch.Tensor]:
    """A SHOT-VAE's (params, batch_stats), its trunk of ``encoder_kind``
    ('wideresnet', 'preactresnet' or 'densenet') -> the port's state_dict
    (CPU tensors)."""
    flat = _flatten(params)
    return _convert(flat, batch_stats, _vae_stem_of(flat, encoder_kind))


def classifier_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """A ``WideResNetClassifier``'s (params, batch_stats) -> the port's
    state_dict (CPU tensors), as ``_invert_classifier`` names it."""
    return _convert(_flatten(params), batch_stats, _classifier_stem)


def mlp_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """An ``MLPClassifier``'s params -> the port's state_dict (CPU
    tensors), as ``export_mlp_state_dict`` gives it: the convs at
    ``encoder.{0,2,4}``, the Dense layers at ``classifier.{0,2}``, the
    first Dense's input rows from (H, W, C) back to (C, H, W) order."""
    inv = np.argsort(_chw_to_hwc_perm(64, 4, 4))

    def stem(path: str) -> str:
        m = re.match(r"conv(\d+)$", path)
        if m:
            return f"encoder.{int(m.group(1)) * 2}"
        if path in ("fc0", "fc1"):
            return f"classifier.{int(path[-1]) * 2}"
        raise KeyError(f"unknown mlp path: {path}")

    flat = _flatten(params)
    flat["fc0"] = dict(flat["fc0"], kernel=flat["fc0"]["kernel"][inv, :])
    return _convert(flat, {}, stem)
