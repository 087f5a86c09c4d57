"""The supervised classifier baselines. Port of
shotvae_tpu/models/classifier.py:1-109.

``WideResNetClassifier``: the WRN trunk of the VAE's encoder, its final
BN+LeakyReLU, global average pooling, cast to f32, and a linear head with
xavier-uniform weight and zero bias; it emits raw logits. Parameter paths
are the reference classifier's (classifier_model/wideresnet.py:68-141), the
names ``shotvae_tpu/io/torch_export.py`` emits for ``kind="classifier"``:
the stem and units under ``encoder.``, the final BN at
``global_avg.norm``, the head at ``classification.fc``; so an exported
state_dict loads with ``strict=True``. The trunk is built from the VAE
encoder's own units (``wideresnet.wrn_units``), so its BN sites run the
same kernels: ``bn_leaky`` and the train-mode fused conv in train mode,
``bn_act`` and the eval-mode fused conv in eval mode.

``MLPClassifier``: three 4x4 stride-2 convs with ReLU, then Dense 256,
ReLU, Dense K (classifier_model/mlp.py:7-44, keys ``encoder.{0,2,4}`` and
``classifier.{0,2}``). It has no BN, so no kernel site. Its flatten is
torch's (C, H, W) order.

``apply_classifier_init``: the reference's explicit init
(classifier_model/wideresnet.py:104-118): every conv weight
kaiming-uniform, U(+-sqrt(6 / fan_in)), every conv bias 0, drawn on the
host from an explicit generator, so one seed gives one model on any
device.

``dtype`` (None: float32) is the trunk's compute dtype, as the VAE's.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from shotvae_torch.device import DeviceLike, resolve_device
from shotvae_torch.models.layers import (BatchNorm, channels_last, conv,
                                         global_avg_pool, zero_biases_)
from shotvae_torch.models.wideresnet import (parse_wideresnet_name,
                                             run_units, wrn_units)


class WideResNetClassifier(nn.Module):
    def __init__(self, depth: int = 28, width: int = 2,
                 num_classes: int = 10, num_input_channels: int = 3,
                 drop_rate: float = 0.0, device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_classes = num_classes
        self.drop_rate = drop_rate
        features = 64 * width
        self.encoder = nn.ModuleDict(wrn_units(
            depth, width, num_input_channels, dtype, drop_rate))
        self.global_avg = nn.ModuleDict({"norm": BatchNorm(features,
                                                           dtype=dtype)})
        self.classification = nn.ModuleDict(
            {"fc": nn.Linear(features, num_classes)})
        zero_biases_(self)
        nn.init.xavier_uniform_(self.classification.fc.weight)
        self.to(device=resolve_device(device),
                memory_format=torch.channels_last)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """(B, C, H, W) f32 -> (B, K) f32 logits. ``generator`` seeds the
        trunk's dropout in train mode."""
        h = run_units(self.encoder, channels_last(x), generator,
                      self.training and self.drop_rate > 0)
        avg = global_avg_pool(self.global_avg.norm(h)).to(torch.float32)
        return self.classification.fc(avg)


class MLPClassifier(nn.Module):
    def __init__(self, num_classes: int = 10, num_input_channels: int = 3,
                 device: DeviceLike = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        layers, cin = [], num_input_channels
        for cout in (32, 64, 64):
            layers += [nn.Conv2d(cin, cout, 4, stride=2, padding=1),
                       nn.ReLU()]
            cin = cout
        self.encoder = nn.Sequential(*layers)
        self.classifier = nn.Sequential(nn.Linear(64 * 4 * 4, 256),
                                        nn.ReLU(), nn.Linear(256, num_classes))
        zero_biases_(self)
        self.to(device=resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, C, 32, 32) f32 -> (B, K) f32 logits; the convs and the first
        Dense in ``dtype``, the last in f32 (as the JAX module)."""
        for layer in self.encoder[::2]:
            x = F.relu(conv(layer, x, self.dtype))
        fc0, fc1 = self.classifier[0], self.classifier[2]
        dtype = self.dtype or fc0.weight.dtype
        h = F.relu(F.linear(x.flatten(1).to(dtype), fc0.weight.to(dtype),
                            fc0.bias.to(dtype)))
        return fc1(h.to(torch.float32))


def build_classifier(net_name: str, num_classes: int, *,
                     num_input_channels: int = 3, drop_rate: float = 0.0,
                     device: DeviceLike = None,
                     dtype: Optional[torch.dtype] = None
                     ) -> WideResNetClassifier:
    """'wideresnet-28-2' -> ``WideResNetClassifier``. The JAX package's
    ``build_classifier`` takes WideResNet names only
    (shotvae_tpu/models/classifier.py:77-83), so neither does this one."""
    if "wideresnet" not in net_name:
        raise NotImplementedError(
            f"--net-name {net_name}: the classifier baseline takes "
            "wideresnet-<depth>-<width> only; the JAX package has no "
            "PreActResNet or DenseNet classifier either")
    depth, width = parse_wideresnet_name(net_name)
    return WideResNetClassifier(depth, width, num_classes,
                                num_input_channels=num_input_channels,
                                drop_rate=drop_rate, device=device,
                                dtype=dtype)


@torch.no_grad()
def apply_classifier_init(model: nn.Module,
                          generator: torch.Generator) -> nn.Module:
    """Re-draw every conv weight from U(+-sqrt(6 / fan_in)) (torch's
    ``kaiming_uniform_(a=0)``) and zero every conv bias, in module order,
    from ``generator`` (a host generator); the head and the BN parameters
    keep their init. In place; returns ``model``."""
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            w = m.weight
            bound = math.sqrt(6.0 / (w.shape[1] * w.shape[2] * w.shape[3]))
            w.copy_(torch.empty(w.shape).uniform_(-bound, bound,
                                                  generator=generator))
            if m.bias is not None:
                m.bias.zero_()
    return model
