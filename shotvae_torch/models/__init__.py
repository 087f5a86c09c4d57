"""The port's model zoo: the WideResNet, PreActResNet and DenseNet
encoders, the DCGAN decoder, the SHOT/M2 VAE, the classifiers and the
smooth-ELBO VAEs (counterparts of shotvae_tpu/models)."""

from shotvae_torch.models.classifier import (MLPClassifier,
                                             WideResNetClassifier,
                                             build_classifier)
from shotvae_torch.models.decoder import Decoder
from shotvae_torch.models.densenet import DenseNet, densenet_dict
from shotvae_torch.models.preactresnet import PreActResNet, preactresnet_dict
from shotvae_torch.models.smooth_vae import (SmoothVAE, mnist_vae_config,
                                             svhn_vae_config)
from shotvae_torch.models.vae import VariationalAutoEncoder, build_encoder
from shotvae_torch.models.wideresnet import WideResNet

__all__ = [
    "Decoder",
    "DenseNet",
    "PreActResNet",
    "SmoothVAE",
    "VariationalAutoEncoder",
    "WideResNet",
    "MLPClassifier",
    "WideResNetClassifier",
    "build_classifier",
    "build_encoder",
    "densenet_dict",
    "mnist_vae_config",
    "preactresnet_dict",
    "svhn_vae_config",
]
