"""Serving API over a trained SHOT-VAE. Port of shotvae_tpu/api.py:28-100.

  classify(images)      -> class probabilities from q(y|x) (deterministic)
  encode(images)        -> (z_mean, z_log_sigma, disc_log_alpha)
  reconstruct(images)   -> sigmoid reconstruction (stochastic z and y)
  generate(labels)      -> decoder samples from the prior p(z) with the
                           given classes' one-hots

Images go in as uint8 NHWC batches and reconstructions come out NHWC, as in
the JAX package. Randomness comes from the caller's ``torch.Generator``;
without one, a generator seeded with 0 keeps an endpoint deterministic, as
the JAX endpoints' default ``jax.random.key(0)`` does. The endpoints run on
``cuda`` unless the caller passes ``device="cpu"``, in full float32
(``device.exact_f32``: no TF32 in cuDNN or cuBLAS).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

from shotvae_torch.data.pipeline import to_float
from shotvae_torch.device import DeviceLike, exact_f32, resolve_device
from shotvae_torch.io.checkpoint import (CheckpointManager,
                                         resolve_checkpoint_path)
from shotvae_torch.io.reference import strip_module_wrappers
from shotvae_torch.models.vae import VariationalAutoEncoder
from shotvae_torch.ops import sampling
from shotvae_torch.utils.spans import span


def _default_generator(generator: Optional[torch.Generator]):
    return torch.Generator().manual_seed(0) if generator is None else generator


class ShotVaeInference:
    def __init__(self, model: VariationalAutoEncoder,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, source: Union[str, os.PathLike,
                                           CheckpointManager], *,
                        best: bool = False, device: DeviceLike = None,
                        encoder_name: Optional[str] = None):
        """Load a ``{"state_dict": ..., "args": {...}}`` checkpoint: one the
        trainer wrote (``shotvae_torch.train.loop``) or one
        scripts/export_torch_checkpoint.py wrote. ``source`` is a
        ``CheckpointManager`` (its latest ``checkpoint``, or ``best``), a
        run folder or pointer-managed name (``best`` picks the ``best``
        pointer) or a file. The latent sizes and the stem (``small_input``)
        are read from the weights; the encoder name (any family
        ``build_encoder`` takes) and temperature from the stored config,
        unless ``encoder_name`` is given. The model serves in float32 in
        eval mode, where DenseNet's ``efficient`` changes nothing, so it is
        not read. The keys may carry the reference's ``nn.DataParallel``
        wrappers (``.module``), which are stripped first."""
        device = resolve_device(device)
        name = "best" if best else "checkpoint"
        path = (source.latest_path(best)
                if isinstance(source, CheckpointManager)
                else resolve_checkpoint_path(os.fspath(source), (name,)))
        payload = torch.load(path, map_location="cpu", weights_only=True)
        sd = strip_module_wrappers(payload["state_dict"])
        args = payload.get("args") or {}
        encoder_name = encoder_name or args.get("net_name")
        if not encoder_name:
            raise ValueError(f"{path} names no net_name; pass encoder_name")
        up0 = sd["feature_reconstructor.decoder.0.weight"]
        stem = sd["feature_extractor.encoder.pre_process.conv0.weight"]
        model = VariationalAutoEncoder(
            encoder_name, num_input_channels=stem.shape[1],
            small_input=stem.shape[2] == 3,  # else the 7x7 stem
            img_size=(32 * up0.shape[2], 32 * up0.shape[3]),
            continuous_latent_dim=sd[
                "continuous_inference.mean.fc.weight"].shape[0],
            disc_latent_dim=sd["disc_latent_inference.fc.weight"].shape[0],
            sample_temperature=float(args.get("temperature", 0.67)),
            device="cpu")
        model.load_state_dict(sd, strict=True)
        return cls(model, device=device)

    def _images(self, images_u8) -> torch.Tensor:
        """uint8 NHWC -> float NCHW (channels_last) on the device."""
        x = torch.as_tensor(images_u8)
        with span("serve.copy_in", bytes=x.nbytes):
            x = x.to(self.device)
        return to_float(x).permute(0, 3, 1, 2)

    @exact_f32()
    @torch.inference_mode()
    def classify(self, images_u8) -> torch.Tensor:
        """(B, H, W, C) uint8 -> (B, K) class probabilities. A profiler
        sees the call as a ``serve.classify`` span around ``serve.copy_in``
        (the batch's copy to the device) and ``serve.forward``."""
        with span("serve.classify", images=len(images_u8)):
            x = self._images(images_u8)
            with span("serve.forward", images=len(x)):
                _, _, log_alpha = self.model.encode(x)
                return torch.exp(log_alpha)

    @exact_f32()
    @torch.inference_mode()
    def encode(self, images_u8):
        """(B, H, W, C) uint8 -> (mean, log_sigma, log_alpha)."""
        return self.model.encode(self._images(images_u8))

    @exact_f32()
    @torch.inference_mode()
    def reconstruct(self, images_u8,
                    generator: Optional[torch.Generator] = None):
        """(B, H, W, C) uint8 -> (B, H, W, C) sigmoid reconstruction. A
        profiler sees the call as a ``serve.reconstruct`` span around
        ``serve.copy_in`` and ``serve.forward`` (the encoder, the draw, the
        decoder and the sigmoid)."""
        with span("serve.reconstruct", images=len(images_u8)):
            x = self._images(images_u8)
            with span("serve.forward", images=len(x)):
                recon, _, _, _ = self.model(
                    x, generator=_default_generator(generator))
                return torch.sigmoid(recon).permute(0, 2, 3, 1)

    @exact_f32()
    @torch.inference_mode()
    def generate(self, labels, generator: Optional[torch.Generator] = None):
        """(B,) class labels -> (B, H, W, C) class-conditional samples."""
        gen = _default_generator(generator)
        labels = torch.as_tensor(labels, device=self.device)
        z = torch.randn((labels.shape[0], self.model.continuous_latent_dim),
                        generator=gen, device=gen.device).to(self.device)
        y = sampling.label_onehot(labels, self.model.disc_latent_dim)
        recon = self.model.decode(torch.cat([z, y], dim=1))
        return torch.sigmoid(recon).permute(0, 2, 3, 1)
