"""Alias of ``vae.py``, as shotvae_tpu/models/mlpvae.py:1-13 is: the
reference's mlpvae.py duplicates vae.py (it holds no MLP), so this module
re-exports the one composition."""

from shotvae_torch.models.vae import VariationalAutoEncoder, build_encoder

__all__ = ["VariationalAutoEncoder", "build_encoder"]
