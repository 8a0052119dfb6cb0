"""Plain PyTorch models: the VAE gate and the CNN4DOF and CNNOpenLab
classifiers."""

from shm_tpu_torch.models.cnn import CNN4DOF, CNNOpenLab, stack_vae_residual_nhwc
from shm_tpu_torch.models.lstm import LSTMLayer, LSTMStack
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config

__all__ = ["CNN4DOF", "CNNOpenLab", "stack_vae_residual_nhwc", "LSTMLayer", "LSTMStack",
           "TemporalVAE", "vae_from_config"]
