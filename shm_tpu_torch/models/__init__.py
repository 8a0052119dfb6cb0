"""Plain PyTorch models: the LSTM-VAE gate and the CNN4DOF classifier."""

from shm_tpu_torch.models.cnn import CNN4DOF, stack_vae_residual_nhwc
from shm_tpu_torch.models.lstm import LSTMLayer, LSTMStack
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config

__all__ = ["CNN4DOF", "stack_vae_residual_nhwc", "LSTMLayer", "LSTMStack",
           "TemporalVAE", "vae_from_config"]
