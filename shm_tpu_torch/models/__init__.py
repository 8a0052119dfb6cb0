"""Plain PyTorch models: the VAE gate (its LSTM, minGRU and attention
stacks) and the CNN4DOF and CNNOpenLab classifiers; the names of
``shm_tpu.models``."""

from shm_tpu_torch.models.attention import AttentionStack, TransformerBlock
from shm_tpu_torch.models.cnn import (CNN4DOF, CNNOpenLab, cnn_from_config,
                                      stack_vae_residual_nhwc)
from shm_tpu_torch.models.lstm import LSTMLayer, LSTMStack
from shm_tpu_torch.models.minrnn import MinGRULayer, MinGRUStack, linear_recurrence
from shm_tpu_torch.models.vae import TemporalVAE, vae_from_config

__all__ = ["LSTMLayer", "LSTMStack", "MinGRULayer", "MinGRUStack",
           "linear_recurrence", "AttentionStack", "TransformerBlock",
           "TemporalVAE", "vae_from_config", "CNN4DOF", "CNNOpenLab",
           "cnn_from_config", "stack_vae_residual_nhwc"]
