"""Training loops (counterpart of ``shm_tpu/train``): the LSTM-VAE trainer."""

from shm_tpu_torch.train.vae import (
    VAETrainResult, kl_anneal_sigmoid, make_optimizer, reconstruction_mse,
    train_vae,
)

__all__ = ["VAETrainResult", "kl_anneal_sigmoid", "make_optimizer",
           "reconstruction_mse", "train_vae"]
