"""Training loops (counterpart of ``shm_tpu/train``): the LSTM-VAE trainer
and the CNN classifier trainer."""

from shm_tpu_torch.train.cnn import CNNTrainResult, predict_probs, train_cnn
from shm_tpu_torch.train.vae import (
    VAETrainResult, kl_anneal_sigmoid, make_optimizer, reconstruction_mse,
    train_vae,
)

__all__ = ["CNNTrainResult", "VAETrainResult", "kl_anneal_sigmoid",
           "make_optimizer", "predict_probs", "reconstruction_mse",
           "train_cnn", "train_vae"]
