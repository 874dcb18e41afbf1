"""Training (``inpaintnet_tpu/train``): the single-device trainer, the
MeasureVAE, LatentRNN and AnticipationRNN trainers, their losses, train-state
checkpoints and an in-memory dataset."""
from inpaintnet_tpu_torch.train.arnn_trainer import (
    AnticipationRNNBaselineTrainer,
    AnticipationRNNGaussianRegTrainer,
)
from inpaintnet_tpu_torch.train.latent_rnn_trainer import LatentRNNTrainer
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

__all__ = ["AnticipationRNNBaselineTrainer", "AnticipationRNNGaussianRegTrainer",
           "LatentRNNTrainer", "VAETrainer"]
