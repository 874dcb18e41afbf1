"""Training (``inpaintnet_tpu/train``): the single-device trainer, the
MeasureVAE and LatentRNN trainers, their losses, train-state checkpoints and
an in-memory dataset."""
from inpaintnet_tpu_torch.train.latent_rnn_trainer import LatentRNNTrainer
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer

__all__ = ["LatentRNNTrainer", "VAETrainer"]
