"""Training (``inpaintnet_tpu/train``): the trainer base class (one device
or a (data, model) mesh), the MeasureVAE, LatentRNN and AnticipationRNN
trainers, their losses, train-state checkpoints and an in-memory dataset."""
from inpaintnet_tpu_torch.train.trainer import Trainer, EarlyStopping
from inpaintnet_tpu_torch.train.vae_trainer import VAETrainer
from inpaintnet_tpu_torch.train.latent_rnn_trainer import (
    LatentRNNTrainer,
    split_score,
    split_to_measures,
    pack_padded,
)
from inpaintnet_tpu_torch.train.arnn_trainer import (
    AnticipationRNNGaussianRegTrainer,
    AnticipationRNNBaselineTrainer,
)
from inpaintnet_tpu_torch.train.checkpoints import save_train_state, load_train_state
