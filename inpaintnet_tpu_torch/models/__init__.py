"""The models (``inpaintnet_tpu/models``): MeasureVAE and its decoders,
LatentRNN and its ablations, the AnticipationRNN family, checkpoints in the
JAX package's layout."""
from inpaintnet_tpu_torch.models.base import Model, flatten_params, unflatten_like
from inpaintnet_tpu_torch.models.measure_vae import (
    Encoder,
    HierarchicalDecoder,
    SRDecoder,
    SRDecoderNoInput,
    MeasureVAE,
)
from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN, LatentRNNAblations
from inpaintnet_tpu_torch.models.anticipation_rnn import (
    ConstraintModelGaussianReg,
    AnticipationRNNBaseline,
)
