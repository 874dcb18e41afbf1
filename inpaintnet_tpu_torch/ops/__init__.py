"""Primitives and kernels (``inpaintnet_tpu/ops``): GRU and LSTM loops,
linear and embedding layers, the diagonal normal, sampling, and the CUDA
kernels' wrappers (``encoder_kernel``, ``decode_kernel``, ``gru_kernel``,
``gru_train_kernel``, ``arnn_kernel``), built on first launch."""
from inpaintnet_tpu_torch.ops.linear import (
    linear_init,
    linear_apply,
    mlp_selu_init,
    mlp_selu_apply,
    embedding_init,
    embedding_apply,
)
from inpaintnet_tpu_torch.ops.gru import (
    gru_init,
    gru_apply,
    gru_cell_init,
    gru_cell_apply,
)
from inpaintnet_tpu_torch.ops.lstm import (
    lstm_cell_init,
    lstm_layer_apply,
    lstm_stack_init,
    lstm_stack_apply,
)
from inpaintnet_tpu_torch.ops.distributions import DiagNormal, kl_diag_normal_vs_standard
from inpaintnet_tpu_torch.ops.sampling import sample_categorical, sample_argmax
