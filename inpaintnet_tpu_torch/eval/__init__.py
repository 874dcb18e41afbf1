"""Testers of the port's models and the HTML report (``inpaintnet_tpu/eval``)."""
from inpaintnet_tpu_torch.eval.vae_tester import VAETester
from inpaintnet_tpu_torch.eval.latent_rnn_tester import LatentRNNTester
from inpaintnet_tpu_torch.eval.anticipation_rnn_tester import AnticipationRNNTester
from inpaintnet_tpu_torch.eval.report import EvalReport, build_report
