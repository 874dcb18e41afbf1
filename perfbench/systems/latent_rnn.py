"""The program under test for a LatentRNN configuration: the port's
``InpaintingEngine`` over a MeasureVAE and a non-autoregressive LatentRNN
built on the meta device and given the benchmark's weights, serving
through ``inpaint_hetero`` (per-row keys: the HTTP server's primitive).

The control is the program's own lower-precision path: the same engine at
``dtype="int8"`` (K3 and K4)."""
from __future__ import annotations

import time

import torch


class System:
    def __init__(self, cfg: dict, weights: dict, device, control: bool = False):
        from inpaintnet_tpu_torch.models.latent_rnn import LatentRNN
        from inpaintnet_tpu_torch.models.measure_vae import MeasureVAE
        from inpaintnet_tpu_torch.models.presets import VocabOnlyDataset
        from inpaintnet_tpu_torch.serve import InpaintingEngine

        self.phases = [("program imports", time.perf_counter())]

        vae = MeasureVAE(VocabOnlyDataset(cfg["vocab_size"]),
                         note_embedding_dim=cfg["note_embedding_dim"],
                         num_encoder_layers=cfg["num_encoder_layers"],
                         encoder_hidden_size=cfg["encoder_hidden_size"],
                         latent_space_dim=cfg["latent_space_dim"],
                         num_decoder_layers=cfg["num_decoder_layers"],
                         decoder_hidden_size=cfg["decoder_hidden_size"], device="meta")
        model = LatentRNN(vae, num_rnn_layers=cfg["num_latent_rnn_layers"],
                          rnn_hidden_size=cfg["latent_rnn_hidden_size"], auto_reg=False,
                          max_target=cfg["max_target"], device="meta")
        model.load_state_dict(weights, strict=True, assign=True)
        self.phases.append(("model", time.perf_counter()))
        self.engine = InpaintingEngine(model, batch_buckets=cfg["batch_buckets"],
                                       dtype="int8" if control else cfg["serve_dtype"],
                                       n_bars=cfg["n_bars"], device=device)

    def describe(self) -> str:
        from inpaintnet_tpu_torch.ops.gru import get_gru_impl

        return (f"InpaintingEngine.inpaint_hetero, dtype {self.engine._quant}/"
                f"{self.engine._params['x_0'].dtype}, GRU route {get_gru_impl()!r}, "
                f"CUDA graphs {self.engine.graphs}")

    def warmup(self, requests: list, bucket: int) -> None:
        """The cell's one graph key: captured by the first call, replayed
        by the second."""
        for _ in range(2):
            self.engine.inpaint_hetero(requests, bucket=bucket)

    def call(self, requests: list, bucket: int) -> list:
        return self.engine.inpaint_hetero(requests, bucket=bucket)

    def counters(self) -> dict:
        graphs = self.engine._graphs
        if not self.engine.graphs or not graphs.keys():
            return {}
        return {"graph_capture_s": sum(graphs[k].warm_s + graphs[k].capture_s
                                       for k in graphs.keys())}

    def close(self) -> None:
        del self.engine
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def check_options(variant) -> dict:
    return {}
