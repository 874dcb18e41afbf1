"""The program under test for an AnticipationRNN configuration: the port's
``ARNNServingEngine`` over an ``AnticipationRNNBaseline`` built on the meta
device and given the benchmark's weights, serving argmax inpainting
through ``inpaint_hetero`` (K7 under the constraint LSTM).

The program has no path below bf16, so the control is the reference's:
the float8 reference's first tokens, judged in float32
(``reference/arnn.py``)."""
from __future__ import annotations

import time

import torch


class System:
    def __init__(self, cfg: dict, weights: dict, device, control: bool = False):
        from inpaintnet_tpu_torch.models.anticipation_rnn import AnticipationRNNBaseline
        from inpaintnet_tpu_torch.models.presets import ARNNDataset
        from inpaintnet_tpu_torch.serve_arnn import ARNNServingEngine

        self.phases = [("program imports", time.perf_counter())]

        model = AnticipationRNNBaseline(
            ARNNDataset(cfg["vocab_size"]), note_embedding_dim=cfg["note_embedding_dim"],
            metadata_embedding_dim=cfg["metadata_embedding_dim"],
            num_lstm_constraints_units=cfg["num_lstm_constraints_units"],
            num_lstm_generation_units=cfg["num_lstm_generation_units"],
            linear_hidden_size=cfg["linear_hidden_size"], num_layers=cfg["num_layers"],
            unary_constraint=True, device="meta")
        model.load_state_dict(weights, strict=True, assign=True)
        self.phases.append(("model", time.perf_counter()))
        self.engine = ARNNServingEngine(model, batch_buckets=cfg["batch_buckets"],
                                        dtype=cfg["serve_dtype"],
                                        measure_seq_len=cfg["measure_seq_len"],
                                        max_measures=cfg["max_measures"], device=device)

    def describe(self) -> str:
        return (f"ARNNServingEngine.inpaint_hetero (argmax), dtype "
                f"{self.engine._params['linear_1']['w'].dtype}, CUDA graphs "
                f"{self.engine.graphs}")

    def warmup(self, requests: list, bucket: int) -> None:
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
    return {"control": variant == "control"}
