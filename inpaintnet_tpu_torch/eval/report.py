"""Self-contained HTML evaluation report (``inpaintnet_tpu/eval/report.py``).

Collates what the reference scattered across stdout, matplotlib windows and
MIDI dumps (vae_tester.py plots, script_gen outputs) into one artifact:
test metrics, latent-space projections (inlined as base64 PNGs), and
sample inpaintings rendered as ABC text.
"""
from __future__ import annotations

import base64
import html
import os
from typing import List


class EvalReport:
    def __init__(self, title: str = "inpaintnet_tpu evaluation"):
        self.title = title
        self._sections: List[str] = []

    def add_metrics(self, name: str, metrics: dict):
        rows = "".join(
            f"<tr><td>{html.escape(str(k))}</td><td>{v:.4f}</td></tr>"
            if isinstance(v, float)
            else f"<tr><td>{html.escape(str(k))}</td><td>{html.escape(str(v))}</td></tr>"
            for k, v in metrics.items()
        )
        self._sections.append(
            f"<h2>{html.escape(name)}</h2>"
            f"<table><tr><th>metric</th><th>value</th></tr>{rows}</table>"
        )

    def add_image(self, name: str, png_path: str):
        with open(png_path, "rb") as f:
            b64 = base64.b64encode(f.read()).decode()
        self._sections.append(
            f"<h2>{html.escape(name)}</h2>"
            f'<img src="data:image/png;base64,{b64}" style="max-width:720px"/>'
        )

    def add_abc(self, name: str, abc_text: str):
        self._sections.append(
            f"<h2>{html.escape(name)}</h2>"
            f"<pre>{html.escape(abc_text)}</pre>"
        )

    def add_note(self, text: str):
        self._sections.append(f"<p>{html.escape(text)}</p>")

    def write(self, path: str) -> str:
        body = "\n".join(self._sections)
        doc = f"""<!doctype html><html><head><meta charset="utf-8">
<title>{html.escape(self.title)}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 860px; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #999; padding: 4px 10px; text-align: left; }}
 pre {{ background: #f6f6f6; padding: 10px; overflow-x: auto; }}
</style></head><body><h1>{html.escape(self.title)}</h1>
{body}
</body></html>"""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(doc)
        return path


def build_report(
    vae_tester=None,
    latent_tester=None,
    arnn_tester=None,
    out_path: str = "eval_report.html",
    num_samples: int = 2,
    batch_size: int = 64,
    plot: bool = True,
) -> str:
    """Run the standard evaluations and emit one HTML file."""
    from inpaintnet_tpu_torch.data.abc_writer import write_abc

    report = EvalReport()
    if vae_tester is not None:
        loss, acc = vae_tester.test_model(batch_size)
        report.add_metrics(
            "MeasureVAE reconstruction",
            {"test NLL": loss, "test accuracy": acc},
        )
        if plot:
            try:
                png = vae_tester.plot_attribute_dist(
                    attribute="num_notes", plt_type="pca", out_dir="plots"
                )
                report.add_image("Latent space, colored by note density (PCA)", png)
            except Exception as e:  # noqa: BLE001 — plots are best-effort
                report.add_note(f"latent plot unavailable: {e}")
    if latent_tester is not None:
        loss, acc = latent_tester.test_model(batch_size)
        report.add_metrics(
            "LatentRNN (InpaintNet) inpainting",
            {"test NLL": loss, "test accuracy": acc},
        )
        for i in range(num_samples):
            latent_tester.seed = i
            gen_score, _, orig = latent_tester.generation_test()
            report.add_abc(f"Inpainting sample {i} (generated)", write_abc(gen_score))
            if orig is not None and i == 0:
                report.add_abc("Original for sample 0", write_abc(orig))
    if arnn_tester is not None:
        loss, acc = arnn_tester.test_model(batch_size)
        report.add_metrics(
            "AnticipationRNN inpainting", {"test NLL": loss, "test accuracy": acc}
        )
    return report.write(out_path)
