"""Live training plot (``inpaintnet_tpu/utils/plotting.py``; reference
utils/trainer.py:106-110,208-269).

The reference's ``plot=True`` opens a matplotlib figure and redraws the
train/val loss+accuracy curves after every epoch. Training hosts are
usually headless, so it auto-detects the backend: with a display it
redraws a live interactive figure exactly like the reference; headless it
renders the same figure to a PNG next to the JSONL metrics log after every
epoch (so ``watch``/a browser tab gives the same live view). matplotlib is
imported lazily — environments without it fall back to JSONL-only logging
with a warning rather than failing the run.
"""
from __future__ import annotations

import os
import warnings


def _headless() -> bool:
    if os.name == "nt":  # pragma: no cover - windows hosts have a display
        return False
    return not os.environ.get("DISPLAY")


class LivePlot:
    """Redraws loss/accuracy curves each epoch; interactive or PNG.

    :param png_path: output path used on headless hosts
    :param interactive: force interactive (True) / PNG (False); default
        auto-detects a display
    """

    def __init__(self, png_path: str, interactive: bool | None = None):
        self.png_path = png_path
        self.epochs: list[int] = []
        self.loss_train: list[float] = []
        self.loss_val: list[float] = []
        self.acc_train: list[float] = []
        self.acc_val: list[float] = []
        self._fig = None
        self._plt = None
        try:
            import matplotlib

            if interactive is None:
                interactive = not _headless()
            if not interactive:
                matplotlib.use("Agg", force=True)
            import matplotlib.pyplot as plt

            self._plt = plt
            self.interactive = interactive
            if interactive:
                plt.ion()
        except Exception as exc:  # a host without matplotlib
            warnings.warn(
                f"matplotlib unavailable ({exc}); live plot disabled, "
                "metrics continue to the JSONL log",
                stacklevel=2,
            )
            self.interactive = False

    def update(
        self,
        epoch_index: int,
        mean_loss_train: float,
        mean_accuracy_train: float,
        mean_loss_val: float,
        mean_accuracy_val: float,
        **_,
    ) -> None:
        """Append one epoch's stats and redraw (reference redraws the full
        curve each epoch, trainer.py:208-269)."""
        if self._plt is None:
            return
        self.epochs.append(epoch_index)
        self.loss_train.append(float(mean_loss_train))
        self.loss_val.append(float(mean_loss_val))
        self.acc_train.append(float(mean_accuracy_train) * 100)
        self.acc_val.append(float(mean_accuracy_val) * 100)

        plt = self._plt
        if self._fig is None:
            self._fig, self._axes = plt.subplots(1, 2, figsize=(10, 4))
        ax_loss, ax_acc = self._axes
        for ax in (ax_loss, ax_acc):
            ax.clear()
        ax_loss.plot(self.epochs, self.loss_train, label="train")
        ax_loss.plot(self.epochs, self.loss_val, label="val")
        ax_loss.set_xlabel("epoch")
        ax_loss.set_ylabel("loss")
        ax_loss.legend()
        ax_acc.plot(self.epochs, self.acc_train, label="train")
        ax_acc.plot(self.epochs, self.acc_val, label="val")
        ax_acc.set_xlabel("epoch")
        ax_acc.set_ylabel("accuracy (%)")
        ax_acc.legend()
        self._fig.tight_layout()
        if self.interactive:
            self._fig.canvas.draw()
            self._fig.canvas.flush_events()
            plt.pause(0.001)
        else:
            self._fig.savefig(self.png_path, dpi=100)

    def close(self) -> None:
        if self._fig is not None and self._plt is not None:
            self._plt.close(self._fig)
            self._fig = None
