"""TensorBoard logging: epoch scalars and parameter histograms.

Counterpart of ``admm_deconv_tpu/train/logging.py`` (the reference's
trainer v2 ``LogMetrics``/``LogHistograms``), through
``torch.utils.tensorboard``, which is imported when a logger is built: it
needs the ``tensorboard`` package, and the trainer builds a logger only
when asked to.
"""

from __future__ import annotations

from torch import nn


class TensorBoardLogger:
    """Epoch-level scalar + histogram writer."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir)

    def log_scalars(self, metrics: dict[str, float], step: int, prefix: str = "") -> None:
        for name, value in metrics.items():
            self.writer.add_scalar(f"{prefix}{name}", float(value), step)

    def log_histograms(self, model: nn.Module, step: int) -> None:
        for name, p in model.named_parameters():
            self.writer.add_histogram(name.replace(".", "/"),
                                      p.detach().float().cpu().numpy().ravel(), step)

    def flush(self) -> None:
        self.writer.flush()

    def close(self) -> None:
        self.writer.close()
