"""Federated semantic segmentation (fedseg), the port of
``fedml_tpu/algorithms/fedseg.py``.

Reference: fedml_api/distributed/fedseg/ — per-client mIoU / FWIoU /
pixel-accuracy evaluation through a confusion-matrix ``Evaluator``
(fedseg/utils.py, MyModelTrainer.py:92-125), an aggregator that keeps each
client's eval record and the global averages (FedSegAggregator.py:105-235),
and an ``EvaluationMetricsKeeper`` record per client.

Training is FedAvg over a trainer of the ``segmentation`` task
(``core/trainer.py``: per-pixel CE with the ignore label). The evaluation is
array math: the engine's per-client evaluation (``FedSim.evaluate_per_client``)
returns every client's ``[C, C]`` confusion matrix, stacked, and each metric
is a closed-form reduction of a matrix. The metric functions take a
matrix as a tensor and compute in its dtype (f32 from the engine).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fedml_tpu_torch.core.trainer import ClientTrainer
from fedml_tpu_torch.sim.engine import FedSim

# ---------------------------------------------------------------------------
# Metrics from confusion matrices (reference fedseg/utils.py Evaluator)
# ---------------------------------------------------------------------------


def pixel_accuracy(conf: torch.Tensor) -> torch.Tensor:
    return torch.trace(conf) / torch.clamp(torch.sum(conf), min=1.0)


def pixel_accuracy_class(conf: torch.Tensor) -> torch.Tensor:
    rows = torch.sum(conf, dim=1)
    per_class = torch.diag(conf) / torch.clamp(rows, min=1.0)
    present = rows > 0
    return (torch.sum(torch.where(present, per_class, 0.0))
            / torch.clamp(torch.sum(present), min=1.0))


def iou_per_class(conf: torch.Tensor) -> torch.Tensor:
    inter = torch.diag(conf)
    union = torch.sum(conf, dim=0) + torch.sum(conf, dim=1) - inter
    return inter / torch.clamp(union, min=1.0)


def mean_iou(conf: torch.Tensor) -> torch.Tensor:
    union = torch.sum(conf, dim=0) + torch.sum(conf, dim=1) - torch.diag(conf)
    present = union > 0
    return (torch.sum(torch.where(present, iou_per_class(conf), 0.0))
            / torch.clamp(torch.sum(present), min=1.0))


def frequency_weighted_iou(conf: torch.Tensor) -> torch.Tensor:
    freq = torch.sum(conf, dim=1) / torch.clamp(torch.sum(conf), min=1.0)
    return torch.sum(torch.where(freq > 0, freq * iou_per_class(conf), 0.0))


@dataclasses.dataclass
class EvaluationMetricsKeeper:
    """Per-client eval record (reference fedseg/utils.py
    EvaluationMetricsKeeper — acc / acc_class / mIoU / FWIoU / loss)."""

    accuracy: float
    accuracy_class: float
    mIoU: float
    FWIoU: float
    loss: float


def metrics_from_confusion(conf, loss: float = 0.0) -> EvaluationMetricsKeeper:
    """The record of one ``[C, C]`` matrix (an array or a tensor)."""
    c = torch.as_tensor(conf)
    return EvaluationMetricsKeeper(
        accuracy=float(pixel_accuracy(c)),
        accuracy_class=float(pixel_accuracy_class(c)),
        mIoU=float(mean_iou(c)),
        FWIoU=float(frequency_weighted_iou(c)),
        loss=float(loss),
    )


# ---------------------------------------------------------------------------
# FedSeg simulation: FedAvg + per-client segmentation eval
# ---------------------------------------------------------------------------


class FedSegSim(FedSim):
    """FedAvg on a segmentation trainer and the fedseg evaluation protocol.

    :meth:`evaluate_clients` replaces the reference aggregator's per-client
    eval bookkeeping (FedSegAggregator.py:105-235): the engine's per-client
    evaluation gives every client's confusion matrix, and the global
    metrics come from their sum (the reference's global average over
    clients, weighted by true pixel counts rather than a mean of per-client
    ratios). The constructor is :class:`FedSim`'s."""

    def __init__(self, trainer: ClientTrainer, train_data, test_arrays, config,
                 aggregator=None, device="cuda"):
        if trainer.task != "segmentation":
            raise ValueError("FedSegSim requires the segmentation task")
        super().__init__(trainer, train_data, test_arrays, config, aggregator=aggregator,
                         device=device)

    def evaluate_clients(self, variables, client_ids=None, batch_size=None):
        """Returns (per-client :class:`EvaluationMetricsKeeper` dict, global
        metrics dict)."""
        cfg = self.config
        ids = np.asarray(client_ids if client_ids is not None
                         else np.arange(cfg.client_num_in_total))
        m = self.evaluate_per_client(variables, client_ids=ids,
                                     batch_size=batch_size or cfg.eval_batch_size)
        confs = np.asarray(m["confusion"])  # [clients, num_classes, num_classes]
        losses = np.asarray(m["test_loss"]) / np.maximum(np.asarray(m["test_total"]), 1.0)
        per_client = {int(cid): metrics_from_confusion(confs[i], losses[i])
                      for i, cid in enumerate(ids)}
        global_conf = torch.as_tensor(confs.sum(axis=0))
        total = float(np.maximum(np.asarray(m["test_total"]).sum(), 1.0))
        global_metrics = {
            "Eval/PixelAcc": float(pixel_accuracy(global_conf)),
            "Eval/AccClass": float(pixel_accuracy_class(global_conf)),
            "Eval/mIoU": float(mean_iou(global_conf)),
            "Eval/FWIoU": float(frequency_weighted_iou(global_conf)),
            "Eval/Loss": float(np.asarray(m["test_loss"]).sum() / total),
        }
        return per_client, global_metrics
