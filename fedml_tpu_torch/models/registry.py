"""Model registry, the port of ``fedml_tpu/models/registry.py``.

Ported: ``lr`` (LogisticRegression), the FedAvg-paper CNNs ``cnn``
(``CNNDropOut``, the FEMNIST model) and ``cnn_original``, ``lenet``,
``transformer``, the CIFAR ResNets with BatchNorm, ``resnet56`` and
``resnet110``, and ``rnn`` (``RNNStackOverflow`` on ``stackoverflow_nwp``,
``RNNOriginalFedAvg`` on any other dataset). Every other model name of the
JAX registry raises, naming the ROADMAP item that ports it.
``TASK_BY_DATASET`` and :func:`task_for_dataset` are the JAX registry's.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg, LeNet
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.resnet import resnet56, resnet110
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.transformer import TransformerLM

# model names of the JAX registry that later slices port (ROADMAP.md §A)
_NOT_PORTED = {
    "resnet18_gn": "§A7 (the rest: resnet18_gn)",
    "mobilenet": "§A7 (the rest: MobileNet)",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# per-example input shape of the ported models on each dataset the CLI
# serves them (flax infers it at the first call; torch sizes layers up front)
_INPUT_SHAPES = {"mnist": (28, 28), "femnist": (28, 28)}


def create_model(model_name: str, output_dim: int, dataset: str = "",
                 dtype: Any = None, device: str | torch.device = "cuda",
                 input_shape: tuple[int, ...] | None = None,
                 **model_kwargs) -> torch.nn.Module:
    """The reference's name/dataset dispatch (main_fedavg.py:354-390).

    ``dtype`` (a torch dtype or "float32"/"bfloat16") is the compute dtype
    for the models that take one (the CNNs, the ResNets, the transformer);
    parameters stay f32. As in the JAX registry, a dtype other than f32 for
    a model without one (``lr``, ``rnn``) raises; ``rnn`` ignores
    ``output_dim`` (its vocabulary is the model's), as there.
    ``input_shape`` is one example's shape (e.g. ``(28, 28)``), which sizes
    ``lr``'s and the CNNs' first Dense; it defaults to the dataset's (28 x
    28 for ``mnist`` and ``femnist``). ``model_kwargs`` set the model's
    other fields (for the transformer: ``embed_dim``, ``num_layers``,
    ``num_heads``, ``max_len``, ``attn_impl``, ...; for ``cnn``:
    ``dropout_rates``; for ``rnn``: ``vocab_size``, ``embedding_dim``,
    ``hidden_size``). The model is built on ``device``, which must be
    available."""
    if model_name not in ("lr", "cnn", "cnn_original", "lenet", "transformer", "resnet56",
                          "resnet110", "rnn"):
        slice_ = _NOT_PORTED.get(model_name, "§A13 (remaining families)")
        raise NotImplementedError(
            f"model {model_name!r} (dataset={dataset!r}) is not ported to "
            f"fedml_tpu_torch yet: ROADMAP {slice_}"
        )
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r} (expected one of {sorted(_DTYPES)})")
        dtype = _DTYPES[dtype]
    if model_name in ("lr", "rnn") and dtype not in (None, torch.float32):
        raise ValueError(f"model {model_name!r} does not take a compute dtype")
    if model_name == "rnn":
        factory = RNNStackOverflow if dataset == "stackoverflow_nwp" else RNNOriginalFedAvg
        return factory(device=device, **model_kwargs)
    if model_name == "lr":
        shape = input_shape or _INPUT_SHAPES.get(dataset)
        if shape is None:
            raise ValueError(f"model 'lr' on dataset {dataset!r} needs input_shape")
        return LogisticRegression(num_classes=output_dim,
                                  in_features=math.prod(shape), device=device,
                                  **model_kwargs)
    dtype = dtype or torch.float32
    if model_name in ("cnn", "cnn_original", "lenet"):
        factory = {"cnn": CNNDropOut, "cnn_original": CNNOriginalFedAvg,
                   "lenet": LeNet}[model_name]
        shape = input_shape or _INPUT_SHAPES.get(dataset, (28, 28))
        return factory(num_classes=output_dim, dtype=dtype, input_shape=shape, device=device,
                       **model_kwargs)
    if model_name == "transformer":
        return TransformerLM(vocab_size=output_dim, dtype=dtype, device=device, **model_kwargs)
    factory = resnet56 if model_name == "resnet56" else resnet110
    return factory(class_num=output_dim, dtype=dtype, device=device, **model_kwargs)


TASK_BY_DATASET = {
    # reference trainer dispatch (fedml_api/distributed/fedavg/FedAvgAPI.py:85-91)
    "stackoverflow_lr": "tag",
    "stackoverflow_nwp": "nwp",
    "shakespeare": "char_lm",
    "fed_shakespeare": "char_lm",
}


def task_for_dataset(dataset: str) -> str:
    return TASK_BY_DATASET.get(dataset, "classification")
