"""Model registry, the port of ``fedml_tpu/models/registry.py``.

Ported: ``lr`` (LogisticRegression), the FedAvg-paper CNNs ``cnn``
(``CNNDropOut``, the FEMNIST model) and ``cnn_original``, ``lenet``,
``transformer``, the ResNets ``resnet56``, ``resnet110`` (BatchNorm) and
``resnet18_gn`` (GroupNorm, the fed_cifar100 model), ``mobilenet`` (V1),
``mobilenet_v3`` (mode "large", as the JAX registry builds it),
``efficientnet-b0`` ... ``-b8`` (a bare ``efficientnet`` is b0),
``vgg<depth>`` (11, 13, 16, 19; a bare ``vgg`` is VGG-16) and ``rnn``
(``RNNStackOverflow`` on ``stackoverflow_nwp``, ``RNNOriginalFedAvg`` on
any other dataset), and the segmentation models ``unet`` and ``deeplab``
(or ``deeplab_lite``) at their full width, features (32, 64, 128); an
unknown name raises ``ValueError``, as in the JAX registry.
``TASK_BY_DATASET`` and :func:`task_for_dataset` are the JAX registry's.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from fedml_tpu_torch.models.cnn import CNNDropOut, CNNOriginalFedAvg, LeNet
from fedml_tpu_torch.models.efficientnet import efficientnet
from fedml_tpu_torch.models.linear import LogisticRegression
from fedml_tpu_torch.models.mobilenet import MobileNet, MobileNetV3
from fedml_tpu_torch.models.resnet import resnet18_gn, resnet56, resnet110
from fedml_tpu_torch.models.rnn import RNNOriginalFedAvg, RNNStackOverflow
from fedml_tpu_torch.models.segmentation import DeepLabLite, UNet
from fedml_tpu_torch.models.transformer import TransformerLM
from fedml_tpu_torch.models.vgg import VGG

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# per-example input shape of the ported models on each dataset the CLI
# serves them (flax infers it at the first call; torch sizes layers up front)
_INPUT_SHAPES = {"mnist": (28, 28), "femnist": (28, 28), "cifar10": (32, 32, 3),
                 "cifar100": (32, 32, 3), "cinic10": (32, 32, 3),
                 "fed_cifar100": (32, 32, 3)}

# models whose compute dtype the JAX registry refuses to set
_NO_DTYPE = ("lr", "rnn", "unet", "deeplab", "deeplab_lite")


# the CIFAR zoo without an input shape, by name
_ZOO = {
    "resnet56": resnet56, "resnet110": resnet110, "resnet18_gn": resnet18_gn,
    "mobilenet": lambda class_num, **kw: MobileNet(num_classes=class_num, **kw),
    "mobilenet_v3": lambda class_num, **kw: MobileNetV3(num_classes=class_num, mode="large",
                                                        **kw),
}

# the segmentation models, which take their input's channel count
_SEG = {"unet": UNet, "deeplab": DeepLabLite, "deeplab_lite": DeepLabLite}


def create_model(model_name: str, output_dim: int, dataset: str = "",
                 dtype: Any = None, device: str | torch.device = "cuda",
                 input_shape: tuple[int, ...] | None = None,
                 **model_kwargs) -> torch.nn.Module:
    """The reference's name/dataset dispatch (main_fedavg.py:354-390).

    ``dtype`` (a torch dtype or "float32"/"bfloat16") is the compute dtype
    for the models that take one (the CNNs, the CIFAR zoo, the
    transformer); parameters stay f32. As in the JAX registry, a dtype other
    than f32 for a model without one (``lr``, ``rnn``) raises; ``rnn``
    ignores ``output_dim`` (its vocabulary is the model's), as there.
    ``input_shape`` is one example's shape (e.g. ``(28, 28)``), which sizes
    ``lr``'s, the CNNs' and VGG's first Dense and the segmentation models'
    first conv (its last axis, the channels; 3 without it); it defaults to
    the dataset's
    (28 x 28 for ``mnist`` and ``femnist``, 32 x 32 x 3 for the CIFAR
    datasets). ``model_kwargs`` set the model's other fields (for the
    transformer: ``embed_dim``, ``num_layers``, ``num_heads``, ``max_len``,
    ``attn_impl``, ...; for ``cnn``: ``dropout_rates``; for ``vgg*``:
    ``dropout_rate``; for ``efficientnet*``: ``dropout_rate``,
    ``drop_connect_rate``; for ``rnn``: ``vocab_size``, ``embedding_dim``,
    ``hidden_size``). The model is built on ``device``, which must be
    available."""
    if not (model_name in _ZOO or model_name in _SEG
            or model_name in ("lr", "cnn", "cnn_original", "lenet", "transformer", "rnn")
            or model_name.startswith(("efficientnet", "vgg"))):
        raise ValueError(f"unknown model {model_name!r} (dataset={dataset!r})")
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r} (expected one of {sorted(_DTYPES)})")
        dtype = _DTYPES[dtype]
    if model_name in _NO_DTYPE and dtype not in (None, torch.float32):
        raise ValueError(f"model {model_name!r} does not take a compute dtype")
    if model_name == "rnn":
        factory = RNNStackOverflow if dataset == "stackoverflow_nwp" else RNNOriginalFedAvg
        return factory(device=device, **model_kwargs)
    if model_name in _SEG:
        shape = input_shape or _INPUT_SHAPES.get(dataset)
        return _SEG[model_name](num_classes=output_dim,
                                in_channels=shape[-1] if shape and len(shape) == 3 else 3,
                                device=device, **model_kwargs)
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
    if model_name.startswith("efficientnet"):
        name = model_name if "-" in model_name else "efficientnet-b0"
        return efficientnet(name, num_classes=output_dim, dtype=dtype, device=device,
                            **model_kwargs)
    if model_name.startswith("vgg"):
        shape = input_shape or _INPUT_SHAPES.get(dataset, (32, 32, 3))
        return VGG(depth=int(model_name[3:] or 16), num_classes=output_dim, dtype=dtype,
                   input_shape=shape, device=device, **model_kwargs)
    return _ZOO[model_name](class_num=output_dim, dtype=dtype, device=device, **model_kwargs)


TASK_BY_DATASET = {
    # reference trainer dispatch (fedml_api/distributed/fedavg/FedAvgAPI.py:85-91)
    "stackoverflow_lr": "tag",
    "stackoverflow_nwp": "nwp",
    "shakespeare": "char_lm",
    "fed_shakespeare": "char_lm",
}


def to_float64(module: torch.nn.Module) -> torch.nn.Module:
    """``module`` in float64, in place: its parameters, its buffers and
    every layer's compute ``dtype``, the float64 reference of an f32 run.
    Returns ``module``."""
    module.double()
    for mod in module.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    return module


def task_for_dataset(dataset: str) -> str:
    return TASK_BY_DATASET.get(dataset, "classification")
