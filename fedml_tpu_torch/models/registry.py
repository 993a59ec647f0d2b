"""Model registry, the port of ``fedml_tpu/models/registry.py``.

Ported: ``transformer`` and the CIFAR ResNets with BatchNorm,
``resnet56`` and ``resnet110``. Every other model name of the JAX registry
raises, naming the ROADMAP item that ports it.
"""

from __future__ import annotations

from typing import Any

import torch

from fedml_tpu_torch.models.resnet import resnet56, resnet110
from fedml_tpu_torch.models.transformer import TransformerLM

# model names of the JAX registry that later slices port (ROADMAP.md §A)
_NOT_PORTED = {
    "lr": "§A5 (MNIST + LogisticRegression)",
    "cnn": "§A6 (FEMNIST + CNN)",
    "cnn_original": "§A6 (FEMNIST + CNN)",
    "lenet": "§A6 (FEMNIST + CNN)",
    "resnet18_gn": "§A7 (the rest: resnet18_gn)",
    "mobilenet": "§A7 (the rest: MobileNet)",
    "rnn": "§A9 (RNN slices)",
}

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def create_model(model_name: str, output_dim: int, dataset: str = "",
                 dtype: Any = None, device: str | torch.device = "cuda",
                 **model_kwargs) -> torch.nn.Module:
    """The reference's name/dataset dispatch (main_fedavg.py:354-390).

    ``dtype`` (a torch dtype or "float32"/"bfloat16") is the compute dtype;
    parameters stay f32. ``model_kwargs`` set the model's other fields (for
    the transformer: ``embed_dim``, ``num_layers``, ``num_heads``,
    ``max_len``, ``attn_impl``, ...; the ResNets take none). The model is
    built on ``device``, which must be available."""
    if model_name not in ("transformer", "resnet56", "resnet110"):
        slice_ = _NOT_PORTED.get(model_name, "§A13 (remaining families)")
        raise NotImplementedError(
            f"model {model_name!r} (dataset={dataset!r}) is not ported to "
            f"fedml_tpu_torch yet: ROADMAP {slice_}"
        )
    if isinstance(dtype, str):
        if dtype not in _DTYPES:
            raise ValueError(f"unknown dtype {dtype!r} (expected one of {sorted(_DTYPES)})")
        dtype = _DTYPES[dtype]
    dtype = dtype or torch.float32
    if model_name == "transformer":
        return TransformerLM(vocab_size=output_dim, dtype=dtype, device=device, **model_kwargs)
    factory = resnet56 if model_name == "resnet56" else resnet110
    return factory(class_num=output_dim, dtype=dtype, device=device, **model_kwargs)
