"""Update-compression subsystem, the port of ``fedml_tpu/compress``: codecs,
error feedback and the sim engine's compressed aggregation, with
bytes-on-wire accounting, and the message-passing server's host-side folds
of an encoded upload (``compress/aggregate.py``). The downlink delta coding
is ROADMAP §A11."""

from fedml_tpu_torch.compress.codec import (
    Bf16Codec,
    ChainCodec,
    Codec,
    EncodedUpdate,
    NoneCodec,
    QuantizeCodec,
    TopKCodec,
    make_codec,
    tree_bytes,
)

__all__ = [
    "Bf16Codec",
    "ChainCodec",
    "Codec",
    "EncodedUpdate",
    "NoneCodec",
    "QuantizeCodec",
    "TopKCodec",
    "make_codec",
    "tree_bytes",
]
