"""Update-compression subsystem, the port of ``fedml_tpu/compress``: codecs,
error feedback and the sim engine's compressed aggregation, with
bytes-on-wire accounting. The downlink delta coding and the wire path's
helpers belong to the message-passing backends (ROADMAP §A11)."""

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
