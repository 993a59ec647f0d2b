"""Update-compression subsystem, the port of ``fedml_tpu/compress``: codecs,
error feedback and the sim engine's compressed aggregation, with
bytes-on-wire accounting, and the message-passing server's host-side folds
of an encoded upload (``compress/aggregate.py``), and the wire's downlink
delta coding (``compress/downlink.py``)."""

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
from fedml_tpu_torch.compress.downlink import (
    DOWNLINK_CHAIN_KIND,
    DownlinkCodecState,
    DownlinkDecoder,
    resolve_downlink_codec,
)

__all__ = [
    "DOWNLINK_CHAIN_KIND",
    "Bf16Codec",
    "ChainCodec",
    "Codec",
    "DownlinkCodecState",
    "DownlinkDecoder",
    "EncodedUpdate",
    "NoneCodec",
    "QuantizeCodec",
    "TopKCodec",
    "make_codec",
    "resolve_downlink_codec",
    "tree_bytes",
]
