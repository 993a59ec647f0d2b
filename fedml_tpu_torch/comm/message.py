"""Message envelope and wire format, the port of ``fedml_tpu/comm/message.py``.

A frame is the JAX package's, byte for byte: the magic ``FTM1``, a
little-endian u32 header length, a JSON header (``msg_type``/``sender``/
``receiver`` and the ``MSG_ARG_*`` params, an array param as its
``{"__arr__", "dtype", "shape"}`` descriptor), then one length-prefixed raw
little-endian segment per array, never a pickled object. So a frame from
either package decodes in the other, a broadcast's ``(head, shared_tail)``
pair included. Model payloads are ``pack_pytree``'s (flat byte vector,
leaf descriptor) pairs over the JAX layout: flax's nested names in sorted
path order, HWIO convolutions and ``[in, out]`` kernels
(``fedml_tpu_torch/convert.py`` ``to_flax``/``from_flax`` move a state
dict in and out of it).

Framing is zero-copy on both sides: packing a contiguous numpy array
contributes a ``memoryview`` of its buffer, and unpacking yields read-only
``np.frombuffer`` views into the received buffer, so two receivers of one
shared broadcast buffer cannot write into each other's model. A consumer
that hands a leaf to torch copies it once (``torch.from_numpy`` on a
read-only view would alias a buffer it must not write).

Where the port departs: array params and pytree leaves may also be torch
tensors (moved to the host first), and a ``bfloat16`` leaf, which numpy
cannot hold, is written from a torch tensor and unpacked as a torch
``bfloat16`` tensor (a copy) with the same bytes and descriptor.
"""

from __future__ import annotations

import json
import struct
import threading
from typing import Any

import numpy as np
import torch

# --- wire-level stats --------------------------------------------------------
# Counts payload serializations (frames built with at least one array
# segment) so the encode-once contract is testable: a broadcast to N workers
# increments this ONCE; a per-rank send loop increments it N times.

_WIRE_LOCK = threading.Lock()
_WIRE_STATS = {"payload_serializations": 0, "frames": 0}


def wire_stats() -> dict[str, int]:
    """Snapshot of the process-wide wire counters."""
    with _WIRE_LOCK:
        return dict(_WIRE_STATS)


def reset_wire_stats() -> None:
    with _WIRE_LOCK:
        for k in _WIRE_STATS:
            _WIRE_STATS[k] = 0


def _is_array(v) -> bool:
    return isinstance(v, (np.ndarray, torch.Tensor))


def _host(v) -> np.ndarray:
    """An array param or leaf as host numpy; a ``bfloat16`` tensor as its
    raw 16-bit words (the caller keeps the dtype name)."""
    if isinstance(v, torch.Tensor):
        t = v.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    return np.asarray(v)


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).removeprefix("torch.")
    return str(np.asarray(v).dtype)


def _byte_view(a: np.ndarray) -> np.ndarray:
    """Flat uint8 view of a contiguous array: zero-copy reinterpretation
    (``ascontiguousarray`` is a no-op on already-contiguous input)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


class Message:
    # key names kept for reference parity (message.py:9-24)
    MSG_ARG_KEY_TYPE = "msg_type"
    MSG_ARG_KEY_SENDER = "sender"
    MSG_ARG_KEY_RECEIVER = "receiver"
    MSG_ARG_KEY_MODEL_PARAMS = "model_params"
    MSG_ARG_KEY_NUM_SAMPLES = "num_samples"
    MSG_ARG_KEY_CLIENT_INDEX = "client_idx"
    # protocol-shared header fields: the model structure descriptor
    # (pack_pytree), the authoritative round index a sync/upload belongs
    # to, and the graceful-stop flag on the final fan-out
    MSG_ARG_KEY_MODEL_DESC = "model_desc"
    MSG_ARG_KEY_ROUND_IDX = "round_idx"
    MSG_ARG_KEY_FINISHED = "finished"
    # compressed-update payload (compress/codec.py EncodedUpdate): the flat
    # byte vector of all encoded planes + the recursive structure descriptor
    MSG_ARG_KEY_ENCODED_UPDATE = "encoded_update"
    MSG_ARG_KEY_ENCODED_DESC = "encoded_desc"
    # the JAX package's later planes (barrier-free server, tree tiers,
    # downlink delta coding, job and trace contexts) stamp these; the port
    # keeps the spellings so it reads their frames
    MSG_ARG_KEY_MODEL_VERSION = "model_version"
    MSG_ARG_KEY_WEIGHT_SUM = "weight_sum"
    MSG_ARG_KEY_FOLD_COUNT = "fold_count"
    MSG_ARG_KEY_PARTIAL_SEQ = "partial_seq"
    MSG_ARG_KEY_WINDOW_COMPLETE = "window_complete"
    MSG_ARG_KEY_BASE_VERSION = "base_version"
    # fleet telemetry (obs/registry.py): a compact JSON-safe dict of
    # sender-side health metrics piggybacked on uploads; header-only,
    # optional, and never read by the aggregation path
    MSG_ARG_KEY_TELEMETRY = "telemetry"
    MSG_ARG_KEY_JOB_ID = "job_id"
    # cross-rank causal tracing (obs/trace.py wire_ctx): stamped only behind
    # a comm manager's ``trace_wire`` opt-in; header-only and optional
    MSG_ARG_KEY_TRACE_CTX = "trace_ctx"

    def __init__(self, msg_type: int = 0, sender_id: int = 0, receiver_id: int = 0):
        self.msg_params: dict[str, Any] = {
            self.MSG_ARG_KEY_TYPE: int(msg_type),
            self.MSG_ARG_KEY_SENDER: int(sender_id),
            self.MSG_ARG_KEY_RECEIVER: int(receiver_id),
        }

    # --- reference API surface (message.py:26-73) ---
    def get_sender_id(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_SENDER]

    def get_receiver_id(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_RECEIVER]

    def get_type(self) -> int:
        return self.msg_params[self.MSG_ARG_KEY_TYPE]

    def add_params(self, key: str, value: Any) -> None:
        self.msg_params[key] = value

    def get_params(self) -> dict[str, Any]:
        return self.msg_params

    def get(self, key: str, default=None) -> Any:
        return self.msg_params.get(key, default)

    def payload_nbytes(self) -> int:
        """Array-payload size in bytes (the JSON header adds a few hundred
        on top), summed over array params without serializing."""
        n = 0
        for v in self.msg_params.values():
            if isinstance(v, np.ndarray):
                n += int(v.nbytes)
            elif isinstance(v, torch.Tensor):
                n += v.numel() * v.element_size()
        return n

    # --- wire format: JSON header + raw array segments ---
    MAGIC = b"FTM1"

    def frame(self) -> "FramedMessage":
        """Encode this message once into a reusable wire frame (the
        broadcast fan-out primitive, :class:`FramedMessage`)."""
        return FramedMessage(self)

    def to_bytes(self) -> bytes:
        return self.frame().bytes_for(self.get_receiver_id())

    @classmethod
    def from_bytes(cls, data) -> "Message":
        """Decode a wire frame. Array params are zero-copy read-only views
        into ``data`` (bytes, bytearray, or memoryview), valid as long as
        the message (which keeps ``data`` alive) is."""
        mv = memoryview(data)
        assert bytes(mv[:4]) == cls.MAGIC, "bad message magic"
        (hlen,) = struct.unpack_from("<I", mv, 4)
        header = json.loads(bytes(mv[8 : 8 + hlen]).decode())
        return cls._from_header_and_tail(header, mv[8 + hlen :])

    @classmethod
    def from_buffers(cls, head, tail) -> "Message":
        """Decode a two-part frame: ``head`` (magic + header) and ``tail``
        (the shared payload segments), as the loopback backend posts a
        broadcast: every receiver's arrays view ONE shared payload buffer."""
        hv = memoryview(head)
        assert bytes(hv[:4]) == cls.MAGIC, "bad message magic"
        (hlen,) = struct.unpack_from("<I", hv, 4)
        header = json.loads(bytes(hv[8 : 8 + hlen]).decode())
        return cls._from_header_and_tail(header, memoryview(tail))

    @classmethod
    def _from_header_and_tail(cls, header: dict, tail: memoryview) -> "Message":
        # collect array descriptors in segment order
        descs = [(k, v) for k, v in header.items() if isinstance(v, dict) and "__arr__" in v]
        descs.sort(key=lambda kv: kv[1]["__arr__"])
        arrays = {}
        offset = 0
        for k, d in descs:
            (alen,) = struct.unpack_from("<Q", tail, offset)
            offset += 8
            arr = np.frombuffer(
                tail, dtype=np.dtype(d["dtype"]),
                count=int(np.prod(d["shape"])) if d["shape"] else 1, offset=offset,
            )
            # wire views are read-only even when the source buffer is
            # mutable: receivers must never alias-write a (possibly shared)
            # transport buffer
            arr.flags.writeable = False
            arrays[k] = arr.reshape(d["shape"])
            offset += alen
        msg = cls()
        for k, v in header.items():
            msg.msg_params[k] = arrays[k] if k in arrays else v
        return msg

    def __repr__(self):
        sizes = {k: f"array{tuple(v.shape)}" if _is_array(v) else v
                 for k, v in self.msg_params.items()}
        return f"Message({sizes})"


# --- encode-once wire frame --------------------------------------------------

# the receiver slot is rendered as an 11-char fixed-width decimal so it can
# be patched in place per receiver; whitespace padding keeps the header
# valid JSON ("receiver":         3)
_RECV_SENTINEL = -1097393539
_RECV_WIDTH = len(str(_RECV_SENTINEL))


class FramedMessage:
    """One message encoded once, emittable to many receivers.

    A frame holds the payload segments as zero-copy memoryviews plus a
    header template with a fixed-width receiver slot; ``bytes_for(dst)``
    patches the slot in place (an O(header) operation) and joins the shared
    segments. Small per-receiver header params (e.g. the assigned client
    index) ride ``overrides``: a header re-dump, never a payload re-pack.
    Overriding array params is rejected: it would orphan a payload segment.
    """

    __slots__ = ("_header", "_arrays", "_tail", "_head", "_slot",
                 "_tail_bytes", "payload_nbytes")

    def __init__(self, msg: Message):
        header: dict[str, Any] = {}
        arrays: list[np.ndarray] = []
        for k, v in msg.msg_params.items():
            if _is_array(v):
                a = np.ascontiguousarray(_host(v))
                header[k] = {"__arr__": len(arrays), "dtype": _dtype_name(v),
                             "shape": list(a.shape)}
                arrays.append(a)
            else:
                header[k] = v
        self._header = header
        self._arrays = arrays  # keeps the segment buffers alive
        tail: list = []
        nbytes = 0
        for a in arrays:
            seg = memoryview(_byte_view(a))
            tail.append(struct.pack("<Q", seg.nbytes))
            tail.append(seg)
            nbytes += seg.nbytes
        self._tail = tail
        self._tail_bytes: bytes | None = None
        self.payload_nbytes = nbytes
        # header template with the fixed-width receiver slot
        probe = dict(header)
        probe[Message.MSG_ARG_KEY_RECEIVER] = _RECV_SENTINEL
        hb = json.dumps(probe).encode()
        token = b'"%s": %d' % (Message.MSG_ARG_KEY_RECEIVER.encode(), _RECV_SENTINEL)
        self._head = None
        self._slot = None
        if hb.count(token) == 1:
            # JSON string escaping makes a str-param collision impossible;
            # a nested dict param repeating key+sentinel falls back to the
            # re-dump path below
            at = hb.index(token) + len(token) - _RECV_WIDTH
            self._head = Message.MAGIC + struct.pack("<I", len(hb)) + hb
            self._slot = 8 + at
        with _WIRE_LOCK:
            _WIRE_STATS["frames"] += 1
            if arrays:
                _WIRE_STATS["payload_serializations"] += 1

    def head_for(self, receiver: int, overrides: dict | None = None) -> bytes:
        rid = int(receiver)
        if overrides is None and self._slot is not None:
            tok = b"%*d" % (_RECV_WIDTH, rid)
            if len(tok) == _RECV_WIDTH:
                head = bytearray(self._head)
                head[self._slot : self._slot + _RECV_WIDTH] = tok
                return bytes(head)
        h = dict(self._header)
        if overrides:
            for k, v in overrides.items():
                if _is_array(v):
                    raise ValueError(
                        f"broadcast override {k!r} is an array: per-receiver "
                        "overrides are header-only (share the payload, vary "
                        "the scalars)"
                    )
                tmpl = self._header.get(k)
                if isinstance(tmpl, dict) and "__arr__" in tmpl:
                    raise ValueError(
                        f"cannot override array param {k!r}: it is a framed "
                        "payload segment"
                    )
                h[k] = v
        h[Message.MSG_ARG_KEY_RECEIVER] = rid
        hb = json.dumps(h).encode()
        return Message.MAGIC + struct.pack("<I", len(hb)) + hb

    def tail_bytes(self) -> bytes:
        """The payload segments joined once (lazily cached), shared across
        every receiver of a broadcast."""
        tb = self._tail_bytes
        if tb is None:
            tb = self._tail_bytes = b"".join(self._tail)
        return tb

    def buffers_for(self, receiver: int, overrides: dict | None = None) -> list:
        """Vectored form: ``[head, len0, seg0, len1, seg1, ...]``; the
        payload entries are zero-copy views of the original arrays."""
        return [self.head_for(receiver, overrides), *self._tail]

    def bytes_for(self, receiver: int, overrides: dict | None = None) -> bytes:
        """Contiguous wire bytes for one receiver (one join, no payload
        re-serialization)."""
        return self.head_for(receiver, overrides) + self.tail_bytes()

    def to_message(self, receiver: int, overrides: dict | None = None) -> Message:
        """Rebuild a Message addressed to ``receiver`` whose array params
        share this frame's buffers (for backends without a framed-send
        hook)."""
        msg = Message()
        msg.msg_params = dict(self._header)
        for k, v in list(msg.msg_params.items()):
            if isinstance(v, dict) and "__arr__" in v:
                msg.msg_params[k] = self._arrays[v["__arr__"]]
        if overrides:
            for k, v in overrides.items():
                if _is_array(v):
                    raise ValueError(
                        f"broadcast override {k!r} is an array: per-receiver "
                        "overrides are header-only"
                    )
                msg.msg_params[k] = v
        msg.msg_params[Message.MSG_ARG_KEY_RECEIVER] = int(receiver)
        return msg


# --- pytree <-> wire payload -------------------------------------------------


def tree_leaves_with_paths(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` pairs of a nested dict (lists and tuples by index)
    in JAX's traversal order: a dict's keys sorted at every level, paths
    joined with ``/`` (``fedml_tpu/core/tree.py`` ``tree_leaves_with_paths``)."""
    if isinstance(tree, dict):
        items = [(k, tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += tree_leaves_with_paths(v, f"{prefix}/{k}" if prefix else str(k))
    return out


def nest(flat: dict[str, Any]) -> dict:
    """A ``{"a/b/c": leaf}`` dict as the nested dict ``{"a": {"b": {"c":
    leaf}}}`` (the inverse of :func:`tree_leaves_with_paths` on dicts)."""
    out: dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def pack_pytree(tree: Any) -> tuple[np.ndarray, str]:
    """Flatten a nested dict of arrays (numpy or torch, on any device) to
    (flat byte vector, json descriptor). The descriptor records leaf
    paths/shapes/dtypes in JAX's sorted path order, so the receiver rebuilds
    the exact structure, and the bytes are JAX's ``pack_pytree``'s on the
    same leaves. Leaves keep their native dtypes byte for byte."""
    leaves = tree_leaves_with_paths(tree)
    desc = [{"path": k, "shape": list(v.shape), "dtype": _dtype_name(v)} for k, v in leaves]
    if leaves:
        flat = np.concatenate([_byte_view(_host(v)) for _, v in leaves])
    else:
        flat = np.zeros((0,), np.uint8)
    return flat, json.dumps(desc)


def unpack_pytree(flat: np.ndarray, descriptor: str) -> Any:
    """Rebuild a nested dict from pack_pytree output (paths use '/').

    Leaves are alignment-safe zero-copy views into ``flat``, always marked
    read-only; a leaf whose byte offset is misaligned for its dtype falls
    back to a copy. A ``bfloat16`` leaf is a torch ``bfloat16`` tensor (a
    copy)."""
    desc = json.loads(descriptor)
    flat = np.asarray(flat, dtype=np.uint8)
    viewable = flat.flags.c_contiguous
    base_addr = flat.ctypes.data if viewable else 0
    out: dict[str, Any] = {}
    i = 0
    for d in desc:
        bf16 = d["dtype"] == "bfloat16"
        dt = np.dtype(np.int16) if bf16 else np.dtype(d["dtype"])
        n = int(np.prod(d["shape"])) if d["shape"] else 1
        nbytes = n * dt.itemsize
        if viewable and (base_addr + i) % dt.itemsize == 0:
            view = flat[i : i + nbytes].view(dt)
            view.flags.writeable = False
            leaf = view.reshape(d["shape"])
        else:
            leaf = np.frombuffer(flat[i : i + nbytes].tobytes(), dtype=dt).reshape(d["shape"])
        if bf16:
            leaf = torch.from_numpy(np.array(leaf)).view(torch.bfloat16)
        i += nbytes
        node = out
        parts = d["path"].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def pack_encoded_update(enc) -> tuple[np.ndarray, str]:
    """Flatten a (possibly chain-nested) ``EncodedUpdate`` to (flat byte
    vector, json descriptor), the encoded-update payload type. Each plane
    (a ``{"a/b/c": tensor}`` state dict in JAX path order, as the wire
    client encodes the JAX layout, or a nested dict) is packed with
    :func:`pack_pytree`; the descriptor records scheme/meta and per-plane
    pack descriptors recursively, so the receiver rebuilds the exact
    EncodedUpdate."""
    from fedml_tpu_torch.compress.codec import EncodedUpdate

    segs: list[np.ndarray] = []

    def walk(e) -> dict:
        spec: dict[str, Any] = {"scheme": e.scheme, "meta": e.meta, "planes": {}}
        for name in sorted(e.planes):
            v = e.planes[name]
            if isinstance(v, EncodedUpdate):
                spec["planes"][name] = {"__enc__": walk(v)}
            else:
                flat, desc = pack_pytree(nest(v))
                segs.append(flat)
                spec["planes"][name] = {"__tree__": json.loads(desc),
                                        "nbytes": int(flat.size)}
        return spec

    spec = walk(enc)
    flat = np.concatenate(segs) if segs else np.zeros((0,), np.uint8)
    return flat, json.dumps(spec)


def _as_tensor(leaf) -> torch.Tensor:
    return leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.array(leaf))


def unpack_encoded_update(flat: np.ndarray, descriptor: str):
    """Inverse of :func:`pack_encoded_update`: each plane a ``{"a/b/c":
    tensor}`` state dict of host tensors (copies) in the descriptor's path
    order, the form the port's codecs decode."""
    from fedml_tpu_torch.compress.codec import EncodedUpdate

    flat = np.asarray(flat, dtype=np.uint8)
    offset = 0

    def walk(spec: dict):
        nonlocal offset
        planes = {}
        for name in sorted(spec["planes"]):
            p = spec["planes"][name]
            if "__enc__" in p:
                planes[name] = walk(p["__enc__"])
            else:
                n = int(p["nbytes"])
                tree = unpack_pytree(flat[offset : offset + n], json.dumps(p["__tree__"]))
                planes[name] = {k: _as_tensor(v) for k, v in tree_leaves_with_paths(tree)}
                offset += n
        return EncodedUpdate(spec["scheme"], planes, spec["meta"])

    return walk(json.loads(descriptor))
