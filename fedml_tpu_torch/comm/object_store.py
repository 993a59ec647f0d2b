"""Split control-plane / data-plane transport: the MQTT+S3 production pattern,
the port of ``fedml_tpu/comm/object_store.py`` (the same blob format, so
either package resolves the other's offloaded payloads).

Reference: fedml_core/distributed/communication/mqtt_s3/ — control messages
ride MQTT while model payloads are uploaded to S3 and referenced by key
(mqtt_s3_multi_clients_comm_manager.py:178-215 download, 222+ upload;
remote_storage.py:14 ``S3Storage.write_model`` joblib-pickle → S3 + presigned
URL). Two reference defects not ported: pickled payloads (typed arrays here)
and the hard S3 dependency (the store is pluggable; a filesystem store covers
single-host/NFS deployments and tests, an S3 store activates when boto3
exists).

``OffloadCommManager`` wraps ANY base backend (loopback/shm/grpc/mqtt): on
send, array params bigger than ``threshold_bytes`` move to the object store
and the message carries ``{key}`` references (the reference's
MSG_ARG_KEY_MODEL_PARAMS → MODEL_PARAMS_URL swap); on receive they are
resolved back before observers see the message.
"""

from __future__ import annotations

import abc
import os
import threading
import uuid
from pathlib import Path

import numpy as np

from fedml_tpu_torch.comm.base import BaseCommunicationManager, Observer
from fedml_tpu_torch.comm.message import Message


class ObjectStore(abc.ABC):
    """Data-plane blob store (reference S3Storage, remote_storage.py:14)."""

    @abc.abstractmethod
    def put(self, key: str, data: bytes) -> None: ...

    @abc.abstractmethod
    def get(self, key: str) -> bytes: ...

    @abc.abstractmethod
    def delete(self, key: str) -> None: ...


class FileSystemStore(ObjectStore):
    """Directory-backed store — the S3 analogue for single-host / shared-FS
    deployments and hermetic tests (no reference equivalent; their tests hit
    real S3)."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: str) -> Path:
        safe = key.replace("/", "_")
        return self.root / safe

    def put(self, key: str, data: bytes) -> None:
        tmp = self._path(key).with_suffix(".tmp-" + uuid.uuid4().hex[:8])
        tmp.write_bytes(data)
        tmp.rename(self._path(key))  # atomic publish

    def get(self, key: str) -> bytes:
        return self._path(key).read_bytes()

    def delete(self, key: str) -> None:
        self._path(key).unlink(missing_ok=True)


class S3Store(ObjectStore):
    """boto3-backed store (reference remote_storage.py:33 write_model /
    :50 read_model, with retries). Import is deferred: constructing raises a
    clear error when boto3 is absent."""

    def __init__(self, bucket: str, prefix: str = "fedml", **client_kwargs):
        try:
            import boto3  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "S3Store requires boto3; use FileSystemStore or install boto3"
            ) from e
        import boto3

        self.bucket = bucket
        self.prefix = prefix
        self.client = boto3.client("s3", **client_kwargs)

    def _key(self, key: str) -> str:
        return f"{self.prefix}/{key}"

    def put(self, key: str, data: bytes) -> None:
        self.client.put_object(Bucket=self.bucket, Key=self._key(key), Body=data)

    def get(self, key: str) -> bytes:
        return self.client.get_object(Bucket=self.bucket, Key=self._key(key))["Body"].read()

    def delete(self, key: str) -> None:
        self.client.delete_object(Bucket=self.bucket, Key=self._key(key))


# ---------------------------------------------------------------------------


_OFFLOADED = "__offloaded__"  # header key: {param_key: store_key, ...}
# large TEXT payloads (e.g. the is_mobile nested-list JSON wire) ride the
# store too — raw utf-8 blobs under their own header so the receive side
# restores a str, not an array
_OFFLOADED_TEXT = "__offloaded_text__"
# marker on broadcast control messages: the referenced blobs are shared by
# every receiver of the fan-out, so receiver-side cleanup is suppressed and
# the SENDER retires them generationally instead
_OFFLOAD_SHARED = "__offload_shared__"


class OffloadCommManager(BaseCommunicationManager):
    """Control-plane messages over ``inner``, large arrays via ``store``.

    Mirrors MqttS3MultiClientsCommManager's send/receive payload swap
    (mqtt_s3_multi_clients_comm_manager.py:178-249) for any base transport.
    """

    def __init__(self, inner: BaseCommunicationManager, store: ObjectStore,
                 threshold_bytes: int = 1 << 16, cleanup: bool = True,
                 broadcast_generations: int = 2):
        super().__init__()
        self.inner = inner
        self.store = store
        self.threshold = threshold_bytes
        self.cleanup = cleanup
        # broadcast blobs are shared by all receivers, so the sender retires
        # them: a generation is deleted once `broadcast_generations` newer
        # fan-outs exist (2 keeps a one-round-stale straggler downloadable).
        # Configurable from the mqtt_s3 runner/CLI (--broadcast_generations),
        # and raised IN PLACE by the async server when the downlink delta
        # plane is armed — the floor tracks the observed staleness p99
        # (compress/downlink.py), so a deliberately slow client's delta-base
        # blob is still downloadable when it finally fetches. Reads happen
        # under _bcast_lock at trim time, so a concurrent raise is safe.
        self.broadcast_generations = max(1, int(broadcast_generations))
        self._bcast_lock = threading.Lock()
        self._bcast_gens: list[list[str]] = []  # guarded-by: _bcast_lock
        self._resolver = _Resolver(self)
        self.inner.add_observer(self._resolver)

    # -- send path ----------------------------------------------------------

    def _put(self, key: str, data: bytes) -> None:
        """Data-plane upload, under the retry plane when one is armed: a
        transient object-store hiccup is exactly the failure comm/retry.py
        exists for, and the put happens before any per-destination send
        isolation could cover it."""
        policy = self.retry_policy
        if policy is None:
            self.store.put(key, data)
        else:
            policy.run(lambda: self.store.put(key, data), store_key=key)

    def _offload_params(self, msg: Message) -> tuple[Message, dict[str, str], dict[str, str]]:
        """Upload every over-threshold array/text param once and strip it
        from a shallow copy of ``msg`` (the caller's Message stays intact so
        it can be reused). Returns (stripped message, array key table, text
        key table) — one definition shared by the per-receiver and broadcast
        send paths."""
        offloaded: dict[str, str] = {}
        offloaded_text: dict[str, str] = {}
        out = Message()
        out.msg_params = dict(msg.msg_params)
        for k, v in list(out.msg_params.items()):
            if isinstance(v, np.ndarray) and v.nbytes >= self.threshold:
                key = f"{k}-{uuid.uuid4().hex}"
                self._put(key, _array_bytes(v))
                offloaded[k] = key
                del out.msg_params[k]
            elif isinstance(v, str) and len(v) >= self.threshold:
                key = f"{k}-{uuid.uuid4().hex}"
                self._put(key, v.encode("utf-8"))
                offloaded_text[k] = key
                del out.msg_params[k]
        if offloaded:
            out.add_params(_OFFLOADED, offloaded)
        if offloaded_text:
            out.add_params(_OFFLOADED_TEXT, offloaded_text)
        return out, offloaded, offloaded_text

    def send_message(self, msg: Message) -> None:
        # each send uploads fresh blobs, which matters with cleanup=True —
        # the first receiver deletes them
        out, _, _ = self._offload_params(msg)
        self.inner.send_message(out)

    def broadcast_message(self, msg: Message, receiver_ids,
                          per_receiver: dict[int, dict] | None = None) -> None:
        """Encode-once for the data plane too: each large payload is uploaded
        to the store ONCE for the whole fan-out (vs once per receiver on the
        legacy path) and every receiver resolves the same key. Shared blobs
        are retired by the sender once ``broadcast_generations`` newer
        fan-outs exist — safe in round-synchronous protocols, where a
        receiver is at most one round stale before being dropped."""
        out, offloaded, offloaded_text = self._offload_params(msg)
        if offloaded or offloaded_text:
            out.add_params(_OFFLOAD_SHARED, 1)
            stale: list[str] = []
            with self._bcast_lock:
                self._bcast_gens.append(
                    list(offloaded.values()) + list(offloaded_text.values())
                )
                while len(self._bcast_gens) > self.broadcast_generations:
                    stale.extend(self._bcast_gens.pop(0))
            if self.cleanup:
                for key in stale:
                    try:
                        self.store.delete(key)
                    except OSError:
                        pass
        # the retry plane (comm/retry.py) arms the OUTERMOST manager; the
        # fan-out legs run inside the inner transport, so delegate the
        # policy there for the duration of this composition
        self.inner.retry_policy = self.retry_policy
        self.inner.broadcast_message(out, receiver_ids, per_receiver)

    # -- receive path -------------------------------------------------------

    def _resolve(self, msg: Message) -> Message:
        shared = bool(msg.get(_OFFLOAD_SHARED))
        for header, restore in ((_OFFLOADED, _bytes_array),
                                (_OFFLOADED_TEXT, lambda b: b.decode("utf-8"))):
            table = msg.get(header)
            if not table:
                continue
            for param_key, store_key in table.items():
                msg.add_params(param_key, restore(self.store.get(store_key)))
                if self.cleanup and not shared:
                    try:
                        self.store.delete(store_key)
                    except OSError:
                        pass
            del msg.msg_params[header]
        msg.msg_params.pop(_OFFLOAD_SHARED, None)
        return msg

    def handle_receive_message(self) -> None:
        self.inner.handle_receive_message()

    def stop_receive_message(self) -> None:
        # The last `broadcast_generations` fan-outs' blobs deliberately
        # OUTLIVE the sender: the final stop broadcast is usually still being
        # resolved by receivers when the sender stops, and deleting under
        # them fails their receive threads. Bounded leak (generation rotation
        # retires everything older); harnesses that know the protocol fully
        # drained can call retire_broadcast_blobs().
        self.inner.stop_receive_message()

    def retire_broadcast_blobs(self) -> None:
        """Delete ALL shared broadcast blobs this sender still tracks. Only
        safe once every receiver has resolved the final fan-out."""
        with self._bcast_lock:
            gens, self._bcast_gens = self._bcast_gens, []
        for keys in gens:
            for key in keys:
                try:
                    self.store.delete(key)
                except OSError:
                    pass


class _Resolver(Observer):
    def __init__(self, outer: OffloadCommManager):
        self.outer = outer

    def receive_message(self, msg_type: int, msg: Message) -> None:
        self.outer.notify(self.outer._resolve(msg))


def _array_bytes(a: np.ndarray) -> bytes:
    """Self-describing array blob: dtype/shape header + raw bytes."""
    import json

    a = np.ascontiguousarray(a)
    head = json.dumps({"dtype": str(a.dtype), "shape": list(a.shape)}).encode()
    return len(head).to_bytes(4, "little") + head + a.tobytes()


def _bytes_array(data: bytes) -> np.ndarray:
    import json

    hlen = int.from_bytes(data[:4], "little")
    head = json.loads(data[4 : 4 + hlen].decode())
    return np.frombuffer(
        data, dtype=np.dtype(head["dtype"]),
        count=int(np.prod(head["shape"])) if head["shape"] else 1,
        offset=4 + hlen,
    ).reshape(head["shape"])
