"""In-process MQTT broker with the paho client surface, a copy of
``fedml_tpu/comm/inproc_broker.py``.

The reference's MQTT backends are verified against a live broker
(mqtt_comm_manager.py:129-144 self-test); this environment has no network
egress, so the CLI's offline ``--backend mqtt_s3`` drives the REAL
``MqttCommManager`` topic/last-will/status logic through this hub instead of
a socket. It implements exactly the client surface MqttCommManager uses
(``will_set``/``connect``/``loop_start``/``subscribe``/``publish``/
``loop_stop``/``disconnect``) with paho semantics: synchronous delivery to
subscribers, wills fired on unclean drop, cleared by clean disconnect.

This is a transport, not a mock of the manager: everything above the socket —
envelope bytes, topic scheme, status messages — is the production code path.
The real-paho constructor branch remains covered only structurally (see
COVERAGE.md caveats).
"""

from __future__ import annotations

import threading
import types


class _PublishInfo:
    def wait_for_publish(self, timeout=None):
        return None


class InProcessBroker:
    """Topic hub shared by all ranks of one job."""

    def __init__(self):
        self._subs: dict[str, list] = {}  # guarded-by: _lock
        self._wills: dict[object, tuple] = {}  # guarded-by: _lock
        self._lock = threading.Lock()

    def subscribe(self, topic: str, client) -> None:
        with self._lock:
            subs = self._subs.setdefault(topic, [])
            if client not in subs:
                subs.append(client)

    def unsubscribe_all(self, client) -> None:
        with self._lock:
            for subs in self._subs.values():
                if client in subs:
                    subs.remove(client)

    def publish(self, topic: str, payload) -> None:
        if isinstance(payload, str):
            payload = payload.encode()
        with self._lock:
            clients = list(self._subs.get(topic, []))
        for c in clients:
            cb = c.on_message
            if cb is not None:
                cb(c, None, types.SimpleNamespace(topic=topic, payload=payload))

    def set_will(self, client, topic: str, payload) -> None:
        with self._lock:
            self._wills[client] = (topic, payload)

    def clear_will(self, client) -> None:
        with self._lock:
            self._wills.pop(client, None)

    def drop(self, client) -> None:
        """Unclean disconnect: deliver the client's last will."""
        with self._lock:
            will = self._wills.pop(client, None)
        self.unsubscribe_all(client)
        if will is not None:
            self.publish(*will)

    def client_factory(self):
        """A ``client_factory`` for :class:`MqttCommManager`: called with the
        paho ``Client`` kwargs, returns a connected-on-demand client."""
        broker = self

        class _Client:
            def __init__(self, client_id: str = "", protocol=None):
                self.client_id = client_id
                self.on_connect = None
                self.on_subscribe = None
                self.on_message = None
                self._connected = False
                self._mid = 0

            def will_set(self, topic, payload, qos=0, retain=False):
                broker.set_will(self, topic, payload)

            def connect(self, host, port, keepalive=60):
                self._connected = True

            def loop_start(self):
                # paho fires on_connect from its network loop; sync here
                if self.on_connect is not None:
                    self.on_connect(self, None, {}, 0)

            def subscribe(self, topic, qos=0):
                broker.subscribe(topic, self)
                # registration is synchronous here; ack it like a SUBACK
                self._mid += 1
                if self.on_subscribe is not None:
                    self.on_subscribe(self, None, self._mid, (qos,))

            def publish(self, topic, payload, qos=0, retain=False):
                broker.publish(topic, payload)
                return _PublishInfo()

            def loop_stop(self):
                pass

            def disconnect(self):
                # clean disconnect: will is discarded, not delivered
                broker.clear_will(self)
                broker.unsubscribe_all(self)
                self._connected = False

        def factory(client_id: str = "", protocol=None):
            return _Client(client_id=client_id, protocol=protocol)

        return factory
