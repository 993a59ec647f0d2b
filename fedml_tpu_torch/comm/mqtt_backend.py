"""MQTT broker backend for edge-device federation, the port of
``fedml_tpu/comm/mqtt_backend.py``.

Reference: fedml_core/distributed/communication/mqtt/mqtt_comm_manager.py:14 —
broker pub/sub with the topic scheme: the server (id 0) publishes
``<topic>0_<clientID>`` and subscribes ``<topic><clientID>``; clients do the
inverse (:47-70, 99-120). The reference ships full JSON payloads inline; here
messages use the typed binary wire format (Message.to_bytes) and large model
payloads ride the object store via OffloadCommManager
(fedml_tpu_torch/comm/object_store.py) — the MQTT_S3 production combination.

Also carried over: the last-will "offline" status message
(mqtt_s3_multi_clients_comm_manager.py:71-72) on the status topic consumed by
comm.status.

paho-mqtt is imported lazily — constructing without it installed raises a
clear error; the rest of the framework never imports this module implicitly.
"""

from __future__ import annotations

import json
import logging
import queue
import threading

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message


class MqttCommManager(BaseCommunicationManager):
    def __init__(self, host: str, port: int, topic: str = "fedml",
                 client_id: int = 0, client_num: int = 0,
                 status_topic: str | None = None, keepalive: int = 180,
                 client_factory=None):
        """``client_factory`` substitutes the broker client construction
        (paho by default) — e.g. ``InProcessBroker().client_factory()`` for
        the offline ``mqtt_s3`` CLI backend. Everything above it (topic
        scheme, wire format, wills, status) is unchanged."""
        super().__init__()
        self.topic = topic
        self.client_id = client_id
        self.client_num = client_num
        self.status_topic = status_topic or f"{topic}/status"
        self._stop = threading.Event()
        self._q: queue.Queue = queue.Queue()

        if client_factory is not None:
            self.client = client_factory(
                client_id=f"{topic}-{client_id}", protocol=None
            )
        else:
            try:
                import paho.mqtt.client as mqtt
            except ImportError as e:
                raise ImportError(
                    "MqttCommManager requires paho-mqtt (not in this image); "
                    "use the loopback/shm/grpc backends, or pass an "
                    "in-process client_factory (comm/inproc_broker.py)"
                ) from e
            if hasattr(mqtt, "CallbackAPIVersion"):  # paho-mqtt >= 2.0
                self.client = mqtt.Client(
                    mqtt.CallbackAPIVersion.VERSION1,
                    client_id=f"{topic}-{client_id}",
                    protocol=mqtt.MQTTv311,
                )
            else:
                self.client = mqtt.Client(
                    client_id=f"{topic}-{client_id}", protocol=mqtt.MQTTv311
                )
        # last-will: broker announces our death on the status topic
        self.client.will_set(
            self.status_topic,
            json.dumps({"id": client_id, "status": "OFFLINE"}),
            qos=1, retain=False,
        )
        self._subscribed = threading.Event()
        self._expected_subacks = self.client_num if client_id == 0 else 1
        self._suback_count = 0
        if self._expected_subacks == 0:
            # a server with no clients yet subscribes to nothing — there is
            # no SUBACK to wait for
            self._subscribed.set()
        self.client.on_connect = self._on_connect
        self.client.on_subscribe = self._on_subscribe
        self.client.on_message = self._on_message
        self.client.connect(host, port, keepalive)
        self.client.loop_start()
        # Block until the broker ACKNOWLEDGES our subscriptions (SUBACK via
        # on_subscribe — subscribe() only queues the packet): a QoS1
        # non-retained publish to a topic whose subscription the broker has
        # not registered yet is silently dropped, so the protocol's init
        # broadcast could vanish and hang the run. Construction-order
        # guarantee: every manager's constructor returns only after its own
        # subscriptions are live, so init messages sent after all managers
        # exist always have their subscribers.
        if not self._subscribed.wait(timeout=30.0):
            raise TimeoutError(
                f"mqtt: no SUBACK within 30 s (broker {host}:{port})"
            )

    # topic scheme (mqtt_comm_manager.py:47-70)
    def _send_topic(self, receiver_id: int) -> str:
        if self.client_id == 0:
            return f"{self.topic}0_{receiver_id}"
        return f"{self.topic}{self.client_id}"

    def _recv_topic(self) -> str:
        if self.client_id == 0:
            # server subscribes to every client's topic via wildcard-free loop
            return None  # handled in _on_connect
        return f"{self.topic}0_{self.client_id}"

    def _on_connect(self, client, userdata, flags, rc):
        if self.client_id == 0:
            for cid in range(1, self.client_num + 1):
                client.subscribe(f"{self.topic}{cid}", qos=1)
        else:
            client.subscribe(self._recv_topic(), qos=1)
        client.publish(
            self.status_topic,
            json.dumps({"id": self.client_id, "status": "ONLINE"}),
            qos=1,
        )

    def _on_subscribe(self, client, userdata, mid, granted_qos, properties=None):
        self._suback_count += 1
        if self._suback_count >= self._expected_subacks:
            self._subscribed.set()

    def _on_message(self, client, userdata, mqtt_msg):
        try:
            self._q.put(Message.from_bytes(mqtt_msg.payload))
        except Exception:
            logging.exception("mqtt: undecodable message on %s", mqtt_msg.topic)

    def send_message(self, msg: Message) -> None:
        topic = self._send_topic(msg.get_receiver_id())
        info = self.client.publish(topic, msg.to_bytes(), qos=1)
        info.wait_for_publish()

    def _send_framed(self, frame, dst: int, overrides: dict | None = None) -> None:
        # encode-once broadcast: per-receiver topics, shared payload bytes
        info = self.client.publish(
            self._send_topic(dst), frame.bytes_for(dst, overrides), qos=1
        )
        info.wait_for_publish()

    def handle_receive_message(self) -> None:
        while not self._stop.is_set():
            try:
                msg = self._q.get(timeout=0.5)
            except queue.Empty:
                continue
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._stop.set()
        self.client.publish(
            self.status_topic,
            json.dumps({"id": self.client_id, "status": "FINISHED"}),
            qos=1,
        )
        self.client.loop_stop()
        self.client.disconnect()
