"""MLOps telemetry, the port of ``fedml_tpu/obs/mlops.py``: the reference's
topic protocol over pluggable messengers.

Reference: fedml_core/mlops_logger.py:15 — a singleton publishing client/
server status, training metrics, round info, model info, and system
performance as JSON to fixed MQTT topics (``fl_client/mlops/status``,
``fl_server/mlops/training_progress_and_eval``, ...). The MLOps platform
subscribes to those topics.

Here the logger keeps the reference's exact topic names and payload keys so
an MLOps consumer sees the same wire protocol, but the transport is a
pluggable ``messenger`` with ``send_message_json(topic, payload_json)``:

- :class:`MqttMessenger` — real MQTT broker (production; requires paho).
- :class:`FileMessenger` — JSONL sink (offline runs, tests, and audit logs).

No singleton: construct one logger per run and pass it around — global
mutable state was a reference defect, not a feature.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Any, Protocol

from fedml_tpu_torch.obs.sysstats import SysStats

# reference topic names (mlops_logger.py:32-110, FedEventSDK.py:72), verbatim
TOPIC_CLIENT_STATUS = "fl_client/mlops/status"
TOPIC_CLIENT_ID_STATUS = "fl_client/mlops/{edge_id}/status"
TOPIC_SERVER_STATUS = "fl_server/mlops/status"
TOPIC_SERVER_ID_STATUS = "fl_server/mlops/id/status"
TOPIC_CLIENT_METRICS = "fl_client/mlops/training_metrics"
TOPIC_SERVER_METRICS = "fl_server/mlops/training_progress_and_eval"
TOPIC_ROUND_INFO = "fl_client/mlops/training_roundx"
TOPIC_CLIENT_MODEL = "fl_server/mlops/client_model"
TOPIC_AGGREGATED_MODEL = "fl_server/mlops/global_aggregated_model"
TOPIC_SYSTEM = "fl_client/mlops/system_performance"
TOPIC_EVENTS = "/mlops/events"
TOPIC_LOGS = "/mlops/logs"


class Messenger(Protocol):
    def send_message_json(self, topic: str, payload_json: str) -> None: ...


class FileMessenger:
    """JSONL sink: one ``{"ts", "topic", "payload"}`` record per message."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a")

    def send_message_json(self, topic: str, payload_json: str) -> None:
        rec = {"ts": time.time(), "topic": topic, "payload": json.loads(payload_json)}
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()


class MqttMessenger:
    """Publishes each topic to a real MQTT broker (paho-mqtt)."""

    def __init__(self, host: str = "localhost", port: int = 1883,
                 client_id: str = "fedml_tpu_mlops"):
        import paho.mqtt.client as mqtt  # gated: optional dependency

        if hasattr(mqtt, "CallbackAPIVersion"):  # paho >= 2.0
            self._client = mqtt.Client(
                mqtt.CallbackAPIVersion.VERSION1, client_id=client_id
            )
        else:
            self._client = mqtt.Client(client_id=client_id)
        self._client.connect(host, port)
        self._client.loop_start()

    def send_message_json(self, topic: str, payload_json: str) -> None:
        self._client.publish(topic, payload_json, qos=1)

    def close(self) -> None:
        self._client.loop_stop()
        self._client.disconnect()


class MLOpsLogger:
    """Reference-protocol telemetry reporter (mlops_logger.py API names)."""

    def __init__(self, messenger: Messenger, run_id: Any = None, edge_id: Any = None):
        self.messenger = messenger
        self.run_id = run_id
        self.edge_id = edge_id
        self._sys = SysStats()

    def _send(self, topic: str, msg: dict) -> None:
        payload = json.dumps(msg)
        logging.debug("mlops %s: %s", topic, payload)
        self.messenger.send_message_json(topic, payload)

    # -- status (reference :32-57) -----------------------------------------
    def report_client_training_status(self, edge_id, status) -> None:
        self._send(TOPIC_CLIENT_STATUS, {"edge_id": edge_id, "status": status})

    def report_client_id_status(self, run_id, edge_id, status) -> None:
        self._send(
            TOPIC_CLIENT_ID_STATUS.format(edge_id=edge_id),
            {"run_id": run_id, "edge_id": edge_id, "status": status},
        )

    def report_server_training_status(self, run_id, status) -> None:
        self._send(TOPIC_SERVER_STATUS, {"run_id": run_id, "status": status})

    def report_server_id_status(self, run_id, status) -> None:
        self._send(TOPIC_SERVER_ID_STATUS, {"run_id": run_id, "status": status})

    # -- metrics / round / model info (reference :59-88) --------------------
    def report_client_training_metric(self, metric: dict) -> None:
        self._send(TOPIC_CLIENT_METRICS, metric)

    def report_server_training_metric(self, metric: dict) -> None:
        self._send(TOPIC_SERVER_METRICS, metric)

    def report_server_training_round_info(self, round_info: dict) -> None:
        self._send(TOPIC_ROUND_INFO, round_info)

    def report_client_model_info(self, model_info: dict) -> None:
        self._send(TOPIC_CLIENT_MODEL, model_info)

    def report_aggregated_model_info(self, model_info: dict) -> None:
        self._send(TOPIC_AGGREGATED_MODEL, model_info)

    # -- system performance (reference :90-110) -----------------------------
    def report_system_metric(self, metric: dict | None = None) -> None:
        if metric is None:
            metric = {"run_id": self.run_id, "edge_id": self.edge_id}
            metric.update(self._sys.sample())
        self._send(TOPIC_SYSTEM, metric)

    def round_callback(self):
        """A FedSim ``callback`` that streams every round record as a server
        training metric plus round info — wiring the engine's history into
        the MLOps protocol."""

        def cb(rec: dict) -> None:
            self.report_server_training_metric(
                {"run_id": self.run_id, **rec}
            )
            self.report_server_training_round_info(
                {"run_id": self.run_id, "round_index": rec.get("round")}
            )

        return cb


class FedEvents:
    """Start/end event spans on the reference's ``/mlops/events`` topic with
    its exact payload keys (FedEventSDK.py:37-81). The reference's singleton
    and hardcoded MqttS3 transport are dropped: one instance per run over any
    :class:`Messenger`."""

    def __init__(self, messenger: Messenger, run_id: Any = None, edge_id: Any = 0):
        self.messenger = messenger
        self.run_id = run_id
        self.edge_id = edge_id

    def _send(self, msg: dict) -> None:
        self.messenger.send_message_json(TOPIC_EVENTS, json.dumps(msg))

    def log_event_started(self, event_name, event_value=None, event_edge_id=None):
        self._send({
            "run_id": self.run_id,
            "edge_id": self.edge_id if event_edge_id is None else event_edge_id,
            "event_name": event_name,
            "event_value": "" if event_value is None else event_value,
            "started_time": int(time.time()),
        })

    def log_event_ended(self, event_name, event_value=None, event_edge_id=None):
        self._send({
            "run_id": self.run_id,
            "edge_id": self.edge_id if event_edge_id is None else event_edge_id,
            "event_name": event_name,
            "event_value": "" if event_value is None else event_value,
            "ended_time": int(time.time()),
        })

    @contextlib.contextmanager
    def span(self, event_name, event_value=None):
        """Context manager emitting a paired started/ended event."""
        self.log_event_started(event_name, event_value)
        try:
            yield
        finally:
            self.log_event_ended(event_name, event_value)


class FedLogs:
    """Incremental log shipper (FedLogsSDK.py:97-139 role): tails a run's
    log file and publishes batches of new lines with the reference's upload
    payload keys. The reference POSTs to open.fedml.ai in a background
    process and tracks its offset in log-config.yaml; here upload is an
    explicit ``upload_once()`` the caller schedules (cron thread, round
    callback, or atexit), the offset lives on the instance, and the sink is
    any :class:`Messenger` on ``/mlops/logs``."""

    LOG_LINES_PER_UPLOAD = 100
    MAX_BYTES_PER_READ = 8 << 20  # backlog is shipped in bounded chunks

    def __init__(self, log_file_path: str | Path, messenger: Messenger,
                 run_id: Any = None, edge_id: Any = 0):
        self.log_file_path = Path(log_file_path)
        self.messenger = messenger
        self.run_id = run_id
        self.edge_id = edge_id
        self._offset = 0  # byte offset of the first unshipped line
        self._ino = None  # inode of the file the offset refers to

    def upload_once(self) -> int:
        """Ship all new complete lines since the last call; returns lines
        shipped. Reads from a byte offset in bounded chunks (never the whole
        backlog at once) and holds back a trailing partial line until its
        newline arrives, so tailing a live log neither truncates records nor
        rereads history. A rotated file (new inode) or one that shrank
        (copytruncate / reopen with mode "w") restarts from byte 0 rather
        than silently going quiet."""
        import os

        if not self.log_file_path.exists():
            return 0
        shipped = 0
        with open(self.log_file_path, "rb") as f:
            st = os.fstat(f.fileno())
            if st.st_ino != self._ino or st.st_size < self._offset:
                self._offset = 0
            self._ino = st.st_ino
            f.seek(self._offset)
            while True:
                data = f.read(self.MAX_BYTES_PER_READ)
                end = data.rfind(b"\n") + 1
                if end == 0:
                    if len(data) < self.MAX_BYTES_PER_READ:
                        break  # genuine partial tail — wait for its newline
                    # a single line longer than the read chunk: ship it as a
                    # forced newline-less batch so the offset keeps advancing
                    # (otherwise every later call re-reads this chunk forever)
                    end = len(data)
                self._offset += end
                lines = data[:end].decode(errors="replace").splitlines(keepends=True)
                for start in range(0, len(lines), self.LOG_LINES_PER_UPLOAD):
                    batch = lines[start:start + self.LOG_LINES_PER_UPLOAD]
                    now = time.time()
                    self.messenger.send_message_json(TOPIC_LOGS, json.dumps({
                        "run_id": self.run_id,
                        "edge_id": self.edge_id,
                        "logs": batch,
                        "create_time": now,
                        "update_time": now,
                        "created_by": str(self.edge_id),
                        "updated_by": str(self.edge_id),
                    }))
                    shipped += len(batch)
                if len(data) < self.MAX_BYTES_PER_READ:
                    break
                f.seek(self._offset)  # re-read the held-back partial tail
        return shipped
