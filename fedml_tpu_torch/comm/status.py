"""Client liveness / status protocol, the port of ``fedml_tpu/comm/status.py``
without its heartbeat plane (``HeartbeatSender``, ``send_client_status`` and
the SLOW judgement that ``heartbeat_timeout`` reads: ``--heartbeat_interval``,
ROADMAP §A11) and without the tracker's readers the server does not call
(``stale``, ``wait_all_online``, ``finished_count``, ``seen_within``).

Status is an ordinary typed message on any backend: a client reports
ONLINE/FINISHED, and the server's :class:`ClientStatusTracker` keeps the
liveness table the round timeout reads (an upload marks its sender ONLINE;
a worker missing at the timeout is dropped from the round, and marked
OFFLINE and excluded after ``exclude_after`` consecutive misses).
"""

from __future__ import annotations

import threading
import time


class ClientStatus:
    MSG_TYPE_CLIENT_STATUS = 7001  # reserved type id for status messages

    ONLINE = "ONLINE"
    FINISHED = "FINISHED"
    OFFLINE = "OFFLINE"

    KEY_STATUS = "client_status"
    KEY_OS = "client_os"  # reference tags client OS in status msgs (message.py:21-24)


class ClientStatusTracker:
    """Server-side liveness table; thread-safe (the reference's unsynchronized
    status dicts are a known hazard, SURVEY §5.2)."""

    def __init__(self, expected_clients: int):
        self.expected = expected_clients
        self._status: dict[int, str] = {}  # guarded-by: _lock
        self._last_seen: dict[int, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        # fleet telemetry hook (obs/registry.py FleetHealth): called as
        # ``on_transition(client_id, status)`` whenever a client's recorded
        # status CHANGES (heartbeats re-asserting ONLINE refresh last_seen
        # without firing it). Invoked UNDER the tracker lock so concurrent
        # updates (timer marking OFFLINE vs receive thread marking ONLINE)
        # deliver transitions in the order the table recorded them — the
        # hook must not call back into the tracker.
        self.on_transition = None

    def update(self, client_id: int, status: str, touch: bool = True) -> None:
        """Record ``status`` for the client. ``touch=False`` marks a
        SERVER-side judgement (the OFFLINE label) without refreshing
        ``last_seen`` — only actual contact from the client may count as
        liveness evidence."""
        with self._lock:
            prev = self._status.get(client_id)
            self._status[client_id] = status
            if touch:
                self._last_seen[client_id] = time.monotonic()
            if self.on_transition is not None and status != prev:
                self.on_transition(client_id, status)

    def last_seen(self, client_id: int) -> float | None:
        """``time.monotonic`` of the client's last status contact (None if
        it never reported)."""
        with self._lock:
            return self._last_seen.get(client_id)

    def snapshot(self) -> dict[int, str]:
        with self._lock:
            return dict(self._status)
