"""Client liveness / status protocol for cross-silo deployments, the port of
``fedml_tpu/comm/status.py``.

Reference: the ONLINE/FINISHED client-status handshake in
fedavg_cross_silo/ClientMasterManager.py:65-77 (CONNECTION_IS_READY →
send_client_status ONLINE) and :169-188 (FINISHED on completion), plus
MqttS3StatusManager's JSON status pub/sub (mqtt_s3_status_manager.py:17) and
the MQTT last-will offline signal. The reference only has liveness on the
MQTT path; here the protocol is transport-agnostic: status is an ordinary
typed message on any backend.

The server holds a ClientStatusTracker and starts the round protocol once
every expected client reported ONLINE — replacing the reference's implicit
"MPI processes all exist" assumption with an explicit, failure-aware
handshake.

On top of the handshake the module carries the liveness half of the
fault-tolerant runtime (docs/ROBUSTNESS.md "Failure recovery"):
:class:`HeartbeatSender` re-sends ONLINE status on an interval from a
daemon thread, so the tracker's ``last_seen`` stays fresh while a worker
computes — letting the server distinguish SLOW (alive, missed the round
deadline, heartbeat fresh) from dead (silent on both planes) before the
elastic timeout fires, and letting an OFFLINE-excluded worker announce its
return for readmission.
"""

from __future__ import annotations

import threading
import time

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message


class ClientStatus:
    MSG_TYPE_CLIENT_STATUS = 7001  # reserved type id for status messages

    ONLINE = "ONLINE"
    FINISHED = "FINISHED"
    OFFLINE = "OFFLINE"
    # alive (heartbeat fresh) but missed the round deadline — dropped from
    # the round's aggregate like a dead worker, but diagnosably different
    # in the status table and eligible for contact-driven readmission
    SLOW = "SLOW"

    KEY_STATUS = "client_status"
    KEY_OS = "client_os"  # reference tags client OS in status msgs (message.py:21-24)


def send_client_status(comm: BaseCommunicationManager, client_id: int,
                       status: str, receiver_id: int = 0) -> None:
    """Reference ClientMasterManager.send_client_status(:169)."""
    msg = Message(ClientStatus.MSG_TYPE_CLIENT_STATUS, client_id, receiver_id)
    msg.add_params(ClientStatus.KEY_STATUS, status)
    msg.add_params(ClientStatus.KEY_OS, "linux-tpu")
    comm.send_message(msg)


class ClientStatusTracker:
    """Server-side liveness table; thread-safe (the reference's unsynchronized
    status dicts are a known hazard, SURVEY §5.2)."""

    def __init__(self, expected_clients: int):
        self.expected = expected_clients
        self._status: dict[int, str] = {}  # guarded-by: _lock
        self._last_seen: dict[int, float] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self._all_online = threading.Event()
        # fleet telemetry hook (obs/registry.py FleetHealth): called as
        # ``on_transition(client_id, status)`` whenever a client's recorded
        # status CHANGES (heartbeats re-asserting ONLINE refresh last_seen
        # without firing it). Invoked UNDER the tracker lock so concurrent
        # updates (timer marking SLOW vs receive thread marking ONLINE)
        # deliver transitions in the order the table recorded them — the
        # hook must not call back into the tracker.
        self.on_transition = None

    def update(self, client_id: int, status: str, touch: bool = True) -> None:
        """Record ``status`` for the client. ``touch=False`` marks a
        SERVER-side judgement (SLOW/OFFLINE labels) without refreshing
        ``last_seen`` — only actual contact from the client may count as
        liveness evidence."""
        with self._lock:
            prev = self._status.get(client_id)
            self._status[client_id] = status
            if touch:
                self._last_seen[client_id] = time.monotonic()
            online = sum(1 for s in self._status.values() if s == ClientStatus.ONLINE)
            if online >= self.expected:
                self._all_online.set()
            if self.on_transition is not None and status != prev:
                self.on_transition(client_id, status)

    def stale(self, timeout: float) -> list[int]:
        """Clients silent for longer than ``timeout`` seconds (and not
        FINISHED) — candidates for OFFLINE marking / round dropping."""
        now = time.monotonic()
        with self._lock:
            return sorted(
                cid for cid, seen in self._last_seen.items()
                if now - seen > timeout
                and self._status.get(cid) not in (ClientStatus.FINISHED,
                                                  ClientStatus.OFFLINE)
            )


    def last_seen(self, client_id: int) -> float | None:
        """``time.monotonic`` of the client's last status contact (None if
        it never reported)."""
        with self._lock:
            return self._last_seen.get(client_id)

    def seen_within(self, client_id: int, window: float) -> bool:
        """True when the client reported status within the last ``window``
        seconds — the slow-vs-dead discriminator: a worker that missed the
        round deadline but heartbeats is SLOW, not dead."""
        seen = self.last_seen(client_id)
        return seen is not None and time.monotonic() - seen <= window

    def handle_message(self, msg: Message) -> None:
        self.update(msg.get_sender_id(), msg.get(ClientStatus.KEY_STATUS))

    def wait_all_online(self, timeout: float | None = None) -> bool:
        return self._all_online.wait(timeout)

    def snapshot(self) -> dict[int, str]:
        with self._lock:
            return dict(self._status)

    def finished_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._status.values() if s == ClientStatus.FINISHED)


class HeartbeatSender:
    """Periodic ONLINE status from a daemon thread (docs/ROBUSTNESS.md
    "Failure recovery").

    Heartbeats are ordinary :func:`send_client_status` messages, so they
    ride any backend (and any fault wrapper) unchanged; the server's
    status handler feeds them into its :class:`ClientStatusTracker`. Send
    errors are swallowed — a heartbeat is best-effort by definition, and a
    sender must survive its transport flapping (or the server restarting
    mid-run). Heartbeats never touch aggregation state, so a heartbeating
    run is bit-identical to a silent one (tools/ft_smoke.py guards this).
    """

    def __init__(self, comm: BaseCommunicationManager, client_id: int,
                 interval: float, receiver_id: int = 0):
        if interval <= 0:
            raise ValueError(f"heartbeat interval must be > 0, got {interval}")
        self.comm = comm
        self.client_id = client_id
        self.interval = float(interval)
        self.receiver_id = receiver_id
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                send_client_status(self.comm, self.client_id,
                                   ClientStatus.ONLINE, self.receiver_id)
            except Exception:  # noqa: BLE001 — best-effort by contract
                pass
            self._stop.wait(self.interval)

    def start(self) -> "HeartbeatSender":
        if self._thread is None:
            from fedml_tpu_torch.obs import jobscope

            self._thread = threading.Thread(
                # inherit the starter's job binding (obs/jobscope.py): a
                # multi-tenant job's heartbeats trace/count into ITS scope
                target=jobscope.wrap_target(self._loop),
                name=f"heartbeat-c{self.client_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
