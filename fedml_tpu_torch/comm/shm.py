"""Shared-memory transport backend (native C++ ring via ctypes), the port of
``fedml_tpu/comm/shm.py``.

Single-host multi-process federation: the role the reference fills with MPI
on localhost (run_fedavg_distributed_pytorch.sh:19 writes `hostname >
mpi_host_file`). Each rank owns one MPSC ring in POSIX shm; send writes into
the receiver's ring; receive blocks on a process-shared condvar (no polling —
contrast the reference's 0.3 s queue poll, mpi/com_manager.py:71-78).

The C++ source is the port's own copy, ``comm/native/shm_ring.cpp`` (the
JAX package's, byte for byte, so a JAX rank and a port rank open each
other's rings: same segment layout, same ``/<job>_r<rank>`` names). It is
compiled with ``g++`` at first use into the gitignored ``ops/_build/``,
under a name keyed on a hash of the source and the flags, as the CUDA
kernels are (``ops/_build.py``). A failed build raises; nothing falls back
to another transport.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

from fedml_tpu_torch.comm.base import BaseCommunicationManager
from fedml_tpu_torch.comm.message import Message

_SRC = Path(__file__).parent / "native" / "shm_ring.cpp"
_BUILD_DIR = Path(__file__).parent.parent / "ops" / "_build"
_CXX_FLAGS = ("-O2", "-shared", "-fPIC")
_LINK_FLAGS = ("-lpthread", "-lrt")  # after the source, so the linker keeps them

_lib = None
_lib_lock = threading.Lock()


def library_path() -> Path:
    """Where the ring builds to; the name carries the hash of the source and
    the flags, so an edited source builds anew."""
    digest = hashlib.sha256(
        _SRC.read_bytes() + " ".join(_CXX_FLAGS + _LINK_FLAGS).encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f"libshmring-{digest}.so"


def build() -> Path:
    """Compile the ring with ``g++`` unless its library for this hash exists;
    raises on a failed compile."""
    out = library_path()
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_CXX_FLAGS, "-o", str(tmp), str(_SRC), *_LINK_FLAGS]
    logging.info("building native shm ring: %s", " ".join(cmd))
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building shm_ring.cpp:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.shmring_create.restype = ctypes.c_void_p
        lib.shmring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.shmring_open.restype = ctypes.c_void_p
        lib.shmring_open.argtypes = [ctypes.c_char_p]
        lib.shmring_send.restype = ctypes.c_int
        lib.shmring_send.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.shmring_recv.restype = ctypes.c_longlong
        lib.shmring_recv.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
        lib.shmring_close.restype = ctypes.c_int
        lib.shmring_close.argtypes = [ctypes.c_void_p]
        lib.shmring_unlink.restype = ctypes.c_int
        lib.shmring_unlink.argtypes = [ctypes.c_char_p]
        _lib = lib
        return lib


class ShmRing:
    """One named MPSC ring."""

    def __init__(self, name: str, capacity: int = 64 << 20, create: bool = False):
        self.lib = _load_lib()
        self.name = name.encode()
        self.handle = (
            self.lib.shmring_create(self.name, capacity)
            if create
            else self.lib.shmring_open(self.name)
        )
        if not self.handle:
            raise OSError(f"shmring {'create' if create else 'open'} failed: {name}")
        self._recv_buf = ctypes.create_string_buffer(capacity if create else 64 << 20)

    def _open_handle(self):
        # a closed ring's handle is NULL, which the C side dereferences: a
        # late send (a delayed fault's timer, after the runner's cleanup)
        # must raise, not crash the process (the JAX ring segfaults here)
        if not self.handle:
            raise OSError(f"shmring {self.name!r} is closed")
        return self.handle

    def send(self, data: bytes, timeout_ms: int = 60_000) -> None:
        rc = self.lib.shmring_send(self._open_handle(), data, len(data), timeout_ms)
        if rc == -1:
            raise TimeoutError(f"shmring send timeout on {self.name!r}")
        if rc != 0:
            raise OSError(f"shmring send failed rc={rc}")

    def recv(self, timeout_ms: int = 1000) -> bytes | None:
        n = self.lib.shmring_recv(self._open_handle(), self._recv_buf, len(self._recv_buf),
                                  timeout_ms)
        if n == -1:
            return None
        if n < 0:
            raise OSError(f"shmring recv failed rc={n}")
        # the message's n bytes only (the JAX ring slices ``.raw``, a copy of
        # the whole 64 MB buffer at every receive)
        return ctypes.string_at(self._recv_buf, n)

    def close(self) -> None:
        if self.handle:
            self.lib.shmring_close(self.handle)
            self.handle = None

    def unlink(self) -> None:
        self.lib.shmring_unlink(self.name)


class ShmCommManager(BaseCommunicationManager):
    """Backend over the native rings: rank r receives on ring
    ``/<job>_r<r>``; send opens the receiver's ring lazily."""

    def __init__(self, job: str, rank: int, world_size: int, capacity: int = 64 << 20):
        super().__init__()
        self.job = job
        self.rank = rank
        self.world_size = world_size
        self.capacity = capacity
        self.my_ring = ShmRing(self._ring_name(rank), capacity, create=True)
        self._out: dict[int, ShmRing] = {}
        self._running = False

    def _ring_name(self, rank: int) -> str:
        return f"/{self.job}_r{rank}"

    def _ring(self, dst: int) -> ShmRing:
        if dst not in self._out:
            # receiver creates its ring at startup; create= True is idempotent
            self._out[dst] = ShmRing(self._ring_name(dst), self.capacity, create=True)
        return self._out[dst]

    def send_message(self, msg: Message) -> None:
        self._ring(msg.get_receiver_id()).send(msg.to_bytes())

    def _send_framed(self, frame, dst: int, overrides: dict | None = None) -> None:
        # encode-once: the shared frame tail is joined once per fan-out; each
        # receiver's ring write reuses it behind a patched header
        self._ring(dst).send(frame.bytes_for(dst, overrides))

    def handle_receive_message(self) -> None:
        self._running = True
        while self._running:
            data = self.my_ring.recv(timeout_ms=200)
            if data is None:
                continue
            msg = Message.from_bytes(data)
            if msg.get_type() == -999:  # internal stop sentinel
                break
            self.notify(msg)

    def stop_receive_message(self) -> None:
        self._running = False
        stop = Message(msg_type=-999, sender_id=self.rank, receiver_id=self.rank)
        try:
            self.my_ring.send(stop.to_bytes(), timeout_ms=1000)
        except Exception:
            pass

    def cleanup(self) -> None:
        self.my_ring.close()
        self.my_ring.unlink()
        for ring in self._out.values():
            ring.close()
