"""Downlink delta coding, the port of ``fedml_tpu/compress/downlink.py``:
quantized model distribution at fan-out.

At each round close (or async emission) the server encodes the new global
ONCE as a delta against the previous *emitted* version through any
delta-domain codec (q8/topk/bf16 and chains), keeps a short chain of
one-step encoded deltas, and serves each receiver by the model version it
echoed: a fresh client gets the one-step delta, a straggler the cumulative
chain, a client whose base was retired the periodic full keyframe.

Error-free reconstruction, the invariant everything hangs off:

- the server's model of record is the DECODED model: after every advance
  ``decoded_r = decoded_{r-1} + decode(encode(global_r - decoded_{r-1}))``
  replaces ``global_r``, so the delta is always formed against what the
  clients hold and quantization error never accumulates across rounds;
- a client applies chain steps with the SAME f32 adds in the SAME order the
  server used, so ``held == decoded`` holds bitwise for every client at its
  version; a cumulative chain is the ordered pack of the retained one-step
  deltas, never a re-encoded sum;
- every ``keyframe_every``-th version is a dense keyframe: the chain resets,
  ``decoded`` snaps back to the exact aggregate, and any receiver (new,
  restarted, or beyond retention) resynchronizes losslessly.

Retention is staleness-driven: the async server feeds its observed
version-lag distribution in through
:meth:`DownlinkCodecState.observe_staleness` and the chain keeps
``max(retention, p99_staleness + 1)`` steps; a base retired anyway falls
back to the keyframe with a loud warning (the server manager's).

**Where the codec runs.** The encode and every decode run on the host CPU,
on both sides, whatever device the clients train on: the server's model of
record and its f64 fold are host numpy already, and the invariant above
needs the server's ``advance`` and every client's ``apply_chain`` to run
the same decode program and the same f32 adds. :func:`_decode_flat` is that
one program. It is also the JAX package's arithmetic on the same planes:
JAX decodes the downlink with its codec under ``jax.jit``, and XLA compiles
a quantizer's ``q / levels * scale`` into ``q * (scale * (1 / levels))``,
so the downlink's quantizer stages dequantize in that order
(:class:`_JitOrderQuantizeCodec`; the uplink keeps the op-by-op quotient).
A JAX server and port clients, or the reverse, then reconstruct bitwise
across the packages. This is the wire's own host plane, not a stand-in for
a device kernel.

Where the port departs from the JAX package: the quantizer's uniforms for
version ``v`` come from :class:`~fedml_tpu_torch.core.rng.RoundNoise`
seeded with ``(0xD0DEC, v)`` (:meth:`DownlinkCodecState.noise`), the
integers of JAX's ``fold_in(key(0xD0DEC), v)``, which draws other numbers
(ROADMAP §C). bf16 and top-k draw nothing and are bitwise JAX's.
"""

from __future__ import annotations

import functools
import json
import logging
import math
import threading

import numpy as np
import torch

from fedml_tpu_torch.comm.message import pack_encoded_update, unpack_encoded_update
from fedml_tpu_torch.compress.codec import (ChainCodec, Codec, QuantizeCodec, _numel, _rebuild,
                                             make_codec)
from fedml_tpu_torch.core.rng import RoundNoise

# descriptor "kind" tag so a receiver can reject a payload that is not a
# downlink chain (e.g. a misrouted uplink EncodedUpdate descriptor)
DOWNLINK_CHAIN_KIND = "downlink_delta_chain"

# the device of every downlink encode and decode (module docstring)
CODEC_DEVICE = "cpu"


def resolve_downlink_codec(spec, topk_frac: float = 0.01,
                           quantize_bits: int = 8) -> Codec | None:
    """A ``--downlink_compressor`` spec (or an already-built codec) to the
    armed downlink codec, or None for the dense path. ``none`` resolves to
    None, not to an identity-codec delta plane: a none-codec "delta" would
    still replace the broadcast with ``decoded + (new - decoded)``, which
    float addition does not round-trip, so the only honest none arm is the
    unchanged dense broadcast."""
    if spec is None:
        return None
    if isinstance(spec, Codec):
        codec = spec
    else:
        s = str(spec).strip()
        if not s or s == "none":
            return None
        codec = make_codec(s, topk_frac=topk_frac, quantize_bits=quantize_bits)
    return codec if codec.delta_domain else None


def _as_f32(flat_u8) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(flat_u8)).view(np.float32)


def _model_tree(flat_f32: np.ndarray, model_desc: str) -> dict[str, torch.Tensor]:
    """A flat f32 model as the ``{"a/b/c": tensor}`` state dict of the JAX
    layout (the descriptor's path order, JAX's sorted traversal), host
    tensors viewing ``flat_f32``."""
    out, off = {}, 0
    for d in json.loads(model_desc):
        n = int(math.prod(d["shape"])) if d["shape"] else 1
        out[d["path"]] = torch.from_numpy(flat_f32[off:off + n]).reshape(d["shape"])
        off += n
    return out


class _JitOrderQuantizeCodec(QuantizeCodec):
    """The quantizer with JAX's jitted dequantization order,
    ``q * (scale * (1 / levels))`` (the module docstring says why)."""

    def decode(self, enc):
        meta = enc.meta_dict()
        vals, scales = enc.planes["values"], enc.planes["scale"]
        out = [self._unpack(v, _numel(spec)) * (scale * torch.full_like(scale, 1 / self.levels))
               for v, scale, spec in zip(vals.values(), scales.values(), meta["leaves"])]
        return _rebuild(vals, out, meta)


@functools.lru_cache(maxsize=None)
def _decode_program(codec: Codec) -> Codec:
    """``codec`` with its quantizer stages in JAX's jitted order."""
    if isinstance(codec, QuantizeCodec):
        return _JitOrderQuantizeCodec(codec.bits)
    if isinstance(codec, ChainCodec):
        return ChainCodec([_decode_program(s) for s in codec.stages])
    return codec


def _decode_flat(codec: Codec, enc) -> np.ndarray:
    """Decode an EncodedUpdate to the flat f32 wire layout. ONE definition
    shared by the server's advance and the client's chain apply: both sides
    must run the same decode on the same device and the same flatten, or the
    bitwise held == decoded contract breaks."""
    tree = _decode_program(codec).decode(enc)
    leaves = [t.to(CODEC_DEVICE, torch.float32).reshape(-1).numpy() for t in tree.values()]
    return (np.concatenate(leaves) if leaves else np.zeros(0, np.float32)).astype(
        np.float32, copy=False)


class DownlinkCodecState:
    """Server-side downlink compression state (one per server manager).

    Owns the decoded model of record, the chain of retained one-step
    encoded deltas, the per-base cumulative-blob cache (so one fan-out
    builds each distinct version gap's blob ONCE: the object-store
    broadcast then puts one blob per gap, and the framed transports share
    one frame per gap), and the staleness histogram driving retention.
    Thread-safe: the server's receive thread, timer thread, and fan-outs
    all touch it."""

    SEED = 0xD0DEC

    def __init__(self, codec: Codec, model_desc: str,
                 keyframe_every: int = 8, retention: int = 4):
        if not codec.delta_domain:
            raise ValueError(
                "downlink delta coding needs a delta-domain codec; the "
                "'none' arm is the unchanged dense broadcast (pass None / "
                "resolve_downlink_codec)"
            )
        self.codec = codec
        self.model_desc = model_desc
        self.keyframe_every = max(1, int(keyframe_every))
        self.retention = max(1, int(retention))
        self._lock = threading.Lock()
        self._decoded: np.ndarray | None = None  # guarded-by: _lock
        self.version = -1  # guarded-by: _lock
        # contiguous ascending one-step deltas, each producing its "version"
        self._chain: list[dict] = []  # guarded-by: _lock
        self._blob_cache: dict[int, tuple] = {}  # guarded-by: _lock
        self._last_keyframe = -1  # guarded-by: _lock
        self._gap_counts: dict[int, int] = {}  # guarded-by: _lock
        self._retention_floor = 0  # guarded-by: _lock
        self._stats = {
            "keyframes": 0, "deltas": 0,
            "keyframes_served": 0, "chains_served": 0,
            "chain_steps_served": 0, "retired_fallbacks": 0,
        }  # guarded-by: _lock

    def noise(self, version: int) -> RoundNoise:
        """The quantizer's draws for ``version``: the JAX key's integers,
        ``(0xD0DEC, version)``, on the codec's device (module docstring)."""
        return RoundNoise(self.SEED, version, CODEC_DEVICE)

    # -- server write path ---------------------------------------------------

    def reset(self, flat_u8, version: int) -> np.ndarray:
        """(Re)anchor on a dense keyframe, at init and after a crash
        restore, when no receiver's held version is known. Returns the
        decoded (== exact) model as wire bytes."""
        with self._lock:
            return self._keyframe(_as_f32(flat_u8), int(version))

    def _keyframe(self, new_f32: np.ndarray, version: int):  # lock-held: _lock
        self._decoded = np.array(new_f32, np.float32)
        self._chain.clear()
        self._blob_cache.clear()
        self.version = version
        self._last_keyframe = version
        self._stats["keyframes"] += 1
        return self._decoded.view(np.uint8)

    def advance(self, new_flat_u8, version: int) -> np.ndarray:
        """Encode the new global ONCE at round close / emission. Returns the
        decoded model's wire bytes: the caller REPLACES its global with
        them, so the next uplink round trains from exactly what every
        receiver reconstructs. Keyframe versions snap back to the exact
        aggregate (and reset the chain)."""
        version = int(version)
        new_f32 = _as_f32(new_flat_u8)
        with self._lock:
            if self._decoded is None or version % self.keyframe_every == 0:
                return self._keyframe(new_f32, version)
            delta = new_f32 - self._decoded
            enc = self.codec.encode(_model_tree(delta, self.model_desc), self.noise(version))
            dec = _decode_flat(self.codec, enc)
            # sequential f32 adds are THE canonical order (clients replay it)
            self._decoded = self._decoded + dec
            flat, desc = pack_encoded_update(enc)
            self._chain.append({"version": version, "flat": flat, "desc": desc})
            keep = max(self.retention, self._staleness_floor())
            while len(self._chain) > keep:
                self._chain.pop(0)
            self._blob_cache.clear()
            self.version = version
            self._stats["deltas"] += 1
            return self._decoded.view(np.uint8)

    # -- staleness-driven retention ------------------------------------------

    def observe_staleness(self, gap: int) -> None:
        """Feed one observed version lag (the async server calls this per
        fold): the retention floor tracks the p99 of the distribution so a
        deliberately slow client keeps finding its delta base."""
        gap = int(gap)
        if gap <= 0:
            return
        with self._lock:
            self._gap_counts[gap] = self._gap_counts.get(gap, 0) + 1

    def _staleness_floor(self) -> int:  # lock-held: _lock
        total = sum(self._gap_counts.values())
        if total:
            cum = 0
            for g in sorted(self._gap_counts):
                cum += self._gap_counts[g]
                if cum >= 0.99 * total:
                    # never shrinks: a once-slow client stays coverable
                    self._retention_floor = max(self._retention_floor, g + 1)
                    break
        return self._retention_floor

    def retention_effective(self) -> int:
        with self._lock:
            return max(self.retention, self._staleness_floor())

    # -- serve-by-version ----------------------------------------------------

    def serve(self, base_version) -> tuple:
        """Payload for a receiver holding ``base_version``:
        ``("delta", flat_u8, desc_json)``, the cumulative chain from base to
        the current version (cached per distinct gap, so every receiver of a
        fan-out with the same base shares ONE blob object), or
        ``("keyframe", reason, retired)`` where ``retired`` flags a base
        that retention trimmed away (the caller warns; a base merely
        predating the last keyframe is the designed cadence)."""
        with self._lock:
            if base_version is None:
                self._stats["keyframes_served"] += 1
                return ("keyframe", "no echoed base version", False)
            base = int(base_version)
            if base >= self.version:
                self._stats["keyframes_served"] += 1
                return ("keyframe", f"base {base} already current", False)
            blob = self._blob_for(base)
            if blob is not None:
                self._stats["chains_served"] += 1
                self._stats["chain_steps_served"] += self.version - base
                return ("delta", blob[0], blob[1])
            retired = base >= self._last_keyframe
            self._stats["keyframes_served"] += 1
            if retired:
                self._stats["retired_fallbacks"] += 1
                reason = (f"base {base} retired (chain starts at "
                          f"{self._chain[0]['version'] if self._chain else '-'},"
                          f" retention {max(self.retention, self._retention_floor)})")
            else:
                reason = f"base {base} predates keyframe {self._last_keyframe}"
            return ("keyframe", reason, retired)

    def _blob_for(self, base: int):  # lock-held: _lock
        cached = self._blob_cache.get(base)
        if cached is not None:
            return cached
        steps = [e for e in self._chain if e["version"] > base]
        if (not steps or steps[0]["version"] != base + 1
                or steps[-1]["version"] != self.version):
            return None
        if len(steps) == 1:
            flat = steps[0]["flat"]  # zero-copy: the stored segment itself
        else:
            flat = np.concatenate([s["flat"] for s in steps])
        desc = json.dumps({
            "kind": DOWNLINK_CHAIN_KIND,
            "scheme": self.codec.name,
            "version": int(self.version),
            "base": int(base),
            "steps": [{"version": int(s["version"]),
                       "nbytes": int(s["flat"].size),
                       "desc": json.loads(s["desc"])} for s in steps],
        })
        self._blob_cache[base] = (flat, desc)
        return self._blob_cache[base]

    def stats_snapshot(self) -> dict:
        with self._lock:
            return dict(self._stats)


class DownlinkDecoder:
    """Client-side held-model state: the mutable f32 copy of the decoded
    global and the version it represents. Keyframes replace it; delta
    chains apply step by step with the server's exact f32 add sequence, so
    reconstruction is bitwise (steps at or below the held version are
    skipped: the server may serve a chain from an older echo than the
    client's true state)."""

    def __init__(self, codec: Codec):
        self.codec = codec
        self.held: np.ndarray | None = None  # f32, this decoder's own copy
        self.version: int | None = None

    def apply_keyframe(self, flat_u8, version) -> np.ndarray:
        self.held = np.array(_as_f32(flat_u8), np.float32)
        self.version = int(version)
        return self.held

    def apply_chain(self, chain_flat_u8, chain_desc: str, base_version,
                    target_version) -> np.ndarray:
        spec = json.loads(chain_desc)
        if spec.get("kind") != DOWNLINK_CHAIN_KIND:
            raise RuntimeError(
                f"downlink payload descriptor kind {spec.get('kind')!r} is "
                f"not {DOWNLINK_CHAIN_KIND!r} — misrouted payload"
            )
        if spec.get("scheme") != self.codec.name:
            raise RuntimeError(
                f"downlink chain was encoded with {spec.get('scheme')!r} but "
                f"this client decodes {self.codec.name!r} — server and "
                "clients must be armed with the same --downlink_compressor"
            )
        if self.held is None or self.version is None:
            raise RuntimeError(
                "delta-coded sync before any keyframe: this client holds no "
                "base model to apply the chain onto (protocol bug — the "
                "init sync is always a dense keyframe)"
            )
        if base_version is not None and int(base_version) > self.version:
            raise RuntimeError(
                f"delta chain base {int(base_version)} is ahead of the held "
                f"version {self.version}: this client missed a sync the "
                "server thinks it received"
            )
        chain = np.ascontiguousarray(np.asarray(chain_flat_u8, np.uint8))
        held, ver = self.held, self.version
        off = 0
        for step in spec["steps"]:
            n = int(step["nbytes"])
            seg = chain[off:off + n]
            off += n
            sv = int(step["version"])
            if sv <= ver:
                continue  # already held (server served from an older echo)
            if sv != ver + 1:
                raise RuntimeError(
                    f"delta chain step {sv} does not continue held version "
                    f"{ver}: missing step {ver + 1} — cannot reconstruct"
                )
            enc = unpack_encoded_update(seg, json.dumps(step["desc"]))
            held = held + _decode_flat(self.codec, enc)
            ver = sv
        if ver != int(spec["version"]):
            raise RuntimeError(
                f"delta chain ends at version {int(spec['version'])} but "
                f"application stopped at {ver}"
            )
        if target_version is not None and ver != int(target_version):
            # a fan-out racing a round close can stamp the header with a
            # version one ahead of/behind the chain (the chain itself is
            # validated and bitwise, and the version echo self-corrects on
            # the next upload): log, don't kill the client thread
            logging.warning(
                "delta chain reconstructs version %d but the sync header is "
                "stamped %d (fan-out raced a round close; the echo "
                "self-corrects)", ver, int(target_version),
            )
        self.held, self.version = held, ver
        return held
