"""Process-boundary transport for the league seams (§3.3 / §3.4);
counterpart of `repro.distributed.transport`, with the same codec, framing,
streaming, shm ring and RPC protocol.

What the port adds is tensors on the wire. Before a message is encoded
(under either codec) every `torch.Tensor` in it becomes numpy: detached,
brought to the host with every CUDA leaf of the message in ONE batched
device-to-host copy (`utils.host.host_bytes`), and a bfloat16 tensor,
which numpy lacks, as its raw 16-bit words under a dtype tag that the
decoder turns back into a bfloat16 CPU tensor. So the wire carries only
numpy, a message of numpy arrays and protocol types packs to the same
msgpack bytes as `repro`'s, and a receiver puts what it gets on its own
device explicitly (the InfServer's `_place`, the Learner's `_snapshot`).
Under the pickle codec this matters most: `pickle` of a CUDA tensor does
not fail, it restores the storage on `cuda:0` in the receiver.

The shm ring's teardown is race-free here: `_ClientConn.fail` takes the
ring under its lock, and every caller of `fail` returns only once the
segment is unlinked, whichever thread did it (the reference lets the
reader thread and `close()` race on the ring, so `close()` can return
with the segment still in `/dev/shm`).

The paper connects LeagueMgr, ModelPool, Learner, Actor and InfServer with
ZeroMQ so each module can live in its own process on a hybrid cluster.
This module is that transport layer: a length-prefixed **msgpack-over-TCP
RPC** (msgpack when available — it is a dev extra — with a pickle fallback
for bare installs; both are trusted-cluster protocols, not internet-facing
ones) plus thin client/server wrappers that mirror the in-process seam
APIs exactly:

  * `ModelPoolClient`   — pull / push / pull_attr / freeze / keys
  * `LeagueMgrClient`   — request_task / report_result / should_freeze /
                          end_learning_period / pool_winrate / league_state
  * `InfServerClient`   — submit / flush / get (ticket ids travel as ints)
                          / update_params / ensure_model / evict_model
  * `DataServerClient`  — put / put_when_room / wait_ready / throughput

**Pipelining (protocol v2):** a client opens with a `__hello__` frame
carrying its protocol version and host boot id. A v2 server acks, and
from then on every request frame carries a request id (`"i"`); the
client keeps up to `max_inflight` requests on the wire at once and a
reader thread matches out-of-order replies to `_Future`s. `call` is
submit-then-await-one (unchanged semantics), `call_async` returns the
future, and `notify` is one-way fire-and-forget (frames tagged `"n"` get
no reply at all — telemetry/priority/beat traffic stops paying a round
trip). The server dispatches each connection's requests on a small
thread pool so a slow method does not head-of-line-block the rest. A
legacy peer simply errors the hello (old servers) or never sends one
(old clients); both sides then fall back to the strict serial
one-in-flight protocol, so mixed deployments negotiate down cleanly.

**Same-host shared-memory fast path:** when the hello exchange shows
both peers on the same host (identical boot ids) and shm is enabled, the
client creates a `multiprocessing.shared_memory` ring and registers it
with a `__shm__` frame. Large ndarray blobs (the streamed leaves below)
are then written into the ring and the wire carries a 17-byte
(tag, offset, length) stub instead of the bytes; the ring never wraps a
blob across its physical end and falls back to inline TCP bytes whenever
it is full, so TCP remains the universal fallback. The ring is
client→server only (puts and obs submits are the asymmetric bulk);
replies always travel TCP. A producer that dies unlinks its segment via
its own resource tracker — the consumer just sees the connection drop.

Every pytree that crosses the wire is freshly deserialized in the
receiving process, so a remote WRITER can never corrupt local buffers.
Note the read-side contract did tighten with the param plane:
`ModelPoolClient.pull` keeps a local version cache and returns it BY
REFERENCE (read-only, like a `copy=False` local pull) — pass
`copy=True` before feeding a remote pull to a donating train step,
exactly as in-process callers must.

Wire format: 1 codec byte + 8-byte big-endian length, then one msgpack
(or pickle) message. Requests are `{"m": "ns.method", "a": [...], "k":
{...}}` (+ `"i"` under v2, + `"n": 1` for notifies); replies `{"ok":
result}` or `{"err": message, "tb": traceback}` (+ the echoed `"i"`) — a
remote exception re-raises client-side as `RemoteError` with the server
traceback attached, and a dead peer raises `TransportError` (the
killed-server path the transport tests exercise).

**Streaming transfer (the param plane):** any ndarray leaf at or above
`_CHUNK_THRESHOLD` bytes is NOT serialized into the msgpack frame.
The frame carries a tiny `{"__nds__": [index, dtype, shape]}` stub
(codec byte gains the 0x80 stream flag) and the raw leaf buffers follow
the frame as length-prefixed blobs, sent and received in bounded
`_CHUNK_BYTES` slices (or as shm stubs on a negotiated ring, above).
A 100 MB pytree therefore never exists as one giant msgpack frame on
either side: the sender streams the live array buffers and the receiver
assembles each leaf zero-copy via `np.frombuffer` over its own
bytearray. A peer that dies mid-blob raises `TransportError`, exactly
like one that dies mid-frame. `chunking(...)` overrides the
threshold/slice size per process; the pickle fallback codec never
streams. Frame payloads land in a per-connection growable scratch
buffer (`recv_into`, no per-frame bytes allocation); blob buffers are
fresh per message because the decoded arrays alias them.

`serve_league` is the one-call server: it namespaces one LeagueMgr (and
its ModelPool, and optionally an InfServer) behind a single `RpcServer`
socket — the layout `launch/train.py --role coordinator` binds.

Env knobs: `REPRO_PIPELINE=0` forces the serial v1 protocol,
`REPRO_SHM=0` disables the shm fast path, `REPRO_SHM_MB` sizes the ring
(default 16).
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import json
import os
import random
import socket
import struct
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from typing import Any, Dict, Hashable, Iterable, List, Optional, Tuple, Union

import numpy as np

try:                                       # NumPy 2.0 moved byte_bounds
    from numpy.lib.array_utils import byte_bounds as _byte_bounds
except ImportError:                        # pragma: no cover — NumPy 1.x
    _byte_bounds = np.byte_bounds

import torch

from repro_torch.core.types import (FreezeGate, Hyperparam, MatchResult,
                                    ModelKey, Task)
from repro_torch.params.cache import CachedPuller
from repro_torch.params.manifest import (NotModified, ParamDelta,
                                         ParamManifest,
                                         apply_delta)  # noqa: F401 — apply_delta
# is re-exported: delta consumers (benchmarks, tools) reach it as
# transport.apply_delta next to the wire types it pairs with
from repro_torch.utils.host import host_bytes
from repro_torch.utils.pytree import tree_copy

import pickle

try:
    import msgpack
    CODEC = "msgpack"
except ImportError:                              # bare install: no dev extras
    CODEC = "pickle"


class TransportError(ConnectionError):
    """The peer is gone (refused, reset, or closed mid-message). An
    instance with `.unsent = True` guarantees the request never reached
    the wire — always safe to retry."""


class RetryableError(TransportError):
    """A NON-idempotent call failed after the request may have reached the
    server (`report_result`, `put_when_room`, ...): the transport cannot
    know whether the side effect happened, so it refuses to blindly
    resend. The caller resolves the ambiguity at the protocol layer —
    lease/generation guards make a duplicate `report_result` harmless
    (the reaped generation is dropped server-side), and a duplicated or
    lost trajectory segment is just data. Subclasses TransportError so
    legacy `except TransportError` shutdown paths keep working."""


class RemoteError(RuntimeError):
    """The remote method raised; `.remote_tb` carries the server traceback."""

    def __init__(self, message: str, remote_tb: str = ""):
        super().__init__(message)
        self.remote_tb = remote_tb


class _IdleTimeout(Exception):
    """Internal: the socket timed out between frames (no header byte yet).
    The pipelined reader treats this as 'keep waiting' when nothing is in
    flight and as a dead peer when replies are owed."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Jittered exponential backoff with a cap and a total deadline.

    N actors respawned together against a restarting pool must not
    thundering-herd it: each client's delay sequence is base * 2^i capped
    at `cap_s`, each multiplied by an independent uniform jitter in
    [0.5, 1.5], and the whole retry loop gives up once `deadline_s` of
    wall time (or `max_attempts` attempts) is spent."""
    base_s: float = 0.1
    cap_s: float = 2.0
    max_attempts: int = 50
    deadline_s: Optional[float] = 5.0

    def delays(self, rng: random.Random):
        """Yield the sleep before each RE-attempt (attempt 0 is free);
        exhaustion means give up. Deadline accounting includes the time
        the attempts themselves burned (monotonic clock, not just the
        sleeps)."""
        t0 = time.monotonic()
        for i in range(max(0, self.max_attempts - 1)):
            d = min(self.cap_s, self.base_s * (2.0 ** i))
            d *= rng.uniform(0.5, 1.5)
            if self.deadline_s is not None:
                left = self.deadline_s - (time.monotonic() - t0)
                if left <= 0:
                    return
                d = min(d, left)
            yield d


# -- protocol constants -------------------------------------------------------
_PROTO = 2                     # this build speaks pipelined v2, serial v1
_HELLO_METHOD = "__hello__"    # v2 opener: a legacy server errors it, which
                               # IS the negotiate-down signal
_SHM_METHOD = "__shm__"        # ring registration (same-host fast path)


def _env_flag(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() not in ("0", "false", "no", "off", "")


_PIPELINE_ENABLED = _env_flag("REPRO_PIPELINE", True)
_SHM_ENABLED = _env_flag("REPRO_SHM", True)
_SHM_DEFAULT_MB = float(os.environ.get("REPRO_SHM_MB", "16") or 16)


def _host_boot_id() -> str:
    """Same-host detection for the shm negotiation: two processes on one
    machine read the same kernel boot id; containers with private /proc
    fall back to hostname+MAC, which still only matches same-host."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import uuid
        return f"{socket.gethostname()}-{uuid.getnode():x}"


_BOOT_ID = _host_boot_id()


# -- codec -------------------------------------------------------------------
# msgpack handles scalars/strings/bytes/lists/dicts natively; everything the
# league protocol adds rides extension dicts: ndarrays (dtype/shape/bytes),
# tuples (strict_types makes them reach `default`, so round-trips preserve
# tuple-ness — pytree treedefs survive), and the §3.3 message dataclasses.

_DATACLASSES = {c.__name__: c for c in
                (ModelKey, Hyperparam, FreezeGate, Task, MatchResult,
                 ParamManifest, ParamDelta, NotModified)}

# streaming-transfer knobs: ndarray leaves >= _CHUNK_THRESHOLD bytes ride
# out-of-band after the frame, sent/received in _CHUNK_BYTES slices
_CHUNK_THRESHOLD = 256 * 1024
_CHUNK_BYTES = 1 << 20
_STREAM_FLAG = 0x80


@contextlib.contextmanager
def chunking(threshold: Optional[int] = None, chunk_bytes: Optional[int] = None):
    """Temporarily override the streaming knobs for THIS process's sends
    (`threshold=None` keeps the current value; `threshold=0` streams
    every leaf, a huge threshold forces monolithic frames). The
    param_plane benchmark's chunked-vs-monolithic axis."""
    global _CHUNK_THRESHOLD, _CHUNK_BYTES
    old = (_CHUNK_THRESHOLD, _CHUNK_BYTES)
    if threshold is not None:
        _CHUNK_THRESHOLD = threshold
    if chunk_bytes is not None:
        _CHUNK_BYTES = chunk_bytes
    try:
        yield
    finally:
        _CHUNK_THRESHOLD, _CHUNK_BYTES = old


# -- tensors -> numpy ----------------------------------------------------------
class _BF16Words:
    """A bfloat16 tensor on the wire: its raw 16-bit words as an int16
    numpy array, which both codecs carry like any array. msgpack tags it
    `__bf16__`; pickle rebuilds it through `__reduce__`. Either way the
    receiver gets a bfloat16 CPU tensor."""
    __slots__ = ("words",)

    def __init__(self, words: np.ndarray):
        self.words = words

    def __reduce__(self):
        return (_bf16_tensor, (self.words,))


def _bf16_tensor(words) -> torch.Tensor:
    """The decoder's side of `_BF16Words`: a bfloat16 CPU tensor that owns
    its memory (the words may alias a receive buffer or the shm ring)."""
    return torch.from_numpy(np.array(words, dtype=np.int16)).view(torch.bfloat16)


def _numpy_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _wire_leaf(t: torch.Tensor, raw: Optional[np.ndarray]):
    """One tensor's wire form: a numpy array (bfloat16: `_BF16Words`).
    `raw` is its bytes already on the host (a CUDA tensor's, from the
    message's one batched copy); None reads a CPU tensor in place."""
    bf16 = t.dtype == torch.bfloat16
    if raw is None:
        x = t.detach().contiguous()
        a = (x.view(torch.int16) if bf16 else x).numpy()
    else:
        a = raw.view(np.int16 if bf16 else _numpy_dtype(t.dtype)).reshape(t.shape)
    return _BF16Words(a) if bf16 else a


def _walk(o, fn):
    """Rebuild the containers of a message (dicts, lists, tuples, protocol
    dataclasses) with `fn` applied to every tensor in it; everything else
    is returned as is, and so is a container in which nothing changed."""
    if isinstance(o, torch.Tensor):
        return fn(o)
    if isinstance(o, dict):
        out = {k: _walk(v, fn) for k, v in o.items()}
        return o if all(out[k] is v for k, v in o.items()) else out
    if isinstance(o, (list, tuple)):
        out = [_walk(v, fn) for v in o]
        if all(a is b for a, b in zip(out, o)):
            return o
        return out if isinstance(o, list) else tuple(out)
    if dataclasses.is_dataclass(o) and type(o).__name__ in _DATACLASSES:
        changed = {}
        for f in dataclasses.fields(o):
            v = getattr(o, f.name)
            w = _walk(v, fn)
            if w is not v:
                changed[f.name] = w
        return dataclasses.replace(o, **changed) if changed else o
    return o


def _tensors_to_wire(obj):
    """`obj` with every `torch.Tensor` replaced by its wire form. The CUDA
    tensors of the whole message reach the host in one batched copy per
    device (one wait for the device, not one per leaf)."""
    found: List[torch.Tensor] = []
    _walk(obj, lambda t: found.append(t) or t)
    if not found:
        return obj
    raw: Dict[int, np.ndarray] = {}
    by_dev: Dict[torch.device, List[torch.Tensor]] = {}
    for t in found:
        if t.is_cuda:
            by_dev.setdefault(t.device, []).append(t)
    for ts in by_dev.values():
        for t, r in zip(ts, host_bytes(ts)):
            raw[id(t)] = r
    return _walk(obj, lambda t: _wire_leaf(t, raw.get(id(t))))


def _make_encoder(blobs: Optional[List[np.ndarray]]):
    """msgpack `default` hook; with a `blobs` collector, large ndarrays
    are hoisted out of the frame and replaced by an index stub."""
    def enc(o):
        if isinstance(o, tuple):
            return {"__t__": list(o)}
        if isinstance(o, torch.Tensor):
            # ahead of `__array__`, which fails on a CUDA, grad or bf16
            # tensor (`packb` has turned a message's tensors to numpy)
            return enc(_tensors_to_wire(o))
        if isinstance(o, _BF16Words):
            return {"__bf16__": o.words}
        if isinstance(o, np.ndarray):
            if blobs is not None and o.nbytes >= _CHUNK_THRESHOLD:
                a = np.ascontiguousarray(o)
                blobs.append(a)
                return {"__nds__": [len(blobs) - 1, a.dtype.str,
                                    list(a.shape)]}
            return {"__nd__": [o.dtype.str, list(o.shape),
                               np.ascontiguousarray(o).tobytes()]}
        if isinstance(o, np.generic):
            return o.item()
        if dataclasses.is_dataclass(o) and type(o).__name__ in _DATACLASSES:
            return {"__dc__": type(o).__name__,
                    "f": {f.name: getattr(o, f.name)
                          for f in dataclasses.fields(o)}}
        if hasattr(o, "__array__"):              # jax.Array and friends
            return enc(np.asarray(o))
        raise TypeError(
            f"cannot serialize {type(o)!r} over the league transport")
    return enc


def _make_decoder(blobs: Optional[List[bytearray]]):
    def dec(d):
        if "__t__" in d and len(d) == 1:
            return tuple(d["__t__"])
        if "__nd__" in d and len(d) == 1:
            dt, shape, buf = d["__nd__"]
            return np.frombuffer(buf, dtype=np.dtype(dt)).reshape(shape).copy()
        if "__nds__" in d and len(d) == 1:
            if blobs is None:
                raise TransportError(
                    "frame references streamed blobs but none followed")
            i, dt, shape = d["__nds__"]
            # zero-copy: the bytearray was recv'd directly into place and
            # is owned exclusively by this message
            return np.frombuffer(blobs[i], dtype=np.dtype(dt)).reshape(shape)
        if "__bf16__" in d and len(d) == 1:
            return _bf16_tensor(d["__bf16__"])
        if "__dc__" in d:
            return _DATACLASSES[d["__dc__"]](**d["f"])
        return d
    return dec


_CODEC_MSGPACK, _CODEC_PICKLE = 1, 2


def _codec_id() -> int:
    """The codec byte of this process's frames, read from `CODEC` at each
    use, so setting `CODEC` alone switches the wire."""
    return _CODEC_MSGPACK if CODEC == "msgpack" else _CODEC_PICKLE


def packb(obj, blobs: Optional[List[np.ndarray]] = None) -> bytes:
    """Serialize one message. With a `blobs` list (msgpack codec only),
    large ndarray leaves are appended to it instead of being copied into
    the returned frame — the streaming path `send_msg` uses. Tensors
    become numpy first, under both codecs (`_tensors_to_wire`)."""
    obj = _tensors_to_wire(obj)
    if CODEC == "msgpack":
        return msgpack.packb(obj, default=_make_encoder(blobs),
                             strict_types=True, use_bin_type=True)
    return pickle.dumps(obj)


def unpackb(buf, codec_id: Optional[int] = None,
            blobs: Optional[List[bytearray]] = None):
    """Decode with the codec the MESSAGE was packed with (every frame
    carries a codec byte), defaulting to this process's codec. A
    msgpack-encoded frame from a peer on a bare install (no msgpack) is a
    clear error instead of a garbled pickle failure; pickle frames decode
    anywhere (pickle is stdlib). `buf` may be a memoryview into a reused
    scratch buffer — both codecs copy what they keep."""
    codec_id = _codec_id() if codec_id is None else codec_id
    if codec_id == _CODEC_MSGPACK:
        if CODEC != "msgpack":
            raise TransportError(
                "peer sent a msgpack frame but msgpack is not installed "
                "here (pip install msgpack, or run all peers bare)")
        return msgpack.unpackb(buf, object_hook=_make_decoder(blobs),
                               raw=False, strict_map_key=False)
    if codec_id == _CODEC_PICKLE:
        return pickle.loads(buf)
    raise TransportError(f"unknown wire codec id {codec_id}")


# -- shared-memory ring (same-host fast path) --------------------------------
_SHM_HEADER = 64       # one cache line; bytes 0..8 = consumer's counter "<Q"


class _ShmRing:
    """Producer side: a single-producer single-consumer byte ring in one
    `multiprocessing.shared_memory` segment. Offsets are VIRTUAL (they
    only ever grow); a blob never wraps the physical end — the tail gap
    is skipped and accounted, so the consumer can copy each blob with one
    slice. `try_write` returns None when the consumer is too far behind
    (ring full) or the blob exceeds the ring; the caller then falls back
    to inline TCP bytes, keeping shm strictly an optimization."""

    def __init__(self, size: int):
        from multiprocessing import shared_memory
        self.size = int(size)
        assert self.size > 0
        self._seg = shared_memory.SharedMemory(
            create=True, size=_SHM_HEADER + self.size)
        self._seg.buf[:_SHM_HEADER] = b"\x00" * _SHM_HEADER
        self._prod = 0                 # virtual write offset
        self.wraps = 0

    @property
    def name(self) -> str:
        return self._seg.name

    def try_write(self, mv) -> Optional[Tuple[int, int]]:
        n = len(mv)
        if n == 0 or n > self.size:
            return None
        v = self._prod
        off = v % self.size
        if off + n > self.size:        # skip the tail gap; never wrap a blob
            v += self.size - off
            off = 0
            self.wraps += 1
        (consumed,) = struct.unpack_from("<Q", self._seg.buf, 0)
        if v + n - consumed > self.size:
            return None                # consumer behind: fall back to TCP
        try:
            # np.copyto is measurably faster than memoryview slice
            # assignment for MB-sized blobs — this copy IS the shm path's
            # cost, so it gets the fast lane
            np.copyto(np.frombuffer(self._seg.buf, np.uint8, n,
                                    _SHM_HEADER + off),
                      np.frombuffer(mv, np.uint8))
        except (ValueError, TypeError):   # non-contiguous source
            self._seg.buf[_SHM_HEADER + off:_SHM_HEADER + off + n] = mv
        self._prod = v + n
        return (v, n)

    def close(self) -> None:
        # close() can raise BufferError under exported views and unlink
        # can race the peer; neither failure matters at teardown
        with contextlib.suppress(Exception):
            self._seg.close()
        with contextlib.suppress(Exception):
            self._seg.unlink()


class _ShmReader:
    """Consumer side: attach to the client's ring WITHOUT letting this
    process's resource tracker adopt it (bpo-38119 — the attacher's
    tracker would unlink a segment it does not own at exit).

    Reads are ZERO-COPY: `view` returns a memoryview straight into the
    segment (a blob never wraps the physical end, so one slice always
    covers it) and does NOT advance the consumed counter. The frame
    reader calls `seal()` once per frame to register the frame's ring
    span; the dispatch worker calls `release(token)` when the handler —
    and the reply that may still reference the blobs — is done with the
    memory. Workers finish out of order, but the consumed counter is a
    single monotonic offset, so spans retire in ARRIVAL order: a span is
    only published once every earlier span has been released too."""

    def __init__(self, name: str, size: int):
        from multiprocessing import shared_memory
        self.size = int(size)
        try:
            try:
                seg = shared_memory.SharedMemory(name=name, track=False)
            except TypeError:          # Python < 3.13: no track kwarg —
                # suppress the attach-side resource_tracker registration
                # (bpo-38119) instead of unregistering after the fact,
                # which double-unregisters when both peers share a process
                from multiprocessing import resource_tracker
                orig = resource_tracker.register
                resource_tracker.register = lambda *a, **k: None
                try:
                    seg = shared_memory.SharedMemory(name=name)
                finally:
                    resource_tracker.register = orig
        except (OSError, ValueError) as e:
            raise TransportError(
                f"cannot attach shm ring {name!r}: {e}") from e
        if seg.size < _SHM_HEADER + self.size:
            with contextlib.suppress(Exception):
                seg.close()
            raise TransportError(
                f"shm ring {name!r} is smaller than negotiated")
        self._seg = seg
        # byte bounds of the mapped segment, for the dispatch-side
        # aliasing check (`_copy_shm_backed`)
        self.bounds = _byte_bounds(np.frombuffer(seg.buf, np.uint8))
        self._lock = threading.Lock()
        self._frame_end: Optional[int] = None   # reader thread only
        self._next_seq = 0                      # arrival order (reader)
        self._retire_seq = 0                    # next span to publish
        self._spans: Dict[int, int] = {}        # seq -> virtual end
        self._released: set = set()

    def view(self, v: int, n: int) -> memoryview:
        off = v % self.size
        if n > self.size or off + n > self.size:
            raise TransportError(
                f"shm blob out of bounds (virt={v}, len={n}, "
                f"ring={self.size})")
        if self._frame_end is None or v + n > self._frame_end:
            self._frame_end = v + n
        return self._seg.buf[_SHM_HEADER + off:_SHM_HEADER + off + n]

    def seal(self) -> Optional[int]:
        """End of one frame (reader thread): claim the frame's ring span
        and return the release token, or None if no blob rode the ring."""
        if self._frame_end is None:
            return None
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._spans[seq] = self._frame_end
        self._frame_end = None
        return seq

    def release(self, seq: int) -> None:
        """Dispatch worker is done with the frame's blobs: retire spans
        in arrival order and publish the new consumed offset, which is
        what un-fills the producer's ring."""
        with self._lock:
            self._released.add(seq)
            end = None
            while self._retire_seq in self._released:
                self._released.remove(self._retire_seq)
                end = self._spans.pop(self._retire_seq)
                self._retire_seq += 1
            if end is not None:
                (cur,) = struct.unpack_from("<Q", self._seg.buf, 0)
                if end > cur:
                    struct.pack_into("<Q", self._seg.buf, 0, end)

    def close(self) -> None:
        # dispatched handlers may still hold views into the mapping;
        # close() then raises BufferError. Deliberately LEAK the mapping
        # until process exit in that case — and disarm SharedMemory's
        # __del__ (which would retry close and spew "Exception ignored"
        # at GC). The PRODUCER owns the unlink either way.
        try:
            self._seg.close()
        except BufferError:
            self._seg.close = lambda: None
        except Exception:                  # noqa: BLE001 — teardown
            pass


# -- framing -----------------------------------------------------------------
# 1-byte codec id + 8-byte big-endian length, then the payload. The codec
# byte makes a mixed msgpack/pickle deployment either work (pickle frames
# decode anywhere) or fail with a message that names the problem. The
# 0x80 bit of the codec byte flags a streamed message: a 4-byte blob
# count follows the payload, then each blob. Without a negotiated shm
# ring each blob is 8-byte length + raw bytes; with one, each blob leads
# with a tag byte — 0 = inline (8-byte length + bytes), 1 = shm stub
# (8-byte virtual offset + 8-byte length, no bytes on the wire).

def _send_frame(sock: socket.socket, obj, shm: Optional[_ShmRing] = None,
                stats: Optional[dict] = None) -> None:
    blobs: Optional[List[np.ndarray]] = [] if CODEC == "msgpack" else None
    payload = packb(obj, blobs)
    streamed = bool(blobs)
    try:
        sock.sendall(struct.pack(
            ">BQ", _codec_id() | (_STREAM_FLAG if streamed else 0),
            len(payload)) + payload)
        if streamed:
            sock.sendall(struct.pack(">I", len(blobs)))
            for arr in blobs:
                mv = memoryview(arr).cast("B")
                if shm is not None:
                    slot = shm.try_write(mv)
                    if slot is not None:
                        sock.sendall(struct.pack(">BQQ", 1, slot[0], slot[1]))
                        if stats is not None:
                            stats["shm_blobs"] += 1
                        continue
                    sock.sendall(struct.pack(">BQ", 0, len(mv)))
                    if stats is not None:
                        stats["shm_fallbacks"] += 1
                else:
                    sock.sendall(struct.pack(">Q", len(mv)))
                # bounded slices: the bulk buffer is handed to the kernel
                # piecewise, never serialized into one giant frame
                for off in range(0, len(mv), _CHUNK_BYTES):
                    sock.sendall(mv[off:off + _CHUNK_BYTES])
    except OSError as e:
        raise TransportError(f"send failed: {e}") from e


def send_msg(sock: socket.socket, obj) -> None:
    _send_frame(sock, obj)


class _FrameReader:
    """Per-connection receive state: one growable scratch buffer that
    every frame payload lands in (`recv_into`, no per-frame allocation)
    plus a small metadata buffer for headers and blob prefixes — kept
    separate so reading a blob header can never clobber the payload the
    decoder is still aliasing. Blob bytes land in FRESH bytearrays: the
    decoded ndarrays wrap them zero-copy and outlive the scratch."""

    __slots__ = ("_sock", "_scratch", "_meta")

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._scratch = bytearray(64 * 1024)
        self._meta = bytearray(32)

    def _read_into(self, mv, n: int, first: bool = False) -> None:
        off = 0
        while off < n:
            try:
                k = self._sock.recv_into(
                    mv[off:off + min(_CHUNK_BYTES, n - off)])
            except socket.timeout:
                if first and off == 0:
                    raise _IdleTimeout() from None
                raise TransportError("recv timed out mid-frame") from None
            except OSError as e:
                raise TransportError(f"recv failed: {e}") from e
            if k == 0:
                raise TransportError("peer closed the connection")
            off += k

    def _read_meta(self, n: int, first: bool = False):
        mv = memoryview(self._meta)[:n]
        self._read_into(mv, n, first)
        return self._meta

    def _read_blob(self, n: int) -> bytearray:
        buf = bytearray(n)
        mv = memoryview(buf)
        off = 0
        while off < n:
            try:
                k = self._sock.recv_into(
                    mv[off:off + min(_CHUNK_BYTES, n - off)])
            except OSError as e:
                raise TransportError(f"recv failed mid-chunk: {e}") from e
            if k == 0:
                raise TransportError(
                    f"peer closed the connection mid-chunk ({off}/{n} bytes)")
            off += k
        return buf

    def recv(self, shm: Optional[_ShmReader] = None, idle_ok: bool = False):
        """Receive one message. With `idle_ok`, a socket timeout BEFORE
        the first header byte raises `_IdleTimeout` (the pipelined
        reader's 'nothing owed, keep waiting' signal); a timeout anywhere
        else is a dead peer. With `shm`, blob prefixes are tagged (see
        the wire format note above)."""
        self._read_meta(9, first=idle_ok)
        codec_byte, n = struct.unpack_from(">BQ", self._meta)
        codec_id = codec_byte & ~_STREAM_FLAG
        if n > len(self._scratch):
            self._scratch = bytearray(max(n, 2 * len(self._scratch)))
        payload = memoryview(self._scratch)[:n]
        self._read_into(payload, n)
        blobs: Optional[List[bytearray]] = None
        if codec_byte & _STREAM_FLAG:
            self._read_meta(4)
            (count,) = struct.unpack_from(">I", self._meta)
            blobs = []
            for _ in range(count):
                if shm is not None:
                    self._read_meta(1)
                    if self._meta[0] == 1:
                        self._read_meta(16)
                        virt, ln = struct.unpack_from(">QQ", self._meta)
                        blobs.append(shm.view(virt, ln))
                        continue
                self._read_meta(8)
                (ln,) = struct.unpack_from(">Q", self._meta)
                blobs.append(self._read_blob(ln))
        return unpackb(payload, codec_id, blobs)


def recv_msg(sock: socket.socket):
    """One-shot receive (fresh scratch) — tests and hand-rolled wire
    exchanges; long-lived connections keep a `_FrameReader`."""
    return _FrameReader(sock).recv()


def _copy_shm_backed(obj, lo: int, hi: int):
    """Replace every ndarray whose memory lies inside the shm ring
    [lo, hi) with a private copy. The dispatch worker runs this on the
    request args when the target method does NOT declare
    `_zero_copy_ok = True` — such a handler may retain the array past
    the dispatch (e.g. `InfServer.submit` references obs until flush),
    and the ring span is recycled the moment the dispatch returns.
    Handlers that copy-or-finish during dispatch (`DataServer.put*`
    copies rows into its preallocated ring) mark themselves and skip
    this — that is the zero-copy fast path."""
    if isinstance(obj, np.ndarray):
        lo_a, hi_a = _byte_bounds(obj)
        return obj.copy() if (lo_a >= lo and hi_a <= hi) else obj
    if isinstance(obj, dict):
        return {k: _copy_shm_backed(v, lo, hi) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_copy_shm_backed(v, lo, hi) for v in obj)
    if isinstance(obj, list):
        return [_copy_shm_backed(v, lo, hi) for v in obj]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            c = _copy_shm_backed(v, lo, hi)
            if c is not v:
                object.__setattr__(obj, f.name, c)
        return obj
    return obj


def parse_addr(addr: str) -> Tuple[str, int]:
    """'host:port' -> (host, port)."""
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


# -- chaos harness ------------------------------------------------------------
# Server-side fault injection for the chaos smoke and the fault_recovery
# benchmark: a seeded FaultPlan decides, per incoming request, whether the
# connection drops before dispatch (request lost), after dispatch (reply
# lost — the ambiguity RetryableError models), gets delayed, or dies
# mid-streamed-chunk. Deterministic given (rules, seed, request order per
# rule); ships across process boundaries as JSON via REPRO_FAULT_PLAN.

@dataclasses.dataclass
class FaultRule:
    """One injection rule. `match` is an fnmatch pattern over the wire
    method name (`"pool.*"`, `"*.pull_if_changed"`, `"*"`); `kind` is
    `drop` (close before dispatch), `drop_reply` (dispatch, then close
    instead of replying), `delay` (sleep `delay_s`, then behave), or
    `close_mid_chunk` (send a truncated reply — for streamed replies,
    half of the first blob — then close). Fires with probability `p`, at
    most `max_times` times."""
    match: str
    kind: str
    p: float = 1.0
    delay_s: float = 0.05
    max_times: Optional[int] = None
    fired: int = 0

    _KINDS = ("drop", "drop_reply", "delay", "close_mid_chunk")

    def __post_init__(self):
        assert self.kind in self._KINDS, \
            f"unknown fault kind {self.kind!r}; pick from {self._KINDS}"


class FaultPlan:
    """A seeded set of FaultRules a `RpcServer` consults per request."""

    def __init__(self, rules: Iterable[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def decide(self, method: str) -> Optional[FaultRule]:
        """First matching rule that fires for this request, else None."""
        with self._lock:
            for rule in self.rules:
                if not fnmatch.fnmatchcase(method, rule.match):
                    continue
                if rule.max_times is not None and rule.fired >= rule.max_times:
                    continue
                if rule.p < 1.0 and self._rng.random() >= rule.p:
                    continue
                rule.fired += 1
                return rule
        return None

    def stats(self) -> dict:
        with self._lock:
            return {f"{r.match}:{r.kind}": r.fired for r in self.rules}

    def to_json(self) -> str:
        return json.dumps({"seed": self.seed, "rules": [
            {"match": r.match, "kind": r.kind, "p": r.p,
             "delay_s": r.delay_s, "max_times": r.max_times}
            for r in self.rules]})

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        return cls([FaultRule(**r) for r in d.get("rules", [])],
                   seed=d.get("seed", 0))

    @classmethod
    def from_env(cls, var: str = "REPRO_FAULT_PLAN") -> Optional["FaultPlan"]:
        """The cross-process seam: a parent (the chaos smoke) plants the
        plan in the environment; `run_coordinator` installs it on its
        server at startup."""
        s = os.environ.get(var)
        return cls.from_json(s) if s else None


def _send_truncated(sock: socket.socket, obj) -> None:
    """Send a deliberately incomplete reply (the close_mid_chunk fault):
    for streamed messages, the header + payload + half of the first blob;
    otherwise half of the frame itself. The peer sees TransportError
    mid-message, exactly like a server dying mid-transfer."""
    blobs: Optional[List[np.ndarray]] = [] if CODEC == "msgpack" else None
    payload = packb(obj, blobs)
    streamed = bool(blobs)
    header = struct.pack(
        ">BQ", _codec_id() | (_STREAM_FLAG if streamed else 0), len(payload))
    if streamed:
        sock.sendall(header + payload)
        sock.sendall(struct.pack(">I", len(blobs)))
        mv = memoryview(blobs[0]).cast("B")
        sock.sendall(struct.pack(">Q", len(mv)))
        sock.sendall(mv[:max(1, len(mv) // 2)])
    else:
        frame = header + payload
        sock.sendall(frame[:max(9, len(frame) // 2)])


# -- server ------------------------------------------------------------------
class RpcServer:
    """Serve the public surface of named objects over one TCP socket.

    `objects` maps a namespace to a backend object; a request for
    `"ns.name"` resolves `getattr(objects[ns], name)` — called with the
    request args when callable, returned as a snapshot value otherwise
    (so plain attributes like `LeagueMgr.frozen_pool` are readable
    remotely). Dunder/private names never resolve.

    One handler thread per connection; a connection whose client opens
    with a v2 `__hello__` is upgraded to the pipelined protocol — its
    requests dispatch on a per-connection thread pool (`conn_workers`)
    and replies go out tagged with the request id as they finish, out of
    order. Every other connection is served with the strict serial v1
    loop. The backend objects' own locks provide the concurrency
    contract, exactly as they do for in-process threads (multiple serial
    connections already dispatched concurrently)."""

    def __init__(self, objects: Dict[str, Any], host: str = "127.0.0.1",
                 port: int = 0, fault_plan: Optional[FaultPlan] = None,
                 pipeline: Optional[bool] = None, conn_workers: int = 8,
                 shm: Optional[bool] = None):
        self._objects = {ns: o for ns, o in objects.items() if o is not None}
        self.fault_plan = fault_plan
        self._pipeline = _PIPELINE_ENABLED if pipeline is None else bool(pipeline)
        self._conn_workers = max(1, int(conn_workers))
        self._shm = _SHM_ENABLED if shm is None else bool(shm)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self._sock.settimeout(0.2)              # accept-loop stop poll
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: list[socket.socket] = []
        self._lock = threading.Lock()

    @property
    def address(self) -> str:
        host, port = self._sock.getsockname()
        return f"{host}:{port}"

    def start(self) -> "RpcServer":
        if self._accept_thread is not None:      # idempotent
            return self
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"rpc-accept@{self.address}",
            daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            # pipelined replies go out as bursts of small frames; Nagle
            # would hold each burst for the peer's delayed ACK
            with contextlib.suppress(OSError):
                conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        rd = _FrameReader(conn)
        try:
            try:
                first = rd.recv()
            except TransportError:
                return
            if (self._pipeline and isinstance(first, dict)
                    and first.get("m") == _HELLO_METHOD):
                self._serve_pipelined(conn, rd, first)
            else:
                self._serve_legacy(conn, rd, first)
        finally:
            conn.close()

    # - v1: strict serial request/reply (legacy clients, pipeline=False) -
    def _serve_legacy(self, conn: socket.socket, rd: _FrameReader, req):
        while not self._stop.is_set():
            rule = (self.fault_plan.decide(req.get("m", ""))
                    if self.fault_plan is not None else None)
            if rule is not None:
                if rule.kind == "drop":
                    return                 # request lost, never dispatched
                if rule.kind == "delay":
                    time.sleep(rule.delay_s)
            reply = self._dispatch(req)
            if rule is not None and rule.kind == "drop_reply":
                return                     # executed, reply lost
            if rule is not None and rule.kind == "close_mid_chunk":
                with contextlib.suppress(OSError):
                    _send_truncated(conn, reply)
                return
            try:
                send_msg(conn, reply)
            except TransportError:
                return                     # peer gone mid-reply
            except Exception as e:         # noqa: BLE001 — result didn't
                # serialize (packb raises before any bytes hit the
                # socket): ship the failure as a RemoteError instead of
                # dropping the connection, which clients would misread
                # as a server shutdown
                send_msg(conn, {"err": f"unserializable reply: "
                                       f"{type(e).__name__}: {e}",
                                "tb": traceback.format_exc()})
            try:
                req = rd.recv()
            except TransportError:
                return

    # - v2: pipelined, id-tagged, out-of-order replies ----------------------
    def _serve_pipelined(self, conn: socket.socket, rd: _FrameReader, hello):
        send_lock = threading.Lock()
        shm_reader: Optional[_ShmReader] = None
        try:
            client_proto = int((hello.get("a") or [1])[0])
        except (TypeError, ValueError):
            client_proto = 1

        def shutdown():
            # wake our own blocked rd.recv AND the client's reader
            with contextlib.suppress(OSError):
                conn.shutdown(socket.SHUT_RDWR)

        def reply(msg):
            try:
                with send_lock:
                    send_msg(conn, msg)
            except TransportError:
                shutdown()
            except Exception as e:         # noqa: BLE001 — unserializable
                # reply: packb raised before any bytes hit the socket
                with contextlib.suppress(Exception):
                    with send_lock:
                        send_msg(conn, {
                            "i": msg.get("i"),
                            "err": f"unserializable reply: "
                                   f"{type(e).__name__}: {e}",
                            "tb": traceback.format_exc()})

        reply({"i": hello.get("i"),
               "ok": {"proto": min(_PROTO, max(1, client_proto)),
                      "boot": _BOOT_ID, "shm": self._shm}})
        pool = ThreadPoolExecutor(
            max_workers=self._conn_workers,
            thread_name_prefix=f"rpc-worker@{self.address}")
        try:
            while not self._stop.is_set():
                try:
                    req = rd.recv(shm=shm_reader)
                except TransportError:
                    return
                # frames that used ring blobs hold their span until the
                # dispatch worker releases it (zero-copy reads)
                token = shm_reader.seal() if shm_reader is not None else None
                method = req.get("m", "") if isinstance(req, dict) else ""
                if method == _SHM_METHOD:
                    ok = False
                    if self._shm:
                        try:
                            shm_reader = _ShmReader(
                                req["a"][0], int(req["a"][1]))
                            ok = True
                        except (TransportError, Exception):  # noqa: B014
                            shm_reader = None
                    reply({"i": req.get("i"), "ok": bool(ok)})
                    continue
                rule = (self.fault_plan.decide(method)
                        if self.fault_plan is not None else None)
                if rule is not None and rule.kind == "drop":
                    return                 # request lost, never dispatched
                pool.submit(self._handle_pipelined, conn, send_lock,
                            shutdown, reply, req, rule, shm_reader, token)
        finally:
            pool.shutdown(wait=False)
            if shm_reader is not None:
                shm_reader.close()

    def _handle_pipelined(self, conn, send_lock, shutdown, reply, req, rule,
                          shm=None, token=None):
        try:
            if rule is not None and rule.kind == "delay":
                time.sleep(rule.delay_s)
            if token is not None and not self._zero_copy_ok(req):
                # the handler may retain the ring-backed arrays past the
                # dispatch; privatize them before the span is recycled
                lo, hi = shm.bounds
                req["a"] = _copy_shm_backed(req.get("a", ()), lo, hi)
                req["k"] = _copy_shm_backed(req.get("k", {}), lo, hi)
            result = self._dispatch(req)
            if req.get("n"):
                return                     # one-way notify: no reply at all
            if rule is not None and rule.kind == "drop_reply":
                shutdown()                 # executed, connection dies
                return
            result["i"] = req.get("i")
            if rule is not None and rule.kind == "close_mid_chunk":
                with contextlib.suppress(OSError):
                    with send_lock:
                        _send_truncated(conn, result)
                shutdown()
                return
            reply(result)
        except Exception:                  # noqa: BLE001 — a worker must
            # never die silently; treat any escape as a dead connection
            shutdown()
        finally:
            if token is not None:
                # reply (which may reference the blobs) is out: retire
                # the frame's ring span so the producer can reuse it
                shm.release(token)

    def _zero_copy_ok(self, req) -> bool:
        """Does the target method declare it never retains argument
        arrays past the dispatch (`_zero_copy_ok = True`)?"""
        try:
            ns, _, name = req.get("m", "").partition(".")
            if name.startswith("_") or not name:
                return False
            target = getattr(self._objects.get(ns), name, None)
            return bool(getattr(target, "_zero_copy_ok", False))
        except Exception:                  # noqa: BLE001 — resolution
            return False                   # failures fall to the safe copy

    def _dispatch(self, req) -> dict:
        try:
            ns, _, name = req["m"].partition(".")
            if name.startswith("_") or not name:
                raise AttributeError(f"{req['m']!r} is not a public method")
            target = getattr(self._objects[ns], name)
            result = (target(*req.get("a", ()), **req.get("k", {}))
                      if callable(target) else target)
            return {"ok": result}
        except Exception as e:                   # noqa: BLE001 — shipped back
            return {"err": f"{type(e).__name__}: {e}",
                    "tb": traceback.format_exc()}

    def close(self) -> None:
        self._stop.set()
        self._sock.close()
        with self._lock:
            conns, self._conns = self._conns, []
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            c.close()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


# -- client ------------------------------------------------------------------
class _Future:
    """Minimal thread-safe future for pipelined replies. `result` raises
    the remote/transport failure or returns the reply VALUE (`"ok"`,
    already unwrapped)."""

    __slots__ = ("_ev", "_result", "_exc")

    def __init__(self):
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[BaseException] = None

    def set_result(self, value) -> None:
        self._result = value
        self._ev.set()

    def set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"no reply within {timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class _ClientConn:
    """One live connection: socket + frame reader + (for v2) the pending
    request-id → future map the reader thread resolves. `fail` is the
    single teardown path — it poisons every pending future, wakes both a
    blocked serial caller and the reader, and releases the shm ring."""

    __slots__ = ("sock", "rd", "addr", "send_lock", "plock", "pending",
                 "next_rid", "proto", "shm", "shm_gone", "dead", "reader",
                 "stats", "sem")

    def __init__(self, sock: socket.socket, addr: str, max_inflight: int):
        self.sock = sock
        self.rd = _FrameReader(sock)
        self.addr = addr
        self.send_lock = threading.Lock()
        self.plock = threading.Lock()
        self.pending: Dict[int, _Future] = {}
        self.next_rid = 0
        self.proto = 1
        self.shm: Optional[_ShmRing] = None
        # set while no ring is attached or once the attached one is
        # unlinked: every `fail` waits on it, so whichever thread tears
        # the ring down, `close()` returns after the unlink
        self.shm_gone = threading.Event()
        self.shm_gone.set()
        self.dead: Optional[TransportError] = None
        self.reader: Optional[threading.Thread] = None
        self.stats = {"shm_blobs": 0, "shm_fallbacks": 0}
        self.sem = threading.Semaphore(max_inflight)

    def rid(self) -> int:
        with self.plock:
            r = self.next_rid
            self.next_rid += 1
            return r

    def has_pending(self) -> bool:
        with self.plock:
            return bool(self.pending)

    def pop_pending(self, rid) -> Optional[_Future]:
        with self.plock:
            fut = self.pending.pop(rid, None)
        if fut is not None:
            self.sem.release()
        return fut

    def submit(self, method: str, args, kwargs) -> _Future:
        """Register a future and put the request on the wire (v2 only).
        Raises TransportError with `.unsent = True` when the connection
        is already down (nothing hit the wire — safe to retry); a send
        failure fails the whole connection and re-raises ambiguous."""
        fut = _Future()
        self.sem.acquire()
        registered = False
        try:
            with self.plock:
                if self.dead is not None:
                    e = TransportError(
                        f"connection to {self.addr} is down: {self.dead}")
                    e.unsent = True
                    raise e
                rid = self.next_rid
                self.next_rid += 1
                self.pending[rid] = fut
            registered = True
        finally:
            if not registered:
                self.sem.release()
        try:
            with self.send_lock:
                _send_frame(self.sock,
                            {"i": rid, "m": method, "a": list(args),
                             "k": kwargs},
                            shm=self.shm, stats=self.stats)
        except TransportError as e:
            self.fail(e)
            raise
        return fut

    def send_notify(self, method: str, args, kwargs) -> None:
        with self.plock:
            if self.dead is not None:
                e = TransportError(
                    f"connection to {self.addr} is down: {self.dead}")
                e.unsent = True
                raise e
        with self.send_lock:
            _send_frame(self.sock,
                        {"m": method, "a": list(args), "k": kwargs, "n": 1},
                        shm=self.shm, stats=self.stats)

    def attach_ring(self, ring: "_ShmRing") -> None:
        with self.plock:
            self.shm = ring
            self.shm_gone.clear()

    def fail(self, exc: TransportError) -> None:
        """Tear the connection down. Both the caller of `close()` and the
        reader thread (woken by the shutdown) get here; the ring is taken
        under `plock`, so exactly one of them unlinks it, and the other
        waits for that unlink before returning."""
        with self.plock:
            if self.dead is None:
                self.dead = exc
            pending, self.pending = self.pending, {}
            shm, self.shm = self.shm, None
        for fut in pending.values():
            fut.set_exception(TransportError(str(exc)))
            self.sem.release()
        with contextlib.suppress(OSError):
            self.sock.shutdown(socket.SHUT_RDWR)
        with contextlib.suppress(OSError):
            self.sock.close()
        if shm is not None:
            try:
                shm.close()
            finally:
                self.shm_gone.set()
        self.shm_gone.wait(timeout=10.0)


class RpcClient:
    """One connection, pipelined when the peer speaks v2 (thread-safe:
    any number of threads may `call`/`call_async`/`notify` concurrently
    and share the connection — requests interleave on the wire and the
    reader thread routes each reply to its caller; against a legacy peer
    calls serialize on a lock exactly as before).

    Failure handling (the robustness plane):

    * `address` may be one endpoint, a comma-separated list, or a list —
      a failed attempt rotates to the next endpoint, so a `ModelPoolClient`
      handed `[replica, primary]` survives either dying.
    * connect failures and IDEMPOTENT call failures retry under the
      jittered-exponential-backoff `RetryPolicy` (pass `idempotent=True`
      to `call` — the seam wrappers do for `pull_if_changed`,
      `request_task`, `has_model`, `ping` and other pure reads).
    * a NON-idempotent call that fails after the request was (possibly)
      sent raises `RetryableError`: the side effect may have happened, so
      the caller must resolve it at the protocol layer instead of the
      transport resending blind. A failure guaranteed pre-wire carries
      `.unsent = True` and retries freely.
    * `abort()` (another thread) poisons the client: every in-flight call
      wakes with TransportError and NO further retry — a heartbeat
      monitor that declared the peer dead must not fight a 5s backoff.
    * a connection failure poisons ALL of its in-flight futures (the
      transport cannot know which requests the dead server processed).

    `call_async` submits without waiting and returns a `_Future`; against
    a legacy peer it degrades to the synchronous call with an
    already-resolved future. `notify` is one-way: no reply is ever
    generated server-side (v2) or the reply is drained and discarded
    (legacy); send failures drop the message (`notify_drops` counts) —
    beat/telemetry traffic must never block progress.

    `connect_retries`/`retry_delay_s` are the legacy knobs: they map onto
    `RetryPolicy(max_attempts=connect_retries, base_s=retry_delay_s,
    deadline_s=connect_retries * retry_delay_s)`, preserving the old
    worst-case wait while replacing the fixed sleep with jittered
    backoff."""

    def __init__(self, address: Union[str, Iterable[str]],
                 timeout: Optional[float] = None,
                 connect_retries: int = 50, retry_delay_s: float = 0.1,
                 retry: Optional[RetryPolicy] = None,
                 seed: Optional[int] = None,
                 pipeline: Optional[bool] = None,
                 shm: Optional[bool] = None,
                 shm_bytes: Optional[int] = None,
                 max_inflight: int = 256):
        if isinstance(address, str):
            self._endpoints = [a.strip() for a in address.split(",") if a.strip()]
        else:
            self._endpoints = list(address)
        assert self._endpoints, "RpcClient needs at least one endpoint"
        self._ep_i = 0
        self._timeout = timeout
        self._retry = retry or RetryPolicy(
            base_s=retry_delay_s, max_attempts=max(1, connect_retries),
            deadline_s=max(1, connect_retries) * retry_delay_s)
        self._rng = random.Random(seed)
        self._pipeline = _PIPELINE_ENABLED if pipeline is None else bool(pipeline)
        self._shm = _SHM_ENABLED if shm is None else bool(shm)
        self._shm_bytes = int(shm_bytes if shm_bytes is not None
                              else _SHM_DEFAULT_MB * (1 << 20))
        self._max_inflight = max(1, int(max_inflight))
        self._conn: Optional[_ClientConn] = None
        self._lock = threading.Lock()
        self._aborted = False
        self.notify_drops = 0

    @property
    def address(self) -> str:
        """The CURRENT endpoint (rotates on failover)."""
        return self._endpoints[self._ep_i]

    @property
    def endpoints(self) -> Tuple[str, ...]:
        return tuple(self._endpoints)

    # - connection lifecycle -------------------------------------------------
    def _ensure_conn(self) -> _ClientConn:
        """Return the live connection, dialing + negotiating a new one if
        needed. Every TransportError raised here carries `.unsent = True`
        — no caller request has touched the wire yet."""
        with self._lock:
            if self._aborted:
                e = TransportError(f"client for {self.address} was aborted")
                e.unsent = True
                raise e
            conn = self._conn
            if conn is not None and conn.dead is None:
                return conn
            self._conn = None
            host, port = parse_addr(self.address)
            try:
                sock = socket.create_connection((host, port), timeout=10.0)
            except OSError as e:
                err = TransportError(f"cannot connect to {self.address}: {e}")
                err.unsent = True
                raise err from e
            sock.settimeout(self._timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _ClientConn(sock, self.address, self._max_inflight)
            if self._pipeline:
                try:
                    self._negotiate(conn)
                except TransportError as e:
                    with contextlib.suppress(OSError):
                        sock.close()
                    e.unsent = True    # only the internal hello was on the wire
                    raise
            if conn.proto >= 2:
                t = threading.Thread(
                    target=self._reader_loop, args=(conn,),
                    name=f"rpc-reader@{self.address}", daemon=True)
                conn.reader = t
                t.start()
            self._conn = conn
            return conn

    def _negotiate(self, conn: _ClientConn) -> None:
        """Synchronous hello exchange (the reader is not running yet). A
        legacy server dispatches `__hello__`, fails to resolve it and
        answers `{"err": ...}` — that IS the negotiate-down signal; we
        stay on the serial v1 protocol over the same connection. A v2
        server acks with its proto/boot/shm capabilities; matching boot
        ids then negotiate the shm ring with a second exchange."""
        _send_frame(conn.sock, {"i": conn.rid(), "m": _HELLO_METHOD,
                                "a": [_PROTO], "k": {"boot": _BOOT_ID}})
        reply = conn.rd.recv()
        ack = reply.get("ok") if isinstance(reply, dict) else None
        if not isinstance(ack, dict):
            conn.proto = 1                 # legacy peer errored the hello
            return
        try:
            conn.proto = min(_PROTO, max(1, int(ack.get("proto", 1))))
        except (TypeError, ValueError):
            conn.proto = 1
        if not (conn.proto >= 2 and self._shm and ack.get("shm")
                and ack.get("boot") == _BOOT_ID):
            return
        try:
            ring = _ShmRing(self._shm_bytes)
        except Exception:                  # noqa: BLE001 — /dev/shm full or
            return                         # absent: silently stay on TCP
        try:
            _send_frame(conn.sock, {"i": conn.rid(), "m": _SHM_METHOD,
                                    "a": [ring.name, ring.size], "k": {}})
            ack2 = conn.rd.recv()
        except TransportError:
            ring.close()
            raise
        if isinstance(ack2, dict) and ack2.get("ok"):
            conn.attach_ring(ring)
        else:
            ring.close()

    def _reader_loop(self, conn: _ClientConn) -> None:
        """Route id-tagged replies to their futures, out of order. A
        socket timeout only kills the connection when replies are owed;
        an idle pipelined connection waits forever (liveness is the
        heartbeat plane's job, not the transport's)."""
        while True:
            try:
                msg = conn.rd.recv(idle_ok=True)
            except _IdleTimeout:
                if conn.has_pending():
                    conn.fail(TransportError(
                        f"timed out after {self._timeout}s waiting for a "
                        f"reply from {conn.addr}"))
                    return
                continue
            except TransportError as e:
                conn.fail(e)
                return
            except Exception as e:         # noqa: BLE001 — a decode bug must
                conn.fail(TransportError(f"reader failed: {e}"))
                return
            rid = msg.get("i") if isinstance(msg, dict) else None
            fut = conn.pop_pending(rid)
            if fut is None:
                continue                   # stale reply after a local drop
            if "err" in msg:
                fut.set_exception(RemoteError(msg["err"], msg.get("tb", "")))
            else:
                fut.set_result(msg.get("ok"))

    def _drop_conn(self, conn: _ClientConn, exc: TransportError) -> None:
        with self._lock:
            if self._conn is conn:
                self._conn = None
        conn.fail(exc)

    def _rotate(self) -> None:
        if len(self._endpoints) > 1:
            self._ep_i = (self._ep_i + 1) % len(self._endpoints)

    # - the three call shapes ------------------------------------------------
    def call(self, method: str, *args, idempotent: bool = False, **kwargs):
        """Submit and await one reply (the classic shape). Pipelined
        under v2 — other threads' calls overlap on the same connection;
        serial with the connection lock held across the round trip under
        v1."""
        delays = self._retry.delays(self._rng)
        last: Optional[TransportError] = None
        while True:
            if self._aborted:
                raise last or TransportError(
                    f"client for {self.address} was aborted")
            sent = False
            conn: Optional[_ClientConn] = None
            try:
                conn = self._ensure_conn()
                if conn.proto >= 2:
                    sent = True
                    fut = conn.submit(method, args, kwargs)
                    return fut.result()    # RemoteError propagates, no retry
                with conn.send_lock:
                    sent = True
                    _send_frame(conn.sock,
                                {"m": method, "a": list(args), "k": kwargs})
                    reply = conn.rd.recv()
                if "err" in reply:
                    raise RemoteError(reply["err"], reply.get("tb", ""))
                return reply.get("ok")
            except TransportError as e:
                if conn is not None:
                    self._drop_conn(conn, e)
                last = e
                if self._aborted:
                    raise
                if sent and not idempotent and not getattr(e, "unsent", False):
                    raise RetryableError(
                        f"{method} may or may not have executed on "
                        f"{self.address}: {e}") from e
                try:
                    delay = next(delays)
                except StopIteration:
                    raise TransportError(
                        f"cannot reach any of {self._endpoints} "
                        f"for {method}: {last}") from last
                self._rotate()
                if delay > 0:
                    time.sleep(delay)

    def call_async(self, method: str, *args, **kwargs) -> _Future:
        """Submit without waiting; returns a `_Future` whose `result()`
        yields the reply value or raises RemoteError/TransportError. One
        attempt, no retry loop — a connect failure raises immediately
        (with `.unsent = True`) so fan-out callers can fail over fast.
        Against a legacy peer this degrades to the synchronous retrying
        `call` wrapped in an already-resolved future."""
        if self._aborted:
            e = TransportError(f"client for {self.address} was aborted")
            e.unsent = True
            raise e
        conn = self._ensure_conn()
        if conn.proto >= 2:
            try:
                return conn.submit(method, args, kwargs)
            except TransportError as e:
                self._drop_conn(conn, e)
                raise
        fut = _Future()
        try:
            fut.set_result(self.call(method, *args, **kwargs))
        except (TransportError, RemoteError) as e:
            fut.set_exception(e)
        return fut

    def notify(self, method: str, *args, **kwargs) -> bool:
        """One-way fire-and-forget: no reply is consumed, so no round
        trip is paid (under v2 the server generates no reply at all).
        Returns False — and counts `notify_drops` — instead of raising
        when the message could not be handed to the wire; beat and
        telemetry traffic must never block or kill progress."""
        if self._aborted:
            self.notify_drops += 1
            return False
        try:
            conn = self._ensure_conn()
        except TransportError:
            self.notify_drops += 1
            return False
        try:
            if conn.proto >= 2:
                conn.send_notify(method, args, kwargs)
            else:
                with conn.send_lock:
                    _send_frame(conn.sock,
                                {"m": method, "a": list(args), "k": kwargs})
                    conn.rd.recv()         # drain + discard the v1 reply
        except TransportError as e:
            self._drop_conn(conn, e)
            self.notify_drops += 1
            return False
        return True

    # - teardown + introspection ---------------------------------------------
    def close(self) -> None:
        with self._lock:
            conn, self._conn = self._conn, None
        if conn is not None:
            conn.fail(TransportError(f"client for {conn.addr} closed"))

    def abort(self) -> None:
        """Force-close from ANOTHER thread: fails the connection, which
        shuts the socket down (waking a v1 caller blocked in recv and the
        v2 reader) and poisons every pipelined future. Poisons the client
        against further retries. Deliberately takes no client lock — a
        blocked caller may be holding it."""
        self._aborted = True
        conn = self._conn
        if conn is not None:
            conn.fail(TransportError(
                f"client for {self.address} was aborted"))

    def transport_stats(self) -> dict:
        """Negotiation + fast-path counters for benches and tests."""
        conn = self._conn
        shm = conn.shm if conn is not None else None
        return {
            "proto": conn.proto if conn is not None else 0,
            "shm": shm is not None,
            "shm_blobs": conn.stats["shm_blobs"] if conn is not None else 0,
            "shm_fallbacks": (conn.stats["shm_fallbacks"]
                              if conn is not None else 0),
            "shm_wraps": shm.wraps if shm is not None else 0,
            "notify_drops": self.notify_drops,
        }


class _ShipFuture:
    """Future for a non-idempotent async ship (`put_when_room_async`):
    a transport failure after the frame may have hit the wire surfaces
    as `RetryableError` from `result()`, exactly like the synchronous
    call raising it — the caller resolves the ambiguity (a duplicated or
    lost segment is just data). A pre-wire failure (`.unsent`) passes
    through as plain TransportError: safe to resubmit."""

    __slots__ = ("_fut", "_addr")

    def __init__(self, fut: _Future, addr: str):
        self._fut = fut
        self._addr = addr

    def done(self) -> bool:
        return self._fut.done()

    def result(self, timeout: Optional[float] = None):
        try:
            return self._fut.result(timeout)
        except RetryableError:
            raise
        except TransportError as e:
            if getattr(e, "unsent", False):
                raise
            raise RetryableError(
                f"put_when_room may or may not have executed on "
                f"{self._addr}: {e}") from e


class _NamespaceClient:
    """Shared plumbing: bind an RpcClient (or address/endpoint-list) to
    one namespace. `_get` marks the call idempotent — safe to resend with
    backoff and to fail over across endpoints. `_notify` is one-way,
    `_call_async` returns a future (both degrade against legacy peers —
    see RpcClient)."""

    def __init__(self, client, ns: str):
        self._c = client if isinstance(client, RpcClient) else RpcClient(client)
        self._ns = ns

    def _call(self, name: str, *args, **kwargs):
        return self._c.call(f"{self._ns}.{name}", *args, **kwargs)

    def _get(self, name: str, *args, **kwargs):
        return self._c.call(f"{self._ns}.{name}", *args, idempotent=True,
                            **kwargs)

    def _call_async(self, name: str, *args, **kwargs) -> _Future:
        return self._c.call_async(f"{self._ns}.{name}", *args, **kwargs)

    def _notify(self, name: str, *args, **kwargs) -> bool:
        return self._c.notify(f"{self._ns}.{name}", *args, **kwargs)

    def ping(self) -> bool:
        """Idempotent liveness probe against the namespace's server; True
        when any method on it answers (the remote `ping` if it exists).
        Deliberately a round trip, NOT a notify — liveness consumers
        (the heartbeat monitor) need the reply."""
        try:
            self._get("ping")
        except RemoteError:
            pass                       # server is up, ns just has no ping
        return True

    def transport_stats(self) -> dict:
        return self._c.transport_stats()

    def close(self) -> None:
        self._c.close()

    def abort(self) -> None:
        """Wake blocked in-flight calls with TransportError (see
        `RpcClient.abort`)."""
        self._c.abort()


# -- seam wrappers -----------------------------------------------------------
class ModelPoolClient(_NamespaceClient):
    """Remote `repro_torch.core.ModelPool` with a LOCAL VERSION CACHE: `pull`
    sends the cached version number, and the server answers with a
    `NotModified` tag (cache hit — zero param bytes move), the changed
    leaves only (grafted onto the cached copy), or the full pytree
    (first pull / prehistoric cache). Callers written against the plain
    pool API therefore get hash-gated delta pulls for free.

    Cache-hit and delta pulls return the cached object BY REFERENCE —
    read-only by contract, like a `copy=False` local pull. Pass
    `copy=True` (the Learner's post-freeze adopt does) for a private
    deep copy the caller may feed to a donating train step. Every array
    that does cross the wire lands in fresh buffers, so corruption by a
    remote writer remains impossible by construction."""

    def __init__(self, client, ns: str = "pool", write_client=None):
        super().__init__(client, ns)
        # the cache logic itself lives in CachedPuller (it drives our raw
        # pull_if_changed below); this class only adds the lock and the
        # copy-on-request semantics
        self._puller = CachedPuller(self)
        self._cache_lock = threading.Lock()
        # reads may fail over across replicas (`client` can be an endpoint
        # list), but WRITES must land on the primary: a separate pinned
        # connection when the read path is replicated
        self._w = (write_client if (write_client is None or
                                    isinstance(write_client, RpcClient))
                   else RpcClient(write_client))

    def _write(self, name: str, *args, **kwargs):
        if self._w is not None:
            return self._w.call(f"{self._ns}.{name}", *args, **kwargs)
        return self._call(name, *args, **kwargs)

    def _read(self, name: str, *args, **kwargs):
        """Keyed read with replica-lag fallback: a replica that hasn't
        synced a freshly-minted key yet answers `RemoteError(KeyError)`
        — the server is alive, so endpoint failover never triggers.
        When a pinned primary exists, retry the read there; the primary
        minted the key, so it always has it."""
        try:
            return self._get(name, *args, **kwargs)
        except RemoteError as e:
            if self._w is None or not str(e).startswith("KeyError"):
                raise
            return self._w.call(f"{self._ns}.{name}", *args, **kwargs)

    def pull(self, key: ModelKey, copy: Optional[bool] = None):
        with self._cache_lock:
            params = self._puller.get(key)
        return tree_copy(params) if copy else params

    def drop(self, key: ModelKey) -> None:
        """Evict `key` from the local version cache (a model-sized
        allocation): callers that pull a key once and then sync through
        their own CachedPuller should drop it so two copies aren't
        pinned for the process lifetime."""
        with self._cache_lock:
            self._puller.drop(key)

    def clear_cache(self) -> None:
        with self._cache_lock:
            self._puller.clear()

    def pull_if_changed(self, key: ModelKey,
                        have_version: Optional[int] = None,
                        copy: Optional[bool] = None, have_hashes=None):
        """The raw protocol call (no client-side caching — `CachedPuller`
        or `pull` own the cache). `copy` is accepted for signature
        compatibility; remote arrays are fresh by construction.
        `have_hashes` rides through to the pool's cross-key content
        addressing: leaves the caller already holds (under any key) come
        back as hash references instead of bytes."""
        if have_hashes is None:
            return self._read("pull_if_changed", key, have_version)
        return self._read("pull_if_changed", key, have_version,
                          have_hashes=sorted(have_hashes))

    def manifest(self, key: ModelKey) -> ParamManifest:
        return self._read("manifest", key)

    def version(self, key: ModelKey) -> int:
        return self._read("version", key)

    def push(self, key: ModelKey, params, step: int = 0) -> None:
        self._write("push", key, params, step=step)

    def pull_attr(self, key: ModelKey) -> dict:
        return self._read("pull_attr", key)

    def freeze(self, key: ModelKey) -> None:
        self._write("freeze", key)

    def keys(self):
        return self._get("keys")

    def __contains__(self, key: ModelKey) -> bool:
        return key in self.keys()

    @property
    def membership_version(self) -> int:
        return self._get("membership_version")

    def close(self) -> None:
        super().close()
        if self._w is not None:
            self._w.close()

    def abort(self) -> None:
        super().abort()
        if self._w is not None:
            self._w.abort()


class LeagueMgrClient(_NamespaceClient):
    """Remote `repro_torch.core.LeagueMgr` — the Actor/Learner-facing slice of
    the league protocol (request_task/report_result on the actor side,
    should_freeze/end_learning_period on the learner side). `model_pool`
    is a `ModelPoolClient` over the same connection, so code written
    against the in-process LeagueMgr (`league.model_pool.pull(...)`) runs
    unchanged against the remote one."""

    def __init__(self, client, ns: str = "league", pool_ns: str = "pool",
                 pool_endpoints: Optional[Union[str, Iterable[str]]] = None):
        super().__init__(client, ns)
        if pool_endpoints:
            # replicated read path: pulls fail over across the endpoint
            # list; writes (push/freeze) stay pinned to the coordinator's
            # authoritative pool over this client's own connection
            self.model_pool = ModelPoolClient(
                RpcClient(pool_endpoints), ns=pool_ns, write_client=self._c)
        else:
            self.model_pool = ModelPoolClient(self._c, ns=pool_ns)

    def request_task(self, agent_id: str = "main",
                     actor_id: Optional[str] = None) -> Task:
        # idempotent by lease design: a duplicate issue is just an extra
        # lease the reaper collects once its TTL lapses
        if actor_id is None:
            return self._get("request_task", agent_id)
        return self._get("request_task", agent_id, actor_id=actor_id)

    def request_learner_task(self, agent_id: str = "main") -> Task:
        return self._get("request_learner_task", agent_id)

    def report_result(self, result: MatchResult) -> None:
        # NOT idempotent: double-recording an outcome skews the payoff
        # matrix — an ambiguous failure surfaces as RetryableError and the
        # lease generation guard makes the caller's choice safe either way
        self._call("report_result", result)

    def pool_winrate(self, agent_id: str) -> Tuple[float, float]:
        return tuple(self._get("pool_winrate", agent_id))

    def should_freeze(self, agent_id: str, steps: int) -> Optional[str]:
        return self._get("should_freeze", agent_id, steps)

    def end_learning_period(self, agent_id: str, params,
                            reason: str = "period") -> ModelKey:
        return self._call("end_learning_period", agent_id, params,
                          reason=reason)

    def league_state(self) -> dict:
        return self._get("league_state")

    def lease_state(self) -> dict:
        return self._get("lease_state")

    @property
    def frozen_pool(self):
        return list(self._get("frozen_pool"))

    @property
    def agents(self):
        """Remote agent registry shaped like the in-process
        `LeagueMgr.agents` just enough for `Learner.current_key`
        (`league.agents[aid].current`). Lazy: indexing returns a view
        whose `.current` is ONE small `current_model_key` RPC — not a
        full `league_state` dump, which Learner.learn would otherwise
        trigger on every published step."""
        return _RemoteAgents(self)

    def close(self) -> None:
        self.model_pool.close()      # may own a separate replica connection
        super().close()

    def abort(self) -> None:
        self.model_pool.abort()
        super().abort()


class _RemoteAgents:
    def __init__(self, league: "LeagueMgrClient"):
        self._league = league

    def __getitem__(self, agent_id: str) -> SimpleNamespace:
        key = self._league._get("current_model_key", agent_id)
        return SimpleNamespace(current=key)


class RemoteTicket:
    """Client-side future for a submitted batch; mirrors `infserver.Ticket`
    (the integer ticket id is what actually crossed the wire). Under the
    pipelined protocol the id itself may still be in flight
    (`submit_async`): `tid` resolves it lazily on first touch, so a
    collector can stage its next submit before the previous ack lands."""
    __slots__ = ("_tid", "model", "rows", "_client")

    def __init__(self, tid, model, rows: int, client: "InfServerClient"):
        self._tid, self.model, self.rows, self._client = \
            tid, model, rows, client

    @property
    def tid(self) -> int:
        t = self._tid
        if not isinstance(t, int):
            self._tid = t = int(t.result())
        return t

    def done(self) -> bool:
        return self._client.poll(self.tid)

    def result(self):
        return self._client.get(self)

    def __int__(self) -> int:
        return self.tid

    def __repr__(self):
        t = self._tid if isinstance(self._tid, int) else "<pending>"
        return f"RemoteTicket({t}, model={self.model!r}, rows={self.rows})"


class InfServerBackend:
    """Server-side adapter: `infserver.Ticket` holds a live server
    reference, so over the wire only its integer id travels. `submit`
    returns the id, `get` accepts it back, `poll` is the non-blocking
    probe.

    Outstanding tickets are bounded (`max_outstanding`): a client that
    submits and then dies would otherwise leak its ticket — and, once
    flushed, its result arrays — forever in a long-lived serving process.
    Beyond the cap the oldest unfetched ticket is discarded server-side
    (its later `get` raises KeyError, which a live client would see as a
    RemoteError rather than silent wrong data)."""

    def __init__(self, server, max_outstanding: int = 4096):
        self._server = server
        self._max_outstanding = max_outstanding
        self._tickets: Dict[int, Any] = {}       # insertion-ordered
        self._lock = threading.Lock()

    def submit(self, obs, model: Hashable = None,
               deadline_s: Optional[float] = None) -> int:
        # `deadline_s` is accepted so a gateway-aware client can talk to
        # a single server unchanged; a lone InfServer is size-bucketed
        # only, so the hint is ignored rather than raised on.
        t = self._server.submit(np.asarray(obs), model=model)
        with self._lock:
            self._tickets[t.tid] = t
            while len(self._tickets) > self._max_outstanding:
                stale = next(iter(self._tickets))
                self._server.discard(self._tickets.pop(stale))
        return t.tid

    def poll(self, tid: int) -> bool:
        with self._lock:
            t = self._tickets.get(tid)
        return bool(t is not None and t.done())

    def get(self, tid: int):
        with self._lock:
            t = self._tickets.pop(tid)
        a, logp, v = self._server.get(t)
        return np.asarray(a), np.asarray(logp), np.asarray(v)

    def flush(self) -> None:
        self._server.flush()

    def update_params(self, params, key: Hashable = None,
                      content_hash: Optional[str] = None,
                      version: Optional[int] = None) -> None:
        self._server.update_params(params, key=key,
                                   content_hash=content_hash,
                                   version=version)

    def ensure_model(self, key: Hashable, params,
                     content_hash: Optional[str] = None) -> None:
        self._server.ensure_model(key, params, content_hash=content_hash)

    def register_model(self, key: Hashable, params,
                       content_hash: Optional[str] = None,
                       version: Optional[int] = None) -> None:
        self._server.register_model(key, params, content_hash=content_hash,
                                    version=version)

    def has_model(self, key: Hashable,
                  content_hash: Optional[str] = None) -> bool:
        return self._server.has_model(key, content_hash=content_hash)

    def evict_model(self, key: Hashable) -> bool:
        return self._server.evict_model(key)

    def stats(self) -> dict:
        return self._server.stats()

    def telemetry(self) -> dict:
        return self._server.telemetry()


class InfServerClient(_NamespaceClient):
    """Remote `repro_torch.infserver.InfServer` speaking the same
    submit/flush/get protocol as the in-process server, so
    `build_served_rollout` (and therefore a served Actor) can run against
    either without knowing which it has. The `*_async` variants pipeline
    submits/probes on the shared connection — a collector overlaps its
    per-slot submits, the gateway fans probes across a fleet."""

    def __init__(self, client, ns: str = "inf"):
        super().__init__(client, ns)

    def submit(self, obs: np.ndarray, model: Hashable = None,
               deadline_s: Optional[float] = None) -> RemoteTicket:
        """`deadline_s` rides along only when set: a plain
        `InfServerBackend` has no deadline notion (size-bucketed only),
        a `serving.GatewayBackend` feeds it to the SLO pump."""
        obs = np.asarray(obs)
        if deadline_s is None:
            tid = self._call("submit", obs, model=model)
        else:
            tid = self._call("submit", obs, model=model,
                             deadline_s=deadline_s)
        return RemoteTicket(tid, model, obs.shape[0], self)

    def submit_async(self, obs: np.ndarray, model: Hashable = None,
                     deadline_s: Optional[float] = None) -> RemoteTicket:
        """Pipelined submit: returns immediately with a ticket whose id
        resolves lazily (first `get`/`poll`/`int()` touch). Lets a caller
        put several submits on the wire back to back — the obs rows ride
        the shm ring when negotiated — before awaiting any ack."""
        obs = np.asarray(obs)
        if deadline_s is None:
            fut = self._call_async("submit", obs, model=model)
        else:
            fut = self._call_async("submit", obs, model=model,
                                   deadline_s=deadline_s)
        return RemoteTicket(fut, model, obs.shape[0], self)

    def poll(self, tid) -> bool:
        return self._get("poll", int(tid))

    def get(self, ticket):
        return tuple(self._call("get", int(ticket)))

    def flush(self) -> None:
        self._call("flush")

    def flush_async(self) -> _Future:
        return self._call_async("flush")

    def update_params(self, params, key: Hashable = None,
                      content_hash: Optional[str] = None,
                      version: Optional[int] = None) -> None:
        """Hash-gated hot-swap over RPC: with a `content_hash`, a cheap
        `has_model` probe runs first and the params are NOT shipped when
        the server already hosts that exact content — the common case
        for every actor but the first to refresh a route."""
        if content_hash is not None and self._get("has_model", key,
                                                  content_hash):
            return
        self._call("update_params", params, key=key,
                   content_hash=content_hash, version=version)

    def ensure_model(self, key: Hashable, params,
                     content_hash: Optional[str] = None) -> None:
        """Idempotent route setup; with a `content_hash` the params only
        cross the wire when the route is absent or stale."""
        if content_hash is not None and self._get("has_model", key,
                                                  content_hash):
            return
        self._call("ensure_model", key, params, content_hash=content_hash)

    def register_model(self, key: Hashable, params,
                       content_hash: Optional[str] = None,
                       version: Optional[int] = None) -> None:
        self._call("register_model", key, params, content_hash=content_hash,
                   version=version)

    def has_model(self, key: Hashable,
                  content_hash: Optional[str] = None) -> bool:
        return self._get("has_model", key, content_hash)

    def has_model_async(self, key: Hashable,
                        content_hash: Optional[str] = None) -> _Future:
        return self._call_async("has_model", key, content_hash)

    def evict_model(self, key: Hashable) -> bool:
        return self._call("evict_model", key)

    def stats(self) -> dict:
        """Full server telemetry across the seam — `InfServer.stats()`
        verbatim (occupancy, per-batch latency, swap + dispatch
        counters). The gateway's router reads the cheap `telemetry()`
        probe instead at steady state; this is the operator view."""
        return self._get("stats")

    def telemetry(self) -> dict:
        """The high-cadence occupancy/latency probe (see
        `InfServer.telemetry`) — the routing signal crossing the RPC
        seam."""
        return self._get("telemetry")

    def telemetry_async(self) -> _Future:
        """Pipelined telemetry probe — the gateway fans these across its
        fleet with a shared deadline so one stalled replica only goes
        stale, never freezes the occupancy view."""
        return self._call_async("telemetry")


class DataServerClient(_NamespaceClient):
    """Remote `repro_torch.learners.DataServer` put-side: the Actor→Learner data
    seam. The DataServer lives in the Learner's process (the paper
    embeds it there); Actors connect here to ship segments. Backpressure
    crosses the boundary: `put_when_room` blocks server-side under the
    ring's condition variable and returns False on timeout exactly like
    the in-process call. `put_when_room_async` overlaps that server-side
    backpressure wait with the actor staging its NEXT segment."""

    def __init__(self, client, ns: str = "data"):
        super().__init__(client, ns)

    def put(self, traj) -> None:
        self._call("put", traj)

    def put_when_room(self, traj, timeout: Optional[float] = None) -> bool:
        return self._call("put_when_room", traj, timeout=timeout)

    def put_when_room_async(self, traj,
                            timeout: Optional[float] = None) -> _ShipFuture:
        """Ship a segment without blocking on the server's admission
        decision: the bulk rows go on the wire (or shm ring) now and the
        returned future resolves to the server's True/False once the ring
        admits or times the segment out. Failure semantics match the
        sync call: ambiguous-after-send surfaces as `RetryableError` from
        `result()`; a failure guaranteed pre-wire falls back to the
        retrying synchronous path before giving up."""
        try:
            fut = self._c.call_async(f"{self._ns}.put_when_room", traj,
                                     timeout=timeout)
        except TransportError as e:
            fut = _Future()
            if getattr(e, "unsent", False):
                # nothing hit the wire — the retrying sync path may still
                # land it (endpoint rotation, backoff)
                try:
                    fut.set_result(
                        self._call("put_when_room", traj, timeout=timeout))
                except (TransportError, RemoteError) as e2:
                    fut.set_exception(e2)
            else:
                fut.set_exception(e)
        return _ShipFuture(fut, self._c.address)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        return self._call("wait_ready", timeout=timeout)

    def ready(self) -> bool:
        return self._get("ready")

    def throughput(self) -> dict:
        return self._get("throughput")

    def last_sample_info(self):
        return self._call("last_sample_info")

    def update_priorities(self, slots, priorities, gen=None) -> None:
        """Prioritized-replay write-back over the wire: a remote learner
        (or a priority-computing sidecar) echoes the sampled slots and
        generations back with fresh priorities; the server drops updates
        for rows the ring has overwritten since.

        One-way by design: no caller ever consumed the applied-count the
        server used to return, and the generation guard already makes a
        LOST update harmless (stale rows keep their old priority until
        resampled) — so the learner's train loop no longer pays a round
        trip per batch."""
        self._notify("update_priorities", slots, priorities, gen=gen)


# -- one-call league server ---------------------------------------------------
def serve_league(league, inf_server=None, *, extra: Optional[Dict[str, Any]] = None,
                 host: str = "127.0.0.1", port: int = 0,
                 fault_plan: Optional[FaultPlan] = None) -> RpcServer:
    """Put a LeagueMgr (namespace `league`), its ModelPool (`pool`) and
    optionally an InfServer (`inf`, ticket ids over the wire) behind one
    started RpcServer. `extra` adds more namespaces (the multiprocess
    driver's `ctrl` plane). `fault_plan` arms the chaos harness on every
    namespace. Close the returned server to tear down."""
    objects: Dict[str, Any] = {"league": league, "pool": league.model_pool}
    if inf_server is not None:
        objects["inf"] = InfServerBackend(inf_server)
    objects.update(extra or {})
    return RpcServer(objects, host=host, port=port,
                     fault_plan=fault_plan).start()
