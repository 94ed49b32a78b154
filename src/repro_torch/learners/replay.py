"""DataServer + ring-buffer replay: the Learner's embedded data path (§3.2);
counterpart of `repro.learners.replay`.

Receives trajectory segments from Actors, stores them in a preallocated
NumPy ring buffer keyed by the trajectory structure, serves minibatches to
the train step, and tracks the paper's throughput telemetry: rfps (frames
received / sec) and cfps (frames consumed / sec); cfps/rfps is the average
learn-repeat ratio, and a `blocking` mode makes cfps track rfps for
on-policy PPO (§4.4).

Storage layout: every trajectory leaf shares a leading "row" axis (one row
= one unroll of `unroll_len` frames), so the buffer is one fixed array per
leaf of shape (row_slots,) + leaf.shape[1:], allocated once from the first
segment's structure. Leaves are taken in `jax.tree_util`'s order (dict keys
sorted; `utils.pytree.tree_flatten_with_path`), so the ring, the rows a
sampler draws and the batches `sample()` returns are those of `repro`'s
DataServer for the same puts and seed. `put` writes rows into fixed slots
with at most two contiguous copies, `sample` is one vectorized gather per
leaf and returns host numpy arrays, and capacity is expressed in frames.

Device feeding: `sample_to_device` returns the minibatch as tensors on
`device` (CUDA unless the caller asks for the CPU) and overlaps the
host-to-device copy with the learner's compute: the *next* minibatch's rows
become known at `put` in blocking (on-policy) mode, and right after the
current sample otherwise, and one staging thread then

1. gathers them (`np.take(..., out=)`) into preallocated pinned host
   buffers, two per leaf used in turn, each written again only after its
   own previous copy has completed;
2. issues `non_blocking` copies into fresh device tensors on a side CUDA
   stream and records an event behind them.

`sample_to_device` makes the caller's current stream wait on that event and
calls `record_stream` on the tensors it hands over, so the caching
allocator never reuses them while the caller's kernels still read them.
The staging thread gathers without the server's lock: a `put` that lands
meanwhile advances the state token, and a staged batch whose token is stale
is never served. On the CPU the staged tensors are plain tensors over
freshly gathered arrays, so a batch is always the caller's own.
"""
from __future__ import annotations

import concurrent.futures
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.learners.samplers import make_sampler
from repro_torch.utils import resolve_device
from repro_torch.utils.pytree import tree_flatten_with_path, tree_unflatten


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Stager:
    """The staging worker's state: a side stream and, per batch shape, two
    pinned buffers per leaf with the copy event of each. Only the staging
    thread touches it."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream: Optional[torch.cuda.Stream] = None
        self.shapes = None
        self.pinned: List[List[torch.Tensor]] = []
        self.events: List[Optional[torch.cuda.Event]] = [None, None]
        self.turn = 0

    def stage(self, buffers: List[np.ndarray], idx: np.ndarray):
        """Gather `idx` rows of every ring leaf and start their upload.
        Returns (tensors, copy event or None)."""
        if self.device.type != "cuda":
            return [torch.from_numpy(np.take(b, idx, axis=0)) for b in buffers], None
        if self.stream is None:
            self.stream = torch.cuda.Stream(self.device)
        shapes = [(len(idx),) + b.shape[1:] for b in buffers]
        if shapes != self.shapes:
            for ev in self.events:          # old buffers may still be copying
                if ev is not None:
                    ev.synchronize()
            self.shapes = shapes
            self.pinned = [[torch.from_numpy(np.empty(s, b.dtype)).pin_memory()
                            for s, b in zip(shapes, buffers)] for _ in range(2)]
            self.events = [None, None]
        k, self.turn = self.turn, 1 - self.turn
        if self.events[k] is not None:
            self.events[k].synchronize()    # its last copy has left the buffer
        host = self.pinned[k]
        for b, h in zip(buffers, host):
            np.take(b, idx, axis=0, out=h.numpy())
        with torch.cuda.stream(self.stream):
            out = [torch.empty(h.shape, dtype=h.dtype, device=self.device) for h in host]
            for o, h in zip(out, host):
                o.copy_(h, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self.events[k] = ev
        return out, ev


class DataServer:
    def __init__(self, *, capacity_frames: Optional[int] = None, seed: int = 0,
                 blocking: bool = True, capacity_segments: int = 64,
                 prefetch: bool = True, device=None, sampler="uniform",
                 sampler_kwargs: Optional[dict] = None):
        """`capacity_frames` bounds the buffer in frames (rows * unroll_len).
        When omitted, the `capacity_segments` bound is translated to frames
        at first `put` (segments * frames-per-segment).

        `prefetch` enables the double-buffered `sample_to_device` staging;
        `device` is where `sample_to_device` puts its tensors: CUDA when
        None (raising where there is none), the CPU when asked by name.

        `sampler` selects the off-policy sampling strategy — a name from
        `repro_torch.learners.samplers.SAMPLERS` ("uniform" | "prioritized"
        | "episode", kwargs via `sampler_kwargs`) or a `Sampler` instance.
        The blocking-mode newest-segment fast path is independent of it."""
        self.capacity_frames = capacity_frames
        self.capacity_segments = capacity_segments
        self.rng = np.random.default_rng(seed)
        self.sampler = make_sampler(sampler, **(sampler_kwargs or {}))
        self.sampler.bind(self)
        # producer/consumer concurrency: every mutation runs under one
        # reentrant lock; the condition signals both directions — `put`
        # wakes learners blocked in `wait_ready`, consumption wakes actors
        # blocked in `wait_for_room` (ring-full backpressure)
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self.blocking = blocking
        self.prefetch = prefetch
        self.device = resolve_device(device)
        self._staged = None      # (state_token, batch_rows, idx, Future)
        # one staging thread: every gather into the pinned buffers and every
        # upload runs on it, so they serialize among themselves but overlap
        # the learner's compute; lazily created at first use
        self._stage_pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._stager = _Stager(self.device)
        self.prefetch_hits = 0
        self.prefetch_misses = 0
        self.frames_received = 0
        self.frames_consumed = 0
        # lifetime rates start at the FIRST put, not construction — else
        # rfps/cfps average over pre-first-put idle time; the window
        # trackers feed the since-last-`throughput()`-call rates
        self._t0: Optional[float] = None
        self._win_t: Optional[float] = None
        self._win_rx = 0
        self._win_cx = 0
        self._unconsumed = 0
        self._last_sample: Optional[dict] = None
        self._slot_gen: Optional[np.ndarray] = None   # overwrite generations
        self._write_seq = 0
        # ring state, allocated lazily from the first segment's structure
        self._treedef = None
        self._buffers: List[np.ndarray] = []
        self._row_shapes: List[tuple] = []
        self._row_slots = 0
        self._frames_per_row = 0
        self._head = 0          # next slot to write
        self._size = 0          # live rows
        self._last_rows: Optional[np.ndarray] = None  # slots of the newest segment

    # -- allocation --------------------------------------------------------------
    def _leaves(self, traj):
        flat, treedef = tree_flatten_with_path(traj)
        leaves = [_as_numpy(x) for _, x in flat]
        if self._treedef is None:
            self._treedef = treedef
            # frames-per-row (unroll length T) comes from the (rows, T)
            # actions leaf when present; row-only payloads count 1 frame/row
            t_len = 1
            if isinstance(traj, dict) and "actions" in traj:
                t_len = int(_as_numpy(traj["actions"]).shape[1])
            self._allocate_with_t(leaves, leaves[0].shape[0], t_len)
        else:
            assert treedef == self._treedef, (
                "trajectory structure changed mid-run: "
                f"{treedef} != {self._treedef}")
        return leaves

    def _allocate_with_t(self, leaves, rows: int, t_len: int) -> None:
        self._frames_per_row = max(1, t_len)
        cap_frames = self.capacity_frames
        if cap_frames is None:
            cap_frames = self.capacity_segments * rows * self._frames_per_row
        self._row_slots = max(rows, cap_frames // self._frames_per_row)
        self._row_shapes = [leaf.shape[1:] for leaf in leaves]
        self._buffers = [np.zeros((self._row_slots,) + s, dtype=leaf.dtype)
                         for s, leaf in zip(self._row_shapes, leaves)]
        self._slot_gen = np.zeros(self._row_slots, np.int64)
        self.sampler.on_allocate(self._row_slots)

    @staticmethod
    def _row_done(traj) -> Optional[np.ndarray]:
        """Per-row terminal flags for episode-aware samplers: True where
        any frame of the row finished an episode; None when the payload
        carries no done signal."""
        if isinstance(traj, dict) and "done" in traj:
            d = _as_numpy(traj["done"])
            return d.reshape(d.shape[0], -1).any(axis=1)
        return None

    # -- actor side --------------------------------------------------------------
    def _write_rows(self, leaves, row_done=None, source=None) -> None:
        """Ring write + accounting + prefetch staging; caller holds the lock."""
        if self._t0 is None:
            self._t0 = self._win_t = time.monotonic()
        rows = leaves[0].shape[0]
        frames = rows * self._frames_per_row
        cap = self._row_slots
        assert rows <= cap, (
            f"segment of {rows} rows exceeds the {cap}-row ring "
            f"(capacity_frames={self.capacity_frames})")
        start = self._head
        first = min(rows, cap - start)
        for buf, leaf in zip(self._buffers, leaves):
            np.copyto(buf[start:start + first], leaf[:first])
            if first < rows:                       # wraparound: second copy
                np.copyto(buf[:rows - first], leaf[first:])
        self._last_rows = (start + np.arange(rows)) % cap
        self._head = (start + rows) % cap
        self._size = min(self._size + rows, cap)
        self._write_seq += 1
        self._slot_gen[self._last_rows] = self._write_seq
        self.sampler.on_write(self._last_rows, row_done=row_done,
                              source=source)
        self.frames_received += frames
        self._unconsumed += frames
        if self.prefetch and self.blocking:
            # on-policy: the next sample IS this segment — start its
            # host->device copy now so it overlaps the in-flight train step
            self._stage(self._last_rows, None)
        self._cond.notify_all()

    def put(self, traj, source=None) -> None:
        """Unconditional ring write: never blocks (lock only) and never
        fails for capacity — old rows are overwritten, which in blocking
        (on-policy) mode can bury frames the learner never saw. Producers
        that must not lose frames use `put_when_room`. The segment is
        COPIED into the preallocated ring (np.copyto), so the caller's
        arrays stay the caller's.

        `source` identifies the producer for episode-granularity
        samplers (rows of consecutive segments from one source chain
        into episodes); it defaults to the calling thread, which matches
        the league runtime's one-thread-per-actor layout."""
        with self._cond:
            self._write_rows(self._leaves(traj),
                             row_done=self._row_done(traj),
                             source=threading.get_ident()
                             if source is None else source)

    def put_when_room(self, traj, timeout: Optional[float] = None,
                      source=None) -> bool:
        """`put` with TOCTOU-safe backpressure: the room predicate (the
        segment fits without burying frames the learner has not consumed)
        and the ring write happen under ONE lock hold, so concurrent
        producers can never jointly overshoot capacity.

        MAY BLOCK up to `timeout` (forever when None) waiting for the
        learner to consume; returns False (nothing written) on timeout."""
        with self._cond:
            leaves = self._leaves(traj)
            frames = leaves[0].shape[0] * self._frames_per_row

            def room():
                cap = self.ring_capacity_frames
                return cap is None or self._unconsumed + frames <= cap
            if not self._cond.wait_for(room, timeout=timeout):
                return False
            self._write_rows(leaves, row_done=self._row_done(traj),
                             source=threading.get_ident()
                             if source is None else source)
            return True

    def wait_for_room(self, frames: int, timeout: Optional[float] = None) -> bool:
        """Advisory backpressure probe: block until a segment of `frames`
        frames currently fits. Racy by construction under multiple
        producers — producers that need the guarantee use `put_when_room`."""
        with self._cond:
            def room():
                cap = self.ring_capacity_frames
                return cap is None or self._unconsumed + frames <= cap
            return self._cond.wait_for(room, timeout=timeout)

    # -- learner side -----------------------------------------------------------
    def ready(self) -> bool:
        with self._lock:
            return self._size > 0 and (not self.blocking or self._unconsumed > 0)

    def wait_ready(self, timeout: Optional[float] = None) -> bool:
        """Block until `ready()` (a fresh segment in blocking mode, any data
        otherwise). True when ready, False on timeout."""
        with self._cond:
            return self._cond.wait_for(self.ready, timeout=timeout)

    def _sample_idx(self, batch_rows: Optional[int]) -> np.ndarray:
        if self.blocking and batch_rows is None:
            return self._last_rows                # freshness contract, not
        k = batch_rows if batch_rows is not None else len(self._last_rows)
        return self.sampler.sample(k)             # ... a sampling strategy

    def _record_sample(self, idx) -> None:
        """Remember the batch just served (slots + overwrite generations
        + IS weights) so the learner can push priorities back after its
        train step — `update_priorities` uses the generations to drop
        updates for slots the ring has since overwritten."""
        idx = np.asarray(idx)
        self._last_sample = {
            "slots": idx.copy(),
            "gen": None if self._slot_gen is None
            else self._slot_gen[idx].copy(),
            "weights": self.sampler.weights(idx),
        }

    def _consume(self, num_rows: int) -> None:
        frames = num_rows * self._frames_per_row
        self.frames_consumed += frames
        self._unconsumed = max(0, self._unconsumed - frames)
        self._cond.notify_all()        # wake producers blocked on backpressure

    def sample(self, batch_rows: Optional[int] = None):
        """Most-recent segment when blocking (on-policy); a sampler draw
        otherwise. Host (NumPy) arrays. Never blocks — asserts non-empty
        instead (gate on `ready()` / `wait_ready` first). The gather COPIES
        out of the ring, so later `put`s can never mutate the batch."""
        with self._cond:
            assert self._size > 0, "DataServer empty"
            idx = self._sample_idx(batch_rows)
            self._record_sample(idx)
            out_leaves = [buf[idx] for buf in self._buffers]
            self._consume(len(idx))
            return tree_unflatten(self._treedef, out_leaves)

    # -- pipelined device feeding -------------------------------------------------
    def _state_token(self) -> tuple:
        """Identity of the buffer state a staged batch was drawn from: any
        `put` advances frames_received, so a stale staged batch (rows since
        overwritten, or no longer the newest segment) can never be served."""
        return (self._head, self._size, self.frames_received)

    def _submit(self, idx: np.ndarray) -> concurrent.futures.Future:
        if self._stage_pool is None:
            self._stage_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dataserver-stage")
        return self._stage_pool.submit(self._stager.stage, self._buffers, idx)

    def _stage(self, idx: np.ndarray, for_batch_rows: Optional[int]) -> None:
        """`for_batch_rows` records which request shape the staged batch
        answers: a batch staged for the on-policy newest-segment request
        (None) must never satisfy an explicit `batch_rows` request — the
        row *distributions* differ, not just the sizes."""
        self._staged = (self._state_token(), for_batch_rows, idx, self._submit(idx))

    def sample_to_device(self, batch_rows: Optional[int] = None):
        """`sample`, but the minibatch lands as tensors on `device`, and the
        next minibatch's transfer is prefetched. Each batch is a set of
        freshly allocated tensors the caller owns."""
        with self._cond:
            assert self._size > 0, "DataServer empty"
            staged, self._staged = self._staged, None
            if (staged is not None and staged[0] == self._state_token()
                    and staged[1] == batch_rows):
                idx, fut = staged[2], staged[3]
                self.prefetch_hits += 1
            else:
                idx = self._sample_idx(batch_rows)
                fut = self._submit(idx)
                self.prefetch_misses += 1
            leaves, ev = fut.result()
            if ev is not None:
                stream = torch.cuda.current_stream(self.device)
                stream.wait_event(ev)
                for t in leaves:
                    t.record_stream(stream)
            self._record_sample(idx)
            self._consume(len(idx))
            if self.prefetch and not self.blocking:
                # off-policy: the next draw is known now — stage it
                # (blocking mode stages at `put`, when the next segment exists)
                self._stage(self._sample_idx(batch_rows), batch_rows)
            return tree_unflatten(self._treedef, leaves)

    # -- prioritized-replay consumer loop -----------------------------------------
    def last_sample_info(self) -> Optional[dict]:
        """Slots/generations/IS-weights of the most recent `sample`/
        `sample_to_device` batch (None before the first). The learner
        echoes slots+gen back through `update_priorities` after it knows
        the batch's TD errors."""
        with self._lock:
            return self._last_sample

    def update_priorities(self, slots, priorities, gen=None) -> int:
        """Consumer-side priority write-back. `priorities` may be a tensor on
        the card (it is brought to the host). `gen` (from
        `last_sample_info`) guards against the ring moving on: updates for
        slots overwritten since the sample are dropped. Returns the number
        of rows actually updated."""
        with self._cond:
            slots = np.asarray(_as_numpy(slots), np.int64).reshape(-1)
            priorities = np.asarray(_as_numpy(priorities), np.float64).reshape(-1)
            assert slots.shape == priorities.shape, \
                "one priority per sampled row"
            if gen is not None and self._slot_gen is not None:
                valid = self._slot_gen[slots] == np.asarray(gen).reshape(-1)
                slots, priorities = slots[valid], priorities[valid]
            if len(slots):
                self.sampler.update_priorities(slots, priorities)
                if (self._staged is not None
                        and getattr(self.sampler, "reweights", False)):
                    self._staged = None   # staged draw used stale priorities
            return int(len(slots))

    # -- introspection ------------------------------------------------------------
    @property
    def num_rows(self) -> int:
        return self._size

    @property
    def size_frames(self) -> int:
        return self._size * self._frames_per_row

    @property
    def ring_capacity_frames(self) -> Optional[int]:
        """Total ring capacity in frames; None before the first `put`
        allocates (capacity_frames unset) — no backpressure until known."""
        if self._row_slots:
            return self._row_slots * self._frames_per_row
        return self.capacity_frames

    @property
    def unconsumed_frames(self) -> int:
        return self._unconsumed

    # -- telemetry (paper Table 3) ----------------------------------------------
    def throughput(self) -> dict:
        """Lifetime rates (since the first `put`) plus windowed rates over
        the interval since the previous `throughput()` call."""
        with self._lock:
            now = time.monotonic()
            t0 = now if self._t0 is None else self._t0
            dt = max(now - t0, 1e-9)
            win_t = now if self._win_t is None else self._win_t
            wdt = max(now - win_t, 1e-9)
            rx_w = self.frames_received - self._win_rx
            cx_w = self.frames_consumed - self._win_cx
            self._win_t = now
            self._win_rx = self.frames_received
            self._win_cx = self.frames_consumed
            return {
                "rfps": self.frames_received / dt,
                "cfps": self.frames_consumed / dt,
                "rfps_window": rx_w / wdt,
                "cfps_window": cx_w / wdt,
                "repeat_ratio": self.frames_consumed / max(self.frames_received, 1),
                "prefetch_hits": self.prefetch_hits,
                "prefetch_misses": self.prefetch_misses,
            }


# Transport contract: both put paths COPY the segment into the
# preallocated ring (np.copyto in _write_rows) before returning, never
# retaining the caller's arrays — so the RPC server may hand them
# zero-copy views into the same-host shared-memory ring instead of
# privatizing the blobs first (see `distributed.transport._ShmReader`).
DataServer.put._zero_copy_ok = True
DataServer.put_when_room._zero_copy_ok = True
