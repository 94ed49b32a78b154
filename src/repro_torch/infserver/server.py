"""InfServer: continuous-batching inference service (§3.2); counterpart of
`repro.infserver.server`.

Collects observations from many Actor clients, runs ONE forward over the
continuous batch on the card, and scatters (action, logp, value) back.

Design, as in `repro`:

* **Ticket futures** — `submit` returns a `Ticket` with `done()`/`result()`;
  the integer id keeps the `get(ticket)` protocol. Results whose owner never
  collects them are expired after `ticket_ttl_flushes` flushes.
* **Bounded request queue** — hitting `max_batch` queued rows flushes.
* **Multi-model routing** — one server hosts the learner theta plus frozen
  opponents phi. A flush groups tickets by model, pads each model's
  sub-batch to a shared power-of-two bucket, stacks them to (M, S, L) and
  runs ONE forward over params stacked on a model axis (the port's stand-in
  for `vmap`). The buckets keep the set of shapes small and stable, which
  is what CUDA graphs need later.
* **Param hot-swap** — `update_params`/`ensure_model` replace a model's
  params; swaps are hash-gated (a refresh carrying the content hash the
  route already hosts is a no-op) and a refresh whose pool version is older
  than the hosted one is dropped.
* **Telemetry** — per-batch latency, occupancy and queue wait feed
  `stats()`. A request's queue wait runs from its `submit` to the start
  of the flush that serves it: `mean_queue_wait_ms` (also in
  `telemetry()`) and `max_queue_wait_ms` are an operator's signal that
  requests queue behind flushes, that is, that the replica takes more
  load than it serves; a closed loop of actors that fill each flush
  keeps them near zero. With tracing on (`utils/trace.py`), each flush
  is a span `infserver.flush#<n>` (n = `batches_run` at its start) over
  `infserver.pad`, `.h2d`, `.forward`, `.d2h` and `.scatter`. The
  latency a flush adds to `mean_batch_latency_ms` ends as its results
  are scattered: the queue-wait sums and the expiry of dead owners'
  results come after it.

The forwards run inside `dispatch.serving()`, so `REPRO_KERNELS_INFER=bf16`
applies to them and never to a learner's forward. Each flush uploads one
padded observation batch and copies one result block back to the host:
results are host numpy arrays, as `repro`'s `np.asarray` gives.

* **Mesh-sharded execution** (`mesh=`, a `DeviceMesh` over ('data',
  'model'), e.g. `launch.mesh.make_local_mesh()`) — each hosted model is
  laid out over the mesh as DTensors with the serving specs
  (`serving_param_shardings`: the 'model' axis split, no FSDP; the grouped
  θ+φ stack with `stacked_param_shardings`), and each flush's padded batch,
  rounded up to a multiple of the data extent, is a DTensor over the data
  axes (`obs_batch_sharding`/`grouped_obs_sharding`). Each rank runs the
  forward on its rows over its param shards in a param scope (each repeat
  unit gathered at use, the compute split over 'model':
  `distributed/sharding.param_scope`), the logits and values are gathered
  over the data axes, and the actions are sampled from the whole batch
  with the server's generator, so a sharded flush gives the single-device
  results. The flush still makes one device->host copy.
  `mesh=None` keeps the single-device path as it was.
"""
from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.actors.policy import make_obs_policy
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import dispatch
from repro_torch.rl.distributions import categorical_logp, categorical_sample
from repro_torch.utils import resolve_device, trace, tree_map, tree_stack

_DEFAULT = "__default__"


def _bucket(n: int) -> int:
    """Next power of two >= n: bounds the set of batch shapes."""
    return 1 << max(0, (n - 1).bit_length())


class Ticket:
    """Future handle for a submitted observation batch."""
    __slots__ = ("tid", "model", "rows", "_server")

    def __init__(self, tid: int, model: Hashable, rows: int, server: "InfServer"):
        self.tid, self.model, self.rows, self._server = tid, model, rows, server

    def done(self) -> bool:
        return self.tid in self._server._results

    def result(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self._server.get(self)

    def __int__(self) -> int:
        return self.tid

    def __repr__(self):
        return f"Ticket({self.tid}, model={self.model!r}, rows={self.rows})"


class InfServer:
    def __init__(self, cfg, num_actions: int, params=None, *, device=None,
                 max_batch: int = 256, seed: int = 0, mesh=None,
                 ticket_ttl_flushes: int = 512):
        """`device` defaults to CUDA and raises where there is none; the CPU
        tests pass device="cpu". Sampling draws from a `torch.Generator` on
        that device seeded with `seed`. `mesh` switches on sharded execution
        (see the module's docstring); it must live on `device`'s type.

        `ticket_ttl_flushes` bounds result retention: a resolved ticket
        whose owner hasn't collected it within that many subsequent
        flushes is expired (its result arrays freed, `tickets_expired`
        bumped)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.policy = make_obs_policy(cfg, num_actions)
        self.max_batch = max_batch
        self.mesh = mesh
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"mesh on {mesh.device_type}, server on {self.device}")
        self._param_specs = None         # lazy: from the first model's shapes
        self._stacked_specs = None
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # one reentrant lock serializes registry mutation, queueing and
        # flushing (`get` may re-enter `flush`, hence reentrant)
        self._lock = threading.RLock()
        # model registry: key -> params, with a swap counter so the
        # stacked-params cache knows when a hot-swap invalidated it, plus
        # the param-plane identity of the hosted copy (content hash +
        # pool version) so identical refreshes no-op
        self._models: Dict[Hashable, Any] = {}
        self._versions: Dict[Hashable, int] = {}
        self._content_hashes: Dict[Hashable, str] = {}
        self._pool_versions: Dict[Hashable, int] = {}
        self._default_key: Optional[Hashable] = None
        self._stack_cache: Dict[tuple, Any] = {}
        self.swaps = 0               # hot-swaps that actually (re)placed params
        self.swap_noops = 0          # refreshes gated off by content hash
        self.swap_stale_drops = 0    # refreshes dropped as version downgrades
        if params is not None:
            self.register_model(_DEFAULT, params)
        # request queue: (ticket id, model, obs, submit time)
        self._pending: List[Tuple[int, Hashable, np.ndarray, float]] = []
        self._pending_rows = 0
        self._results: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
        # tid -> batches_run at resolution; drives dead-owner expiry
        self._result_born: Dict[int, int] = {}
        self.ticket_ttl_flushes = ticket_ttl_flushes
        self.tickets_expired = 0
        self._next_id = 0
        # telemetry
        self.requests_served = 0
        self.batches_run = 0
        self.rows_served = 0
        self.rows_padded = 0
        self._latency_sum = 0.0
        self._queue_wait_sum = 0.0       # over served requests: submit -> flush start
        self._queue_wait_max = 0.0
        self.last_batch_latency_s = 0.0
        self.last_batch_models = 0

    # -- model registry ------------------------------------------------------
    @property
    def params(self):
        """Legacy accessor: the default model's current params."""
        return self._models.get(self._default_key)

    def _place(self, params):
        """Params on the server's device (tensors already there are hosted
        live, as `repro` hosts its pytrees; numpy leaves are uploaded). In
        sharded mode they are laid out over the mesh with the serving specs
        (computed once from the first model's shapes: every route hosts the
        same arch)."""
        params = tree_map(lambda a: torch.as_tensor(a, device=self.device), params)
        if self.mesh is None:
            return params
        if self._param_specs is None:
            self._param_specs = SH.serving_param_shardings(params, self.cfg, self.mesh)
            self._stacked_specs = SH.stacked_param_shardings(self._param_specs, self.mesh)
        return SH.distribute(params, self._param_specs, self.mesh)

    def _pad_rows(self, rows: int) -> int:
        """Padded batch size for `rows` real rows: the power-of-two bucket,
        rounded up in sharded mode to a multiple of the mesh's data extent,
        so the batch dim always divides for the data-parallel layout."""
        s = _bucket(rows)
        if self.mesh is not None:
            d = math.prod(SH.mesh_sizes(self.mesh)[a] for a in SH.data_axes(self.mesh))
            s = -(-s // d) * d
        return s

    def _place_obs(self, obs: np.ndarray, grouped: bool):
        """A flush batch on the device, as a DTensor over the data axes in
        sharded mode (rows of (S, L), or the S of a grouped (M, S, L))."""
        tokens = torch.from_numpy(obs).to(self.device, torch.long)
        if self.mesh is None:
            return tokens
        from torch.distributed.tensor import distribute_tensor
        spec = (SH.grouped_obs_sharding(self.mesh, obs.shape[1]) if grouped
                else SH.obs_batch_sharding(self.mesh, obs.shape[0]))
        spec = spec + (None,) * (obs.ndim - len(spec))
        return distribute_tensor(tokens, self.mesh, SH.placements(spec, self.mesh))

    def register_model(self, key: Hashable, params,
                       content_hash: Optional[str] = None,
                       version: Optional[int] = None) -> None:
        """Host (or refresh) a model. The first registered model becomes
        the default route for `submit(obs)` without an explicit model.

        A refresh whose `content_hash` matches the hosted route is a no-op;
        one whose `version` is older than the hosted one is dropped.
        Without a hash the swap is unconditional."""
        with self._lock:
            if self._default_key is None:
                self._default_key = key
            if key in self._models:
                if (content_hash is not None
                        and self._content_hashes.get(key) == content_hash):
                    self.swap_noops += 1
                    return
                hosted_v = self._pool_versions.get(key)
                if (version is not None and hosted_v is not None
                        and version < hosted_v):
                    self.swap_stale_drops += 1
                    return
            self.swaps += 1
            self._versions[key] = self._versions.get(key, -1) + 1
            self._models[key] = self._place(params)
            if content_hash is not None:
                self._content_hashes[key] = content_hash
            else:
                self._content_hashes.pop(key, None)
            if version is not None:
                self._pool_versions[key] = version
            else:
                self._pool_versions.pop(key, None)
            # stacked copies holding this key can never match again (its
            # version bumped): drop them so they don't pin device memory
            self._stack_cache = {ck: v for ck, v in self._stack_cache.items()
                                 if all(k != key for k, _ in ck)}

    def ensure_model(self, key: Hashable, params,
                     content_hash: Optional[str] = None) -> None:
        """Register if absent (an existing route is never overwritten)."""
        with self._lock:
            if key not in self._models:
                self.register_model(key, params, content_hash=content_hash)

    def has_model(self, key: Hashable,
                  content_hash: Optional[str] = None) -> bool:
        """Is `key` hosted (and, with `content_hash`, at exactly that content)?"""
        with self._lock:
            if key not in self._models:
                return False
            return (content_hash is None
                    or self._content_hashes.get(key) == content_hash)

    def update_params(self, params, key: Hashable = None,
                      content_hash: Optional[str] = None,
                      version: Optional[int] = None) -> None:
        """Learner pushed new theta -> hot-swap. In-flight flushes finish
        under the old weights, the next flush sees the new ones."""
        with self._lock:
            if key is None:
                key = self._default_key if self._default_key is not None else _DEFAULT
            self.register_model(key, params, content_hash=content_hash,
                                version=version)

    def evict_model(self, key: Hashable) -> bool:
        """Drop a route. Returns False (and keeps the route) when requests
        for it are still queued."""
        with self._lock:
            if any(k == key for _, k, *_ in self._pending):
                return False
            self._models.pop(key, None)
            self._versions.pop(key, None)
            self._content_hashes.pop(key, None)
            self._pool_versions.pop(key, None)
            self._stack_cache.clear()
            if key == self._default_key:
                self._default_key = next(iter(self._models), None)
            return True

    # -- client protocol -----------------------------------------------------
    def submit(self, obs: np.ndarray, model: Hashable = None) -> Ticket:
        """Queue a (k, L) observation batch for `model` (default: theta);
        returns a ticket future. May block for one forward when this submit
        fills the queue to `max_batch` rows. The obs array is referenced
        until that flush, not copied."""
        obs = np.asarray(obs)
        with self._lock:
            key = self._default_key if model is None else model
            if key not in self._models:
                raise KeyError(f"unknown model route {key!r}")
            ticket = Ticket(self._next_id, key, obs.shape[0], self)
            self._next_id += 1
            self._pending.append((ticket.tid, key, obs, time.perf_counter()))
            self._pending_rows += obs.shape[0]
            if self._pending_rows >= self.max_batch:
                self.flush()
            return ticket

    @property
    def queue_depth(self) -> int:
        return self._pending_rows

    def flush(self) -> None:
        """Run one forward over everything pending and resolve tickets.
        Blocks for the device round trip while holding the server lock."""
        with self._lock:
            if not self._pending:
                return
            t0 = time.perf_counter()
            pending, self._pending, self._pending_rows = self._pending, [], 0
            with trace.span(f"infserver.flush#{self.batches_run}"), dispatch.serving(), \
                    torch.inference_mode():
                with trace.span("infserver.pad"):
                    groups: Dict[Hashable, List[Tuple[int, np.ndarray]]] = {}
                    for tid, key, obs, _ in pending:
                        groups.setdefault(key, []).append((tid, obs))
                    keys = sorted(groups, key=repr)
                    obs, rows, padded = self._batch([groups[k] for k in keys])
                params = (self._models[keys[0]] if len(keys) == 1
                          else self._stacked_params(keys))
                out = self._forward(params, obs, grouped=len(keys) > 1)
                with trace.span("infserver.scatter"):
                    for m, k in enumerate(keys):
                        self._scatter(groups[k], *(out if len(keys) == 1
                                                   else (o[m] for o in out)))
            self.rows_served += rows
            self.rows_padded += padded
            self.requests_served += len(pending)
            self.batches_run += 1
            self.last_batch_models = len(groups)
            self.last_batch_latency_s = time.perf_counter() - t0
            self._latency_sum += self.last_batch_latency_s
            waits = [t0 - t for *_, t in pending]
            self._queue_wait_sum += sum(waits)
            self._queue_wait_max = max(self._queue_wait_max, max(waits))
            rec = trace.active()
            if rec is not None:
                rec.queue_waits_s += waits
            # dead-owner expiry; strict >: a result born in THIS flush must
            # survive the full TTL window before it can be reclaimed
            expired = [tid for tid, born in self._result_born.items()
                       if self.batches_run - born > self.ticket_ttl_flushes]
            for tid in expired:
                self._results.pop(tid, None)
                self._result_born.pop(tid, None)
                self.tickets_expired += 1

    def _batch(self, parts):
        """The flush's observations, each model's rows padded to one
        bucket: (S, L) for one model, (M, S, L) for several; and the real
        and padded row counts."""
        per_model = [np.concatenate([o for _, o in items], axis=0) for items in parts]
        S = self._pad_rows(max(m.shape[0] for m in per_model))
        obs = np.zeros((len(parts), S) + per_model[0].shape[1:], per_model[0].dtype)
        for m, sub in enumerate(per_model):
            obs[m, :sub.shape[0]] = sub
        return (obs[0] if len(parts) == 1 else obs), sum(m.shape[0] for m in per_model), \
            len(parts) * S

    def _forward(self, params, obs: np.ndarray, grouped: bool = False):
        """Upload the padded batch, act, and copy (a, logp, v) back to the
        host as one block (actions ride as fp32, exact below 2**24)."""
        with trace.span("infserver.h2d"):
            tokens = self._place_obs(obs, grouped)
        with trace.span("infserver.forward"):
            a, logp, v = self._act(params, tokens, grouped)
        with trace.span("infserver.d2h"):
            out = torch.stack([a.float(), logp.float(), v.float()], dim=-1).cpu().numpy()
        return out[..., 0].astype(np.int32), out[..., 1], out[..., 2]

    def _act(self, params, tokens, grouped: bool):
        """(action, logp, value) of every row, on the device."""
        if self.mesh is None:
            return self.policy.act(params, self.gen, tokens)
        # this rank's rows over its param shards; the logits and values
        # of every data rank, then one draw over the batch
        row = 1 if grouped else 0
        axes = [a for a in SH.data_axes(self.mesh)
                if tokens.placements[self.mesh.mesh_dim_names.index(a)].is_shard()]
        local, specs = SH.local_params(params, self.mesh)
        with SH.data_parallel(self.mesh, axes), \
                SH.param_scope(self.mesh, specs, self.cfg):
            lg, v = self.policy.logits_values(local, SH.local_rows(tokens))
        lg, v = (SH.all_gather(t, row, self.mesh, axes) for t in (lg, v))
        a = categorical_sample(self.gen, lg)
        return a, categorical_logp(lg, a), v

    def _stacked_params(self, keys) -> Any:
        """(M, ...) stacked params for the model set, cached until any
        member hot-swaps (version bump clears the cache)."""
        cache_key = tuple((k, self._versions[k]) for k in keys)
        hit = self._stack_cache.get(cache_key)
        if hit is None:
            hit = (tree_stack([self._models[k] for k in keys]) if self.mesh is None
                   else self._stack_sharded([self._models[k] for k in keys]))
            while len(self._stack_cache) >= 8:     # bound without thrashing
                self._stack_cache.pop(next(iter(self._stack_cache)))
            self._stack_cache[cache_key] = hit
        return hit

    def _stack_sharded(self, members) -> Any:
        """The (M, ...) stack of DTensor trees: each rank stacks its own
        shards, laid out by the stacked specs (M unsharded)."""
        from torch.distributed.tensor import DTensor
        stacked = tree_stack([tree_map(lambda t: t.to_local(), m) for m in members])
        flat = SH.spec_items(self._stacked_specs)
        return SH.map_with_path(
            lambda name, t: DTensor.from_local(t, self.mesh, SH.placements(flat[name], self.mesh),
                                               run_check=False), stacked)

    def _scatter(self, items, a, logp, v) -> None:
        """Each (ticket id, obs) of `items` gets its rows of the results."""
        ofs = 0
        for t, o in items:
            n = o.shape[0]
            self._results[t] = (a[ofs:ofs + n], logp[ofs:ofs + n], v[ofs:ofs + n])
            self._result_born[t] = self.batches_run
            ofs += n

    def get(self, ticket) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Resolve a ticket: (actions, logps, values) for its rows. An
        unresolved ticket triggers a flush. Results pop on read; a second
        get for the same ticket raises KeyError."""
        tid = ticket.tid if isinstance(ticket, Ticket) else int(ticket)
        with self._lock:
            if tid not in self._results:
                self.flush()
            self._result_born.pop(tid, None)
            return self._results.pop(tid)

    def discard(self, ticket) -> None:
        """Forget a ticket without consuming it: drop its queued request
        (if not yet flushed) and its result (if already resolved)."""
        tid = ticket.tid if isinstance(ticket, Ticket) else int(ticket)
        with self._lock:
            self._results.pop(tid, None)
            self._result_born.pop(tid, None)
            kept = [p for p in self._pending if p[0] != tid]
            if len(kept) != len(self._pending):
                self._pending_rows -= sum(p[2].shape[0] for p in self._pending
                                          if p[0] == tid)
                self._pending = kept

    # -- telemetry ------------------------------------------------------------
    def telemetry(self) -> dict:
        """The router's cheap occupancy/latency probe (a subset of stats())."""
        batches = max(self.batches_run, 1)
        return {
            "queue_depth": self.queue_depth,
            "results_held": len(self._results),
            "rows_served": self.rows_served,
            "batches_run": self.batches_run,
            "occupancy": self.rows_served / max(self.rows_padded, 1),
            "mean_batch_latency_ms": 1e3 * self._latency_sum / batches,
            "last_batch_latency_ms": 1e3 * self.last_batch_latency_s,
            "mean_queue_wait_ms": 1e3 * self._queue_wait_sum / max(self.requests_served, 1),
            "models_hosted": len(self._models),
        }

    def stats(self) -> dict:
        batches = max(self.batches_run, 1)
        return {
            "requests_served": self.requests_served,
            "batches_run": self.batches_run,
            "rows_served": self.rows_served,
            "mean_batch_rows": self.rows_served / batches,
            "occupancy": self.rows_served / max(self.rows_padded, 1),
            "mean_batch_latency_ms": 1e3 * self._latency_sum / batches,
            "last_batch_latency_ms": 1e3 * self.last_batch_latency_s,
            "mean_queue_wait_ms": 1e3 * self._queue_wait_sum / max(self.requests_served, 1),
            "max_queue_wait_ms": 1e3 * self._queue_wait_max,
            "last_batch_models": self.last_batch_models,
            "swaps": self.swaps,
            "swap_noops": self.swap_noops,
            "swap_stale_drops": self.swap_stale_drops,
            "models_hosted": len(self._models),
            "queue_depth": self.queue_depth,
            "results_held": len(self._results),
            "tickets_expired": self.tickets_expired,
            "sharded": self.mesh is not None,
            "mesh_shape": (list(SH.mesh_sizes(self.mesh).values())
                           if self.mesh is not None else None),
            "infer_mode": os.environ.get("REPRO_KERNELS_INFER") or None,
            # per-call routing counts of the port's dispatch (a misrouted
            # reference tier shows up here)
            "dispatch": dispatch.stats(),
        }
