"""The per-rank counter: what one rank of a step computes, reads and sends,
and the peak of what it holds; the port's counterpart of the numbers
`repro`'s dry-run reads off XLA's compiled program (`cost_analysis`,
`memory_analysis` and the collectives of `as_text`).

`Counter` is a context manager: through a `TorchDispatchMode` it sees
every aten op and collective this thread (and autograd's threads for its
backward) runs, and through `kernels/cost.counted` every kernel wrapper
call:

  - flops: aten matmuls and convolutions as `FlopCounterMode` counts them
    (its `flop_registry`, ops outside it decomposed as it decomposes
    them), and each kernel's `cost.py` work. The aten ops a kernel wrapper
    runs (its allocations on the card and on meta, its plain version on
    the CPU) are not counted again, so a step counts the same on meta, on
    the card and on the CPU;
  - bytes (accessed): each aten op's tensor inputs plus outputs, views and
    allocations free, and each kernel's `cost.py` bytes;
  - collectives: one record per `c10d.*` or `_c10d_functional.*` op
    (DTensor's redistributes included), with its kind and operand bytes,
    the tensor each rank sends in: the shard for an all-gather, the whole
    buffer for an all-reduce or a reduce-scatter, the input for an
    all-to-all. `collective_bytes(records)` sums them under `repro`'s keys;
  - temp_size_in_bytes: the peak of the bytes of storages allocated inside
    the scope and still alive (the arguments, allocated before, are not
    in it; the outputs alive at the peak are), and `temp_by_phase`, the
    peak within each phase the step marks (`cost.phase`: the train step's
    update after its forward and backward, "step" before any mark);
    `live` holds, for each phase, the live bytes after each allocation
    (the phase's first entry: those at its start). A kernel wrapper's
    allocations count as they are: on the card and on meta its outputs and
    the workspace it allocates; on the CPU only its outputs, not its plain
    version's intermediates.

Ops on DTensors are handed back to DTensor (as `CommDebugMode` does), so
the counter sees the local ops and the collectives they lower to, at the
shapes this rank holds; DTensor's shape inference on fake tensors is not
counted. The counter changes nothing that runs: it reads
shapes, keeps no tensor alive (storages are tracked by weak reference) and
launches nothing. It counts every kernel call in the process while open
(the kernels' hook is process-wide), so open it where one thread steps.
"""
from __future__ import annotations

import collections
import weakref
from array import array

import torch
from torch._guards import detect_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from repro_torch.kernels import cost

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# collective op -> (kind, index of the argument each rank sends)
_COLL_OPS = {
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_": ("all-gather", 1),
    "c10d.allgather_coalesced_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allreduce_coalesced_": ("all-reduce", 0),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_out": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "_c10d_functional.isend": ("collective-permute", 0),
}
# ops of those namespaces that move no data of their own (a receive is
# counted at its send)
_NO_DATA = {"c10d.barrier", "c10d.monitored_barrier_", "c10d.recv_",
            "c10d.recv_any_source_", "_c10d_functional.wait_tensor",
            "_c10d_functional.irecv", "_c10d_functional._wrap_tensor_autograd"}
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")

_aten = torch.ops.aten
# allocations: no bytes accessed
_ALLOC = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.empty_like.default,
          _aten.new_empty.default, _aten.new_empty_strided.default}


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def collective_bytes(records) -> dict:
    """Operand bytes and counts of a counter's collective records by kind,
    under `repro`'s keys (`repro.launch.dryrun.collective_bytes`, which reads
    the same from HLO text): total, one key per kind, n_<kind>."""
    per_kind = dict.fromkeys(COLLECTIVES, 0)
    counts = dict.fromkeys(COLLECTIVES, 0)
    for r in records:
        per_kind[r["kind"]] += r["bytes"]
        counts[r["kind"]] += 1
    return {"total": sum(per_kind.values()), **per_kind,
            **{f"n_{k}": v for k, v in counts.items()}}


class Counter:
    """Counts one rank's work inside its scope (module docstring); read
    `result()` after it closes."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self._registry = flop_registry
        self.flops_by_op = collections.Counter()
        self.bytes = 0
        self.records = []
        self.kernels = collections.Counter()
        self._live = {}            # storage id -> (bytes, its finalizer)
        self._now = 0
        self._phase = "step"
        self.live = {"step": array("q", [0])}
        self._mode = None

    def __enter__(self):
        self._mode = _Mode(self)
        cost.listeners.append(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._mode.__exit__(*exc)
        finally:
            self._mode = None
            cost.listeners.remove(self)
            for _, fin in self._live.values():
                fin.detach()
            self._live.clear()

    def result(self) -> dict:
        return {"flops": sum(self.flops_by_op.values()),
                "flops_by_op": dict(self.flops_by_op), "bytes": self.bytes,
                "collectives": collective_bytes(self.records),
                "temp_size_in_bytes": max(map(max, self.live.values())),
                "temp_by_phase": {p: max(v) for p, v in self.live.items()},
                "kernels": dict(self.kernels)}

    # -- storages alive ---------------------------------------------------------

    def _track(self, out, inputs=()) -> None:
        """Add the storages of `out` that no input holds and that are not
        tracked yet: storage allocated now."""
        held = {t.untyped_storage()._cdata for t in tree_leaves(inputs)
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in held:
                continue
            n = st.nbytes()
            self._live[key] = (n, weakref.finalize(st, self._free, key))
            self._now += n
            self.live[self._phase].append(self._now)

    def _free(self, key) -> None:
        n, _ = self._live.pop(key, (0, None))
        self._now -= n

    # -- what runs --------------------------------------------------------------

    def phase(self, name) -> None:
        """From here on the step is in phase `name` (`cost.phase`)."""
        self._phase = name
        self.live.setdefault(name, array("q")).append(self._now)

    def kernel(self, name, work, out) -> None:
        """One kernel wrapper's call (`cost.counted`): its work, and its
        outputs as live storage (already tracked where it allocated them)."""
        self.kernels[name] += 1
        self.flops_by_op[name] += work.flops
        self.bytes += work.bytes
        self._track(out)

    def op(self, func, args, kwargs):
        """One aten op or collective, outside DTensor (see `_Mode`)."""
        name = str(func._overloadpacket)
        if func.namespace in _COLL_NAMESPACES:
            out = func(*args, **kwargs)
            if name in _COLL_OPS:
                kind, i = _COLL_OPS[name]
                self.records.append({"kind": kind, "op": name, "bytes": _nbytes(args[i])})
            elif name not in _NO_DATA:
                raise NotImplementedError(f"counter: no kind for the collective {name}")
            self._track(out, (args, kwargs))
            return out
        if cost.inside_kernel():
            # a kernel wrapper's own ops: its work is `cost.py`'s; on the
            # CPU they are the plain version, whose intermediates the
            # kernel does not allocate
            out = func(*args, **kwargs)
            if not any(t.device.type == "cpu" for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)):
                self._track(out, (args, kwargs))
            return out
        if func is not torch.ops.prim.device.default:
            # as FlopCounterMode: count what an op decomposes into
            with self._mode:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        if packet in self._registry:
            self.flops_by_op[name] += self._registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and func not in _ALLOC and any(
                isinstance(t, torch.Tensor) for t in tree_leaves(out)):
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
        if not func.is_view:
            self._track(out, (args, kwargs))
        return out


class _Mode(TorchDispatchMode):
    def __init__(self, counter: Counter):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            # let DTensor lower the op to local ops and collectives, which
            # come back through this mode (as `CommDebugMode` does)
            return NotImplemented
        if types or detect_fake_mode() is not None:
            # DTensor's shape inference on fake tensors of the global shape,
            # which computes and holds nothing on this rank
            return func(*args, **(kwargs or {}))
        return self.counter.op(func, args, kwargs or {})
