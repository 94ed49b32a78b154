"""AdamW's update and the global gradient norm: the CUDA kernels for CUDA
tensors, the plain versions (`ref.py`) for CPU tensors.

New kernels, replacing no TPU kernel: the JAX package leaves its optimizer
to XLA, which fuses it; `csrc/adamw.cu`'s header says what bounds them and
how they are laid out. `optim.optimizers.adamw` calls them for every leaf,
a DTensor's by its local shard.

- `adamw_update` runs one leaf's step and writes it into the outputs it is
  given, which may be its inputs (in place) or fresh tensors (the
  functional update): it allocates nothing and returns None. One launch;
  on the CPU, the plain body over flat slices of 2^24 elements, so its own
  memory is a few slices of temporaries.
- `global_norm` returns the norm of all the leaves it is given, and the
  clip scale: one launch per leaf into a workspace of partial sums, then
  one that sums them in a fixed order. The two are 0-d views of one fp32
  pair on the device, so the update reads the scale with no host sync.
  `groups` names, for each leaf that is one rank's shard, the process
  groups to sum it over: the leaves of each set of groups are first
  summed to one value (the finish kernel without its square root), which
  one all-reduce a group sums across the ranks, a few bytes; every rank
  then holds the whole norm.

`adamw_update.launches` and `global_norm.launches` count kernel launches
and nothing else (a norm: one per leaf with elements, and its finish; with
`groups`, one finish more for each set of groups).
A meta tensor is checked as the card's would be and launches nothing
(shape-only evaluation); `cost.adamw` and `cost.global_norm` are the
kernels' work.
"""
from __future__ import annotations

import itertools

import torch
import torch.distributed as dist

from repro_torch.kernels import _build, cost
from repro_torch.kernels.adamw.ref import adamw_ref, clip_scale_ref

DTYPES = (torch.float32, torch.bfloat16)
_SLICE_ELEMS = 1 << 24                # elements a slice of the CPU update
_THREADS, _VEC = 256, 8            # csrc/adamw.cu's kThreads and kVec
# at most this many partial sums a leaf: 8 blocks of 256 threads on each
# of an H100's 132 SMs, one wave that fills the card
NORM_BLOCKS = 8 * 132


def _device(name, tensors):
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: tensors on {sorted({str(t.device) for t in tensors})}")
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


@cost.counted("adamw", cost.adamw)
def adamw_update(g, m, v, base, out, *, scale, lr, bc1, bc2, b1, b2, eps, weight_decay):
    """One leaf's AdamW step (`ref.adamw_ref`), written to `out`.

    g: the grad, fp32 or bf16; m, v: fp32 moments; base: the fp32 master,
    or the param; out = (m_out, v_out, master_out, p_out): the new moments,
    the new fp32 master (None without one) and the new param, fp32 or bf16;
    every tensor of g's elements, contiguous but g. scale (None: no clip),
    lr, bc1, bc2: fp32 scalars on g's device."""
    m_out, v_out, master_out, p_out = out
    fp32 = [m, v, m_out, v_out] + ([master_out] if master_out is not None else [])
    state = fp32 + [base, p_out]
    scalars = [lr, bc1, bc2] + ([scale] if scale is not None else [])
    dev = _device("adamw_update", [g] + state + scalars)
    n = g.numel()
    if any(t.numel() != n for t in state):
        raise ValueError(f"adamw_update: a leaf of {n} elements with state of "
                         f"{[t.numel() for t in state]}")
    if g.dtype not in DTYPES or p_out.dtype not in DTYPES:
        raise TypeError(f"adamw_update takes grads and params in {DTYPES}, got "
                        f"{g.dtype} and {p_out.dtype}")
    want_base = torch.float32 if master_out is not None else p_out.dtype
    if any(t.dtype != torch.float32 for t in fp32) or base.dtype != want_base:
        raise TypeError(f"adamw_update: fp32 moments and master, the base in {want_base}; "
                        f"got {[t.dtype for t in state]}")
    if any(t.dtype != torch.float32 or t.numel() != 1 for t in scalars):
        raise TypeError("adamw_update: scale, lr and the bias corrections are fp32 scalars")
    if not all(t.is_contiguous() for t in state):
        raise ValueError("adamw_update updates contiguous moments, masters and params only")
    if dev.type == "cpu":
        g, m, v, base, m_out, v_out, master_out, p_out = (
            None if t is None else t.reshape(-1)
            for t in (g, m, v, base, m_out, v_out, master_out, p_out))
        for i in range(0, n, _SLICE_ELEMS):
            s = slice(i, i + _SLICE_ELEMS)
            m_out[s], v_out[s], new = adamw_ref(g[s], m[s], v[s], base[s], scale, lr, bc1, bc2,
                                                b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
            if master_out is not None:
                master_out[s] = new
            p_out[s] = new
        return None
    g = g.contiguous()
    if dev.type == "meta" or n == 0:
        return None
    lib = _build.library()
    err = lib.adamw_update(
        g.data_ptr(), m.data_ptr(), v.data_ptr(), base.data_ptr(), m_out.data_ptr(),
        v_out.data_ptr(), master_out.data_ptr() if master_out is not None else None,
        p_out.data_ptr(), n, scale.data_ptr() if scale is not None else None, lr.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), b1, 1 - b1, b2, 1 - b2, eps, weight_decay,
        _bf16(g), _bf16(p_out), int(master_out is not None), int(scale is not None),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "adamw_update")
    _build.count_launch(adamw_update)
    return None


adamw_update.launches = 0


def _norm_blocks(n: int) -> int:
    """The partial sums the norm kernel writes for a leaf of n elements:
    one a block of 256 threads of 8 elements, at most NORM_BLOCKS."""
    return min(NORM_BLOCKS, -(-n // (_THREADS * _VEC)))


@cost.counted("global_norm", cost.global_norm)
def global_norm(grads, max_norm=0.0, groups=None):
    """(norm, clip scale or None) of the leaves `grads` (fp32 or bf16 on
    the card): sqrt of the sum of every element's square in fp32, and,
    where `max_norm` is set, min(1, max_norm / (norm + 1e-9)); fp32 0-d
    tensors. `groups`: for each leaf, the process groups to sum its sum of
    squares over (() for a whole leaf; None: every leaf whole)."""
    grads = list(grads)
    groups = [()] * len(grads) if groups is None else list(groups)
    dev = _device("global_norm", grads)
    cpu = dev.type == "cpu"
    if not cpu and any(g.dtype not in DTYPES for g in grads):
        raise TypeError(f"global_norm takes grads in {DTYPES}, got "
                        f"{sorted({str(g.dtype) for g in grads})}")
    if not cpu:
        kept = [i for i, g in enumerate(grads) if g.numel()]
        grads, groups = [grads[i].contiguous() for i in kept], [groups[i] for i in kept]
    # runs of the leaves summed over the same groups, in their first leaf's
    # order; plain leaves keep theirs
    first = {}
    for gr in groups:
        first.setdefault(gr, len(first))
    order = sorted(range(len(grads)), key=lambda i: first[groups[i]])
    grads, groups = [grads[i] for i in order], [groups[i] for i in order]
    blocks = [1 if cpu else _norm_blocks(g.numel()) for g in grads]
    runs, start = [], 0
    for gr, run in itertools.groupby(zip(groups, blocks), key=lambda x: x[0]):
        stop = start + sum(nb for _, nb in run)
        runs.append((gr, start, stop))
        start = stop
    if cpu:
        partial = torch.stack([torch.sum(torch.square(g.float())) for g in grads])
    else:
        partial = torch.empty(sum(blocks), dtype=torch.float32, device=dev)
        out = torch.empty(2, dtype=torch.float32, device=dev)
        if dev.type == "cuda":
            lib = _build.library()
            stream = torch.cuda.current_stream(dev).cuda_stream
            slot = 0
            for g, nb in zip(grads, blocks):
                err = lib.global_norm_sumsq(g.data_ptr(), g.numel(), _bf16(g),
                                            partial.data_ptr() + 4 * slot, nb, stream)
                _build.check(err, "global_norm_sumsq")
                _build.count_launch(global_norm)
                slot += nb

    def finish(src, dst, root):
        """The sum of `src` (its square root, with root) into `dst`, and
        the clip scale after it where root and `max_norm` are set."""
        if cpu:
            total = sum(src.unbind())
            dst[0] = torch.sqrt(total) if root else total
            if root and max_norm:
                dst[1] = clip_scale_ref(dst[0], max_norm)
        elif dev.type == "cuda":
            err = lib.global_norm_finish(src.data_ptr(), src.numel(), dst.data_ptr(),
                                         float(max_norm), int(root), int(bool(max_norm)), stream)
            _build.check(err, "global_norm_finish")
            _build.count_launch(global_norm)

    if cpu:
        out = torch.empty(2, dtype=torch.float32)
    if len(runs) > 1 or runs and runs[0][0]:
        # each run's sum, summed across the ranks that hold its shards
        sums = torch.empty(len(runs), dtype=torch.float32, device=dev)
        for j, (gr, lo, hi) in enumerate(runs):
            finish(partial[lo:hi], sums[j:j + 1], False)
            for pg in gr:
                dist.all_reduce(sums[j:j + 1], group=pg)
        partial = sums
    finish(partial, out, True)
    return out[0], (out[1] if max_norm else None)


global_norm.launches = 0
