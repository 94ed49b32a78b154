"""The port's shm smoke: the same-host shared-memory fast path of
`repro_torch.distributed.transport` must not leak segments or wedge the
server when the PRODUCER is SIGKILLed mid-stream. Counterpart of
`tests/smoke_shm.py`.

Not a pytest module (real kill -9 semantics across processes):

    PYTHONPATH=src python tests/smoke_torch_shm.py            # on the card
    PYTHONPATH=src python tests/smoke_torch_shm.py --device cpu

The scenario:
  1. This process serves an echo backend over `RpcServer` (shm enabled).
  2. A child connects, negotiates the shm ring (same host, same boot id)
     and streams large frames through it in a tight loop. Each frame is a
     tensor on `--device` drawn from a seed, so on the card every call
     goes through the port's encode path, which brings CUDA leaves to the
     host in one batched copy (`transport._tensors_to_wire`).
  3. The child is kill -9'd mid-stream (the child alone: its resource
     tracker, which unlinks its segments, lives on). The server must shrug
     the dead connection off, the child's /dev/shm segment must vanish
     within 10 s, and a FRESH client must negotiate its own ring and round
     trip the seeded tensor bit-exact.

The last line is one JSON object: the frames before the kill, the seconds
the segment took to vanish, the fresh client's transport stats and
whether its round trip was bit-exact. `--device` is CUDA by default and
raises without a card; the child gets it too.
"""
import argparse
import os
import re
import signal
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import torch_smoke_lib as lib  # noqa: E402

ELEMS = 96 * 1024                                     # 384 KiB of fp32 a frame
SEED = 1234

CHILD = r"""
import sys
import torch
from repro_torch.distributed import transport as tp

c = tp.RpcClient(sys.argv[1])
dev = torch.device(sys.argv[2])
blob = torch.randn(int(sys.argv[3]), generator=torch.Generator(device=dev).manual_seed(int(sys.argv[4])),
                   device=dev)
c.call("b.echo", blob)                                # negotiate first
st = c.transport_stats()
name = c._conn.shm.name if (c._conn and c._conn.shm) else ""
print(f"SHM name={name} proto={st['proto']} device={blob.device}", flush=True)
i = 0
while True:                                           # stream until killed
    c.call("b.echo", blob + i)
    i += 1
"""


class _Echo:
    def __init__(self):
        self.frames = 0
        self._lock = threading.Lock()

    def echo(self, x):
        with self._lock:
            self.frames += 1
        return x


def seeded(device: str, scale: float = 1.0):
    """The child's tensor, drawn the same way, on this process's device."""
    import torch
    dev = torch.device(device)
    return torch.randn(ELEMS, generator=torch.Generator(device=dev).manual_seed(SEED),
                       device=dev) * scale


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = lib.device_of(args.device)
    fields = {}
    ok = False
    try:
        ok = scenario(device, fields)
    finally:
        print(f"[shm] {'PASS' if ok else 'FAIL'}", flush=True)
        lib.result("shm", ok, device=device, **fields)
    return 0 if ok else 1


def scenario(device: str, fields: dict) -> bool:
    import numpy as np

    from repro_torch.distributed import transport as tp

    t0 = time.monotonic()
    backend = _Echo()
    ok, child = True, None
    with tp.RpcServer({"b": backend}) as srv:
        try:
            child = lib.Child("producer", [sys.executable, "-c", CHILD, srv.address, device,
                                           str(ELEMS), str(SEED)], t0)
            line = child.wait_for(r"(SHM name=\S* proto=\d+ device=\S+)", 120.0)
            if line is None:
                raise RuntimeError(f"child never negotiated:\n{child.tail()}")
            m = re.search(r"SHM name=(\S*) proto=(\d+) device=(\S+)", line)
            name, proto, child_device = m.group(1), int(m.group(2)), m.group(3)
            print(f"[shm] child pid={child.pid} ring={name!r} proto={proto} "
                  f"device={child_device}", flush=True)
            fields.update(ring=name, proto=proto, child_device=child_device)
            if not name or proto < 2:
                raise RuntimeError("child did not negotiate the shm ring")
            if not os.path.exists(f"/dev/shm/{name}"):
                raise RuntimeError("ring segment missing")
            if not lib.wait_until(lambda: backend.frames >= 50, 30.0, poll=0.05):
                raise RuntimeError(f"child never streamed frames:\n{child.tail()}")
            fields["frames_before_kill"] = backend.frames
            print(f"[shm] {backend.frames} frames through the ring; "
                  "SIGKILL the producer mid-stream", flush=True)
            child.signal(signal.SIGKILL)
            t_kill = time.monotonic()
            child.wait(10.0)

            # the dead producer's segment is reaped (its resource tracker),
            # not leaked into /dev/shm for the life of the host
            gone = lib.wait_until(lambda: not os.path.exists(f"/dev/shm/{name}"), 10.0,
                                  poll=0.05)
            fields["segment_vanished_s"] = time.monotonic() - t_kill if gone else None
            if gone:
                print(f"[shm] dead producer's segment reaped in "
                      f"{fields['segment_vanished_s']:.2f}s", flush=True)
            else:
                print(f"[shm] FAIL: segment {name} leaked after kill -9", flush=True)
                ok = False
        finally:
            if child is not None:
                child.kill_group()

        # the server survived: a fresh client negotiates ITS OWN ring and
        # round trips the seeded tensor bit-exact
        before = backend.frames
        c = tp.RpcClient(srv.address)
        try:
            blob = seeded(device, 2.0)
            out = c.call("b.echo", blob)
            want = blob.cpu().numpy()
            exact = (isinstance(out, np.ndarray) and out.dtype == want.dtype
                     and out.shape == want.shape
                     and np.array_equal(out.view(np.uint32), want.view(np.uint32)))
            st = c.transport_stats()
            fields.update(fresh_client=st, bit_exact=exact)
            print(f"[shm] fresh client after kill: proto={st['proto']} "
                  f"shm={st['shm']} blobs={st['shm_blobs']} bit_exact={exact}", flush=True)
            if not exact:
                print("[shm] FAIL: round trip not bit-exact", flush=True)
                ok = False
            if st["proto"] < 2 or not st["shm"] or st["shm_blobs"] < 1:
                print("[shm] FAIL: fresh client did not take the fast path", flush=True)
                ok = False
            if backend.frames <= before:
                print("[shm] FAIL: server stopped serving", flush=True)
                ok = False
        finally:
            c.close()
            fields["seconds"] = time.monotonic() - t0
            fields["processes"] = {"producer": lib.report(child)} if child else {}
    return ok


if __name__ == "__main__":
    raise SystemExit(main())
