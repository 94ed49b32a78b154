"""Launch: the port's entry points; counterpart of `repro.launch`.

  train       - `python -m repro_torch.launch.train`: the `--sync` loop,
                the threaded runtime, and the multiprocess league
                (`--workers N` or one `--role` per process).
  distributed - the multiprocess roles and `run_multiprocess`.
  serve       - `python -m repro_torch.launch.serve`: a replica, a
                gateway, or a local fleet behind one.
  k8s         - renders the multiprocess league as k8s objects.

`repro`'s mesh, step, spec and dry-run modules (and the decode demo) are
ROADMAP queue 1 items 8 and 9.
"""
