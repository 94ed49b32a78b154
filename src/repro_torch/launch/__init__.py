"""Launch: the port's entry points; counterpart of `repro.launch`.

  train       - `python -m repro_torch.launch.train`: the `--sync` loop,
                the threaded runtime, and the multiprocess league
                (`--workers N` or one `--role` per process).
  distributed - the multiprocess roles and `run_multiprocess`.
  serve       - `python -m repro_torch.launch.serve`: a replica, a
                gateway, or a local fleet behind one.
  k8s         - renders the multiprocess league as k8s objects.
  mesh        - the production meshes (shape only) and the local DeviceMesh.
  specs       - meta-tensor input specs per (arch, input shape).
  steps       - the dry-run step factory, sharded on a DeviceMesh.
  dryrun      - `python -m repro_torch.launch.dryrun`: per-device bytes and
                FLOPs of every (arch x shape) on the production meshes.
"""
