"""PyTorch / CUDA port of the TLeague reproduction.

The JAX package `repro` is the reference; this package mirrors its module
names (`repro_torch.models.transformer` is the counterpart of
`repro.models.transformer`, and so on) and imports nothing from it.
Entry points run on CUDA unless the caller passes `device="cpu"`; with no
CUDA device and no explicit "cpu" they raise instead of moving to the CPU.
"""
