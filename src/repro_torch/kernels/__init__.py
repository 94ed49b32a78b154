"""Hand-written Hopper kernels for the serving hot spots, each beside its
plain PyTorch version (`ref.py`):

  flash_attention - fused online-softmax attention forward, GQA, causal +
                    sliding-window + logit-softcap aware (csrc/flash_fwd.cu).
  rmsnorm         - fused RMS normalization (csrc/rmsnorm.cu).

`repro_torch.kernels.dispatch` is the entry point models/ call: CUDA
tensors launch the kernels, CPU tensors run the plain versions. The
kernels are built from `csrc/` by `_build` at first use.
"""
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
