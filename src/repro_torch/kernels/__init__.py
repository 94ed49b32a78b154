"""Hand-written Hopper kernels for the serving and learner hot spots, each
beside its plain PyTorch version (`ref.py`):

  flash_attention - fused online-softmax attention forward, GQA, causal +
                    sliding-window + logit-softcap aware (csrc/flash_fwd.cu),
                    and its FlashAttention-2 backward: dq, with the delta
                    preprocess in its prologue, and dk/dv (csrc/flash_bwd.cu).
  rmsnorm         - fused RMS normalization (csrc/rmsnorm.cu).
  vtrace_scan     - reverse discounted scan behind GAE and V-trace
                    (csrc/reverse_scan.cu), with its closed-form gradient.
  adamw           - AdamW's per-leaf update and the global gradient norm
                    with its clip scale (csrc/adamw.cu), for the learner's
                    optimizer; they replace no TPU kernel (XLA fuses AdamW).

`repro_torch.kernels.dispatch` is the entry point models/ call: CUDA
tensors launch the kernels, CPU tensors run the plain versions. The
kernels are built from `csrc/` by `_build` at first use.
"""
from repro_torch.kernels import dispatch
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.kernels.vtrace_scan.ops import reverse_discounted_scan
