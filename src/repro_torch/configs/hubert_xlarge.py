"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16) d_ff=5120
vocab=504 (k-means units), encoder-only (w2v2 arch). [arXiv:2106.07447]

Per the carve-out, the mel-spectrogram + conv feature extractor is a stub:
`input_specs` provides frame embeddings. Encoder-only => no decode step
(decode_32k / long_500k skipped; see DESIGN.md). `train_4k` is masked-unit
prediction, `prefill_32k` is the batched encoder forward (the InfServer role
for an encoder).
"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hubert-xlarge",
    family="audio",
    source="arXiv:2106.07447 (HuBERT X-Large)",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    encoder_only=True,
    frontend="audio",
    norm="layernorm",
    activation="gelu",
    mlp_gated=False,
    param_dtype="float32",
)

ARCHS.register("hubert-xlarge", CONFIG)
