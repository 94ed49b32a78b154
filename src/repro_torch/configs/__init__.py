"""Architecture registry: `get_arch(name)`, `list_archs()`.

Counterpart of `repro.configs`: the ten assigned architectures, each citing
its source, and the league's own policy nets; and the port's own entries,
which the JAX package lacks (`PORT_ONLY`). The model code runs the
dense family; `init_params` raises for the others until their families
are ported. `<cfg>.smoke()` is the reduced same-family variant for CPU
smoke tests.
"""
from repro_torch.configs.base import (INPUT_SHAPES, ArchConfig, InputShape, MLAConfig,
                                      MoEConfig, RouterConfig, SSMConfig, YarnScaling,
                                      dtype_of)
from repro_torch.utils.registry import Registry

ARCHS: Registry = Registry("arch")

from repro_torch.configs import (  # noqa: E402,F401  (registration imports)
    qwen3_8b,
    mistral_large_123b,
    command_r_35b,
    pixtral_12b,
    rwkv6_3b,
    hubert_xlarge,
    gemma2_2b,
    kimi_k2_1t_a32b,
    qwen3_moe_235b_a22b,
    hymba_1p5b,
    tleague_nets,
    kimi_k2_instruct,
)


PORT_ONLY = ("kimi-k2-instruct",)


def get_arch(name: str) -> ArchConfig:
    return ARCHS.get(name)


def list_archs():
    return ARCHS.names()


__all__ = ["ARCHS", "INPUT_SHAPES", "ArchConfig", "InputShape", "MLAConfig", "MoEConfig",
           "RouterConfig", "SSMConfig", "YarnScaling", "dtype_of", "get_arch", "list_archs"]
