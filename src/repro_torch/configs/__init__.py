"""Architecture registry: `get_arch(name)`, `list_archs()`.

Counterpart of `repro.configs`. Only the league's own policy nets are
registered so far; the ten assigned architectures arrive with their
families.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig, SSMConfig, dtype_of
from repro_torch.utils.registry import Registry

ARCHS: Registry = Registry("arch")

from repro_torch.configs import tleague_nets  # noqa: E402,F401  (registration)


def get_arch(name: str) -> ArchConfig:
    return ARCHS.get(name)


def list_archs():
    return ARCHS.names()


__all__ = ["ARCHS", "ArchConfig", "MoEConfig", "SSMConfig", "dtype_of",
           "get_arch", "list_archs"]
