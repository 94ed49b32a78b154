"""The paper's own policy-net scale (TPolicies §3.5), as in
`repro.configs.tleague_nets`: the small transformer policies the league
trains and serves. Widths are the published ones, unchanged.
"""
from repro_torch.configs import ARCHS
from repro_torch.configs.base import ArchConfig

# action/observation vocab for the bundled envs (see repro/envs):
# env obs tokens + action tokens share one table.
POLICY_S = ArchConfig(
    name="tleague-policy-s",
    family="dense",
    source="arXiv:2011.12895 (TLeague, TPolicies-scale policy net)",
    num_layers=2,
    d_model=128,
    num_heads=4,
    num_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab_size=512,
    rope_theta=10_000.0,
    param_dtype="float32",
    value_head_hidden=64,
    max_position=2048,
)

POLICY_M = ArchConfig(
    name="tleague-policy-m",
    family="dense",
    source="arXiv:2011.12895 (TLeague)",
    num_layers=4,
    d_model=256,
    num_heads=8,
    num_kv_heads=4,
    head_dim=32,
    d_ff=512,
    vocab_size=512,
    rope_theta=10_000.0,
    param_dtype="float32",
    value_head_hidden=128,
    max_position=2048,
)

ARCHS.register("tleague-policy-s", POLICY_S)
ARCHS.register("tleague-policy-m", POLICY_M)
