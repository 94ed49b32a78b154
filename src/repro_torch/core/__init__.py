"""The paper's primary contribution: league-based CSP-MARL machinery
(LeagueMgr, GameMgr opponent sampling, ModelPool, HyperMgr, payoff/Elo);
counterpart of `repro.core`."""
from repro_torch.core.types import (ModelKey, Task, MatchResult, Hyperparam,
                                    FreezeGate)
from repro_torch.core.payoff import PayoffMatrix
from repro_torch.core.model_pool import ModelPool, ModelPoolReplica
from repro_torch.core.hyper_mgr import HyperMgr
from repro_torch.core.game_mgr import (
    GameMgr, UniformGameMgr, PFSPGameMgr, SelfPlayPFSPGameMgr,
    EloMatchGameMgr, ExploiterGameMgr, LeagueExploiterGameMgr,
    MinimaxExploiterGameMgr, GAME_MGRS,
)
from repro_torch.core.league_mgr import LeagueMgr, LearningAgent, ROLES, TaskLease
