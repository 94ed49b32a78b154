"""Role-based asynchronous league runtime (§3.2, Fig. 2): LeagueSpec roles
over an event-driven Actor/Learner/coordinator control plane; counterpart
of `repro.league`."""
from repro_torch.core.types import FreezeGate
from repro_torch.league.spec import LeagueSpec, RoleSpec, ROLE_DEFAULTS
from repro_torch.league.roles import install_roles, make_game_mgr
from repro_torch.league.runtime import (ActorWorker, Coordinator, LearnerWorker,
                                        LeagueRuntime, RoleRuntime, build_runtime)
