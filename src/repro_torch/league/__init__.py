"""Role-based league population (§3.2): LeagueSpec roles wired onto a
LeagueMgr; counterpart of `repro.league`. The event-driven runtime
(`repro.league.runtime`) is not ported yet."""
from repro_torch.core.types import FreezeGate
from repro_torch.league.spec import LeagueSpec, RoleSpec, ROLE_DEFAULTS
from repro_torch.league.roles import install_roles, make_game_mgr
