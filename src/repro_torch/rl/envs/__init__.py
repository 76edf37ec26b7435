"""Environment zoo; importing it registers every family:

    landmark        the paper's landmark-covering particle task
    windy           LandmarkNav + wind drift and Gaussian gusts
    multilandmark   nearest-of-L landmark covering
    cliffwalk       Sutton-Barto cliff walking (one-hot states, slip)
    lqr             linear-quadratic regulation (continuous actions)
    tabular         known-model finite MDPs (the Garnet generator), exact J
    hetero          per-agent heterogeneous wrapper over any family

Counterpart of ``repro/rl/envs`` without the sweep-lane packers (sweep
slice).
"""
from repro_torch.rl.envs.gridworld import CliffWalk  # noqa: F401
from repro_torch.rl.envs.heterogeneous import (  # noqa: F401
    HeterogeneousEnv, check_agent_count, make_heterogeneous_env,
)
from repro_torch.rl.envs.lqr import LQRTask  # noqa: F401
from repro_torch.rl.envs.particle import (  # noqa: F401
    MultiLandmarkNav, WindyLandmarkNav,
)
from repro_torch.rl.envs.registry import (  # noqa: F401
    default_policy, env_kind, make_env, register_env, registered_envs,
)
from repro_torch.rl.envs.tabular import garnet  # noqa: F401
