"""Environment zoo; importing it registers every family:

    landmark        the paper's landmark-covering particle task
    windy           LandmarkNav + wind drift and Gaussian gusts
    multilandmark   nearest-of-L landmark covering
    cliffwalk       Sutton-Barto cliff walking (one-hot states, slip)
    lqr             linear-quadratic regulation (continuous actions)
    tabular         known-model finite MDPs (the Garnet generator), exact J
    hetero          per-agent heterogeneous wrapper over any family

Counterpart of ``repro/rl/envs``, with the sweep-lane packers and
builders (``batched_env_arrays``, ``build_lane_env``).
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
    batched_env_arrays, build_lane_env, default_policy, env_kind,
    is_float_field, make_env, register_env, registered_envs, robust_eq,
    values_vary,
)
from repro_torch.rl.envs.tabular import garnet  # noqa: F401
