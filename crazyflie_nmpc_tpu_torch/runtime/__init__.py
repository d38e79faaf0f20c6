from crazyflie_nmpc_tpu_torch.runtime.bag import (  # noqa: F401
    Bag,
    BagWriter,
    record_loop_result,
)
from crazyflie_nmpc_tpu_torch.runtime.batch import (  # noqa: F401
    SwarmResult,
    monte_carlo_hover,
    swarm_hover,
)
from crazyflie_nmpc_tpu_torch.runtime.closed_loop import (  # noqa: F401
    LoopConfig,
    LoopResult,
    cmd_vel_loop,
    estimator_in_the_loop,
    estimator_measurement,
    flight_configuration,
    hover_regulation,
    simulate,
    tracking_error,
    trajectory_tracking,
)
from crazyflie_nmpc_tpu_torch.runtime.tuning import (  # noqa: F401
    TuneResult,
    hover_objective,
    spec_with_diag_cost,
    tune_diagonal_cost,
)
