from crazyflie_nmpc_tpu_torch.utils.trajectories import (  # noqa: F401
    decode_poly4d,
    encode_poly4d,
    eval_flat_outputs,
    flat_to_state,
    helix_trajectory,
    load_poly_csv,
    load_traj_txt,
    sample_poly_trajectory,
    save_traj_txt,
    smooth_step_trajectory,
)
from crazyflie_nmpc_tpu_torch.utils import profiling  # noqa: F401
