"""Native (C++) runtime: CRTP codec + lock-free rings + link server
(the PyTorch port's copy of the JAX package's `native`).

`src/` holds the same C++ sources; g++ builds them at first use into
`build/torch_native/` at the repo root.  The vehicle endpoints
(`FirmwareSim`, `FlyingFirmwareSim`, `CascadeFirmwareSim`) are host-side
simulated vehicles: their physics runs on the CPU in plain Python floats.
"""

from crazyflie_nmpc_tpu_torch.native.bindings import (  # noqa: F401
    LinkServer,
    build_library,
    decode_full_state,
    decode_setpoint,
    encode_full_state,
    encode_log_data,
    encode_setpoint,
    load_library,
    quat_compress,
    quat_decompress,
)
from crazyflie_nmpc_tpu_torch.native.channels import (  # noqa: F401
    IMU_BLOCK,
    POSE_BLOCK,
    SENSORS_BLOCK,
    decode_channels,
    start_typed_channels,
    stop_typed_channels,
)
from crazyflie_nmpc_tpu_torch.native.firmware_sim import (  # noqa: F401
    FirmwareSim,
)
from crazyflie_nmpc_tpu_torch.native.hl_executor import (  # noqa: F401
    CascadeFirmwareSim,
    FlyingFirmwareSim,
)
