"""The port's command-line tools (`crazyflie_nmpc_tpu_torch.tools`) on the
CPU, against the port's firmware simulator on ports the OS picks: `toc`
(its listing equal to the JAX tool's against the JAX simulator), `imu`,
`scan`, `console`, `bag` (info / csv / plot / play, equal to the JAX
tool's output) and `fly --device cpu` (a 17-column flight file and a bag;
without `--device` it needs a GPU)."""

import numpy as np
import pytest
import torch

from crazyflie_nmpc_tpu import tools as jtools
from crazyflie_nmpc_tpu.native import FirmwareSim as JFirmwareSim
from crazyflie_nmpc_tpu_torch import tools
from crazyflie_nmpc_tpu_torch.native import FirmwareSim
from crazyflie_nmpc_tpu_torch.runtime.bag import Bag, BagWriter
from _torch_shared import one_torch_thread  # noqa: F401


def test_toc_lists_what_the_jax_tool_lists(capsys):
    outs = []
    for sim, main in ((FirmwareSim, tools.main), (JFirmwareSim,
                                                  jtools.main)):
        with sim(0).serve() as fw:
            # the JAX simulator has no `port`: read its socket's
            port = fw.sock.getsockname()[1]
            assert main(["toc", "--peer-port", str(port),
                         "--local-port", "0"]) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert "commander/enHighLevel" in outs[0] and "uint8" in outs[0]
    assert "gyro.x" in outs[0] and "float" in outs[0]


def test_imu_echo(capsys):
    state = {"gyro.x": 1.0, "gyro.y": 2.0, "gyro.z": 3.0,
             "acc.x": 0.0, "acc.y": 0.0, "acc.z": 1.0}
    with FirmwareSim(0, state_provider=lambda n: state.get(n, 0.0)).serve(
    ) as fw:
        assert tools.main(["imu", "--peer-port", str(fw.port),
                           "--local-port", "0", "--duration", "0.5"]) == 0
    out = capsys.readouterr().out
    assert "gyro [deg/s]" in out
    assert "+1.000" in out and "+3.000" in out


def test_scan_and_console(capsys):
    with FirmwareSim(0, state_provider=lambda n: 1.5).serve() as fw:
        assert tools.main(["scan", "--ports", f"{fw.port}-{fw.port}"]) == 0
        assert f"udp://127.0.0.1:{fw.port}" in capsys.readouterr().out
        assert tools.main(["console", "--peer-port", str(fw.port),
                           "--local-port", "0", "--duration", "0.2"]) == 0
    assert "listening for log data" in capsys.readouterr().out


def test_bag_cli_matches_jax(tmp_path, capsys):
    path = str(tmp_path / "x.bag")
    with BagWriter(path) as w:
        for i in range(5):
            w.write("x", 0.1 * i, np.array([i, -i], np.float32))
    for argv in (["bag", "info", path], ["bag", "csv", path, "--channel",
                                          "x"],
                 ["bag", "plot", path, "--channel", "x", "--col", "0"],
                 ["bag", "play", path]):
        assert tools.main(argv) == 0
        out = capsys.readouterr().out
        assert jtools.main(argv) == 0
        assert out == capsys.readouterr().out, argv
    assert tools.main(["bag", "csv", path]) == 2      # --channel needed


def test_fly_on_the_cpu(tmp_path, capsys):
    out, bag = tmp_path / "flight.txt", tmp_path / "flight.bag"
    assert tools.main(["fly", "--traj", "hover", "--steps", "3",
                       "--device", "cpu", "--out", str(out),
                       "--bag", str(bag)]) == 0
    text = capsys.readouterr().out
    assert "flew 3 ticks of hover(0,0,0.5) on cpu" in text
    table = np.loadtxt(out)
    assert table.shape == (3, 17) and np.isfinite(table).all()
    np.testing.assert_allclose(table[0, :3], [0.3, -0.2, 0.1])
    assert Bag(str(bag))["state_estimate"].values.shape == (3, 13)


def test_fly_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tools.main(["fly", "--steps", "1", "--out",
                    str(tmp_path / "f.txt")])
