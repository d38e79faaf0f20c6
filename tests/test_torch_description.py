"""The port's vehicle description presets (`models.description`, its own
copy of the JAX package's host code) against the JAX package's: every
preset's parameters, the URDF text and the STL bytes equal, overrides and
the unknown-model error alike."""

import dataclasses

import pytest

from crazyflie_nmpc_tpu.models import description as jdesc
from crazyflie_nmpc_tpu_torch.models import description as tdesc
from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams
from _torch_shared import one_torch_thread  # noqa: F401

PRESETS = ("cf21_identified", "cf2_urdf", "cf1_urdf")


def _fields(p):
    return {f.name: float(getattr(p, f.name))
            for f in dataclasses.fields(QuadrotorParams)}


@pytest.mark.parametrize("name", PRESETS)
def test_presets_match_jax(name):
    assert sorted(tdesc.PRESETS) == sorted(jdesc.PRESETS)
    got, want = tdesc.params_for(name), jdesc.params_for(name)
    assert isinstance(got, QuadrotorParams)
    assert _fields(got) == _fields(want)
    assert _fields(getattr(tdesc, name)(mq=0.04)) == _fields(
        getattr(jdesc, name)(mq=0.04))
    assert got.hover_speed() == pytest.approx(float(want.hover_speed()),
                                              rel=1e-15)


def test_constants_and_unknown_model():
    assert tdesc.ROTOR_DRAG_COEFFICIENT == jdesc.ROTOR_DRAG_COEFFICIENT
    assert tdesc.MOMENT_CONSTANT == jdesc.MOMENT_CONSTANT
    with pytest.raises(KeyError, match="unknown vehicle model 'cf3'"):
        tdesc.params_for("cf3")


@pytest.mark.parametrize("kw", [
    {}, dict(name="cf21", mesh=None),
    dict(name='a"b&<c', mesh="file:///tmp/x y.stl")],
    ids=["default", "no_mesh", "escaped"])
@pytest.mark.parametrize("name", PRESETS)
def test_urdf_text_matches_jax(name, kw):
    assert tdesc.to_urdf(tdesc.params_for(name), **kw) == jdesc.to_urdf(
        jdesc.params_for(name), **kw)
    assert tdesc.to_urdf() == jdesc.to_urdf()


@pytest.mark.parametrize("name", PRESETS)
def test_stl_bytes_match_jax(name, tmp_path):
    kw = dict(segments=8, body_radius=0.021)
    data = tdesc.to_stl(tdesc.params_for(name), path=str(tmp_path / "t.stl"),
                        **kw)
    assert data == jdesc.to_stl(jdesc.params_for(name), **kw)
    assert (tmp_path / "t.stl").read_bytes() == data
    assert tdesc.to_stl() == jdesc.to_stl()
