"""Vehicle description presets: the crazyflie_description equivalent
(the port's own copy of the JAX package's `models/description.py`, host
code).

The reference ships URDF xacro models whose inertial blocks differ from
the controller's identified model constants: the NMPC uses the
system-identification values (export_ode_model.py:33-42, mass 33 g
including a mocap marker), while the URDF carries the bare-airframe
datasheet values (crazyflie2.urdf.xacro:8-15, mass 27 g).  Both are
exposed here as named `QuadrotorParams` presets, with a URDF and a
procedural STL export of any of them.
"""

from __future__ import annotations

from crazyflie_nmpc_tpu_torch.models.quadrotor import QuadrotorParams


def cf21_identified(**overrides) -> QuadrotorParams:
    """Crazyflie 2.1 + mocap marker, sysid values: the NMPC model
    (export_ode_model.py:33-42).  This is the `QuadrotorParams()` default."""
    return QuadrotorParams(**overrides)


def cf2_urdf(**overrides) -> QuadrotorParams:
    """Crazyflie 2.x bare airframe, URDF datasheet inertials
    (crazyflie2.urdf.xacro:10-13: mass 0.027, Ixx=Iyy=2.3951e-5,
    Izz=3.2347e-5)."""
    kw = dict(mq=0.027, Ixx=2.3951e-5, Iyy=2.3951e-5, Izz=3.2347e-5)
    kw.update(overrides)
    return QuadrotorParams(**kw)


def cf1_urdf(**overrides) -> QuadrotorParams:
    """Crazyflie 1.0 (crazyflie.urdf.xacro:6-11: mass 0.019,
    Ixx=Iyy=0.01152, Izz=0.0218 — the URDF's values verbatim)."""
    kw = dict(mq=0.019, Ixx=0.01152, Iyy=0.01152, Izz=0.0218)
    kw.update(overrides)
    return QuadrotorParams(**kw)


# rotor aerodynamic constants from the xacro property block
# (crazyflie2.urdf.xacro:5-6), kept for sim fidelity extensions
ROTOR_DRAG_COEFFICIENT = 1.8580e-05  # [N m s^2]
MOMENT_CONSTANT = 0.005              # [N s^2]

PRESETS = {
    "cf21_identified": cf21_identified,
    "cf2_urdf": cf2_urdf,
    "cf1_urdf": cf1_urdf,
}


def params_for(model: str, **overrides) -> QuadrotorParams:
    """Look up a preset by name (the `model` arg a bringup would take)."""
    try:
        return PRESETS[model](**overrides)
    except KeyError:
        raise KeyError(
            f"unknown vehicle model {model!r}; have {sorted(PRESETS)}"
        ) from None


def to_urdf(params: QuadrotorParams | None = None, name: str = "crazyflie2",
            mesh: str | None = "package://crazyflie_description/meshes/"
                              "crazyflie2.dae") -> str:
    """Emit a URDF for a vehicle description (xacro-expanded equivalent of
    crazyflie2.urdf.xacro:8-26, with the inertial block driven by the
    given `QuadrotorParams` instead of hard-coded literals — so the
    identified NMPC model and the datasheet model both export).

    `mesh=None` drops the visual element (no mesh assets ship with this
    framework; pass a path/URI to reference external ones).  Products of
    inertia are zero, matching the reference's diagonal inertia model
    (export_ode_model.py:37-39; crazyflie2.urdf.xacro:14).
    """
    from xml.sax.saxutils import quoteattr

    p = params if params is not None else cf2_urdf()
    # attribute values are escaped (quoteattr): a name/mesh URI containing
    # quotes/&/< must not produce malformed URDF
    visual = "" if mesh is None else f"""
    <visual>
      <origin xyz="0 0 0" rpy="0 0 0" />
      <geometry>
        <mesh filename={quoteattr(mesh)}/>
      </geometry>
    </visual>
"""
    return f"""<?xml version="1.0"?>
<robot name={quoteattr(name)}>
  <link name="base_link">
    <inertial>
      <mass value="{float(p.mq)!r}" />
      <origin xyz="0 0 0" />
      <inertia ixx="{float(p.Ixx)!r}" ixy="0.0" ixz="0.0" \
iyy="{float(p.Iyy)!r}" iyz="0.0" izz="{float(p.Izz)!r}" />
    </inertial>{visual}  </link>
</robot>
"""


def to_stl(params: QuadrotorParams | None = None, path: str | None = None,
           body_radius: float = 0.02, prop_radius: float = 0.023,
           height: float = 0.006, segments: int = 12) -> bytes:
    """Procedurally generate a binary-STL visualization mesh for a
    vehicle description, the stand-in for the reference's shipped
    collada assets (crazyflie_description/meshes; binary art assets are
    not re-created, but a dimensionally accurate mesh derived from the
    model constants is): a center disc plus four
    rotor discs at the X-configuration arm positions.  The model's `l`
    (export_ode_model.py:41) is the PER-AXIS moment arm — the torque
    rows use Ct*l directly — so rotors sit at (+-l, +-l): radial
    distance l*sqrt(2) ~ 46 mm for the CF2, its real center-to-rotor
    arm.

    Returns the STL bytes; writes them to `path` if given (the URI to
    hand to `to_urdf(mesh=...)`).
    """
    import math
    import struct as _st

    p = params if params is not None else cf2_urdf()
    arm = float(p.l)
    tris = []

    def disc(cx, cy, r):
        """Closed cylinder (top+bottom fans + side wall)."""
        top, bot = height / 2.0, -height / 2.0
        for k in range(segments):
            a0 = 2.0 * math.pi * k / segments
            a1 = 2.0 * math.pi * (k + 1) / segments
            x0, y0 = cx + r * math.cos(a0), cy + r * math.sin(a0)
            x1, y1 = cx + r * math.cos(a1), cy + r * math.sin(a1)
            tris.append(((0, 0, 1), (cx, cy, top), (x0, y0, top),
                         (x1, y1, top)))
            tris.append(((0, 0, -1), (cx, cy, bot), (x1, y1, bot),
                         (x0, y0, bot)))
            tris.append(((0, 0, 0), (x0, y0, bot), (x1, y1, bot),
                         (x1, y1, top)))
            tris.append(((0, 0, 0), (x0, y0, bot), (x1, y1, top),
                         (x0, y0, top)))

    disc(0.0, 0.0, body_radius)
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        disc(sx * arm, sy * arm, prop_radius)

    out = bytearray(b"crazyflie_nmpc_tpu procedural mesh".ljust(80, b"\0"))
    out += _st.pack("<I", len(tris))
    for n, a, b, c in tris:
        out += _st.pack("<3f", *n)
        for v in (a, b, c):
            out += _st.pack("<3f", *v)
        out += _st.pack("<H", 0)
    data = bytes(out)
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data
