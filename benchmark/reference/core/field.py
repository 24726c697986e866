"""Field geometry and robot parameter tables (VSS and SSL).

A copy of ``rsoccer_tpu/core/field.py``'s ``FieldParams`` and its VSS and
SSL tables.
It is copied, not imported: importing any ``rsoccer_tpu`` module runs that
package's ``__init__``, which loads JAX, and the port must run where JAX is
not installed.  ``tests/test_torch_port_basics.py`` and ``tests/test_torch_env_ssl.py``
hold the tables equal to the JAX package's field by field.

Units: meters, degrees for wheel mount angles, RPM for the motor limit —
the reference's ``Field`` contract (Entities/Field.py:4-21), so the derived
``max_pos``/``max_v``/``max_wheel_rad_s`` come out identical.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class FieldParams:
    """Mirror of the reference's 17-float ``Field`` contract."""

    length: float
    width: float
    penalty_length: float
    penalty_width: float
    goal_width: float
    goal_depth: float
    ball_radius: float
    rbt_distance_center_kicker: float
    rbt_kicker_thickness: float
    rbt_kicker_width: float
    rbt_wheel0_angle: float
    rbt_wheel1_angle: float
    rbt_wheel2_angle: float
    rbt_wheel3_angle: float
    rbt_radius: float
    rbt_wheel_radius: float
    rbt_motor_max_rpm: float

    @property
    def half_length(self) -> float:
        return self.length / 2

    @property
    def half_width(self) -> float:
        return self.width / 2

    @property
    def max_pos(self) -> float:
        """Reference vss_gym_base.py:52-54."""
        return max(self.width / 2, (self.length / 2) + self.penalty_length)

    @property
    def max_wheel_rad_s(self) -> float:
        return (self.rbt_motor_max_rpm / 60.0) * 2.0 * math.pi

    @property
    def max_v(self) -> float:
        """Reference vss_gym_base.py:55-56."""
        return self.max_wheel_rad_s * self.rbt_wheel_radius


_VSS_ROBOT = dict(
    penalty_length=0.15,
    penalty_width=0.7,
    goal_width=0.4,
    goal_depth=0.1,
    ball_radius=0.0215,
    rbt_distance_center_kicker=0.0,
    rbt_kicker_thickness=0.0,
    rbt_kicker_width=0.0,
    rbt_wheel0_angle=90.0,
    rbt_wheel1_angle=270.0,
    rbt_wheel2_angle=0.0,
    rbt_wheel3_angle=0.0,
    rbt_radius=0.0375,
    rbt_wheel_radius=0.026,
    rbt_motor_max_rpm=440.0,
)

VSS_FIELDS = {
    0: FieldParams(length=1.5, width=1.3, **_VSS_ROBOT),  # 3v3 field
    1: FieldParams(length=2.2, width=1.8, **_VSS_ROBOT),  # 5v5 field
}


# SSL: 4-omni robots (front wheels at +-60 deg, rear at +-135 deg); the
# motor limit gives the 160 rad/s wheel cap of the reference's energy
# scale (ssl_hw_challenge/static_defenders.py:71)
_SSL_ROBOT = dict(
    ball_radius=0.0215,
    rbt_distance_center_kicker=0.081,
    rbt_kicker_thickness=0.005,
    rbt_kicker_width=0.08,
    rbt_wheel0_angle=60.0,
    rbt_wheel1_angle=135.0,
    rbt_wheel2_angle=225.0,
    rbt_wheel3_angle=300.0,
    rbt_radius=0.09,
    rbt_wheel_radius=0.027,
    rbt_motor_max_rpm=1528.0,
)

_SSL_DIV_B = dict(length=9.0, width=6.0, penalty_length=1.0, penalty_width=2.0,
                  goal_width=1.0, goal_depth=0.18)

SSL_FIELDS = {
    0: FieldParams(**_SSL_DIV_B, **_SSL_ROBOT),  # division B, 6v6
    1: FieldParams(length=12.0, width=9.0, penalty_length=1.8,  # division A
                   penalty_width=3.6, goal_width=1.8, goal_depth=0.18, **_SSL_ROBOT),
    2: FieldParams(**_SSL_DIV_B, **_SSL_ROBOT),  # 2021 hardware challenges
}


def vss_field(field_type: int) -> FieldParams:
    return VSS_FIELDS[field_type]


def ssl_field(field_type: int) -> FieldParams:
    return SSL_FIELDS[field_type]
