"""Physics coefficients: a copy of ``rsoccer_tpu/physics/config.py``.

Copied rather than imported for the reason given in ``core/field.py``;
``tests/test_torch_port_basics.py`` and ``tests/test_torch_env_ssl.py`` hold
``VSS_PHYSICS`` and ``SSL_PHYSICS`` equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    # integration
    n_substeps: int = 5  # substeps per control step (dt/n each)

    # robot drive response (first-order velocity tracking with accel clamps)
    robot_accel: float = 5.0  # m/s^2
    robot_alpha: float = 100.0  # rad/s^2
    lateral_decay: float = 40.0  # 1/s — diff-drive lateral slip decay

    # ball
    ball_friction_decel: float = 0.5  # m/s^2 rolling deceleration
    ball_mass: float = 0.046
    robot_mass: float = 0.5

    # vertical axis (grSim-lineage ball contact parameters)
    gravity: float = 9.8
    rest_ball_ground: float = 0.5
    ball_bounce_min_v: float = 0.1
    rbt_height: float = 0.15  # m — ball passes over robots above this

    # restitution
    rest_ball_wall: float = 0.6
    rest_ball_robot: float = 0.5
    rest_dribbler: float = 0.1
    rest_robot_robot: float = 0.1

    # SSL kicker and dribbler
    kicker_depth_slack: float = 0.01
    kicker_height: float = 0.05
    dribbler_pull_accel: float = 300.0
    dribbler_damping: float = 30.0
    dribbler_capture_speed: float = 2.0
    dribbler_reach: float = 0.03


VSS_PHYSICS = PhysicsConfig(
    robot_accel=6.0,
    robot_alpha=180.0,
    ball_friction_decel=0.6,
    robot_mass=0.25,
    rbt_height=0.075,  # VSS robots are 75 mm cubes
)

SSL_PHYSICS = PhysicsConfig(
    robot_accel=3.5,
    robot_alpha=50.0,
    ball_friction_decel=0.35,
    robot_mass=2.5,
    rbt_height=0.147,  # SSL rule-book max robot height
)
