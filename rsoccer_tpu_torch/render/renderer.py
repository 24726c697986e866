"""Host-side pygame renderer.

A copy of ``rsoccer_tpu/render/renderer.py`` reading the port's ``Frame``
(importing any ``rsoccer_tpu`` module loads JAX);
``tests/test_torch_frame_render.py`` holds its pixels equal to the JAX
package's.  Conceptual port of the reference's Render package (field painters
Render/field.py, robot/ball painters Render/robot.py, Render/ball.py) with
the same visual constants — field geometry, px/m scales (VSS 500, SSL 100),
colors and id tag patterns — but a single compact Renderer class instead of a
class hierarchy.  Strictly host-side: it reads a degree-based ``Frame`` view
(``rsoccer_tpu_torch.core.frame``) and never touches device arrays in the hot loop.

Supports "human" (window, 60 fps pacing — reference vss_gym_base.py:23,183)
and "rgb_array" (HxWx3 uint8) modes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from rsoccer_tpu_torch.core.frame import Frame
from rsoccer_tpu_torch.render.colors import COLORS, VSS_TAG_COLORS, ssl_tag_colors


@dataclass(frozen=True)
class RenderGeometry:
    """Field-drawing constants (reference Render/field.py:189-264)."""

    length: float
    width: float
    margin: float
    center_circle_r: float
    penalty_length: float
    penalty_width: float
    goal_width: float
    goal_depth: float
    scale: float  # px per meter
    robot_size: float  # VSS square side / SSL disc radius, meters
    league: str  # "vss" | "ssl"

    @property
    def screen_size(self):
        # Scale each term before summing — the reference transforms params
        # individually (field.py:33-42,204-210), and the association order
        # matters at float precision (9.0*100 + 2*(0.35*100) = 970.0 but
        # (9.0 + 0.7)*100 = 969.99…).
        w = int(self.length * self.scale + 2 * (self.margin * self.scale))
        h = int(self.width * self.scale + 2 * (self.margin * self.scale))
        return (w, h)

    @property
    def center(self):
        return (
            (self.length / 2 + self.margin) * self.scale,
            (self.width / 2 + self.margin) * self.scale,
        )


VSS_GEOMETRY = RenderGeometry(
    length=1.5, width=1.3, margin=0.1, center_circle_r=0.2,
    penalty_length=0.15, penalty_width=0.7, goal_width=0.4, goal_depth=0.1,
    scale=500.0, robot_size=0.072, league="vss",
)

SSL_GEOMETRY = RenderGeometry(
    length=9.0, width=6.0, margin=0.35, center_circle_r=1.0,
    penalty_length=1.0, penalty_width=2.0, goal_width=1.0, goal_depth=0.18,
    scale=100.0, robot_size=0.09, league="ssl",
)

BALL_RADIUS = 0.0215  # reference Render/ball.py:6


class Renderer:
    """Draws frames for one league; lazily initialises pygame."""

    fps = 60

    def __init__(self, league: str, render_mode: str = "rgb_array"):
        if league not in ("vss", "ssl"):
            raise ValueError(f"unknown league {league!r}")
        self.geom = VSS_GEOMETRY if league == "vss" else SSL_GEOMETRY
        self.render_mode = render_mode
        self._surface = None
        self._clock = None
        self.window_size = self.geom.screen_size

    # ------------------------------------------------------------------
    def _ensure_surface(self):
        import pygame

        if self._surface is not None:
            return pygame
        pygame.init()
        if self.render_mode == "human":
            pygame.display.init()
            caption = "VSS Environment" if self.geom.league == "vss" else "SSL Environment"
            pygame.display.set_caption(caption)
            self._surface = pygame.display.set_mode(self.window_size)
        else:
            self._surface = pygame.Surface(self.window_size)
        self._clock = pygame.time.Clock()
        return pygame

    def _px(self, x: float, y: float):
        cx, cy = self.geom.center
        return (int(x * self.geom.scale + cx), int(y * self.geom.scale + cy))

    # ------------------------------------------------------------------
    def _draw_field(self, pygame):
        g = self.geom
        s = self._surface
        scale = g.scale
        W, H = self.window_size
        m = g.margin * scale
        s.fill(COLORS["BG_GREEN"])
        # bounds, center line+circle
        pygame.draw.rect(
            s, COLORS["WHITE"], (m, m, g.length * scale, g.width * scale), 1
        )
        pygame.draw.line(s, COLORS["WHITE"], (W / 2, m), (W / 2, H - m), 1)
        pygame.draw.circle(
            s, COLORS["WHITE"], (W // 2, H // 2), int(g.center_circle_r * scale), 1
        )
        # penalty areas
        pw, pl = g.penalty_width * scale, g.penalty_length * scale
        pygame.draw.rect(s, COLORS["WHITE"], (m, (H - pw) // 2, pl, pw), 1)
        pygame.draw.rect(s, COLORS["WHITE"], (W - m - pl, (H - pw) // 2, pl, pw), 1)
        # goals
        gw, gd = g.goal_width * scale, g.goal_depth * scale
        pygame.draw.rect(s, COLORS["WHITE"], (m - gd, (H - gw) // 2, gd, gw), 1)
        pygame.draw.rect(s, COLORS["WHITE"], (W - m, (H - gw) // 2, gd, gw), 1)

    def _draw_vss_robot(self, pygame, x, y, theta_deg, rid, team_color):
        size = self.geom.robot_size * self.geom.scale
        surf = pygame.Surface((size * 2, size * 2), pygame.SRCALPHA)
        pygame.draw.rect(
            surf, COLORS["ROBOT_BLACK"], (size // 2, size // 2, size, size)
        )
        tag_w, tag_h = 0.03 * self.geom.scale, 0.068 * self.geom.scale
        ty = size // 2 + (size - tag_h) // 2
        pygame.draw.rect(
            surf, team_color, (size // 2 + (size - 2 * tag_w) // 2 - 1, ty, tag_w, tag_h)
        )
        pygame.draw.rect(
            surf,
            VSS_TAG_COLORS.get(rid % 3, COLORS["GREEN"]),
            (size + 1, ty, tag_w, tag_h),
        )
        rotated = pygame.transform.rotate(surf, -theta_deg)
        rect = rotated.get_rect(center=(x, y))
        self._surface.blit(rotated, rect.topleft)

    def _draw_ssl_robot(self, pygame, x, y, theta_deg, rid, team_color):
        scale = self.geom.scale
        size = self.geom.robot_size * scale
        surf = pygame.Surface((size * 2, size * 2), pygame.SRCALPHA)
        pygame.draw.circle(surf, COLORS["ROBOT_BLACK"], (size, size), size)
        pygame.draw.circle(surf, team_color, (size, size), 0.025 * scale)
        # 4-dot id pattern at the standard positions (Render/robot.py:190-197)
        offsets = np.array(
            [[0.035, 0.054772], [-0.054772, 0.035], [-0.054772, -0.035], [0.035, -0.054772]]
        ) * scale
        for dot, color in zip(offsets, ssl_tag_colors(rid)):
            pygame.draw.circle(
                surf, color, (int(size + dot[0]), int(size + dot[1])), 0.02 * scale
            )
        rotated = pygame.transform.rotate(surf, -theta_deg)
        rect = rotated.get_rect(center=(x, y))
        self._surface.blit(rotated, rect.topleft)
        # heading line
        rad = math.radians(theta_deg)
        pygame.draw.line(
            self._surface, COLORS["WHITE"], (x, y),
            (x + size * math.cos(rad), y + size * math.sin(rad)),
        )

    def _draw_ball(self, pygame, x, y):
        r = BALL_RADIUS * self.geom.scale
        pygame.draw.circle(self._surface, COLORS["ORANGE"], (x, y), r)
        pygame.draw.circle(self._surface, COLORS["BLACK"], (x, y), r, 1)

    # ------------------------------------------------------------------
    def render_frame(self, frame: Frame):
        """Draw one frame; returns HxWx3 uint8 in rgb_array mode."""
        pygame = self._ensure_surface()
        self._draw_field(pygame)
        draw_robot = (
            self._draw_vss_robot if self.geom.league == "vss" else self._draw_ssl_robot
        )
        for rid, rb in frame.robots_blue.items():
            x, y = self._px(rb.x, rb.y)
            draw_robot(pygame, x, y, rb.theta, rid, COLORS["BLUE"])
        for rid, rb in frame.robots_yellow.items():
            x, y = self._px(rb.x, rb.y)
            draw_robot(pygame, x, y, rb.theta, rid, COLORS["YELLOW"])
        bx, by = self._px(frame.ball.x, frame.ball.y)
        self._draw_ball(pygame, bx, by)

        if self.render_mode == "human":
            pygame.event.pump()
            pygame.display.update()
            self._clock.tick(self.fps)
            return None
        return np.transpose(
            np.array(pygame.surfarray.pixels3d(self._surface)), axes=(1, 0, 2)
        )

    def close(self):
        if self._surface is not None:
            import pygame

            if self.render_mode == "human":
                pygame.display.quit()
            pygame.quit()
            self._surface = None
