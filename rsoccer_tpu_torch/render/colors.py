"""Render palette.

A copy of ``rsoccer_tpu/render/colors.py`` (importing any ``rsoccer_tpu``
module loads JAX); ``tests/test_torch_frame_render.py`` holds it equal.
Same RGB values as the reference so frames are visually identical
(Render/utils.py:2-15 for COLORS; Render/utils.py:17-114 for the SSL id tag
dot patterns; Render/robot.py:86 for the VSS id colors).
"""

COLORS = {
    "BLACK": (0, 0, 0),
    "WHITE": (220, 220, 220),
    "BG_GREEN": (20, 90, 45),
    "ROBOT_BLACK": (25, 25, 25),
    "ORANGE": (253, 106, 2),
    "BLUE": (0, 64, 255),
    "YELLOW": (250, 218, 94),
    "GREEN": (57, 220, 20),
    "RED": (151, 21, 0),
    "PURPLE": (102, 51, 153),
    "PINK": (220, 0, 220),
}

# VSS robots carry a single id tag: ids 0/1/2 -> green/purple/red
VSS_TAG_COLORS = {0: COLORS["GREEN"], 1: COLORS["PURPLE"], 2: COLORS["RED"]}

# SSL robots carry the standard 4-dot pink/green id pattern.  Encoded as
# 4-bit masks (bit i set -> dot i green) — same patterns as the reference's
# 16-entry table, stored compactly.
_SSL_TAG_BITS = [
    0b0010, 0b0011, 0b1011, 0b1010, 0b0100, 0b0101, 0b1101, 0b1100,
    0b1111, 0b0000, 0b0110, 0b1001, 0b0111, 0b0001, 0b1110, 0b1000,
]


def ssl_tag_colors(robot_id: int):
    bits = _SSL_TAG_BITS[robot_id % 16]
    return [
        COLORS["GREEN"] if (bits >> i) & 1 else COLORS["PINK"] for i in range(4)
    ]
