"""Episode video export via the host renderer.

Port of ``rsoccer_tpu/utils/video.py``: rolls a policy in one env (a batch
of 1 on ``device``), renders every frame on the host, and writes an
animated GIF (imageio when present, else Pillow).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from rsoccer_tpu_torch.core.frame import frame_from_world
from rsoccer_tpu_torch.envs.base import draw_noise
from rsoccer_tpu_torch.models.networks import check_device
from rsoccer_tpu_torch.ops.philox import make_key
from rsoccer_tpu_torch.render.renderer import Renderer


def record_episode(
    env,
    policy: Optional[Callable] = None,
    seed: int = 0,
    max_steps: int = 600,
    every: int = 2,
    device="cuda",
):
    """Roll one episode of the functional ``env``, returning a list of
    HxWx3 uint8 frames.

    ``policy(gen, obs (O, 1)) -> action (A, 1)``, the port's lane-layout
    policy on a batch of 1; defaults to uniform random.  ``every``
    subsamples frames (2 -> 20 fps at the 40 Hz step).  The episode ends
    when the task terminates or after ``max_steps`` steps.
    """
    device = check_device(device)
    renderer = Renderer(env.league, "rgb_array")
    key = make_key(seed, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = env.reset_state(draw_noise(key, env.reset_noise_spec(), 1))
    obs = env.observe(state)
    t_spec = env.transition_noise_spec()
    frames = []
    for t in range(max_steps):
        if t % every == 0:
            frames.append(renderer.render_frame(frame_from_world(state.world, env.n_blue, env.n_yellow)))
        if policy is None:
            action = torch.rand((env.action_size, 1), generator=gen, device=device) * 2.0 - 1.0
        else:
            action = policy(gen, obs)
        state, reward, done, info = env.transition(state, action, draw_noise(key, t_spec, 1))
        obs = env.observe(state)
        if bool(done[0]):
            break
    renderer.close()
    return frames


def save_gif(frames, path: str, fps: int = 20):
    """Write frames to an animated GIF (imageio if present, else PIL)."""
    try:
        import imageio

        imageio.mimsave(path, frames, duration=1000 / fps, loop=0)
        return path
    except ImportError:
        pass
    from PIL import Image

    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(
        path,
        save_all=True,
        append_images=imgs[1:],
        duration=int(1000 / fps),
        loop=0,
    )
    return path
