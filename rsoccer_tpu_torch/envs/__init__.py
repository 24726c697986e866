from rsoccer_tpu_torch.envs.base import Env
from rsoccer_tpu_torch.envs.vss import VSSEnv

__all__ = ["Env", "VSSEnv"]
