from rsoccer_tpu_torch.envs.base import Env
from rsoccer_tpu_torch.envs.ssl_contested_possession import SSLContestedPossessionEnv
from rsoccer_tpu_torch.envs.ssl_static_defenders import SSLStaticDefendersEnv
from rsoccer_tpu_torch.envs.vss import VSSEnv

__all__ = ["Env", "SSLContestedPossessionEnv", "SSLStaticDefendersEnv", "VSSEnv"]
