"""The head's config: the base config, interpolation, resolvers and
overrides."""
from moshpp_torch.config.config import Config, load_config, prepare_cfg
