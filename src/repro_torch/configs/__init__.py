"""Model configurations: a copy of ``repro.configs`` plus ``reduce_config``."""
from repro_torch.configs.base import (ModelConfig, get_config,  # noqa: F401
                                      reduce_config)
