"""Configuration schema.

The JAX package's ``config.py`` imports no jax (and parses the yaml
configs without PyYAML when it is absent), so the port uses it
unchanged: a config file means the same model in both packages. It is
re-exported here so that the port's own callers (``chip_smoke.py``)
import only from the port.
"""

from gluon_e2e_asr_tpu.config import (  # noqa: F401
    Config,
    DataConfig,
    DecodeConfig,
    FrontendConfig,
    ModelConfig,
    TrainConfig,
    apply_overrides,
    load_config,
)
