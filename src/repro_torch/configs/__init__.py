from repro_torch.configs.base import (  # noqa: F401
    SHAPES, AttnConfig, ModelConfig, MoEConfig, ShapeConfig, SSMConfig,
    cell_is_runnable, get_config, list_archs, reduced_config, register,
)
