from repro_torch.configs.base import (  # noqa: F401
    ASSIGNED, ArchConfig, FedConfig, INPUT_SHAPES, ShapeConfig, get, names,
    register,
)
