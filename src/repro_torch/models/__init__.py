"""Model zoo of the port: config, layers, the parameter bridge and Model."""

from repro_torch.models.config import INPUT_SHAPES, Block, InputShape, ModelConfig
from repro_torch.models.transformer import Model

__all__ = ["INPUT_SHAPES", "Block", "InputShape", "ModelConfig", "Model"]
