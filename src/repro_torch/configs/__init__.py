"""Architecture configs: a copy of ``repro.configs`` (data literals only), so
that the port knows the same ``--arch`` ids without importing the JAX
package.  ``tests/test_torch_models.py`` holds the copy equal to the
reference field for field."""
from repro_torch.configs.base import (INPUT_SHAPES, InputShape, ModelConfig,
                                      reduce_for_smoke)
from repro_torch.configs.registry import ARCHS, get_config, list_archs

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "reduce_for_smoke",
           "ARCHS", "get_config", "list_archs"]
