from repro_torch.configs.base import ArchConfig, RunShape, SHAPES, applicable_shapes, smoke  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get  # noqa: F401
