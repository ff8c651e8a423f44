from repro_torch.common.config import (  # noqa: F401
    ModelConfig,
    ShapeConfig,
    SHAPES,
    SHAPES_BY_NAME,
    MeshConfig,
    SINGLE_POD_MESH,
    MULTI_POD_MESH,
    ChameleonConfig,
    TrainConfig,
)
