from analytics_zoo_tpu_torch.keras.engine import (  # noqa: F401
    Input, Layer, Model, Node, Sequential)
from analytics_zoo_tpu_torch.keras import layers  # noqa: F401
