from .windows import window_partition, window_merge
from .attention import cswin_attention_xla, depthwise_conv3x3
from .carafe import carafe

__all__ = [
    "window_partition",
    "window_merge",
    "cswin_attention_xla",
    "depthwise_conv3x3",
    "carafe",
]
