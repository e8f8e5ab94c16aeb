from .cswin_unet import CSWinUNet, cswin_block
from .wrapper import CSwinUnet, build_model

__all__ = [
    "CSWinUNet",
    "cswin_block",
    "CSwinUnet",
    "build_model",
]
