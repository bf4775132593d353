from .factory import buffer_names, model_from_config  # noqa: F401
from .swin_transformer import BasicLayer, SwinTransformer  # noqa: F401
from .ssl_head import SSLHead  # noqa: F401
from .swin_unetr import SwinUNETR  # noqa: F401
from .unetr import UNETR  # noqa: F401
from .vit import ViT  # noqa: F401
from .unet import UNet, UNetVanilla  # noqa: F401
