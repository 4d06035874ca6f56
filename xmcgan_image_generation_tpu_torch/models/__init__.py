from xmcgan_image_generation_tpu_torch.models.registry import (  # noqa: F401
    get_architecture,
)
