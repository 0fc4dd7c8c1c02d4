from .unet import NBP
