from . import from_jax
from .deeplab_single import DeeplabSingle, res_deeplab
from .deeplab_vgg import DeeplabVGG, deeplab_vgg
from .deeplabv3 import DeepLabv3, deeplabv3
from .discriminator import FCDiscriminator
from .resnet_multi import ResNetMulti, deeplab_multi, init_weights
