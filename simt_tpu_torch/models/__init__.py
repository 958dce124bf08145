from . import from_jax
from .resnet_multi import ResNetMulti, deeplab_multi, init_weights
