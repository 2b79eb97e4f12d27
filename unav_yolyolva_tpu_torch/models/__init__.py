from .alignment import Alignment
from .backbone import ConvTransformerBackbone
from .blocks import (AffineDropPath, ChannelLayerNorm, LearnableScale,
                     MaskedConv1D, MaskedMHCA, TransformerBlock)
from .dependency import DependencyBlock
from .fusion import FusionModule
from .heads import ClsHead, RegHead
from .meta_arch import LocPointTransformer, build_model, init_weights

__all__ = [
    "AffineDropPath", "Alignment", "ChannelLayerNorm", "ClsHead",
    "ConvTransformerBackbone", "DependencyBlock", "FusionModule", "LearnableScale",
    "LocPointTransformer", "MaskedConv1D", "MaskedMHCA", "RegHead",
    "TransformerBlock", "build_model", "init_weights",
]
