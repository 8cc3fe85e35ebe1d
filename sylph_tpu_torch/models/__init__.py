from .code_generator import CodeGeneratorHead
from .fcos_head import FCOSHead, HeadOutputs
from .fpn import FPN
from .meta_arch import MetaOneStageDetector
from .resnet import RESNET_STAGES, ResNet

__all__ = ["CodeGeneratorHead", "FCOSHead", "HeadOutputs", "FPN",
           "MetaOneStageDetector", "RESNET_STAGES", "ResNet"]
