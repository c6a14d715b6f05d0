from .svd import StableVideoDiffusionPipeline
from .svd_controlnet import StableVideoDiffusionControlNetPipeline

__all__ = ["StableVideoDiffusionPipeline", "StableVideoDiffusionControlNetPipeline"]
