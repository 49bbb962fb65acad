"""The pipelines: the image swap, the video swap and training."""
from vface_torch.pipelines.image_swap import ImageSwapOptions, run_test_bench, swap_image_batch
from vface_torch.pipelines.train import TrainConfig, make_optimizer, make_train_step, p_losses_face
from vface_torch.pipelines.video_swap import SwapOptions, VideoSwapPipeline

__all__ = [
    "ImageSwapOptions",
    "run_test_bench",
    "swap_image_batch",
    "TrainConfig",
    "make_optimizer",
    "make_train_step",
    "p_losses_face",
    "SwapOptions",
    "VideoSwapPipeline",
]
