from merv_tpu_torch.preprocessing.transforms import VideoTransform, subsample_frames
from merv_tpu_torch.preprocessing.video_io import load_video, open_video

__all__ = ["VideoTransform", "load_video", "open_video", "subsample_frames"]
