from merv_tpu_torch.preprocessing.transforms import VideoTransform, subsample_frames

__all__ = ["VideoTransform", "subsample_frames"]
