from merv_tpu_torch.preprocessing.datasets.datasets import AlignVideoDataset, FinetuneVideoDataset

__all__ = ["AlignVideoDataset", "FinetuneVideoDataset"]
