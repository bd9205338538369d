from mrfp_tpu_torch.data.synthetic import SyntheticDataset

__all__ = ["SyntheticDataset"]
