from mrfp_tpu_torch.models.mrfp import MRFP, build_mrfp

__all__ = ["MRFP", "build_mrfp"]
