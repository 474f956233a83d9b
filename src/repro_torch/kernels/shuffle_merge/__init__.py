from repro_torch.kernels.shuffle_merge.ops import shuffle_merge

__all__ = ["shuffle_merge"]
