from repro_torch.data.pipeline import DataConfig, TokenPipeline, host_batches

__all__ = ["DataConfig", "TokenPipeline", "host_batches"]
