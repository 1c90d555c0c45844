from repro_torch.data.pipeline import SyntheticPipeline, make_batch_fn  # noqa: F401
