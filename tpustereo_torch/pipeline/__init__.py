from tpustereo_torch.pipeline.sgbm import sgbm, sgbm_batched, sgbm_frames  # noqa: F401
