from tpustereo_torch.pipeline.sgbm import (  # noqa: F401
    select_and_refine, sgbm, sgbm_batched, sgbm_frames, sgbm_volume)
