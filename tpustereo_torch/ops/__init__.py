from tpustereo_torch.ops.census import census, cost_volume  # noqa: F401
from tpustereo_torch.ops.sad import sad_volume  # noqa: F401
from tpustereo_torch.ops.sgm import aggregate, aggregate_path  # noqa: F401
from tpustereo_torch.ops.wta import wta  # noqa: F401
from tpustereo_torch.ops.postproc import (  # noqa: F401
    component_big, connected_component_labels, dr_consistency, lr_check,
    median3, speckle, speckle_frames, speckle_labels)
