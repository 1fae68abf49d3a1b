from tpustereo_torch.ops.census import census, cost_volume  # noqa: F401
from tpustereo_torch.ops.sad import sad_volume  # noqa: F401
from tpustereo_torch.ops.sgm import aggregate, aggregate_path  # noqa: F401
from tpustereo_torch.ops.wta import wta  # noqa: F401
from tpustereo_torch.ops.postproc import (  # noqa: F401
    component_big, component_big_sorted, connected_component_labels,
    dr_consistency, fill_background, fill_hirschmuller, lr_check, lr_hits,
    lr_hits_from_volume, median3, speckle, speckle_frames, speckle_labels)
