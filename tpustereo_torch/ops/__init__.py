from tpustereo_torch.ops.census import census, cost_volume  # noqa: F401
from tpustereo_torch.ops.sgm import aggregate, aggregate_path  # noqa: F401
from tpustereo_torch.ops.wta import wta  # noqa: F401
from tpustereo_torch.ops.postproc import dr_consistency, lr_check  # noqa: F401
