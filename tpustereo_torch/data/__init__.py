from tpustereo_torch.data.datasets import (  # noqa: F401
    KittiCalib, parse_kitti_odometry_calib)
from tpustereo_torch.data.synthetic import (  # noqa: F401
    synthetic_pair, synthetic_sequence)
