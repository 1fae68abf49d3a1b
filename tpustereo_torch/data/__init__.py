from tpustereo_torch.data.datasets import (  # noqa: F401
    KittiCalib, kitti_odometry_sequence, load_kitti2015_pair,
    load_middlebury_pair, parse_kitti_odometry_calib)
from tpustereo_torch.data.io import (  # noqa: F401
    read_image_gray, read_kitti_disparity, read_pfm, write_image,
    write_kitti_disparity, write_pfm)
from tpustereo_torch.data.prefetch import prefetch_pairs  # noqa: F401
from tpustereo_torch.data.synthetic import (  # noqa: F401
    synthetic_pair, synthetic_sequence)
