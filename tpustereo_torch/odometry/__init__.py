from tpustereo_torch.odometry.backend import (  # noqa: F401
    OdometryConfig, StereoOdometry)
from tpustereo_torch.odometry.pose_graph import (  # noqa: F401
    PoseGraph, optimize_poses)
from tpustereo_torch.odometry.pnp import gauss_newton_pose  # noqa: F401
from tpustereo_torch.odometry.features import (  # noqa: F401
    detect_corners, describe, match_descriptors,
)
from tpustereo_torch.odometry import se3  # noqa: F401
