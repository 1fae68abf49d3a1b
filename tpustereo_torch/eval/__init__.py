from tpustereo_torch.eval.metrics import (ate, bad, d1_all,  # noqa: F401
                                          end_point_error,
                                          kitti_segment_errors, rpe)
