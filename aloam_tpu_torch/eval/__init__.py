from aloam_tpu_torch.eval.ate import (  # noqa: F401
    ate_rmse, kitti_drift, rpe, rpe_rot, umeyama_align)
